"""Parity of the port's blocked-grid layout math and plain encode
(ngp_tpu_torch/kernels/blocked_grid.py) with the JAX package: the same
numpy inputs go through both. The CUDA kernel itself runs only on the
card; chip_smoke.py holds it against the plain version there."""
import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import ngp_tpu.kernels.blocked_grid as jbg
import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu.config import autofill_hashgrid_config as j_autofill
from ngp_tpu.config import load_network_config as j_load
from ngp_tpu_torch.config import autofill_hashgrid_config as t_autofill
from ngp_tpu_torch.config import load_network_config as t_load
from ngp_tpu_torch.kernels import blocked_grid_cuda

@contextlib.contextmanager
def pallas_calls_in_turn():
    """Each ``pallas_call`` finishes before the caller dispatches its next
    operation. Dispatched eagerly, the JAX package's kernels (one call per
    level group, with gathers between) otherwise race the TPU
    interpreter's callbacks, whose own operations then queue behind the
    next group's and wait for a computation that waits for them: the
    process hangs in about one run in four."""
    from jax.experimental import pallas as pl
    pallas_call = pl.pallas_call

    def in_turn(*args, **kwargs):
        kernel = pallas_call(*args, **kwargs)
        return lambda *a: jax.block_until_ready(kernel(*a))
    with mock.patch.object(pl, "pallas_call", in_turn):
        yield


META_FIELDS = ("n_dims", "n_levels", "base_resolution", "per_level_scale",
               "log2_rows", "n_features_per_level", "row_hash",
               "level_scales", "level_resolutions", "level_blocks_per_dim",
               "level_is_dense", "rows", "n_output_dims", "n_params")

# small metas: 3D and 2D, both row hashes, a mix of dense and hashed levels
SMALL = [
    dict(n_dims=3, n_levels=5, base_resolution=16, per_level_scale=1.5,
         log2_rows=9, row_hash="prime"),
    dict(n_dims=3, n_levels=4, base_resolution=8, per_level_scale=2.0,
         log2_rows=7, row_hash="morton"),
    dict(n_dims=2, n_levels=6, base_resolution=16, per_level_scale=1.6,
         log2_rows=8, row_hash="prime"),
    dict(n_dims=2, n_levels=4, base_resolution=8, per_level_scale=2.0,
         log2_rows=7, row_hash="morton"),
]
SMALL_IDS = [f"{m['n_dims']}d-{m['row_hash']}" for m in SMALL]


@pytest.fixture(autouse=True)
def _no_jax_layout_knobs(monkeypatch):
    # the JAX meta reads TPU ablation knobs from the environment; the port
    # has none, so keep them unset for a like-for-like comparison
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)


def _assert_meta_equal(tm, jm):
    for f in META_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f


@pytest.mark.parametrize("aabb_scale", [1, 4, 16])
def test_meta_from_base_config_matches_jax(aabb_scale):
    enc = t_load("configs/nerf/base.json")["encoding"]
    assert enc == j_load("configs/nerf/base.json")["encoding"]
    t_enc = t_autofill(enc, 3, 2048.0, aabb_scale=aabb_scale)
    assert t_enc == j_autofill(enc, 3, 2048.0, aabb_scale=aabb_scale)
    tm = tbg.BlockedGridMeta.from_hashgrid_config(t_enc)
    _assert_meta_equal(tm, jbg.BlockedGridMeta.from_hashgrid_config(t_enc))
    if aabb_scale == 4:
        # the full-width table the card runs: (16, 8192, 128) f32, 64 MiB
        assert (tm.n_levels, tm.rows) == (16, 8192)
        assert tm.n_params * 4 == 64 << 20


def test_meta_stamped_layout_takes_precedence():
    enc = t_autofill(t_load("configs/nerf/base.json")["encoding"], 3, 2048.0,
                     aabb_scale=4)
    enc.update(log2_rows=10, row_hash="morton")
    tm = tbg.BlockedGridMeta.from_hashgrid_config(enc)
    assert (tm.log2_rows, tm.row_hash) == (10, "morton")
    _assert_meta_equal(tm, jbg.BlockedGridMeta.from_hashgrid_config(enc))
    # the cap at what the finest level can address still applies
    small = dict(enc, n_levels=2, per_level_scale=1.2, log2_rows=16)
    tm = tbg.BlockedGridMeta.from_hashgrid_config(small)
    assert tm.log2_rows < 16
    _assert_meta_equal(tm, jbg.BlockedGridMeta.from_hashgrid_config(small))


def _positions(meta_kw, n=2048, seed=0):
    """Random positions in [0,1], plus 0, 1, dyadic points, positions up
    to 0.1 outside the unit cube (where the block clip engages), and
    positions on each level's lattice vertices (pos·scale + 0.5
    integral), where a fused multiply-add would flip the floor."""
    rng = np.random.default_rng(seed)
    D = meta_kw["n_dims"]
    pts = [rng.random((n, D), dtype=np.float32),
           np.zeros((1, D), np.float32), np.ones((1, D), np.float32),
           rng.random((256, D), dtype=np.float32) * 1.2 - 0.1,
           (rng.integers(0, 65, (64, D)) / 64.0).astype(np.float32)]
    for s in tbg.BlockedGridMeta(**meta_kw).level_scales:
        m = rng.integers(1, int(s) + 1, (32, D)).astype(np.float32)
        pts.append(np.clip((m - np.float32(0.5)) / np.float32(s), 0, 1))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("meta_kw", SMALL, ids=SMALL_IDS)
def test_lookup_geometry_matches_jax(meta_kw):
    pos = _positions(meta_kw)
    t_rows, t_local, t_frac = tbg.lookup_geometry(
        tbg.BlockedGridMeta(**meta_kw), torch.from_numpy(pos))
    j_rows, j_local, j_frac = jbg.lookup_geometry(
        jbg.BlockedGridMeta(**meta_kw), pos)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_local.numpy(), np.asarray(j_local))
    # fractions: within 1 ulp (both take x - floor(x) of the same f32 x)
    np.testing.assert_array_max_ulp(t_frac.numpy(), np.asarray(j_frac), 1)


@pytest.mark.parametrize("meta_kw", SMALL, ids=SMALL_IDS)
def test_encode_reference_matches_jax(meta_kw):
    L = meta_kw["n_levels"]
    rng = np.random.default_rng(1)
    table = (rng.standard_normal((L, 1 << meta_kw["log2_rows"], 128))
             * 0.3).astype(np.float32)
    pos = _positions(meta_kw, seed=2)
    got = tbg.encode_reference(torch.from_numpy(table), torch.from_numpy(pos),
                               tbg.BlockedGridMeta(**meta_kw)).numpy()
    ref = np.asarray(jbg.encode_reference(table, pos,
                                          jbg.BlockedGridMeta(**meta_kw)))
    assert got.shape == (pos.shape[0], L * 2)
    # same f32 arithmetic; only the order of the 2^D-term sums may differ
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_plain_encode_matches_pallas_kernel_interpret():
    """The port's plain encode against K1 itself (hashgrid_pallas
    _fwd_kernel) in interpret mode, with the multi-group meta of
    tests/test_pallas_interpret.py."""
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import (_level_groups,
                                                 blocked_grid_encode)
    kw = dict(n_dims=3, n_levels=6, base_resolution=16, per_level_scale=1.6,
              log2_rows=11)
    groups, _ = _level_groups(jbg.BlockedGridMeta(**kw))
    assert len(groups) >= 3
    rng = np.random.default_rng(3)
    table = (rng.standard_normal((6, 1 << 11, 128)) * 0.3).astype(np.float32)
    pos = rng.random((512, 3), dtype=np.float32)
    got = blocked_grid_cuda.blocked_grid_encode(
        torch.from_numpy(table), torch.from_numpy(pos),
        tbg.BlockedGridMeta(**kw)).numpy()
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(blocked_grid_encode(table, pos,
                                             jbg.BlockedGridMeta(**kw), 256))
    # K1 rounds the table to bf16 in its selection matmul; the port reads
    # f32 — the bf16 tolerance of tests/test_pallas_interpret.py
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=4e-3)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    kw = SMALL[0]
    meta = tbg.BlockedGridMeta(**kw)
    g = torch.Generator().manual_seed(0)
    table = meta.init_params(g)
    assert table.shape == (meta.n_levels, meta.rows, 128)
    assert float(table.abs().max()) <= 1e-4
    pos = torch.from_numpy(_positions(kw, n=256))
    before = dict(blocked_grid_cuda.launches)
    out = blocked_grid_cuda.blocked_grid_encode(table, pos, meta)
    assert blocked_grid_cuda.launches == before
    torch.testing.assert_close(out, tbg.encode_reference(table, pos, meta),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        blocked_grid_cuda.blocked_grid_encode(table, pos.to("meta"), meta)
