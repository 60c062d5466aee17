"""Parity of the plain versions of K3 (the encode's position gradient) and
K5 (the ``full`` int8 mode's table gradient) with the JAX package, on 3D
and 2D grids: K3's against JAX autodiff and the Pallas
``_bwd_frac_kernel`` in interpret mode, K5's against the Pallas
``_bwd_table_kernel_i8`` in interpret mode, and the sample tile. The CUDA
kernels run only on the card; chip_smoke.py holds them against these plain
versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.kernels.blocked_grid as jbg
import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu_torch.kernels import blocked_grid_cuda
from test_torch_blocked_grid import (SMALL, SMALL_IDS, _positions,
                                     pallas_calls_in_turn)
from test_torch_encode_grad import MULTIGROUP, MULTIGROUP_2D, _inputs

METAS = SMALL + [MULTIGROUP, MULTIGROUP_2D]
META_IDS = SMALL_IDS + ["3d-multigroup", "2d-multigroup"]


@pytest.fixture(autouse=True)
def _no_jax_layout_knobs(monkeypatch):
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _plain_pos_grad(table, pos, cot, meta_kw):
    meta = tbg.BlockedGridMeta(**meta_kw)
    got = tbg.encode_position_backward_reference(*_t(table, pos, cot), meta)
    mag = tbg.encode_position_backward_reference(*_t(table, pos, cot), meta,
                                                 magnitude=True)
    return got.numpy(), mag.numpy()


@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_position_backward_reference_matches_jax_autodiff(meta_kw):
    """The plain K3 against jax.grad wrt the positions of the JAX
    ``encode_reference``, on positions that include every level's lattice
    vertices: each component to 1e-5 of the sum of its terms' magnitudes
    (the terms cancel, so a relative tolerance on the sum itself would
    measure the cancellation, not the method)."""
    table, pos, cot = _inputs(meta_kw, seed=11)
    got, mag = _plain_pos_grad(table, pos, cot, meta_kw)
    jm = jbg.BlockedGridMeta(**meta_kw)
    ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jbg.encode_reference(table, p, jm) * cot))(pos))
    assert got.shape == pos.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - ref) <= 1e-5 * mag)
    assert np.abs(ref).max() > 0 and (mag > 0).mean() > 0.5
    # the samples of rays without a loss get exactly zero
    assert np.all(got[::7] == 0)


def _check_pos_grad_against_pallas(meta_kw, seed):
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import blocked_grid_encode
    table, pos, cot = _inputs(meta_kw, seed=seed, n=512)
    got, mag = _plain_pos_grad(table, pos, cot, meta_kw)
    jm = jbg.BlockedGridMeta(**meta_kw)
    with pltpu.force_tpu_interpret_mode(), pallas_calls_in_turn():
        ref = np.asarray(jax.grad(lambda p: jnp.sum(
            blocked_grid_encode(table, p, jm, 256) * cot))(pos))
    assert np.all(np.abs(got - ref) <= 2.0 ** -8 * mag)
    assert np.abs(got - ref).max() > 0      # the bf16 rounding shows


def test_position_backward_reference_matches_pallas_interpret():
    """Against K3 itself (hashgrid_pallas ``_bwd_frac_kernel`` and its
    einsum over levels), which rounds the table to bf16: that moves each
    term by at most 2^-9 of itself, so each component is held to 2^-8 of
    the sum of its terms' magnitudes."""
    _check_pos_grad_against_pallas(MULTIGROUP, 12)


def test_position_backward_reference_matches_pallas_interpret_2d():
    """The 2D K3's plain version (the neural image's uv gradient) against
    the Pallas K3 on a 2D grid, with the 3D test's tolerance (2^-8 of
    Σ|term|)."""
    assert len({r for r, _ in _pallas_level_groups(MULTIGROUP_2D)}) > 1
    _check_pos_grad_against_pallas(MULTIGROUP_2D, 22)


def _pallas_level_groups(meta_kw):
    from ngp_tpu.kernels.hashgrid_pallas import _level_groups
    return _level_groups(jbg.BlockedGridMeta(**meta_kw))[0]


@pytest.mark.parametrize("n", [1, 511, 512, 513, 1024, 1025, 2047, 2048,
                               2049, 5000, 1 << 18, (1 << 18) + 1])
def test_eff_tile_matches_jax(n):
    from ngp_tpu.kernels.hashgrid_pallas import DEFAULT_TILE, _eff_tile
    assert tbg.DEFAULT_TILE == DEFAULT_TILE
    for tile in (256, 512, DEFAULT_TILE):
        assert tbg.eff_tile(n, tile) == _eff_tile(n, tile)
    assert tbg.eff_tile(n) == _eff_tile(n, DEFAULT_TILE)


def _tile_quanta(pos, cot, meta, tile):
    """Per table entry: the sum over the tiles it is touched in of the
    tile's scale × the number of samples adding to it there (one quantum
    per contributing sample)."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    idx, w = tbg._corner_index(meta, pos)
    g = cot.reshape(N, L, F).transpose(0, 1)
    wg = w[..., None] * g[:, :, None, :]                    # (L, N, C, F)
    ent = idx[..., None] + torch.arange(F)
    out = torch.zeros(L, meta.rows * tbg.LANES, dtype=torch.float64)
    for l in range(L):
        for t0 in range(0, N, tile):
            v = wg[l, t0:t0 + tile]
            scale = float(torch.clamp(v.abs().max(), min=1e-20)) / 127.0
            out[l].index_add_(0, ent[l, t0:t0 + tile][v != 0],
                              torch.full((int((v != 0).sum()),), scale,
                                         dtype=torch.float64))
    return out.view(L, meta.rows, tbg.LANES).numpy()


def _check_int8_backward_against_pallas(meta_kw, seed):
    from jax.experimental.pallas import tpu as pltpu
    from ngp_tpu.kernels.hashgrid_pallas import (_eff_tile,
                                                 blocked_grid_encode_int8)
    n, tile = 1000, 512
    table, pos, cot = _inputs(meta_kw, seed=seed, n=n)
    assert _eff_tile(pos.shape[0], tile) == tile
    assert 2 * tile < pos.shape[0] < 3 * tile
    meta = tbg.BlockedGridMeta(**meta_kw)
    tp, tc = _t(pos, cot)
    got = tbg.encode_backward_reference_i8(tp, tc, meta, tile).numpy()
    mag = tbg.encode_backward_reference_i8(tp, tc, meta, tile,
                                           magnitude=True).numpy()
    jm = jbg.BlockedGridMeta(**meta_kw)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.grad(lambda t: jnp.sum(
            blocked_grid_encode_int8(t, pos, jm, tile) * cot))(table))
    assert got.shape == ref.shape
    quanta = _tile_quanta(tp, tc, meta, tile)
    diff = np.abs(got - ref)
    assert np.all(diff <= quanta * (1 + 1e-6))
    assert (diff > 1e-6 * mag).mean() <= 1e-3
    assert np.all(got[mag == 0] == 0) and np.all(ref[mag == 0] == 0)
    assert (mag > 0).mean() > 0.05


def test_int8_backward_reference_matches_pallas_interpret():
    """The plain K5 against jax.grad wrt the table of
    ``blocked_grid_encode_int8`` (hashgrid_pallas ``_bwd_table_kernel_i8``)
    in interpret mode, over three tiles of 512 samples, the last one
    partial. Under jit XLA multiplies by the f32 reciprocal of 127 where
    the port divides, so a tile's scale can differ by an ulp, which moves
    its entries by f32 rounding and can move a product across a rounding
    tie: each entry within one quantum per contributing sample, at most
    0.1 % of entries differing by more than f32 rounding (1e-6 of
    Σ_t scale_t·Σ|q|), and exact zeros where no quantum is nonzero."""
    _check_int8_backward_against_pallas(MULTIGROUP, 13)


def test_int8_backward_reference_matches_pallas_interpret_2d():
    """The 2D K5's plain version against the Pallas K5 on a 2D grid, with
    the 3D test's tolerances (one quantum per contributing sample)."""
    _check_int8_backward_against_pallas(MULTIGROUP_2D, 23)


def test_int8_wrapper_on_cpu_runs_plain_versions_without_launch():
    """``blocked_grid_encode_int8`` on CPU tensors: the int8 forward, the
    plain K5 table gradient in tiles of ``eff_tile(N)`` (or the tile it is
    given), the plain K3 position gradient from the f32 table, and no
    kernel launched."""
    _check_int8_wrapper_on_cpu(SMALL[0])


def test_int8_wrapper_on_cpu_runs_plain_versions_without_launch_2d():
    """The same on a 2D grid: the plain 2D K4, K5 and K3, no launch."""
    _check_int8_wrapper_on_cpu(MULTIGROUP_2D)


def _check_int8_wrapper_on_cpu(meta_kw):
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = _t(*_inputs(meta_kw, 14, 1500))
    before = dict(blocked_grid_cuda.launches)
    for tile in (None, 512):
        t = table.clone().requires_grad_()
        p = pos.clone().requires_grad_()
        out = blocked_grid_cuda.blocked_grid_encode_int8(t, p, meta, tile)
        tq, qs = tbg.quantize_table_i8(table)
        torch.testing.assert_close(
            out, tbg.encode_reference_i8(tq, qs, pos, meta), rtol=0, atol=0)
        d_table, d_pos = torch.autograd.grad((out * cot).sum(), (t, p))
        eff = tile or tbg.eff_tile(pos.shape[0])
        torch.testing.assert_close(
            d_table, tbg.encode_backward_reference_i8(pos, cot, meta, eff),
            rtol=0, atol=0)
        torch.testing.assert_close(
            d_pos, tbg.encode_position_backward_reference(table, pos, cot,
                                                          meta),
            rtol=0, atol=0)
    assert tbg.eff_tile(pos.shape[0]) == 2048
    assert blocked_grid_cuda.launches == before
    with pytest.raises(ValueError, match="int8 mode"):
        blocked_grid_cuda.encode_mode(table, pos, meta, "half")
