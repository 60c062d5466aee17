"""The launch plan of K1 and K2 (``blocked_grid_cuda.launch_plan``): which
(sample, level) pair each thread takes, and the per-level parameters the
kernels are handed, against the JAX package's meta. The kernels run only
on the card; chip_smoke.py checks their results there."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import ngp_tpu.kernels.blocked_grid as jbg
import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu.config import autofill_hashgrid_config, load_network_config
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from test_torch_blocked_grid import SMALL

LEVELS = [1, 2, 4, 8, 12, 16, 24, 32]
SAMPLES = [1, 31, 32, 1000, 65539]


def _kernel_groups():
    """kGroupFwd and kGroupBwd as the CUDA source sets them."""
    src = (bgc.CSRC / "blocked_grid_encode.cu").read_text()
    return [int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kGroupFwd", "kGroupBwd")]


# the kernels' own groups and every group the sweep of PERF.md timed
GROUPS = sorted({4, 8, 16, *_kernel_groups()})


@pytest.fixture(autouse=True)
def _no_jax_layout_knobs(monkeypatch):
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)


@pytest.mark.parametrize("n", SAMPLES)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_plan_covers_every_pair_once(n_levels, n):
    for group in GROUPS:
        plan = bgc.launch_plan(n, n_levels, group)
        assert plan.groups * plan.width == n_levels
        assert plan.width <= group and n_levels % plan.width == 0
        sample, level = plan.pairs()
        busy = sample < n
        pairs = sample[busy] * n_levels + level[busy]
        assert pairs.size == n * n_levels
        assert np.array_equal(np.sort(pairs), np.arange(n * n_levels))
        # idle threads only after the last sample, fewer than a block
        assert not busy[:, -1].any() or plan.blocks * plan.threads \
            == n * plan.width
        assert (plan.blocks - 1) * plan.threads < n * plan.width


@pytest.mark.parametrize("n", SAMPLES)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_plan_groups_store_contiguous_aligned_bytes(n_levels, n):
    """Each sample's group is taken by ``width`` neighbouring threads of one
    warp, whose float2 outputs are 8·width contiguous bytes aligned to
    8·width: whole 32-byte sectors from a width of 4 on."""
    for group in GROUPS:
        plan = bgc.launch_plan(n, n_levels, group)
        w = plan.width
        assert 32 % w == 0                 # a group never spans two warps
        if n_levels % group == 0:
            assert w == group
        sample, level = plan.pairs()
        byte = (sample * n_levels + level) * 8         # float2 offsets
        for k in range(plan.groups):
            chunks_s = sample[k].reshape(-1, w)
            chunks_b = byte[k].reshape(-1, w)
            chunks_s, chunks_b = chunks_s[chunks_s[:, 0] < n], \
                chunks_b[chunks_s[:, 0] < n]
            assert (chunks_s == chunks_s[:, :1]).all()
            assert (chunks_b == chunks_b[:, :1] + 8 * np.arange(w)).all()
            assert (chunks_b[:, 0] % (8 * w) == 0).all()
            if w >= 4:
                assert (chunks_b[:, 0] % 32 == 0).all()


def test_plan_rejects_what_the_kernels_do_not_take():
    for group in (0, 3, 12, 64):
        with pytest.raises(ValueError):
            bgc.launch_plan(10, 16, group)
    for threads in (16, 100, 2048):
        with pytest.raises(ValueError):
            bgc.launch_plan(10, 16, 4, threads)


def _base_meta_kw(aabb_scale):
    enc = autofill_hashgrid_config(
        load_network_config("configs/nerf/base.json")["encoding"], 3, 2048.0,
        aabb_scale=aabb_scale)
    return dict(n_dims=3, n_levels=enc["n_levels"],
                base_resolution=enc["base_resolution"],
                per_level_scale=enc["per_level_scale"],
                log2_rows=tbg.BlockedGridMeta.from_hashgrid_config(
                    enc).log2_rows)


METAS = [_base_meta_kw(a) for a in (1, 4, 16)] + [
    m for m in SMALL if m["n_dims"] == 3]


@pytest.mark.parametrize("meta_kw", METAS,
                         ids=[f"L{m['n_levels']}-b{m['base_resolution']}-"
                              f"s{m['per_level_scale']:.4g}" for m in METAS])
def test_level_arrays_match_the_jax_meta(meta_kw):
    scales, blocks, dense = bgc.level_arrays(tbg.BlockedGridMeta(**meta_kw))
    jm = jbg.BlockedGridMeta(**meta_kw)
    # bit-equal to the f32 scales JAX's lookup geometry multiplies by
    j_scales = np.asarray(jnp.asarray(jm.level_scales, jnp.float32))
    assert scales.dtype == np.float32
    assert np.array_equal(scales.view(np.uint32), j_scales.view(np.uint32))
    assert blocks.dtype == np.int32
    assert blocks.tolist() == list(jm.level_blocks_per_dim)
    assert dense.dtype == np.uint8
    assert dense.astype(bool).tolist() == list(jm.level_is_dense)
    # each meta mixes dense and hashed levels, as the kernels' warps do
    assert 0 < dense.sum() < len(dense)
