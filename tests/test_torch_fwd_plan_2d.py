"""The 2D encode forward's plan (``blocked_grid_cuda.fwd_plan_2d``, K1 and
K4 on 2D grids): which (sample, level) each lane of each block's warps
takes, and which bytes of the output each block stores, emulated in
numpy from the plan as the kernel reads it. The kernel runs only on the
card; ``test_torch_kernel_emulation.py`` runs its source on the host and
chip_smoke.py checks it there."""
from unittest import mock

import numpy as np
import pytest

from ngp_tpu_torch import config as tcfg
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
from test_torch_kernel_plan import SAMPLES

ROOT = bgc.CSRC.parent.parent
LEVELS = [1, 2, 6, 7, 12, 16, 24, 32]
# (samples a tile, the most levels a warp walks; 32: one thread a sample)
PLANS = [(32, 1), (64, 1), (32, 4), (128, 32), (256, 3)]


def _meta(n_levels: int) -> BlockedGridMeta:
    return BlockedGridMeta(2, n_levels, 16, 1.3, log2_rows=11)


def _plan(n: int, meta, samples: int, per_warp: int):
    """``fwd_plan_2d`` with tiles of ``samples`` and walks of at most
    ``per_warp`` levels."""
    with mock.patch.multiple(bgc, FWD_2D_SAMPLES=samples,
                             FWD_2D_LEVELS_PER_WARP=per_warp):
        return bgc.fwd_plan_2d(n, meta)


def _plans(n: int, n_levels: int):
    """Every plan of PLANS that the kernel takes at n_levels, with the
    walk it gives each warp."""
    meta = _meta(n_levels)
    for samples, per_warp in PLANS:
        walk = min(per_warp, n_levels)
        threads = samples // 32 * -(-n_levels // walk) * 32
        if (threads <= 1024 and bgc.fwd_2d_smem_bytes(samples, n_levels)
                <= bgc.FWD_2D_SMEM):
            yield _plan(n, meta, samples, per_warp), walk


@pytest.mark.parametrize("n", SAMPLES)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_fwd_plan_2d_covers_every_pair_once(n_levels, n):
    """Every (sample, level) with sample < n is one lane's, once; the lanes
    past n are those of the last tile only; each warp walks at most its
    share of the tile's columns, all of one 32-sample column range."""
    for plan, per_warp in _plans(n, n_levels):
        assert plan.blocks == -(-n // plan.samples)
        sample, level, warp = plan.pairs()
        busy = sample < n
        pairs = sample[busy] * n_levels + level[busy]
        assert np.array_equal(np.sort(pairs), np.arange(n * n_levels))
        assert not busy[:-1].size or busy[:-1].all()
        assert busy[-1].any()
        warps = plan.threads // 32
        cols = plan.samples // 32
        assert warps % cols == 0 and warps * per_warp >= cols * n_levels
        taken = np.bincount(warp[0, :, 0], minlength=warps)
        assert taken.max() <= per_warp and taken.min() >= 1
        # a warp walks one column: its lanes keep one position each
        for w in range(warps):
            first = sample[0][warp[0, :, 0] == w, 0]
            assert (first == first[0]).all()


@pytest.mark.parametrize("n", SAMPLES)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_fwd_plan_2d_stores_whole_lines_once(n_levels, n):
    """The stores cover the (N, L·2) f32 output exactly once; every
    16-byte store is 16-byte aligned; every tile but the last stores
    whole 128-byte lines, from a 256-byte boundary, and 4-byte stores
    appear only at the end of the output (an odd L at an odd tail)."""
    total = n * n_levels * 8
    for plan, _ in _plans(n, n_levels):
        block, offset, size = plan.stores()
        # sorted, each store starts where the one before ends: no gap and
        # no byte twice
        order = np.argsort(offset, kind="stable")
        o, s = offset[order], size[order]
        assert o[0] == 0 and o[-1] + s[-1] == total
        assert np.array_equal(o[1:], o[:-1] + s[:-1])
        assert (offset[size == 16] % 16 == 0).all()
        assert (offset[size == 4] >= total - 12).all()
        lo = np.full(plan.blocks, total)
        hi = np.zeros(plan.blocks, np.int64)
        np.minimum.at(lo, block, offset)
        np.maximum.at(hi, block, offset + size)
        assert np.array_equal(lo, np.arange(plan.blocks) * plan.samples
                              * n_levels * 8)
        assert (lo % 256 == 0).all() and hi[-1] == total
        assert (hi[:-1] % 128 == 0).all()


def test_fwd_plan_2d_rejects_what_the_kernel_does_not_take():
    meta = _meta(16)
    with pytest.raises(ValueError):
        bgc.fwd_plan_2d(100, BlockedGridMeta(3, 16, 16, 1.5, log2_rows=9))
    with pytest.raises(ValueError):
        bgc.fwd_plan_2d(100, _meta(33))
    for samples in (16, 48, 2048):
        with pytest.raises(ValueError):
            _plan(100, meta, samples, 4)
    with pytest.raises(ValueError):
        _plan(100, meta, 32, 0)
    with pytest.raises(ValueError):                   # 2048 threads
        _plan(100, _meta(32), 64, 1)
    with pytest.raises(ValueError):                   # 67.6 KB a tile
        _plan(100, _meta(32), 256, 32)
    assert bgc.fwd_2d_smem_bytes(256, 32) > bgc.FWD_2D_SMEM
    # a grid of fewer levels than the walk: every warp walks them all
    assert _plan(100, _meta(2), 32, 4).threads == 32


def test_fwd_plan_2d_on_the_image_grid():
    """On the image grid (configs/image/base.json at a 2048² image: 16
    levels, all dense) the default plans of K1 and K4 take tiles of 32
    samples, each of 4 warps walking 4 levels: 128 threads, 8192 blocks at
    2^18 samples, 4.2 KB of shared memory a tile; the launch wrappers pass
    the plan to the entry points as (blocks, threads, log2 samples)."""
    enc = tcfg.autofill_hashgrid_config(tcfg.load_network_config(
        ROOT / "configs/image/base.json")["encoding"], 2, 1024.0)
    meta = BlockedGridMeta.from_hashgrid_config(enc)
    assert meta.n_levels == 16 and all(meta.level_is_dense)
    plan = bgc.fwd_plan_2d(1 << 18, meta)
    assert (plan.samples, plan.threads, plan.blocks, plan.smem_bytes) \
        == (32, 128, 8192, 4224)
    assert plan.launch_args == (8192, 128, 5) and plan.steps == 4
