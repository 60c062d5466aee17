"""The 2D position backward (K3 on 2D grids) on ``fwd_plan_2d``'s plan,
emulated in numpy at f32 as the kernel runs a tile: the cotangent comes
into the tile's padded shared memory by 16-byte steps (zeros past sample
n - 1), each lane of each warp's walk reads its (sample, level) slot and
writes its level's dfrac·scale over it, and one thread per (sample,
component) adds the levels in level order and stores dpos. The kernel runs
only on the card; ``test_torch_kernel_emulation.py`` runs its source on
the host and chip_smoke.py checks it there."""
from unittest import mock

import numpy as np
import pytest
import torch

import ngp_tpu_torch.kernels.blocked_grid as tbg
from chip_smoke import KERNEL_POS_TOL
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from test_torch_blocked_grid import SMALL, SMALL_IDS
from test_torch_encode_grad import _inputs
from test_torch_fwd_plan_2d import LEVELS, _meta, _plans
from test_torch_kernel_plan import SAMPLES
from test_torch_pos_plan import _lane_values

SMALL_2D = [m for m in SMALL if m["n_dims"] == 2]
SMALL_2D_IDS = [i for m, i in zip(SMALL, SMALL_IDS) if m["n_dims"] == 2]


def plan_2d(n: int, meta, samples: int, walk: int):
    """``fwd_plan_2d`` with tiles of ``samples`` and walks of at most
    ``walk`` levels."""
    with mock.patch.multiple(bgc, FWD_2D_SAMPLES=samples,
                             FWD_2D_LEVELS_PER_WARP=walk):
        return bgc.fwd_plan_2d(n, meta)


def _slot(f):
    """Float f of a tile at f + f / 32 of its shared memory."""
    return f + f // 32


def emulate_k3_2d(plan, values, cot):
    """dpos (N, 2) as the 2D K3 forms it on ``plan`` from each (level,
    sample) lane's dfrac·scale ``values`` (L, N, 2) f32 and the cotangent
    ``cot`` (N, 2L), every block's shared memory starting NaN, dpos too.
    Asserts what the kernel relies on: every slot a lane or a sum reads was
    written before (no NaN), each (sample, level) is one lane's, each
    (sample, component) of dpos one thread's; a lane whose cotangent is
    zero writes 0. Returns dpos and the float of dpos each thread of each
    block stores, as (block · threads + thread, float index) arrays."""
    L, N, _ = values.shape
    width = 2 * L
    tile = plan.samples * width
    smem = np.full((plan.blocks, _slot(tile)), np.nan, np.float32)
    first = np.arange(plan.blocks) * plan.samples
    floats = np.minimum(plan.samples, N - first) * width
    # the cotangent in: thread t takes floats 4t, 4t + 4·threads, ...; each
    # of the tile's floats once, zeros past sample n - 1
    steps = np.arange(0, tile, 4 * plan.threads)
    k = (steps[:, None] + 4 * np.arange(plan.threads)).reshape(-1)
    k = (k[k < tile][:, None] + np.arange(4)).reshape(-1)
    assert np.array_equal(np.sort(k), np.arange(tile))
    flat = cot.reshape(-1)
    src = np.minimum(first[:, None] * width + k, flat.size - 1)
    smem[:, _slot(k)] = np.where(k < floats[:, None], flat[src], 0)
    # each lane's walk: its slot's cotangent, then its value over it
    sample, level, _ = plan.pairs()
    b = np.broadcast_to(np.arange(plan.blocks)[:, None, None], sample.shape)
    f = (sample - first[:, None, None]) * width + 2 * level
    seen = np.zeros((plan.blocks, plan.samples * L), np.int64)
    np.add.at(seen, (b, f // 2), 1)
    assert (seen == 1).all()
    live = sample < N
    sm = np.minimum(sample, N - 1)
    for c in range(2):
        got = smem[b, _slot(f + c)]
        assert not np.isnan(got).any()
        assert np.array_equal(got[live], cot[sm, 2 * level + c][live])
    nonzero = (smem[b, _slot(f)] != 0) | (smem[b, _slot(f + 1)] != 0)
    for c in range(2):
        v = np.where(nonzero & live, values[level, sm, c], np.float32(0))
        smem[b, _slot(f + c)] = v
    # the sums: level order from level 0, each (sample, component) once
    blk, thread, s, comp = plan.sums()
    dpos = np.full((N, 2), np.nan, np.float32)
    stored = np.zeros((N, 2), np.int64)
    fs = (s - first[blk]) * width + comp
    acc = smem[blk, _slot(fs)]
    for lv in range(1, L):
        acc = acc + smem[blk, _slot(fs + 2 * lv)]
    assert not np.isnan(acc).any() and acc.dtype == np.float32
    dpos[s, comp] = acc
    np.add.at(stored, (s, comp), 1)
    assert (stored == 1).all()
    return dpos, (blk * plan.threads + thread, 2 * s + comp)


def level_order_sum(values):
    """Each sample's ``values`` (L, N, 2) added in level order at f32,
    as the plain position backward adds its levels."""
    dpos = values[0]
    for v in values[1:]:
        dpos = dpos + v
    return dpos


@pytest.mark.parametrize("n", SAMPLES)
@pytest.mark.parametrize("n_levels", LEVELS)
def test_k3_2d_takes_every_pair_once(n_levels, n):
    """Under every plan of test_torch_fwd_plan_2d.PLANS that the kernel
    takes at n_levels: each (sample, level) is one lane's, reading the
    cotangent it was given (zeros past n), every slot read was written,
    each (sample, component) of dpos is one thread's, the sums equal the
    level-order sum of the lanes' values bit for bit, and each aligned 128
    bytes of dpos is stored by one warp."""
    rng = np.random.default_rng(n + n_levels)
    values = rng.standard_normal((n_levels, n, 2)).astype(np.float32)
    cot = rng.standard_normal((n, 2 * n_levels)).astype(np.float32)
    cot[::3] = 0.0
    # a lane whose cotangent is zero contributes 0
    values[:, ::3] = 0.0
    want = level_order_sum(values)
    for plan, _ in _plans(n, n_levels):
        dpos, (thread, index) = emulate_k3_2d(plan, values, cot)
        assert np.array_equal(dpos.view(np.int32), want.view(np.int32))
        order = np.argsort(index)
        warp, line = thread[order] // 32, index[order] // 32
        same_line = line[1:] == line[:-1]
        assert (warp[1:] == warp[:-1])[same_line].all()


@pytest.mark.parametrize("meta_kw", SMALL_2D, ids=SMALL_2D_IDS)
def test_k3_2d_level_order_sum_matches_the_plain_version(meta_kw):
    """The emulated kernel on the lanes' f32 dfrac·scale against the plain
    position backward under every plan of test_torch_fwd_plan_2d.PLANS
    that the kernel takes: within KERNEL_POS_TOL of each component's
    Σ|term|, exactly 0 where every term is, and the same bits under every
    plan."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = (torch.from_numpy(a)
                       for a in _inputs(meta_kw, seed=23))
    values = _lane_values(table, pos, cot, meta)
    ref = tbg.encode_position_backward_reference(table, pos, cot, meta
                                                 ).numpy()
    mag = tbg.encode_position_backward_reference(table, pos, cot, meta,
                                                 magnitude=True).numpy()
    assert (mag == 0).any() and (mag > 0).mean() > 0.5
    runs = [emulate_k3_2d(plan, values, cot.numpy())[0]
            for plan, _ in _plans(pos.shape[0], meta.n_levels)]
    assert len(runs) >= 3
    for dpos in runs:
        assert np.all(np.abs(dpos - ref) <= KERNEL_POS_TOL * mag)
        assert np.all(dpos[mag == 0] == 0)
        assert np.array_equal(dpos.view(np.int32), runs[0].view(np.int32))


def test_k3_2d_plan_is_the_encode_forwards():
    """The 2D K3 takes ``fwd_plan_2d``'s plan (its tile's cotangent fills
    the forward's output tile: the same shared memory): at 16 levels a
    tile of 32 samples, 4 warps each walking 4 levels, and the sums of a
    tile on threads 0-63; one thread a sample walks all 16."""
    meta = _meta(16)
    plan = bgc.fwd_plan_2d(100, meta)
    assert (plan.samples, plan.threads, plan.walk) == (32, 128, 4)
    blk, thread, s, comp = plan.sums()
    assert np.array_equal(np.bincount(blk), [64, 64, 64, 8])
    assert thread.max() == 63 and np.array_equal(2 * s + comp,
                                                 np.arange(200))
    assert plan_2d(100, meta, 128, 32).walk == 16
