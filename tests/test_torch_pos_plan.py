"""The launch plan of K3 (the encode's position backward) and its sum across
levels, emulated in numpy: each (sample, level) lane forms its level's
dfrac·scale; on 3D grids the lanes of a level group add theirs by xor
butterflies, and the groups' partial sums are added in group order; on 2D
grids the 2D K3 adds each sample's levels in level order
(``test_torch_pos_plan_2d.emulate_k3_2d``). The kernel runs only on the
card; chip_smoke.py holds it against the plain version there, and against
a second launch of itself."""
import numpy as np
import pytest
import torch

import ngp_tpu_torch.kernels.blocked_grid as tbg
from chip_smoke import KERNEL_POS_TOL
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from test_torch_blocked_grid import SMALL, SMALL_IDS
from test_torch_encode_grad import _inputs
from test_torch_kernel_plan import LEVELS, SAMPLES, _kernel_groups

K3 = "blocked_grid_encode_bwd_pos"
# the kernel's own group and every group the sweep builds it with
GROUPS = sorted({*bgc.SWEPT_GROUPS, _kernel_groups()[K3]})
# 16 levels, as the NeRF grid has: groups of 4, 8 and 16 all divide it
SIXTEEN = dict(n_dims=3, n_levels=16, base_resolution=16,
               per_level_scale=1.38, log2_rows=8, row_hash="prime")
METAS = SMALL + [SIXTEEN]
META_IDS = SMALL_IDS + ["3d-16-levels"]
# 2D grids take no level group (the 2D K3 runs on fwd_plan_2d's plan): each
# group's 2D case runs one of these plans (samples a tile, the most levels
# a warp walks) instead: the default, a warp a level of 64 samples, one
# thread a sample
PLANS_2D = dict(zip(GROUPS, [(32, 4), (64, 1), (128, 32)]))


@pytest.fixture(autouse=True)
def _no_jax_layout_knobs(monkeypatch):
    monkeypatch.delenv("NGP_TPU_BLOCKED_LOG2_ROWS", raising=False)
    monkeypatch.delenv("NGP_TPU_BLOCKED_HASH", raising=False)


@pytest.mark.parametrize("n_levels", LEVELS)
def test_k3_plan_covers_every_pair_once(n_levels):
    for group in GROUPS:
        for n in SAMPLES:
            plan = bgc.launch_plan(n, n_levels, group)
            assert plan.width == min(group, n_levels & -n_levels)
            sample, level = plan.pairs()
            busy = sample < n
            pairs = sample[busy] * n_levels + level[busy]
            assert np.array_equal(np.sort(pairs), np.arange(n * n_levels))
            # a group's lanes are one sample's, inside one warp: the
            # butterflies' partners (lane xor 1, 2, …, width / 2) too
            lanes = sample.reshape(plan.groups, -1, plan.width)
            assert (lanes == lanes[..., :1]).all() and 32 % plan.width == 0


@pytest.mark.parametrize("group", GROUPS)
def test_k3_stores_cover_every_partial_once(group):
    """Lane j of a group stores components j, j + width, … of its sample's
    sum into group k's partial (or dpos, for one group): every (group,
    sample, component) is stored by exactly one lane, and a warp's stores
    are contiguous."""
    for n_levels in LEVELS:
        for n in (1, 31, 1000):
            plan = bgc.launch_plan(n, n_levels, group)
            sample, level = plan.pairs()
            j = level % plan.width
            addr = (level // plan.width * n + sample) * 3
            mine = [(sample < n) & (j <= d) & ((d - j) % plan.width == 0)
                    for d in range(3)]
            stored = np.concatenate([(addr + d)[m]
                                     for d, m in enumerate(mine)])
            assert np.array_equal(np.sort(stored),
                                  np.arange(plan.groups * n * 3))
            warp = np.sort(np.concatenate([(addr[0, :32] + d)[m[0, :32]]
                                           for d, m in enumerate(mine)]))
            assert np.array_equal(warp, np.arange(warp.size))


def _lane_values(table, pos, cot, meta):
    """Each (level, sample) lane's dfrac · scale_l at f32, (L, N, D), its
    corners added in the kernel's order (c = 0 … 2^D − 1, each as ±gg·Π
    of the other dimensions' weights, gg = T[c, 0]·g0 + T[c, 1]·g1); a lane
    whose cotangent is zero holds zeros."""
    L, F, D = meta.n_levels, meta.n_features_per_level, meta.n_dims
    N = pos.shape[0]
    rows, local, frac = tbg.lookup_geometry(meta, pos)
    lanes, _ = tbg.corner_lanes_and_weights(meta, local, frac)
    idx = rows[:, :, None] * tbg.LANES + lanes                 # (L, N, C)
    flat = table.reshape(L, -1)
    g = cot.reshape(N, L, F).transpose(0, 1)                   # (L, N, F)
    corner = [torch.gather(flat, 1, (idx + f).reshape(L, -1)).view(idx.shape)
              for f in range(F)]
    dfrac = torch.zeros((L, N, D), dtype=torch.float32)
    for c in range(1 << D):
        gg = corner[0][..., c] * g[..., 0] + corner[1][..., c] * g[..., 1]
        for d in range(D):
            prod = torch.ones_like(gg)
            for dd in range(D):
                if dd != d:
                    prod = prod * (frac[..., dd] if (c >> dd) & 1
                                   else 1.0 - frac[..., dd])
            dfrac[..., d] += gg * prod if (c >> d) & 1 else -(gg * prod)
    dfrac[~(g != 0).any(-1)] = 0.0
    scales = torch.tensor(meta.level_scales, dtype=torch.float32)
    return (dfrac * scales[:, None, None]).numpy()


def _kernel_sum(values, width: int):
    """The kernel's sum of the lanes' ``values`` (L, N, D) f32: xor
    butterflies within each group of ``width`` levels, then the groups'
    partials in group order. Returns (every lane's value after the
    butterflies, (groups, width, N, D); dpos (N, D))."""
    L, N, D = values.shape
    lanes = values.reshape(L // width, width, N, D)
    m = 1
    while m < width:
        lanes = lanes + lanes[:, np.arange(width) ^ m]
        m <<= 1
    dpos = lanes[0, 0]
    for k in range(1, lanes.shape[0]):
        dpos = dpos + lanes[k, 0]
    return lanes, dpos


def _emulated(meta_kw, group, seed):
    """The kernel's dpos: in 3D with its lanes after the butterflies, in 2D
    (lanes None) on the plan PLANS_2D[group]."""
    meta = tbg.BlockedGridMeta(**meta_kw)
    table, pos, cot = (torch.from_numpy(a)
                       for a in _inputs(meta_kw, seed=seed))
    values = _lane_values(table, pos, cot, meta)
    if meta.n_dims == 2:
        # imported here: that module imports this one
        from test_torch_pos_plan_2d import emulate_k3_2d, plan_2d
        plan = plan_2d(pos.shape[0], meta, *PLANS_2D[group])
        dpos = emulate_k3_2d(plan, values, cot.numpy())[0]
        return meta, (table, pos, cot), None, dpos
    width = bgc.launch_plan(pos.shape[0], meta.n_levels, group).width
    lanes, dpos = _kernel_sum(values, width)
    assert lanes.dtype == np.float32 and dpos.dtype == np.float32
    return meta, (table, pos, cot), lanes, dpos


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_k3_summation_order_matches_the_plain_version(meta_kw, group):
    """The kernel's order of summation, at f32 (3D: butterflies in groups
    of ``group``, then the groups' partials; 2D: the level-order sum on the
    plan PLANS_2D[group]), against the plain position backward: each
    component within KERNEL_POS_TOL of its Σ|term|, and exactly 0 where
    every term is."""
    meta, args, _, dpos = _emulated(meta_kw, group, seed=21)
    ref = tbg.encode_position_backward_reference(*args, meta).numpy()
    mag = tbg.encode_position_backward_reference(*args, meta,
                                                 magnitude=True).numpy()
    assert np.all(np.abs(dpos - ref) <= KERNEL_POS_TOL * mag)
    assert np.all(dpos[mag == 0] == 0) and (mag == 0).any()
    assert (mag > 0).mean() > 0.5


@pytest.mark.parametrize("meta_kw", METAS, ids=META_IDS)
def test_k3_butterfly_gives_every_lane_of_a_group_the_same_bits(meta_kw):
    """After the butterflies every lane of a group holds its group's sum
    bit for bit (IEEE addition commutes), so which lane stores a
    component does not change it, and neither does a second launch. On 2D
    grids, with no butterflies, every plan of PLANS_2D gives the same
    bits."""
    runs = []
    for group in GROUPS:
        _, _, lanes, dpos = _emulated(meta_kw, group, seed=22)
        if lanes is None:
            runs.append(dpos.view(np.uint32))
            continue
        bits = lanes.view(np.uint32)
        assert (bits == bits[:, :1]).all()
    assert all(np.array_equal(r, runs[0]) for r in runs)
