"""The launch plans of K4 (int8-table forward) and K5 (int8 table backward),
and the indexing K4's line loads and K5's packed quanta rest on, emulated
in numpy. The kernels run only on the card; chip_smoke.py checks their
results there."""
import numpy as np
import pytest
import torch

import ngp_tpu_torch.kernels.blocked_grid as tbg
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from test_torch_kernel_plan import LEVELS, SAMPLES, _kernel_groups

I8_KERNELS = ("blocked_grid_encode_fwd_i8", "blocked_grid_encode_bwd_i8")
TILES = [32 << k for k in range(7)]          # 32 … 2048


def test_kernel_groups_are_ones_the_sweep_times():
    groups = _kernel_groups()
    assert set(groups) == set(bgc.GROUP_KERNELS)
    for name in bgc.GROUP_KERNELS:
        assert groups[name] in bgc.SWEPT_GROUPS, name


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("kernel", I8_KERNELS)
def test_i8_plans_cover_every_pair_once(kernel, n_levels):
    group = _kernel_groups()[kernel]
    for n in SAMPLES:
        plan = bgc.launch_plan(n, n_levels, group)
        assert plan.width == min(group, n_levels & -n_levels)
        sample, level = plan.pairs()
        busy = sample < n
        pairs = sample[busy] * n_levels + level[busy]
        assert np.array_equal(np.sort(pairs), np.arange(n * n_levels))


@pytest.mark.parametrize("tile", TILES)
def test_k5_warps_lie_inside_one_tile(tile):
    """Every warp of K5's plan, for every group the sweep times, holds
    samples of one tile only: the warp's maxima and quanta share a scale."""
    for group in sorted({*bgc.SWEPT_GROUPS, _kernel_groups()[I8_KERNELS[1]]}):
        for n_levels in (1, 2, 4, 12, 16, 32):
            n = 3 * tile + 17
            plan = bgc.launch_plan(n, n_levels, group)
            bgc.check_warps_in_tiles(plan, tile)
            sample, _ = plan.pairs()
            warps = sample.reshape(plan.groups, -1, 32)
            t = np.where(warps < n, warps // tile, -1)
            first = t[:, :, :1]
            assert ((t == first) | (t == -1)).all()


def test_check_warps_in_tiles_refuses_a_smaller_tile():
    plan = bgc.launch_plan(1000, 16, 1)             # 32 samples per warp
    with pytest.raises(ValueError):
        bgc.check_warps_in_tiles(plan, 16)


def _byte_perm(lo: int, hi: int, sel: int) -> int:
    """CUDA's __byte_perm(lo, hi, sel): result byte k is byte
    (sel >> 4k) & 7 of the 8 bytes hi:lo."""
    b = (lo | hi << 32).to_bytes(8, "little")
    return int.from_bytes(bytes(b[(sel >> 4 * k) & 7] for k in range(4)),
                          "little")


def test_k4_line_loads_pick_each_corner_byte():
    """K4 reads line (y + dy, z + dz) of the row as 8 aligned bytes at
    8·(y + dy + 4(z + dz)), or lines dy = 0, 1 as 16 aligned bytes where y
    is even, and takes corners x and x + 1 by one byte permute: for every
    local (x, y, z) ∈ {0, 1, 2}³, corner and feature, the byte the plain
    version's lane indexing names."""
    meta = tbg.BlockedGridMeta(n_dims=3, n_levels=1, base_resolution=16,
                               per_level_scale=2.0)
    row = np.arange(tbg.LANES, dtype=np.uint8).tobytes()   # byte k holds k
    local = torch.tensor([[(x, y, z) for z in range(3) for y in range(3)
                           for x in range(3)]])            # (1, 27, 3)
    lanes, _ = tbg.corner_lanes_and_weights(meta, local,
                                            torch.zeros(local.shape))
    for (x, y, z), corner_lanes in zip(local[0].tolist(), lanes[0].tolist()):
        base_lane = 2 * (x + 4 * y + 16 * z)
        line0 = base_lane & ~7
        assert line0 % 8 == 0 and line0 == 8 * (y + 4 * z)
        sel = 0x3210 + 0x2222 * ((base_lane & 7) >> 1)
        if (base_lane & 8) == 0:                # y even
            assert line0 % 16 == 0
            pairs = [row[line0 + 32 * dz: line0 + 32 * dz + 16]
                     for dz in range(2)]
            lines = [p[8 * dy: 8 * dy + 8] for p in pairs for dy in range(2)]
        else:
            lines = [row[line0 + 8 * ((k & 1) + 4 * (k >> 1)):][:8]
                     for k in range(4)]
        for c in range(8):
            word = _byte_perm(int.from_bytes(lines[c >> 1][:4], "little"),
                              int.from_bytes(lines[c >> 1][4:], "little"),
                              sel)
            for f in range(2):
                got = (word >> 8 * (2 * (c & 1) + f)) & 0xFF
                assert got == corner_lanes[c] + f, (x, y, z, c, f)


def test_k4_line_loads_pick_each_corner_byte_2d():
    """The 2D K4 reads line y + dy of the row as 16 aligned bytes at
    16·(y + dy), picks word x / 2 (and x / 2 + 1 for odd x) by selects and
    takes corners x and x + 1 by one byte permute (0x3210 for even x,
    0x5432 for odd): for every local (x, y) ∈ {0, …, 6}², corner and
    feature, the byte the plain version's lane indexing names."""
    meta = tbg.BlockedGridMeta(n_dims=2, n_levels=1, base_resolution=16,
                               per_level_scale=2.0)
    row = np.arange(tbg.LANES, dtype=np.uint8).tobytes()   # byte k holds k
    local = torch.tensor([[(x, y) for y in range(7) for x in range(7)]])
    lanes, _ = tbg.corner_lanes_and_weights(meta, local,
                                            torch.zeros(local.shape))
    for (x, y), corner_lanes in zip(local[0].tolist(), lanes[0].tolist()):
        base_lane = 2 * (x + 8 * y)
        line0 = base_lane & ~15
        assert line0 == 16 * y
        xx, w = (base_lane & 15) >> 1, ((base_lane & 15) >> 1) >> 1
        assert xx == x
        sel = 0x5432 if x & 1 else 0x3210
        for c in range(4):
            line = row[line0 + 16 * (c >> 1): line0 + 16 * (c >> 1) + 16]
            words = [int.from_bytes(line[4 * k: 4 * k + 4], "little")
                     for k in range(4)]
            lo, hi = words[w], words[min(w + 1, 3)]
            word = _byte_perm(lo, hi, sel)
            for f in range(2):
                got = (word >> 8 * (2 * (c & 1) + f)) & 0xFF
                assert got == corner_lanes[c] + f, (x, y, c, f)


def _sbyte(x: np.ndarray, k: int) -> np.ndarray:
    """The kernels' sbyte: byte k of a uint32 as a signed value, by
    ``(int)(x << (24 - 8k)) >> 24``."""
    return ((x << np.uint32(24 - 8 * k)).astype(np.uint32).view(np.int32)
            >> 24)


def test_k5_packed_quanta_unpack_to_the_quanta():
    """K5 packs the quanta (q0, q1) of corners 2k and 2k + 1 into the 4
    bytes of one word for its shuffles; unpacked they give every pair in
    [-127, 127]² back, for both corners of the word."""
    q = np.arange(-127, 128, dtype=np.int64)
    q0, q1 = (a.reshape(-1) for a in np.meshgrid(q, q))
    b = ((q0 & 0xFF) | (q1 & 0xFF) << 8).astype(np.uint32)
    for odd in (0, 1):
        word = (b << np.uint32(16 * odd)).astype(np.uint32)
        assert np.array_equal(_sbyte(word, 2 * odd), q0)
        assert np.array_equal(_sbyte(word, 2 * odd + 1), q1)
