"""The blocked multiresolution grid's geometry, frozen for the benchmark.

Copied from ``ngp_tpu_torch/kernels/blocked_grid.py`` (``BlockedGridMeta``,
``lookup_geometry``, ``corner_lanes_and_weights``) and
``ngp_tpu_torch/config.py`` (``autofill_hashgrid_config``), so that the
plain reference and the kernels' byte counts keep their meaning whatever
a later change does to the program. Also frozen here, from
``chip_smoke.py``: ``flops_per_lookup`` and the touched-entry count behind
``kernel_bytes``, with one change: a table gradient is counted as the
entries its corners touch, not as the dense table, so that a kernel that
skips untouched rows is not held to bytes it never needs to move.
"""
from __future__ import annotations

import dataclasses
import math

import torch

LANES = 128
HASH_PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF

# published H100 SXM peaks (NVIDIA's data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def block_geom(n_dims: int) -> tuple[int, int]:
    """(vertices per side, stride in cells) of a 128-lane block."""
    return {3: (4, 3), 2: (8, 7)}[n_dims]


@dataclasses.dataclass(frozen=True)
class GridMeta:
    n_dims: int
    n_levels: int
    base_resolution: int
    per_level_scale: float
    log2_rows: int
    n_features: int = 2

    @property
    def level_scales(self):
        return tuple(math.exp2(l * math.log2(self.per_level_scale))
                     * self.base_resolution - 1.0
                     for l in range(self.n_levels))

    @property
    def blocks_per_dim(self):
        _, stride = block_geom(self.n_dims)
        return tuple((int(math.ceil(s)) + 1 + stride - 1) // stride
                     for s in self.level_scales)

    @property
    def rows(self) -> int:
        return 1 << self.log2_rows

    @property
    def is_dense(self):
        return tuple(b ** self.n_dims <= self.rows
                     for b in self.blocks_per_dim)

    @property
    def n_params(self) -> int:
        return self.n_levels * self.rows * LANES


def grid_meta(encoding: dict, n_dims: int,
              desired_resolution: float) -> GridMeta:
    """The blocked grid a HashGrid config maps to: the reference's
    auto-fill of base resolution and per-level scale, and rows =
    2^log2_hashmap_size · F / 128, never more than the finest level can
    address."""
    F = int(encoding.get("n_features_per_level", 2))
    L = int(encoding.get("n_levels", 16))
    log2_T = int(encoding.get("log2_hashmap_size", 15))
    base = int(encoding.get("base_resolution", 0)) or (1 << (log2_T // n_dims))
    scale = float(encoding.get("per_level_scale", 0.0))
    if scale <= 0.0 and L > 1:
        scale = math.exp(math.log(desired_resolution / base) / (L - 1))
    log2_rows = max(6, log2_T + int(math.log2(F)) - 7)
    probe = GridMeta(n_dims, L, base, scale, log2_rows, F)
    max_blocks = max(b ** n_dims for b in probe.blocks_per_dim)
    need = max(6, math.ceil(math.log2(max(max_blocks, 1))))
    return dataclasses.replace(probe, log2_rows=min(log2_rows, need))


def corner_index(meta: GridMeta, pos: torch.Tensor):
    """Flat (row·128 + feature-0 lane) index (L, N, C) of each position's
    2^D corners within its level, and their interpolation weights."""
    D, L = meta.n_dims, meta.n_levels
    side, stride = block_geom(D)
    dev = pos.device
    scales = torch.tensor(meta.level_scales, dtype=torch.float32, device=dev)
    x = pos.T[None] * scales[:, None, None] + 0.5            # (L, D, N)
    x0f = torch.floor(x)
    frac = (x - x0f).movedim(1, -1)                          # (L, N, D)
    base = x0f.to(torch.int64)
    block = torch.div(base, stride, rounding_mode="floor")
    local = (base - block * stride).movedim(1, -1)           # (L, N, D)
    nblk = torch.tensor(meta.blocks_per_dim, dtype=torch.int64,
                        device=dev)[:, None, None]
    block = torch.minimum(torch.clamp(block, min=0), nblk - 1)
    bstr = torch.tensor([[b ** d for d in range(D)]
                         for b in meta.blocks_per_dim], dtype=torch.int64,
                        device=dev)
    dense_row = torch.sum(block * bstr[:, :, None], dim=1)    # (L, N)
    bu = block.movedim(1, -1) & U32
    h = (bu[..., 0] * HASH_PRIMES[0]) & U32
    for d in range(1, D):
        h = h ^ ((bu[..., d] * HASH_PRIMES[d]) & U32)
    is_dense = torch.tensor(meta.is_dense, device=dev)[:, None]
    rows = torch.where(is_dense, dense_row, h & (meta.rows - 1))
    C = 1 << D
    cor = torch.tensor([[(c >> d) & 1 for d in range(D)] for c in range(C)],
                       dtype=torch.int64, device=dev)        # (C, D)
    v = local[:, :, None, :] + cor[None, None]
    lane_str = torch.tensor([side ** d for d in range(D)], dtype=torch.int64,
                            device=dev)
    lanes = torch.sum(v * lane_str, -1) * meta.n_features
    w = torch.where(cor[None, None] > 0, frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])
    weights = w[..., 0]
    for d in range(1, D):
        weights = weights * w[..., d]
    return rows[:, :, None] * LANES + lanes, weights


def touched_entries(meta: GridMeta, pos: torch.Tensor,
                    chunk: int = 1 << 18) -> int:
    """Table entries (level, row, lane), both features, that the corners
    of ``pos`` read: what a forward must fetch and a table gradient must
    write at least."""
    touched = torch.zeros(meta.n_levels * meta.rows * LANES,
                          dtype=torch.bool, device=pos.device)
    base = torch.arange(meta.n_levels, device=pos.device)[:, None, None] \
        * (meta.rows * LANES)
    for c in pos.split(chunk):
        idx, _ = corner_index(meta, c)
        for f in range(meta.n_features):
            touched[(idx + base + f).reshape(-1)] = True
    return int(touched.sum())


# operations per corner of each encode kernel (chip_smoke.FLOPS_PER_CORNER)
FLOPS_PER_CORNER = {"fwd": 4, "bwd": 2, "bwd_pos": 12.75, "fwd_i8": 6,
                    "bwd_i8": 10.25}


def flops_per_lookup(kind: str, n_dims: int) -> float:
    """Operations per (sample, level) of an encode kernel: the geometry
    (3 per dimension), the 2^D corner weights (D - 1 products each, and D
    complements), and the corner arithmetic."""
    corners = 1 << n_dims
    return (3 * n_dims + corners * (n_dims - 1) + n_dims
            + corners * FLOPS_PER_CORNER[kind])


def encode_bytes(kind: str, meta: GridMeta, pos: torch.Tensor) -> int:
    """Bytes an encode call of ``kind`` must move on ``pos`` (N, D): the
    positions, the features out or the cotangent in, and the touched table
    entries read (forward; one byte each for the int8 table, with its level
    scales) or written (table gradient); the position gradient also writes
    dpos."""
    n, L, D = pos.shape[0], meta.n_levels, meta.n_dims
    moved = 4 * D * n + 4 * meta.n_features * L * n
    touched = touched_entries(meta, pos)
    if kind == "fwd_i8":
        return moved + 4 * L + touched
    dpos = 4 * D * n if kind == "bwd_pos" else 0
    return moved + 4 * touched + dpos


def encode_least_s(kind: str, meta: GridMeta, pos: torch.Tensor) -> float:
    """The least time of an encode call: the larger of its bytes at the HBM
    rate and its operations at the f32 rate."""
    t_bytes = encode_bytes(kind, meta, pos) / HBM_BYTES_PER_S
    t_ops = (flops_per_lookup(kind, meta.n_dims) * pos.shape[0]
             * meta.n_levels / F32_FLOPS)
    return max(t_bytes, t_ops)
