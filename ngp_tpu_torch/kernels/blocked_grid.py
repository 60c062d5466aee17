"""Blocked multiresolution grid: layout math and the plain PyTorch encode
(port of ``ngp_tpu/kernels/blocked_grid.py``).

Each level's table is ``rows`` rows of 128 lanes; one row holds an
overlapping block of 4×4×4 vertices × 2 features (stride 3 cells; 2D:
8×8 vertices, stride 7), so every sample's 2^D interpolation corners lie
in exactly one row. Coarse ("dense") levels index a raster over blocks;
fine levels hash the block coordinate (instant-ngp primes) into the
power-of-two row count. The ``(L, R, 128)`` table layout is the JAX
package's, so its parameters load unchanged.

``encode_reference``, ``encode_backward_reference``,
``encode_position_backward_reference``, ``encode_reference_i8`` (with
``quantize_table_i8``) and ``encode_backward_reference_i8`` are the plain
versions of the CUDA kernels K1, K2, K3, K4 and K5 wrapped in
``blocked_grid_cuda.py``: the CPU path, and the oracles the kernels are
checked against on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

LANES = 128

# instant-ngp spatial-hash primes (paper eq. 4; identity along x)
_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _block_geom(n_dims: int) -> tuple[int, int]:
    """(vertices per side, stride in cells) for a 128-lane block."""
    if n_dims == 3:
        return 4, 3   # 4^3 * 2 = 128
    if n_dims == 2:
        return 8, 7   # 8^2 * 2 = 128
    raise ValueError("blocked grid supports 2D and 3D")


def _part_bits(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Interleave zeros between bits. ``x`` is int64 holding uint32 values
    (torch has little uint32 arithmetic on the CPU); the masks keep every
    intermediate inside 32 bits."""
    if n_dims == 2:
        x = x & 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        return (x | (x << 1)) & 0x55555555
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_nd(coords: torch.Tensor, n_dims: int) -> torch.Tensor:
    """coords (..., D) int → Morton code (uint32 values in int64)."""
    c = coords.to(torch.int64) & _U32
    out = _part_bits(c[..., 0], n_dims)
    for d in range(1, n_dims):
        out = out | (_part_bits(c[..., d], n_dims) << d)
    return out & _U32


@dataclasses.dataclass(frozen=True)
class BlockedGridMeta:
    """Static config of the blocked multiresolution grid."""

    n_dims: int
    n_levels: int
    base_resolution: int
    per_level_scale: float
    log2_rows: int = 11              # rows per level: uniform (L, R, 128) table
    n_features_per_level: int = 2    # fixed: 2 (packed into the 128 lanes)
    row_hash: str = "prime"          # "prime" (tcnn-like) | "morton" (legacy)

    @functools.cached_property
    def level_scales(self) -> Tuple[float, ...]:
        # Python doubles; cast to f32 only where positions are scaled
        return tuple(
            math.exp2(l * math.log2(self.per_level_scale)) * self.base_resolution - 1.0
            for l in range(self.n_levels))

    @functools.cached_property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @functools.cached_property
    def level_blocks_per_dim(self) -> Tuple[int, ...]:
        _, stride = _block_geom(self.n_dims)
        return tuple((res + stride - 1) // stride for res in self.level_resolutions)

    @property
    def rows(self) -> int:
        return 1 << self.log2_rows

    @functools.cached_property
    def level_is_dense(self) -> Tuple[bool, ...]:
        """Dense = every block gets its own row (no hashing)."""
        return tuple(b ** self.n_dims <= self.rows
                     for b in self.level_blocks_per_dim)

    @functools.cached_property
    def level_needed_rows(self) -> Tuple[int, ...]:
        """Rows a level can address, per level: a dense level its blocks^D
        raster rows rounded up to a power of two (min 8), a hashed level
        the whole table (``ngp_tpu/kernels/blocked_grid.py``
        ``level_needed_rows``, where the Pallas kernels group levels by
        it). The 2D table backward's plan reads it to decide where each
        level's gradient is summed (``blocked_grid_cuda.
        table_bwd_plan_2d``); the stored table stays (L, rows, 128)."""
        out = []
        for l in range(self.n_levels):
            if self.level_is_dense[l]:
                need = 1 << max(
                    3, int(math.ceil(math.log2(
                        max(self.level_blocks_per_dim[l] ** self.n_dims,
                            1)))))
                out.append(min(need, self.rows))
            else:
                out.append(self.rows)
        return tuple(out)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_params(self) -> int:
        return self.n_levels * self.rows * LANES

    @classmethod
    def from_hashgrid_config(cls, enc: dict) -> "BlockedGridMeta":
        """Map a tcnn HashGrid config onto the blocked grid with matched
        parameter budget: rows = 2^log2_hashmap_size · F / 128. A
        ``log2_rows``/``row_hash`` stamped into a snapshot's config wins:
        a stored table decodes only with the geometry it was trained
        under."""
        n_dims = int(enc["n_pos_dims"])
        F = int(enc.get("n_features_per_level", 2))
        log2_T = int(enc.get("log2_hashmap_size", 19))
        log2_rows = int(enc.get("log2_rows",
                                max(6, log2_T + int(math.log2(F)) - 7)))
        probe = cls(n_dims=n_dims,
                    n_levels=int(enc.get("n_levels", 16)),
                    base_resolution=int(enc.get("base_resolution", 16)),
                    per_level_scale=float(enc.get("per_level_scale", 2.0)),
                    log2_rows=log2_rows, n_features_per_level=F,
                    row_hash=enc.get("row_hash", "prime"))
        # never allocate more rows than the finest level can address
        max_blocks = max(b ** n_dims for b in probe.level_blocks_per_dim)
        log2_needed = max(6, math.ceil(math.log2(max(max_blocks, 1))))
        return dataclasses.replace(probe,
                                   log2_rows=min(log2_rows, log2_needed))

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
        """(L, R, 128) f32 table, uniform ±1e-4 like tcnn."""
        t = torch.rand((self.n_levels, self.rows, LANES), generator=generator,
                       device=device, dtype=torch.float32)
        return t * 2e-4 - 1e-4


def lookup_geometry(meta: BlockedGridMeta, pos: torch.Tensor):
    """Per (sample, level): row id, base-local vertex coords, fractions.

    pos: (N, D) f32 in [0,1]. Returns
      rows   (L, N) int64    — row within the level's table
      local  (L, N, D) int64 — base-vertex coords within the block
      frac   (L, N, D) f32   — interpolation fractions
    """
    D, L = meta.n_dims, meta.n_levels
    _, stride = _block_geom(D)
    dev = pos.device
    scales = torch.tensor(meta.level_scales, dtype=torch.float32, device=dev)
    x = pos.T[None] * scales[:, None, None] + 0.5          # (L, D, N)
    x0f = torch.floor(x)
    frac = x - x0f
    base = x0f.to(torch.int64)                             # vertex base coords
    block = torch.div(base, stride, rounding_mode="floor")
    local = base - block * stride                          # ∈ [0, stride)
    # clamp blocks into the level's block grid (positions slightly ≥ res);
    # ``local`` above is taken BEFORE this clip, as in the JAX package
    nblk = torch.tensor(meta.level_blocks_per_dim, dtype=torch.int64,
                        device=dev)[:, None, None]
    block = torch.minimum(torch.clamp(block, min=0), nblk - 1)

    # dense: raster index over blocks; hashed: prime hash (or morton) & rows-1
    bstr = torch.tensor([[b ** d for d in range(D)]
                         for b in meta.level_blocks_per_dim],
                        dtype=torch.int64, device=dev)     # (L, D)
    dense_row = torch.sum(block * bstr[:, :, None], dim=1)  # (L, N)
    blockT = block.movedim(1, -1)                          # (L, N, D)
    if meta.row_hash == "morton":
        h = morton_nd(blockT, D)
    else:
        bu = blockT & _U32
        h = (bu[..., 0] * _HASH_PRIMES[0]) & _U32
        for d in range(1, D):
            h = h ^ ((bu[..., d] * _HASH_PRIMES[d]) & _U32)
    tiled_row = h & (meta.rows - 1)
    is_dense = torch.tensor(meta.level_is_dense, device=dev)[:, None]
    rows = torch.where(is_dense, dense_row, tiled_row)     # (L, N)
    return rows, local.movedim(1, -1), frac.movedim(1, -1)


def corner_lanes_and_weights(meta: BlockedGridMeta, local: torch.Tensor,
                             frac: torch.Tensor):
    """(L, N, D) local+frac → lanes (L, N, C) int64 (feature-0 lanes) and
    weights (L, N, C) f32, where C = 2^D. Lane layout within a row:
    vertex raster index within the block · 2 + feature."""
    D = meta.n_dims
    side, _ = _block_geom(D)
    C = 1 << D
    cor = torch.tensor([[(c >> d) & 1 for d in range(D)] for c in range(C)],
                       dtype=torch.int64, device=local.device)  # (C, D)
    v = local[:, :, None, :] + cor[None, None]             # (L, N, C, D)
    lane_strides = torch.tensor([side ** d for d in range(D)],
                                dtype=torch.int64, device=local.device)
    lanes = torch.sum(v * lane_strides, dim=-1) * meta.n_features_per_level
    w = torch.where(cor[None, None] > 0, frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])
    # the product in dimension order, as the kernels multiply: the int8
    # backward quantises w·g, so its plain version needs the same bits
    weights = w[..., 0]
    for d in range(1, D):
        weights = weights * w[..., d]
    return lanes, weights


def _corner_index(meta: BlockedGridMeta, pos: torch.Tensor):
    """Flat (row·128 + feature-0 lane) index (L, N, C) of each sample's
    corners within its level, and their weights (L, N, C)."""
    rows, local, frac = lookup_geometry(meta, pos)
    lanes, weights = corner_lanes_and_weights(meta, local, frac)
    return rows[:, :, None] * LANES + lanes, weights


def encode_reference(table: torch.Tensor, pos: torch.Tensor,
                     meta: BlockedGridMeta) -> torch.Tensor:
    """Plain PyTorch encode: (L, R, 128) table + (N, D) positions →
    (N, L·F) features, gathering each corner's features directly."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    idx, weights = _corner_index(meta, pos)
    flat = table.reshape(L, -1)                            # (L, R·128)
    feats = []
    for f in range(F):
        vals = torch.gather(flat, 1, (idx + f).reshape(L, -1)).view(idx.shape)
        feats.append(torch.sum(vals * weights, dim=-1))    # (L, N)
    out = torch.stack(feats, dim=-1)                       # (L, N, F)
    return out.transpose(0, 1).reshape(N, L * F)


def encode_backward_reference(pos: torch.Tensor, grad: torch.Tensor,
                              meta: BlockedGridMeta) -> torch.Tensor:
    """Plain table backward of ``encode_reference``: (N, D) positions +
    (N, L·F) cotangent → dTable (L, R, 128), adding w·g into each corner's
    feature lanes. Entries no sample touches stay exactly 0."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    idx, weights = _corner_index(meta, pos)
    g = grad.reshape(N, L, F).transpose(0, 1)              # (L, N, F)
    dflat = torch.zeros((L, meta.rows * LANES), dtype=grad.dtype,
                        device=grad.device)
    for f in range(F):
        dflat.scatter_add_(1, (idx + f).reshape(L, -1),
                           (weights * g[:, :, f:f + 1]).reshape(L, -1))
    return dflat.view(L, meta.rows, LANES)


def encode_position_backward_reference(table: torch.Tensor, pos: torch.Tensor,
                                       grad: torch.Tensor,
                                       meta: BlockedGridMeta,
                                       magnitude: bool = False
                                       ) -> torch.Tensor:
    """Plain position backward of ``encode_reference``, written out as the
    Pallas ``_bwd_frac_kernel`` computes it: per level and dimension d,
    dfrac_d = Σ_c Σ_f (g_f · T[c, f]) · Π_{d'≠d} w_{d'}(c) · (2·bit_d(c) − 1),
    then dpos = Σ_l dfrac · scale_l in level order. Reads the f32 table
    (the Pallas kernel rounds it to bf16). (N, D) f32.

    ``magnitude`` sums the terms' absolute values instead: the scale that
    the sum's rounding error is relative to (the terms cancel)."""
    L, F, D = meta.n_levels, meta.n_features_per_level, meta.n_dims
    N = pos.shape[0]
    rows, local, frac = lookup_geometry(meta, pos)
    lanes, _ = corner_lanes_and_weights(meta, local, frac)
    idx = rows[:, :, None] * LANES + lanes                 # (L, N, C)
    flat = table.reshape(L, -1)
    g = grad.reshape(N, L, F).transpose(0, 1)              # (L, N, F)
    C = 1 << D
    bits = torch.tensor([[(c >> d) & 1 for d in range(D)] for c in range(C)],
                        dtype=torch.int64, device=pos.device)  # (C, D)
    w = torch.where(bits[None, None] > 0, frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])             # (L, N, C, D)
    # d/dw of the output, per corner and feature: g_f · T[c, f]
    gG = [g[:, :, f:f + 1] * torch.gather(flat, 1, (idx + f).reshape(L, -1)
                                          ).view(idx.shape)
          for f in range(F)]                               # F × (L, N, C)
    if magnitude:
        gG = [torch.abs(t) for t in gG]
    dfrac = []
    for d in range(D):
        prod = torch.ones_like(w[..., 0])
        for dd in range(D):
            if dd != d:
                prod = prod * w[..., dd]
        sign = (bits[:, d] * 2 - 1).to(pos.dtype)          # (C,)
        if magnitude:
            sign = torch.ones_like(sign)
        dfrac.append(sum(torch.sum(t * prod * sign, dim=-1) for t in gG))
    dfrac = torch.stack(dfrac, dim=-1)                     # (L, N, D)
    scales = torch.tensor(meta.level_scales, dtype=torch.float32,
                          device=pos.device)
    dpos = dfrac[0] * scales[0]
    for l in range(1, L):
        dpos = dpos + dfrac[l] * scales[l]
    return dpos


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded as the JAX package and the kernels divide:
    PyTorch on CUDA multiplies by the reciprocal of a Python-number
    divisor, which is an ulp off for some x."""
    return x / torch.tensor(127.0, device=x.device)


# Sample tile of the Pallas kernels (hashgrid_pallas.py:32): the int8 table
# backward quantises its cotangents per (level, tile of samples)
DEFAULT_TILE = 2048


def eff_tile(n: int, tile: int = DEFAULT_TILE) -> int:
    """The sample tile the Pallas kernels use for a stream of n samples:
    ``tile``, clamped to the stream padded to a power of two ≥ 512
    (``hashgrid_pallas._eff_tile``)."""
    p = 1 << max(int(n - 1).bit_length(), 9)
    return min(tile, p)


def encode_backward_reference_i8(pos: torch.Tensor, grad: torch.Tensor,
                                 meta: BlockedGridMeta, tile: int,
                                 magnitude: bool = False) -> torch.Tensor:
    """Plain table backward of the ``full`` int8 mode (Pallas
    ``_bwd_table_kernel_i8``): per level and per tile of ``tile`` samples,
    in tile order, the products w·g are quantised with the tile's scale
    ``max(max|w·g|, 1e-20) / 127`` to q = clip(round_half_even(w·g /
    scale), ±127); each table entry sums its q exactly in integers within
    the tile and adds ``f32(Σq) · scale`` across tiles. Entries whose every
    q is 0 stay exactly 0. (L, R, 128) f32.

    ``magnitude`` sums |q| instead: Σ_t scale_t · Σ|q|, the scale that a
    sum in another order is held to."""
    L, F = meta.n_levels, meta.n_features_per_level
    N = pos.shape[0]
    idx, weights = _corner_index(meta, pos)                # (L, N, C)
    g = grad.reshape(N, L, F).transpose(0, 1)              # (L, N, F)
    wg = weights[:, :, :, None] * g[:, :, None, :]         # (L, N, C, F)
    ent = idx[:, :, :, None] + torch.arange(F, device=pos.device)
    dflat = torch.zeros((L, meta.rows * LANES), dtype=torch.float32,
                        device=pos.device)
    for l in range(L):
        for t0 in range(0, N, tile):
            v = wg[l, t0:t0 + tile].reshape(-1)
            scale = _div127(torch.clamp(torch.amax(torch.abs(v)), min=1e-20))
            q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int32)
            if magnitude:
                q = torch.abs(q)
            qsum = torch.zeros(meta.rows * LANES, dtype=torch.int32,
                               device=pos.device)
            qsum.scatter_add_(0, ent[l, t0:t0 + tile].reshape(-1), q)
            dflat[l] += qsum.to(torch.float32) * scale
    return dflat.view(L, meta.rows, LANES)


def quantize_table_i8(table: torch.Tensor):
    """(L, R, 128) f32 table → (int8 table, (L,) f32 scales), per-level
    scale ``max|T|/127`` with a 1e-20 floor, rounded half to even
    (``hashgrid_pallas.py:445-448``)."""
    scales = _div127(torch.clamp(torch.amax(torch.abs(table), dim=(1, 2)),
                                 min=1e-20))
    q = torch.clamp(torch.round(table / scales[:, None, None]), -127, 127)
    return q.to(torch.int8), scales


def encode_reference_i8(table_q: torch.Tensor, scales: torch.Tensor,
                        pos: torch.Tensor,
                        meta: BlockedGridMeta) -> torch.Tensor:
    """Plain int8-table encode: ``encode_reference`` on the dequantised
    table q·scale."""
    return encode_reference(table_q.to(torch.float32) * scales[:, None, None],
                            pos, meta)
