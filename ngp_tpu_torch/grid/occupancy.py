"""Cascaded occupancy grid: lookups, camera-visibility init, the sweeps,
and the bitfield and coarse-mask rebuild (port of
``ngp_tpu/grid/occupancy.py``).

Layout, as in the JAX package (it differs from the reference's Morton
order):
- grid values: ((max_cascade+1)·128³,) f32 in LINEAR (z,y,x) order per
  cascade;
- bitfield: (NERF_CASCADES·128³//8,) uint8. Byte index = linear index of
  (x//2, y//2, z//2) in a 64³ grid; bit = (x&1) | (y&1)<<1 | (z&1)<<2.
- The reference's Morton layout appears only at the snapshot boundary
  (``density_to_morton``/``density_from_morton``, numpy).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ngp_tpu_torch.common import (GRID_VOLUME, MIN_CONE_STEPSIZE,
                                  NERF_CASCADES, NERF_GRIDSIZE,
                                  NERF_MIN_OPTICAL_THICKNESS)

G = NERF_GRIDSIZE          # 128
GH = NERF_GRIDSIZE // 2    # 64 (byte-block grid side)


# --- Morton order at the snapshot boundary ------------------------------------

def morton3d(x, y, z) -> np.ndarray:
    """The Morton code of 10-bit coordinates (numpy integer arrays), int64
    (the JAX package's ``grid.occupancy.morton3d``)."""
    def part(v):
        v = np.asarray(v).astype(np.uint32) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return (part(x) | (part(y) << 1) | (part(z) << 2)).astype(np.int64)


def _morton_perm() -> np.ndarray:
    """linear index → Morton index, one 128³ cascade."""
    idx = np.arange(GRID_VOLUME, dtype=np.uint32)
    return morton3d(idx % G, (idx // G) % G, idx // (G * G))


def density_to_morton(density: np.ndarray) -> np.ndarray:
    """Linear-layout density → reference Morton layout (per cascade)."""
    d = np.asarray(density).reshape(-1, GRID_VOLUME)
    out = np.empty_like(d)
    out[:, _morton_perm()] = d
    return out.reshape(np.shape(density))


def density_from_morton(density: np.ndarray) -> np.ndarray:
    """Reference Morton-layout density → linear layout (per cascade)."""
    d = np.asarray(density).reshape(-1, GRID_VOLUME)
    return d[:, _morton_perm()].reshape(np.shape(density))


# --- mip / cell helpers (ref: src/testbed_nerf.cu:267-352,449-463) -----------

def mip_from_pos(pos: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """Smallest cascade whose [0,1]-scaled cube contains pos (pos in
    ngp/world units, scene centered at 0.5)."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    # frexpf: maxval = m·2^e with m ∈ [0.5,1) → e = floor(log2(maxval)) + 1
    exponent = torch.floor(torch.log2(torch.clamp(maxval, min=1e-10))
                           ).to(torch.int32) + 1
    return torch.clamp(exponent + 1, 0, max_cascade)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor,
                max_cascade: int) -> torch.Tensor:
    mip = mip_from_pos(pos, max_cascade)
    d = dt * (2 * NERF_GRIDSIZE)
    e = torch.floor(torch.log2(torch.clamp(d, min=1e-10))).to(torch.int32) + 1
    return torch.where(d < 1.0, mip,
                       torch.clamp(torch.maximum(e, mip), 0, max_cascade))


def cell_coords_at(pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Integer cell coords (N,3) of pos at the given mip."""
    scale = torch.exp2(-mip.to(torch.float32))[:, None]
    p = (pos - 0.5) * scale + 0.5
    return torch.clamp((p * NERF_GRIDSIZE).to(torch.int32), 0,
                       NERF_GRIDSIZE - 1)


def cell_idx_at(pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """LINEAR cell index (N,) of pos at the given mip."""
    i = cell_coords_at(pos, mip).to(torch.int64)
    return (i[:, 2] * G + i[:, 1]) * G + i[:, 0]


def occupied_at(bitfield: torch.Tensor, pos: torch.Tensor,
                mip: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup (ref: density_grid_occupied_at). Out-of-range
    bytes clamp to the ends, like the JAX package's take(mode="clip")."""
    i = cell_coords_at(pos, mip).to(torch.int64)
    byte = ((i[:, 2] >> 1) * GH + (i[:, 1] >> 1)) * GH + (i[:, 0] >> 1)
    bit = (i[:, 0] & 1) | ((i[:, 1] & 1) << 1) | ((i[:, 2] & 1) << 2)
    idx = torch.clamp(byte + mip.to(torch.int64) * (GRID_VOLUME // 8), 0,
                      bitfield.numel() - 1)
    v = bitfield[idx].to(torch.int64)
    return ((v >> bit) & 1) > 0


# --- grid state ---------------------------------------------------------------

GC = 16  # coarse mask side (128 / 8)


class OccupancyGrid(NamedTuple):
    density: torch.Tensor   # ((max_cascade+1)·128³,) f32 linear, <0 untrained
    bitfield: torch.Tensor  # (NERF_CASCADES·128³//8,) uint8
    mean: torch.Tensor      # scalar f32: mean clamped level-0 density
    ema_step: int           # update counter
    coarse: Optional[torch.Tensor] = None  # (NERF_CASCADES·16³,) uint8


def init_grid(max_cascade: int, device=None) -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.zeros(GRID_VOLUME * (max_cascade + 1),
                            dtype=torch.float32, device=device),
        bitfield=torch.zeros(NERF_CASCADES * GRID_VOLUME // 8,
                             dtype=torch.uint8, device=device),
        mean=torch.zeros((), dtype=torch.float32, device=device),
        ema_step=0,
        coarse=torch.zeros(NERF_CASCADES * GC ** 3, dtype=torch.uint8,
                           device=device))


def _cell_coords(idx: torch.Tensor) -> torch.Tensor:
    """Linear cell index within a cascade → (x, y, z) f32 coords."""
    return torch.stack([idx % G, (idx // G) % G, idx // (G * G)],
                       -1).to(torch.float32)


def cell_center_positions(max_cascade: int, device=None) -> torch.Tensor:
    """World positions ((max_cascade+1)·128³, 3) of every cell centre,
    cascade by cascade in linear order."""
    base = (_cell_coords(torch.arange(GRID_VOLUME, device=device)) + 0.5) \
        / NERF_GRIDSIZE
    levels = torch.exp2(torch.arange(max_cascade + 1, dtype=torch.float32,
                                     device=device))
    return ((base[None] - 0.5) * levels[:, None, None] + 0.5).reshape(-1, 3)


def mark_untrained(max_cascade: int, xforms: torch.Tensor,
                   focal: torch.Tensor, resolution: torch.Tensor
                   ) -> torch.Tensor:
    """The initial density vector: -1 in cells no training camera sees,
    0 elsewhere (ref: mark_untrained_density_grid,
    src/testbed_nerf.cu:369-417). xforms (I,3,4) camera→world, focal
    (I,2), resolution (I,2)."""
    dev = xforms.device
    pos = cell_center_positions(max_cascade, dev)
    levels = torch.arange(max_cascade + 1, device=dev).repeat_interleave(
        GRID_VOLUME)
    voxel_radius = 0.5 * (3.0 ** 0.5) * torch.exp2(
        levels.to(torch.float32)) / NERF_GRIDSIZE
    seen = torch.zeros(pos.shape[0], dtype=torch.bool, device=dev)
    for xf, f, res in zip(xforms, focal, resolution.to(torch.float32)):
        ploc = pos - xf[:, 3]
        x, y, z = ploc @ xf[:, 0], ploc @ xf[:, 1], ploc @ xf[:, 2]
        half = res * 0.5
        seen |= ((z > 0)
                 & (torch.abs(x) - voxel_radius < z / f[0] * half[0])
                 & (torch.abs(y) - voxel_radius < z / f[1] * half[1]))
    return torch.where(seen, 0.0, -1.0)


def update_grid(grid: OccupancyGrid,
                density_fn: Callable[[torch.Tensor], torch.Tensor],
                generator: Optional[torch.Generator], max_cascade: int,
                decay: float = 0.95, n_uniform: int = GRID_VOLUME // 4,
                n_nonuniform: int = GRID_VOLUME // 4,
                aabb_min: float = 0.0, aabb_size: float = 1.0,
                jitter: Optional[torch.Tensor] = None) -> OccupancyGrid:
    """One grid maintenance step: swept cells get σ at a uniformly
    jittered position (``density_fn`` maps warped positions (N,3) ∈
    [0,1]³ → σ (N,)), max-merged into the decayed EMA, then the bitfield
    and coarse mask are rebuilt. Cells marked untrained (< 0) stay so.

    A budget ``n_uniform + n_nonuniform`` that covers every cell is the
    full sweep (the warm-up branch). A smaller one is the INTERLEAVED
    slab-cyclic sweep: update k refreshes every n_blocks-th z-slab (one z
    layer of 128² cells), the phase rotating with ``ema_step``, after the
    EMA decay of every cell. The interleave matters: a contiguous half-grid
    block let the decayed half fall below the relative mean threshold on a
    near-uniform early density, and culled a whole half-space of the scene
    (``ngp_tpu/grid/occupancy.py:277-288``).

    ``jitter`` (n, 3) in [0,1) replaces the draw from ``generator``."""
    n_cascades = max_cascade + 1
    n_cells = GRID_VOLUME * n_cascades
    budget = max(n_uniform + n_nonuniform, 1)
    dev = grid.density.device
    if budget >= n_cells:
        idx = torch.arange(n_cells, dtype=torch.int64, device=dev)
        n_sel = n_blocks = phase = None
    else:
        n_rows = n_cascades * G
        n_blocks = max(int(round(n_cells / budget)), 1)
        while n_rows % n_blocks:                 # need a divisor of rows
            n_blocks -= 1
        n_sel = n_rows // n_blocks
        phase = grid.ema_step % n_blocks
        rows = torch.arange(n_sel, dtype=torch.int64, device=dev) * n_blocks \
            + phase
        idx = (rows[:, None] * (G * G) + torch.arange(
            G * G, dtype=torch.int64, device=dev)[None]).reshape(-1)
    u = jitter if jitter is not None else torch.rand(
        (idx.shape[0], 3), generator=generator, device=dev)
    level = idx // GRID_VOLUME
    lv = torch.exp2(level.to(torch.float32))[:, None]
    pos = ((_cell_coords(idx % GRID_VOLUME) + u) / NERF_GRIDSIZE - 0.5) * lv \
        + 0.5
    splat = density_fn((pos - aabb_min) / aabb_size) * MIN_CONE_STEPSIZE
    if n_sel is None:
        new = torch.maximum(grid.density * decay, splat)
    else:
        # decay everywhere (ref: ema_grid_samples_nerf), then max-merge
        # the swept slabs
        new = (grid.density * decay).view(n_sel, n_blocks, G * G)
        new[:, phase] = torch.maximum(new[:, phase],
                                      splat.view(n_sel, G * G))
        new = new.reshape(-1)
    density = torch.where(grid.density < 0.0, grid.density, new)
    return rebuild_bitfield(grid._replace(density=density,
                                          ema_step=grid.ema_step + 1))


def rebuild_bitfield(grid: OccupancyGrid) -> OccupancyGrid:
    """Mean + threshold + bit packing + mip max-pool
    (ref: update_density_grid_mean_and_bitfield), and the coarse mask of
    the hierarchical march."""
    level0 = grid.density[:GRID_VOLUME]
    mean = torch.mean(torch.clamp(level0, min=0.0))
    thresh = torch.clamp(mean, max=NERF_MIN_OPTICAL_THICKNESS)
    n_cascades = grid.density.shape[0] // GRID_VOLUME
    occ = grid.density.view(n_cascades, G, G, G) > thresh     # (C,z,y,x)
    w = torch.arange(2, device=occ.device)
    weights = (1 << (w[:, None, None] * 4 + w[None, :, None] * 2
                     + w[None, None, :])).view(1, 2, 1, 2, 1, 2)

    def pack_level(cur):
        """(128³ bool) → (64³ uint8): byte = linear block, bit = x&1 |
        y&1<<1 | z&1<<2."""
        b = cur.view(GH, 2, GH, 2, GH, 2).to(torch.int32)
        return torch.sum(b * weights, dim=(1, 3, 5)).to(torch.uint8)

    # mip max-pool (ref: bitfield_max_pool): level m's packed bytes are its
    # 2×2×2 any-pool, and they cover exactly the center half of level m+1
    q = G // 4
    packed = []
    for m in range(NERF_CASCADES):
        cur = (occ[m] if m < n_cascades
               else torch.zeros((G, G, G), dtype=torch.bool,
                                device=occ.device))
        if m > 0:
            cur = cur.clone()
            cur[q:3 * q, q:3 * q, q:3 * q] |= packed[m - 1] != 0
        packed.append(pack_level(cur))
    packed = torch.stack(packed)                              # (8, 64³)
    return grid._replace(bitfield=packed.reshape(-1), mean=mean,
                         coarse=_build_coarse_mask(packed.view(-1, GH, GH,
                                                               GH)))


def _build_coarse_mask(packed: torch.Tensor) -> torch.Tensor:
    """Conservative 16³ per-mip 'maybe occupied' mask: a coarse cell is
    set iff any fine cell within ±1 coarse cell of it, at its own mip or
    any coarser mip's overlapping region, is occupied — so a segment test
    at the midpoint's mip never culls a sample the fine test would keep."""
    C = NERF_CASCADES
    byte_any = packed != 0                                    # (C,z,y,x)
    coarse = byte_any.view(C, GC, 4, GC, 4, GC, 4).any(6).any(4).any(2)
    # union of coarser mips: mip m+1's centre half is mip m's whole box
    q = GC // 4
    levels = list(coarse)
    for m in range(C - 2, -1, -1):
        up = levels[m + 1][q:3 * q, q:3 * q, q:3 * q]
        up2 = up.repeat_interleave(2, 0).repeat_interleave(2, 1) \
            .repeat_interleave(2, 2)
        levels[m] = levels[m] | up2
    u = torch.stack(levels)
    # spatial dilation by ±1 coarse cell
    pad = torch.nn.functional.pad(u.to(torch.uint8), (1, 1, 1, 1, 1, 1))
    d = torch.zeros_like(u, dtype=torch.uint8)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                d |= pad[:, dz:dz + GC, dy:dy + GC, dx:dx + GC]
    return d.reshape(-1)


def coarse_occupied_at(coarse: torch.Tensor, pos: torch.Tensor,
                       mip: torch.Tensor) -> torch.Tensor:
    """Conservative segment-level lookup on the 16³ mask. Out-of-range
    indices clamp like take(mode="clip")."""
    scale = torch.exp2(-mip.to(torch.float32))[:, None]
    p = (pos - 0.5) * scale + 0.5
    i = torch.clamp((p * GC).to(torch.int64), 0, GC - 1)
    idx = (i[:, 2] * GC + i[:, 1]) * GC + i[:, 0] + mip.to(torch.int64) \
        * GC ** 3
    return coarse[torch.clamp(idx, 0, coarse.numel() - 1)] > 0
