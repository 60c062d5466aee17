"""Cascaded occupancy grid: lookups, bitfield rebuild and the full sweep
(port of the render-path parts of ``ngp_tpu/grid/occupancy.py``).

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

def _morton_perm() -> np.ndarray:
    """linear index → Morton index, one 128³ cascade."""
    idx = np.arange(GRID_VOLUME, dtype=np.uint32)

    def part(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    x, y, z = idx % G, (idx // G) % G, idx // (G * G)
    return (part(x) | (part(y) << 1) | (part(z) << 2)).astype(np.int64)


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

class OccupancyGrid(NamedTuple):
    density: torch.Tensor   # ((max_cascade+1)·128³,) f32 linear, <0 untrained
    bitfield: torch.Tensor  # (NERF_CASCADES·128³//8,) uint8
    mean: torch.Tensor      # scalar f32: mean clamped level-0 density
    ema_step: int           # update counter


def init_grid(max_cascade: int, device=None) -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.zeros(GRID_VOLUME * (max_cascade + 1),
                            dtype=torch.float32, device=device),
        bitfield=torch.zeros(NERF_CASCADES * GRID_VOLUME // 8,
                             dtype=torch.uint8, device=device),
        mean=torch.zeros((), dtype=torch.float32, device=device),
        ema_step=0)


def update_grid(grid: OccupancyGrid,
                density_fn: Callable[[torch.Tensor], torch.Tensor],
                generator: Optional[torch.Generator], max_cascade: int,
                decay: float = 0.95, n_uniform: int = GRID_VOLUME // 4,
                n_nonuniform: int = GRID_VOLUME // 4,
                aabb_min: float = 0.0, aabb_size: float = 1.0
                ) -> OccupancyGrid:
    """One grid maintenance step: every cell gets σ at a uniformly
    jittered position (``density_fn`` maps warped positions (N,3) ∈
    [0,1]³ → σ (N,)), max-merged into the decayed EMA, then the bitfield
    is rebuilt. Only the full sweep (budget ≥ all cells, the warm-up
    branch) is ported; the partial slab sweep belongs to training."""
    n_cells = GRID_VOLUME * (max_cascade + 1)
    if max(n_uniform + n_nonuniform, 1) < n_cells:
        raise NotImplementedError("partial grid sweep: training slice")
    dev = grid.density.device
    idx = torch.arange(n_cells, dtype=torch.int32, device=dev)
    level = idx // GRID_VOLUME
    lin = idx % GRID_VOLUME
    cell = torch.stack([lin % G, (lin // G) % G, lin // (G * G)],
                       -1).to(torch.float32)
    u = torch.rand((n_cells, 3), generator=generator, device=dev)
    lv = torch.exp2(level.to(torch.float32))[:, None]
    pos = ((cell + u) / NERF_GRIDSIZE - 0.5) * lv + 0.5
    warped = (pos - aabb_min) / aabb_size
    splat = density_fn(warped) * MIN_CONE_STEPSIZE
    density = torch.where(grid.density < 0.0, grid.density,
                          torch.maximum(grid.density * decay, splat))
    return rebuild_bitfield(grid._replace(density=density,
                                          ema_step=grid.ema_step + 1))


def rebuild_bitfield(grid: OccupancyGrid) -> OccupancyGrid:
    """Mean + threshold + bit packing + mip max-pool
    (ref: update_density_grid_mean_and_bitfield)."""
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
    return grid._replace(bitfield=torch.stack(packed).reshape(-1), mean=mean)
