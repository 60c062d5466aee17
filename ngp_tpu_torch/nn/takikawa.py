"""Takikawa (NGLOD-style) octree feature encoding (port of
``ngp_tpu/nn/takikawa.py``; ref: takikawa_encoding.cuh:278,
triangle_octree.cuh:69): learned features live only on octree cells
around the mesh surface, trilinearly interpolated per level from a
starting depth.

As in the JAX package, the octree's topology is a per-level occupancy
bitset built on the host from surface samples (``build_surface_occupancy``,
a numpy copy: the same bits), held here as device buffers; the features
are a blocked multiresolution grid whose levels sit at the octree's depths
(base resolution 2^start_depth, scale 2), each level's features multiplied
by its cell's bit. On the card the encode is K1 forward, K2 for the table
gradient and K3 where the positions need a gradient (analytic normals); on
the CPU the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta


def build_surface_occupancy(surface_points: np.ndarray, max_depth: int,
                            start_depth: int = 3) -> Tuple[np.ndarray, ...]:
    """Per-level dense occupancy bitsets from surface samples in [0,1]³.
    Level d has resolution 2^d; a cell is occupied if any sample falls in
    it or its 1-neighborhood (dilation keeps interpolation well-defined
    at cell borders, like the reference's dual-octree vertices)."""
    out = []
    offs = np.array([(dx, dy, dz) for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dz in (-1, 0, 1)], np.int64)
    for d in range(start_depth, max_depth + 1):
        res = 1 << d
        idx = np.clip((surface_points * res).astype(np.int64), 0, res - 1)
        occ = np.zeros((res, res, res), bool)
        # 1-cell dilation by writing all 27 neighbor offsets of each sample
        for off in offs:
            j = np.clip(idx + off, 0, res - 1)
            occ[j[:, 0], j[:, 1], j[:, 2]] = True
        out.append(occ)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TakikawaMeta:
    start_depth: int = 3
    max_depth: int = 8
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19

    @property
    def n_levels(self) -> int:
        return self.max_depth - self.start_depth + 1

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @classmethod
    def from_config(cls, enc_cfg: dict) -> "TakikawaMeta":
        """From an ``otype: Takikawa`` encoding config: ``n_levels`` is the
        deepest octree depth, ``starting_level`` the first (as the JAX
        SdfTrainer reads them)."""
        return cls(start_depth=int(enc_cfg.get("starting_level", 3)),
                   max_depth=int(enc_cfg.get("n_levels", 8)),
                   n_features_per_level=int(
                       enc_cfg.get("n_features_per_level", 2)))


class TakikawaEncoding(nn.Module):
    """Octree-masked multiresolution features (otype "Takikawa"): one
    parameter, ``table`` (L, R, 128), and a packed bitset buffer per
    level (``occupancy_<l>``, big-endian bits as ``np.packbits`` packs
    them)."""

    def __init__(self, meta: TakikawaMeta, surface_points: np.ndarray,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.meta = meta
        self.grid_meta = BlockedGridMeta.from_hashgrid_config({
            "n_pos_dims": 3,
            "n_levels": meta.n_levels,
            "n_features_per_level": meta.n_features_per_level,
            "log2_hashmap_size": meta.log2_hashmap_size,
            "base_resolution": 1 << meta.start_depth,
            "per_level_scale": 2.0,
        })
        self.n_output_dims = meta.n_output_dims
        self.table = nn.Parameter(self.grid_meta.init_params(generator,
                                                             device))
        occs = build_surface_occupancy(surface_points, meta.max_depth,
                                       meta.start_depth)
        for level, o in enumerate(occs):
            self.register_buffer(f"occupancy_{level}", torch.from_numpy(
                np.packbits(o.reshape(-1))).to(device))

    def _level_mask(self, level: int, pos: torch.Tensor) -> torch.Tensor:
        res = 1 << (self.meta.start_depth + level)
        i = torch.clamp((pos * res).to(torch.int64), 0, res - 1)
        flat = (i[:, 0] * res + i[:, 1]) * res + i[:, 2]
        bits = getattr(self, f"occupancy_{level}")
        byte = bits[torch.clamp(flat // 8, 0, bits.numel() - 1)]
        return ((byte.to(torch.int64) >> (7 - flat % 8)) & 1).to(
            torch.float32)

    def contains(self, pos: torch.Tensor) -> torch.Tensor:
        """True where the finest octree level has features — the
        reference's TriangleOctree::contains analog (IoU counts points
        outside as correct by assumption, testbed_sdf.cu:464-466)."""
        return self._level_mask(self.meta.n_levels - 1, pos) > 0

    def empty_space_distance(self, pos: torch.Tensor) -> torch.Tensor:
        """0 where the finest level holds ``pos``'s cell (inside the
        octree); elsewhere the cell width of the coarsest level whose cell
        at ``pos`` is empty, a lower bound on the distance to the surface
        (no surface sample lies in that cell or its neighbours). A sphere
        tracer steps by it outside the octree, where the features are 0
        and the network's output means nothing, as the reference's tracer
        jumps to the next octree node."""
        empty = torch.stack([self._level_mask(level, pos) == 0
                             for level in range(self.meta.n_levels)], -1)
        first = torch.argmax(empty.to(torch.int32), dim=-1)
        width = torch.exp2(-(first + self.meta.start_depth).to(
            torch.float32))
        return torch.where(empty[:, -1], width, 0.0)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        feats = blocked_grid_cuda.blocked_grid_encode(self.table, pos,
                                                      self.grid_meta)
        masks = torch.stack([self._level_mask(level, pos)
                             for level in range(self.meta.n_levels)], -1)
        return feats * torch.repeat_interleave(
            masks, self.meta.n_features_per_level, dim=-1)
