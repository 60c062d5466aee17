"""The tcnn-layout multiresolution hash grid (port of
``ngp_tpu/kernels/hashgrid.py``), as plain PyTorch.

L levels of D-linear interpolated feature grids; a level whose dense grid
fits in 2^log2_hashmap_size entries is stored densely, a finer one is
spatially hashed. The table is tiny-cuda-nn's: one FLAT parameter vector
of ``n_params · F`` floats, levels concatenated, the F features of an
entry interleaved (row r, feature f at index r·F + f), so a reference
(CUDA) snapshot's ``params_binary`` loads as it is.

The encode is a gather and a lerp over all levels at once. Autograd gives
its table gradient (a scatter-add into the gathered entries) and its
position gradient (through the fractional positions), so it needs no
hand-written backward. In the JAX package this grid is XLA, not Pallas:
no TPU kernel of the repository lands here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

# Spatial-hash primes (instant-ngp paper eq. 4; the first is 1, so the
# hash is the identity along x)
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
          2165219737)


@dataclasses.dataclass(frozen=True)
class HashGridMeta:
    """Static hash-grid configuration."""

    n_dims: int                      # D: 2 (image) or 3 (nerf/sdf/volume)
    n_levels: int                    # L
    n_features_per_level: int        # F
    log2_hashmap_size: int           # T = 2^this
    base_resolution: int             # N_min
    per_level_scale: float           # b
    interpolation: str = "linear"    # "linear" | "smoothstep"

    @functools.cached_property
    def level_scales(self) -> Tuple[float, ...]:
        """exp2(l·log2 b)·N_min − 1 in FLOAT32, as tcnn computes it: f64
        rounds some exact-integer scales the other way (b = 1.5, l = 3:
        53.0 vs 53.000000000000007), which changes ceil() and with it the
        level resolution and the table layout (tcnn ABI rule 6,
        io/snapshot.py)."""
        log2b = np.log2(np.float32(self.per_level_scale))
        return tuple(
            float(np.exp2(np.float32(l) * log2b, dtype=np.float32)
                  * np.float32(self.base_resolution) - np.float32(1.0))
            for l in range(self.n_levels))

    @functools.cached_property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(s)) + 1 for s in self.level_scales)

    @functools.cached_property
    def level_params(self) -> Tuple[int, ...]:
        """Table entries per level: dense if it fits, else hashed, rounded
        up to a multiple of 8 (tcnn's alignment)."""
        T = 1 << self.log2_hashmap_size
        return tuple(((min(res ** self.n_dims, T) + 7) // 8) * 8
                     for res in self.level_resolutions)

    @functools.cached_property
    def level_is_dense(self) -> Tuple[bool, ...]:
        T = 1 << self.log2_hashmap_size
        return tuple(res ** self.n_dims <= T for res in self.level_resolutions)

    @functools.cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for p in self.level_params:
            offs.append(acc)
            acc += p
        return tuple(offs)

    @property
    def n_params(self) -> int:
        return self.level_offsets[-1] + self.level_params[-1]

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @classmethod
    def from_config(cls, enc: dict) -> "HashGridMeta":
        return cls(
            n_dims=int(enc["n_pos_dims"]),
            n_levels=int(enc.get("n_levels", 16)),
            n_features_per_level=int(enc.get("n_features_per_level", 2)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=int(enc.get("base_resolution", 16)),
            per_level_scale=float(enc.get("per_level_scale", 2.0)),
            interpolation=str(enc.get("interpolation", "Linear")).lower(),
        )

    def init_params(self, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
        """The flat (n_params · F,) table, uniform in ±1e-4 like tcnn."""
        t = torch.rand((self.n_params * self.n_features_per_level,),
                       generator=generator, device=device,
                       dtype=torch.float32)
        return t * 2e-4 - 1e-4


def _corner_offsets(d: int, device) -> torch.Tensor:
    """(2^D, D) binary corner offsets, corner c's bit i on axis i."""
    c = torch.arange(1 << d, device=device)
    return torch.stack([(c >> i) & 1 for i in range(d)], -1)


def corner_indices_and_weights(meta: HashGridMeta, pos: torch.Tensor):
    """Table entries and interpolation weights of every corner of every
    level: pos (N, D) in [0, 1] → (idx (N, L, 2^D) int64, weights (N, L,
    2^D) f32). The hash runs in 32-bit unsigned arithmetic, as tcnn's,
    held in int64."""
    dev = pos.device
    D, L = meta.n_dims, meta.n_levels
    scales = torch.tensor(meta.level_scales, dtype=torch.float32, device=dev)
    res = torch.tensor(meta.level_resolutions, dtype=torch.int64, device=dev)
    x = pos[:, None, :] * scales[None, :, None] + 0.5           # (N, L, D)
    x0f = torch.floor(x)
    frac = x - x0f
    if meta.interpolation == "smoothstep":
        wfrac = frac * frac * (3.0 - 2.0 * frac)
    else:
        wfrac = frac
    offs = _corner_offsets(D, dev)                              # (C, D)
    coord = x0f.to(torch.int64)[:, :, None, :] + offs[None, None]
    coord = torch.minimum(torch.clamp(coord, min=0),
                          (res - 1)[None, :, None, None])       # (N, L, C, D)

    strides = torch.tensor([[r ** d for d in range(D)]
                            for r in meta.level_resolutions],
                           dtype=torch.int64, device=dev)       # (L, D)
    dense_idx = (coord * strides[None, :, None, :]).sum(-1)     # (N, L, C)
    mask32 = 0xFFFFFFFF
    h = (coord[..., 0] * PRIMES[0]) & mask32
    for d in range(1, D):
        h = h ^ ((coord[..., d] * PRIMES[d]) & mask32)
    params = torch.tensor(meta.level_params, dtype=torch.int64, device=dev)
    hash_idx = h % params[None, :, None]
    is_dense = torch.tensor(meta.level_is_dense, device=dev)[None, :, None]
    offsets = torch.tensor(meta.level_offsets, dtype=torch.int64,
                           device=dev)[None, :, None]
    idx = torch.where(is_dense, dense_idx, hash_idx) + offsets

    # D-linear weights: the product over dims of (w or 1 − w)
    w = torch.where(offs[None, None] > 0, wfrac[:, :, None, :],
                    1.0 - wfrac[:, :, None, :])                 # (N, L, C, D)
    weights = w[..., 0]
    for d in range(1, D):
        weights = weights * w[..., d]
    return idx, weights


def hashgrid_encode(table: torch.Tensor, pos: torch.Tensor,
                    meta: HashGridMeta) -> torch.Tensor:
    """Encode positions (N, D) in [0, 1] → (N, L·F) features, level-major
    (feature f of level l at column l·F + f). ``table``: the flat
    (n_params · F,) vector."""
    F = meta.n_features_per_level
    idx, weights = corner_indices_and_weights(meta, pos)
    feats = table.view(-1, F)[idx]                              # (N, L, C, F)
    out = (feats * weights[..., None]).sum(2)                   # (N, L, F)
    return out.reshape(pos.shape[0], meta.n_output_dims)


def hashgrid_encode_with_max_level(table: torch.Tensor, pos: torch.Tensor,
                                   meta: HashGridMeta, max_level=None):
    """``hashgrid_encode`` with the levels at or above max_level·L zeroed
    (``max_level`` in [0, 1], scalar or per sample (N,); ref: tcnn
    set_max_level_gpu, src/testbed_nerf.cu:3251-3259)."""
    return mask_levels(hashgrid_encode(table, pos, meta), max_level,
                       meta.n_levels, meta.n_features_per_level)


def mask_levels(out: torch.Tensor, max_level, n_levels: int,
                n_features: int) -> torch.Tensor:
    """Zero the features (N, L·F) of the levels at or above max_level·L
    (``max_level`` None: none; a scalar or per sample (N,))."""
    if max_level is None:
        return out
    level_ids = torch.arange(n_levels * n_features,
                             device=out.device) // n_features
    thresh = torch.as_tensor(max_level, device=out.device) * n_levels
    mask = ((level_ids < thresh) if thresh.dim() == 0
            else (level_ids[None, :] < thresh[:, None]))
    return out * mask.to(out.dtype)
