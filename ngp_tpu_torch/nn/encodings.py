"""Input encodings (port of ``ngp_tpu/nn/encodings.py``): Identity,
Frequency, OneBlob, SphericalHarmonics (degree ≤ 4), Composite, the blocked
hash grid (2D and 3D) and the tcnn-layout hash and dense grids. Each is an
``nn.Module`` mapping (N, n_dims) → (N, n_output_dims); a grid holds its
table as the parameter ``table``. ``encode`` runs any of them in one of
the blocked grid's int8 modes."""
from __future__ import annotations

import math

from typing import Optional, Sequence

import torch
from torch import nn

from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
from ngp_tpu_torch.kernels.hashgrid import (HashGridMeta,
                                            hashgrid_encode_with_max_level,
                                            mask_levels)

GRID_IMPLS = ("blocked", "tcnn")


class Identity(nn.Module):
    def __init__(self, n_dims: int, scale: float = 1.0, offset: float = 0.0):
        super().__init__()
        self.n_dims = n_dims
        self.scale = scale
        self.offset = offset
        self.n_output_dims = n_dims

    def forward(self, x):
        return x * self.scale + self.offset


class Frequency(nn.Module):
    """NeRF-style frequency encoding: per dim, sin and cos at π·2^k."""

    def __init__(self, n_dims: int, n_frequencies: int = 12):
        super().__init__()
        self.n_dims = n_dims
        self.n_frequencies = n_frequencies
        self.n_output_dims = n_dims * n_frequencies * 2

    def forward(self, x):
        freqs = torch.exp2(torch.arange(self.n_frequencies,
                                        dtype=torch.float32, device=x.device))
        ang = x[..., :, None] * freqs * math.pi                 # (N, D, K)
        out = torch.stack([torch.sin(ang), torch.cos(ang)], -1)  # (N, D, K, 2)
        return out.reshape(x.shape[0], self.n_output_dims)


class OneBlob(nn.Module):
    """One-blob encoding (Neural Importance Sampling): each input is
    soft-binned into ``n_bins`` by a quartic kernel of radius 2/n_bins,
    integrated over each bin."""

    def __init__(self, n_dims: int, n_bins: int = 16):
        super().__init__()
        self.n_dims = n_dims
        self.n_bins = n_bins
        self.n_output_dims = n_dims * n_bins

    @staticmethod
    def _quartic_cdf(x, inv_radius: float):
        """CDF of the normalised quartic kernel 15/16 (1-u²)² on [-1, 1]."""
        u = torch.clamp(x * inv_radius, -1.0, 1.0)
        return 0.5 + (15.0 / 16.0) * (u - 2.0 * u ** 3 / 3.0 + u ** 5 / 5.0)

    def forward(self, x):
        n = self.n_bins
        edges = torch.arange(n + 1, dtype=torch.float32,
                             device=x.device) / n                # (n+1,)
        cdf = self._quartic_cdf(edges - x[..., :, None], n * 0.5)
        out = cdf[..., 1:] - cdf[..., :-1]                      # (N, D, n)
        return out.reshape(x.shape[0], self.n_output_dims)


class SphericalHarmonics(nn.Module):
    """Real SH basis up to degree 4 (16 coeffs), tcnn's polynomials. Input
    is the warped direction in [0,1]^3 (ref: warp_direction,
    src/testbed_nerf.cu:291-294), unwarped here."""

    def __init__(self, n_dims: int = 3, degree: int = 4):
        super().__init__()
        if n_dims != 3:
            raise ValueError("SphericalHarmonics encodes 3D directions")
        if not (1 <= degree <= 4):
            raise ValueError("SH degree 1..4 supported")
        self.degree = degree
        self.n_output_dims = degree * degree

    def forward(self, dirs01):
        d = dirs01 * 2.0 - 1.0
        x, y, z = d[..., 0], d[..., 1], d[..., 2]
        xy, xz, yz = x * y, x * z, y * z
        x2, y2, z2 = x * x, y * y, z * z
        out = [torch.full_like(x, 0.28209479177387814)]
        if self.degree >= 2:
            out += [
                -0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x,
            ]
        if self.degree >= 3:
            out += [
                1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2,
            ]
        if self.degree >= 4:
            out += [
                0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2),
            ]
        return torch.stack(out, dim=-1)


class Composite(nn.Module):
    """Applies nested encodings to consecutive slices of the input
    (ref: dir_encoding in configs/nerf/base.json). ``int8`` and ``tile``
    reach every nested grid (``encode``)."""

    def __init__(self, parts: Sequence[tuple[int, nn.Module]]):
        super().__init__()
        self.dims = [nd for nd, _ in parts]
        self.parts = nn.ModuleList([e for _, e in parts])
        self.n_output_dims = sum(e.n_output_dims for e in self.parts)

    def forward(self, x, int8: str = "", tile: Optional[int] = None):
        outs, off = [], 0
        for nd, enc in zip(self.dims, self.parts):
            outs.append(encode(enc, x[..., off:off + nd], int8, tile))
            off += nd
        return torch.cat(outs, dim=-1)


class BlockedGridEncoding(nn.Module):
    """The blocked multiresolution grid (see kernels/blocked_grid.py). The
    encode runs the CUDA kernels on CUDA tensors and the plain PyTorch
    versions on CPU tensors. ``int8`` is the JAX package's
    ``NGP_TPU_ENCODE_INT8``, as an argument: ``"fwd"`` reads the table
    quantised to int8 in the forward (K4) and keeps the exact f32 table
    backward (K2); ``"full"`` quantises the table backward's cotangents
    too (K5), per tile of ``tile`` samples. ``quantized``, the pair
    ``quantize_table_i8(self.table)`` gave, encodes through it (K4) without
    quantising again and without a gradient (the grid sweep's chunks)."""

    def __init__(self, meta: BlockedGridMeta,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.meta = meta
        self.n_output_dims = meta.n_output_dims
        self.table = nn.Parameter(meta.init_params(generator, device))

    def resolved_config(self) -> dict:
        """Layout keys a snapshot must carry: a table decodes only with
        the row hash and row count it was trained under."""
        return {"row_hash": self.meta.row_hash,
                "log2_rows": self.meta.log2_rows}

    def forward(self, x, max_level=None, int8: str = "",
                tile: Optional[int] = None, quantized=None):
        if quantized is not None:
            out = blocked_grid_cuda.encode_quantized(*quantized, x, self.meta)
        else:
            out = blocked_grid_cuda.encode_mode(self.table, x, self.meta,
                                                int8, tile)
        return mask_levels(out, max_level, self.meta.n_levels,
                           self.meta.n_features_per_level)


class GridEncoding(nn.Module):
    """The tcnn-layout hash or dense grid (see kernels/hashgrid.py): a flat
    table and a plain PyTorch encode. It serves reference (CUDA) snapshots,
    whose ``params_binary`` holds this layout; the int8 modes of the
    blocked grid do not apply to it."""

    def __init__(self, meta: HashGridMeta,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.meta = meta
        self.n_output_dims = meta.n_output_dims
        self.table = nn.Parameter(meta.init_params(generator, device))

    def forward(self, x, max_level=None, int8: str = "",
                tile: Optional[int] = None, quantized=None):
        if int8 or quantized is not None:
            raise NotImplementedError("the int8 encode modes exist for the "
                                      "blocked grid only")
        return hashgrid_encode_with_max_level(self.table, x, self.meta,
                                              max_level)


def encode(enc: nn.Module, x, int8: str = "", tile: Optional[int] = None):
    """``enc(x)`` in the int8 mode ``int8`` (the JAX package's
    ``NGP_TPU_ENCODE_INT8``, which every blocked grid reads, nested ones
    included): the grids and ``Composite`` take the mode, the tcnn-layout
    grid refuses any but ``""``, and the analytic encodings ignore it, as
    in the JAX package."""
    if isinstance(enc, (BlockedGridEncoding, GridEncoding, Composite)):
        return enc(x, int8=int8, tile=tile)
    return enc(x)


def create_encoding(n_dims: int, cfg: dict,
                    generator: Optional[torch.Generator] = None,
                    device=None, grid_impl: str = "blocked") -> nn.Module:
    """Factory mirroring tcnn::create_encoding (by ``otype``). A HashGrid
    maps to the blocked grid unless ``grid_impl`` is ``"tcnn"`` (the JAX
    package's ``NGP_TPU_GRID_IMPL``, as an argument): then, like a
    DenseGrid or a grid over other than 2 or 3 dims, it is the tcnn-layout
    grid."""
    if grid_impl not in GRID_IMPLS:
        raise ValueError(f"grid_impl {grid_impl!r} is not one of "
                         f"{GRID_IMPLS}")
    otype = cfg.get("otype", "Identity").lower()
    if "grid" in otype:
        c = dict(cfg)
        c.setdefault("n_pos_dims", n_dims)
        if otype.startswith("blocked") or (
                grid_impl == "blocked" and not otype.startswith("dense")
                and c["n_pos_dims"] in (2, 3)):
            return BlockedGridEncoding(
                BlockedGridMeta.from_hashgrid_config(c), generator, device)
        if otype.startswith("dense"):
            c["log2_hashmap_size"] = 40    # effectively infinite: all dense
        return GridEncoding(HashGridMeta.from_config(c), generator, device)
    if otype == "identity":
        return Identity(n_dims, cfg.get("scale", 1.0), cfg.get("offset", 0.0))
    if otype == "frequency":
        return Frequency(n_dims, cfg.get("n_frequencies", 12))
    if otype == "oneblob":
        return OneBlob(n_dims, cfg.get("n_bins", 16))
    if otype == "sphericalharmonics":
        return SphericalHarmonics(n_dims, cfg.get("degree", 4))
    if otype == "composite":
        parts, remaining = [], n_dims
        for sub in cfg.get("nested", []):
            nd = sub.get("n_dims_to_encode", remaining)
            parts.append((nd, create_encoding(nd, sub, generator, device,
                                              grid_impl)))
            remaining -= nd
        return Composite(parts)
    if otype == "takikawa":
        raise ValueError("the Takikawa octree encoding needs the mesh's "
                         "surface: SdfTrainer builds it (nn/takikawa.py)")
    raise ValueError(f"unknown encoding otype {cfg.get('otype')!r}")
