"""Render buffer operations on tensors: spp accumulation, tonemapping,
colour space (port of ``ngp_tpu/render/buffer.py``; ref:
src/render_buffer.cu tonemap :606-628). A frame is a tensor and
accumulation is a running mean over sample indices."""
from __future__ import annotations

import torch

from ngp_tpu_torch.common import TonemapCurve, linear_to_srgb


def accumulate(prev, new, spp: int):
    """Progressive sample accumulation: running mean over spp
    (ref: accumulate_kernel — out = (prev·spp + new)/(spp+1))."""
    if spp == 0:
        return new
    return (prev * spp + new) / (spp + 1)


def tonemap_aces(x):
    """ACES filmic curve (ref: tonemap in render_buffer.cu)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _hable_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.20, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap_hable(x):
    W = 11.2
    return torch.clamp(_hable_partial(x) / _hable_partial(W), 0.0, 1.0)


def tonemap_reinhard(x):
    return x / (1.0 + x)


def tonemap(x, curve: TonemapCurve):
    if curve == TonemapCurve.IDENTITY:
        return x
    if curve == TonemapCurve.ACES:
        return tonemap_aces(x)
    if curve == TonemapCurve.HABLE:
        return tonemap_hable(x)
    if curve == TonemapCurve.REINHARD:
        return tonemap_reinhard(x)
    raise ValueError(curve)


def finalize_frame(rgba, exposure: float = 0.0,
                   curve: TonemapCurve = TonemapCurve.IDENTITY,
                   to_srgb: bool = True):
    """Scale by 2^exposure, tonemap, optionally convert to sRGB for
    display (alpha passes through)."""
    rgb = rgba[..., :3] * (2.0 ** exposure)
    rgb = tonemap(torch.clamp(rgb, min=0.0), curve)
    if to_srgb:
        rgb = linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
    return torch.cat([rgb, rgba[..., 3:]], dim=-1)
