"""Trainable buffers (port of ``ngp_tpu/nn/trainable_buffer.py``): the
environment map and the learned lens-distortion grid (ref: testbed.h:937-951;
envmap read envmap.cuh:30-105; 32×32 distortion grid consumed in ray
generation, src/testbed_nerf.cu:1188-1190). Both are plain tensors with
bilinear sampling; autograd gives the deposit the reference writes with
atomics."""
from __future__ import annotations

import math

import torch


def bilinear_sample(grid: torch.Tensor, uv: torch.Tensor,
                    wrap_x: bool = False) -> torch.Tensor:
    """grid (H, W, C), uv (N, 2) in [0,1] → (N, C), bilinear, edges clamped
    (or wrapping in x, for equirect envmaps)."""
    H, W = grid.shape[:2]
    x = uv[:, 0] * W - 0.5
    y = torch.clamp(uv[:, 1] * H - 0.5, 0.0, H - 1.000001)
    x = torch.remainder(x, W) if wrap_x else torch.clamp(x, 0.0, W - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x1 = (x0 + 1) % W if wrap_x else torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    g = grid
    return ((1 - fx) * (1 - fy) * g[y0, x0] + fx * (1 - fy) * g[y0, x1]
            + (1 - fx) * fy * g[y1, x0] + fx * fy * g[y1, x1])


class Envmap:
    """Equirectangular trainable environment map (RGBA)."""

    def __init__(self, height: int = 256, width: int = 512):
        self.height = height
        self.width = width

    def init_params(self, device=None) -> torch.Tensor:
        return torch.zeros((self.height, self.width, 4), device=device)

    @staticmethod
    def dir_to_uv(d: torch.Tensor) -> torch.Tensor:
        """Direction → equirect uv (ref: dir→latlong mapping)."""
        theta = torch.arcsin(torch.clamp(d[:, 1], -1.0, 1.0))
        phi = torch.atan2(d[:, 0], d[:, 2])
        return torch.stack([phi / (2 * math.pi) + 0.5,
                            theta / math.pi + 0.5], -1)

    def sample(self, params: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """(N, 3) directions → RGBA radiance; the caller blends it over the
        background (ref: compute_loss_kernel :1393-1400)."""
        return bilinear_sample(params, self.dir_to_uv(dirs), wrap_x=True)


class DistortionGrid:
    """Learned 2D ray-direction offset grid (ref: 32×32
    TrainableBuffer<2,2> added in pixel→ray)."""

    def __init__(self, resolution=(32, 32)):
        self.resolution = tuple(resolution)

    def init_params(self, device=None) -> torch.Tensor:
        h, w = self.resolution
        return torch.zeros((h, w, 2), device=device)

    def sample(self, params: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
        return bilinear_sample(params, xy)
