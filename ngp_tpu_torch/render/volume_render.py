"""Neural-volume renderer: emission-absorption ray march (port of
``ngp_tpu/render/volume_render.py``; ref: render_volume and its kernels,
src/testbed_volume.cu:206-392).

Each chunk of pixel rays takes ``n_steps`` fixed Δt steps through the
volume's AABB, accumulating emission under the transmittance, with the
dilated 128³ occupancy mask of the ground-truth grid zeroing the density
of empty cells; what the rays leave of their transmittance sees the
procedural sky. The network runs in the trainer's int8 mode on the
trainer's inference parameters, under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.rays.camera import ray_aabb_intersect
from ngp_tpu_torch.train.volume import sky_color


@dataclasses.dataclass
class VolumeRenderOptions:
    width: int = 512
    height: int = 512
    focal: float = 512.0
    n_steps: int = 192
    distance_scale: float = 100.0
    chunk: int = 1 << 15
    sun_dir: tuple = (0.577, 0.577, 0.577)


class VolumeRenderer:
    """Renders a ``VolumeTrainer``'s network on the trainer's device."""

    def __init__(self, trainer, opts: Optional[VolumeRenderOptions] = None):
        self.trainer = trainer
        self.opts = opts or VolumeRenderOptions()

    @functools.cached_property
    def _occupancy(self) -> torch.Tensor:
        """The grid's dilated 128³ occupancy, flat (x-major), f32."""
        return torch.as_tensor(
            self.trainer.grid.occupancy_dense_128().reshape(-1),
            dtype=torch.float32, device=self.trainer.device)

    def march(self, params: dict, o: torch.Tensor, d: torch.Tensor):
        """(rgb (N, 3), opacity (N,)) of rays ``o``, ``d`` (N, 3)."""
        opts, tr = self.opts, self.trainer
        g = tr.grid
        occ_mask = self._occupancy
        tmin, tmax = ray_aabb_intersect(o, d, tr.aabb_min, tr.aabb_max)
        tmin = torch.clamp(tmin, min=0.0)
        dt = torch.clamp(tmax - tmin, min=0.0) / opts.n_steps
        sigma_scale = opts.distance_scale / max(g.global_majorant, 1e-9)
        mode = {"int8": tr.encode_int8}
        n = o.shape[0]
        rgb = torch.zeros((n, 3), device=o.device)
        T = torch.ones(n, device=o.device)
        for i in range(opts.n_steps):
            t = tmin + (i + 0.5) * dt
            p = o + t[:, None] * d
            cell = torch.clamp((p * 128).to(torch.int32), 0, 127).long()
            # jnp.take(mode="clip") of the JAX package
            occ = occ_mask[torch.clamp(
                (cell[:, 0] * 128 + cell[:, 1]) * 128 + cell[:, 2], 0,
                occ_mask.numel() - 1)]
            out = functional_call(tr.model, params, (p,), mode).to(
                torch.float32)
            emit = torch.clamp(out[:, :3], min=0.0)
            sigma = occ * torch.clamp(out[:, 3], min=0.0) * sigma_scale
            alpha = 1.0 - torch.exp(-sigma * dt)
            rgb = rgb + (T * alpha)[:, None] * emit
            T = T * (1.0 - alpha)
        rgb = rgb + T[:, None] * sky_color(d, opts.sun_dir)
        return rgb, 1.0 - T

    def camera_rays(self, camera_matrix: np.ndarray, width: int,
                    height: int):
        """(origins, unit directions) (H·W, 3) numpy of the pixel centres
        of a pinhole camera with focal ``opts.focal`` (pixels), row-major."""
        focal = self.opts.focal
        ys, xs = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        u = (xs.reshape(-1) + 0.5) / width - 0.5
        v = (ys.reshape(-1) + 0.5) / height - 0.5
        dirs = np.stack([u * width / focal, v * height / focal,
                         np.ones_like(u)], -1).astype(np.float32)
        d = dirs @ np.asarray(camera_matrix[:, :3], np.float32).T
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
        o = np.broadcast_to(np.asarray(camera_matrix[:, 3], np.float32),
                            d.shape)
        return np.ascontiguousarray(o), d

    @torch.inference_mode()
    def render(self, camera_matrix: np.ndarray,
               width: Optional[int] = None,
               height: Optional[int] = None) -> np.ndarray:
        """(H, W, 4) numpy frame: rgb over the sky, and the opacity."""
        W, H = width or self.opts.width, height or self.opts.height
        o, d = self.camera_rays(camera_matrix, W, H)
        dev = self.trainer.device
        o = torch.from_numpy(o).to(dev)
        d = torch.from_numpy(d).to(dev)
        params = self.trainer.inference_params()
        parts = [self.march(params, oc, dc) for oc, dc in
                 zip(o.split(self.opts.chunk), d.split(self.opts.chunk))]
        rgb = torch.cat([p[0] for p in parts])
        opacity = torch.cat([p[1] for p in parts])
        return torch.cat([rgb, opacity[:, None]], -1).reshape(
            H, W, 4).cpu().numpy()
