"""Single-NeRF renderer, static path (port of the SHADE path of
``ngp_tpu/render/nerf_render.py``).

Each pixel chunk marches the closed-form cone lattice through the
occupancy bitfield, then walks the lattice in ``march_segments``
front-to-back segments: saturated rays drop out (transmittance early-out),
rays over the per-segment sample cap are decimated with dt compensation,
the live samples are compacted, evaluated by the network in one batch
and composited with per-ray lattice transmittance. The network outputs
sRGB; ``linear_out`` converts the frame to linear like the JAX renderer.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.common import RenderMode, TonemapCurve, srgb_to_linear
from ngp_tpu_torch.rays.camera import iterative_opencv_undistort
from ngp_tpu_torch.rays.marching import (compact_samples, composite_samples,
                                         march_rays, merge_excess_samples)


@dataclasses.dataclass
class RenderOptions:
    width: int = 1080
    height: int = 1920
    fov_axis_focal: float = 1375.0       # focal length in pixels (x)
    focal_y: Optional[float] = None
    principal: tuple = (0.5, 0.5)
    spp: int = 1
    render_mode: RenderMode = RenderMode.SHADE
    lens_params: tuple = (0.0, 0.0, 0.0, 0.0)   # OpenCV k1 k2 p1 p2
    lens_mode: str = "auto"              # auto | perspective | opencv
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    linear_out: bool = True              # return linear RGB (like run.py eval)
    min_transmittance: float = 1e-4
    chunk: int = 1 << 14                 # rays per pixel chunk
    march_steps: int = 1024
    samples_per_chunk_factor: int = 48   # per-ray sample cap per segment
    march_segments: int = 4              # early-out granularity
    exposure: float = 0.0
    tonemap_curve: TonemapCurve = TonemapCurve.IDENTITY
    snap_to_pixel_centers: bool = False  # eval protocol (ref run.py:228-241)


class NerfRenderer:
    """Renders frames from a NeRF (model + parameters + occupancy bitfield).

    ``aabb_min``/``aabb_size`` are the training AABB's scalar corner and
    side (the trainer's ``0.5 - aabb_scale/2`` and ``aabb_scale``)."""

    def __init__(self, model, aabb_min, aabb_size, cone_angle: float,
                 max_cascade: int, opts: Optional[RenderOptions] = None):
        self.model = model
        # f32 values, and their f32 sum, as the JAX package computes them
        self.aabb_min = float(np.float32(aabb_min))
        self.aabb_size = float(np.float32(aabb_size))
        self.aabb_max = float(np.float32(aabb_min) + np.float32(aabb_size))
        self.cone_angle = cone_angle
        self.max_cascade = max_cascade
        self.opts = opts or RenderOptions()
        if self.opts.render_mode != RenderMode.SHADE:
            raise NotImplementedError(
                f"render mode {self.opts.render_mode.name} is not ported yet")
        if self.opts.lens_mode not in ("auto", "perspective", "opencv"):
            raise NotImplementedError(
                f"lens mode {self.opts.lens_mode!r} is not ported yet")
        if self.opts.tonemap_curve != TonemapCurve.IDENTITY:
            raise NotImplementedError("tonemapping is not ported yet")
        # samples the last ``render`` call sent through the network
        self.last_n_samples = 0

    @classmethod
    def for_trainer(cls, trainer, opts: Optional[RenderOptions] = None):
        """A renderer of a trainer's scene: its model, AABB, cone angle and
        cascades."""
        return cls(trainer.model, trainer.aabb_min, trainer.aabb_size,
                   trainer.cone_angle, trainer.max_cascade, opts)

    def _gen_rays(self, generator, pix0: int, n_rays: int, W: int, H: int,
                  fx: float, fy: float, xf: torch.Tensor, jitter_on: bool):
        """Pixel idx → (o, d) world rays for one chunk, with per-pixel
        jitter (spp > 1) and the OpenCV lens undistortion."""
        opts = self.opts
        dev = xf.device
        cx, cy = opts.principal
        idx = pix0 + torch.arange(n_rays, dtype=torch.int64, device=dev)
        px = (idx % W).to(torch.float32)
        py = (idx // W).to(torch.float32)
        if jitter_on:
            jit = torch.rand((n_rays, 2), generator=generator, device=dev)
            jx, jy = jit[:, 0], jit[:, 1]
        else:
            jx = jy = 0.5
        u = (px + jx) / W
        v = (py + jy) / H
        fx32 = torch.tensor(fx, dtype=torch.float32, device=dev)
        fy32 = torch.tensor(fy, dtype=torch.float32, device=dev)
        dx = (u - cx) * W / fx32
        dy = (v - cy) * H / fy32
        lens_mode = opts.lens_mode
        if lens_mode == "auto":
            lens_mode = ("opencv" if any(abs(p) > 0 for p in
                                         opts.lens_params[:4])
                         else "perspective")
        if lens_mode == "opencv":
            k1, k2, p1, p2 = opts.lens_params[:4]
            dx, dy = iterative_opencv_undistort(dx, dy, k1, k2, p1, p2)
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        d_world = d_cam @ xf[:, :3].T
        o_world = xf[:, 3].expand(n_rays, 3)
        d_world = d_world / (torch.linalg.vector_norm(d_world, dim=-1,
                                                      keepdim=True) + 1e-9)
        return o_world, d_world

    def _render_chunk(self, net, bitfield, xf, bg, generator, pix0: int,
                      jitter_on: bool, fx: float, fy: float, n_rays: int,
                      W: int, H: int):
        """One pixel chunk → (rgb (R,3) in network colour space, opacity
        (R,), samples evaluated)."""
        opts = self.opts
        o, d = self._gen_rays(generator, pix0, n_rays, W, H, fx, fy, xf,
                              jitter_on)
        t, dt, emit = march_rays(
            bitfield, o, d, None, n_rays, opts.march_steps, self.cone_angle,
            self.max_cascade, self.aabb_min, self.aabb_size,
            t_start_min=0.05)

        nseg = max(opts.march_segments, 1)
        seg_len = opts.march_steps // nseg
        dev = o.device
        rgb_acc = torch.zeros((n_rays, 3), device=dev)
        logT = torch.zeros((n_rays,), device=dev)
        total = 0
        for si in range(nseg):
            sl = slice(si * seg_len, (si + 1) * seg_len)
            alive = torch.exp(-logT) > opts.min_transmittance
            emit_s = emit[:, sl] & alive[:, None]
            emit_s, dt_m = merge_excess_samples(
                emit_s, dt[:, sl], opts.samples_per_chunk_factor)
            s_t, s_dt, s_ray, _, _, s_k = compact_samples(t[:, sl], dt_m,
                                                          emit_s)
            total += s_ray.numel()
            pos = o[s_ray] + s_t[:, None] * d[s_ray]
            pos_w = (pos - self.aabb_min) / self.aabb_size
            dir_w = d[s_ray] * 0.5 + 0.5
            rgb_raw, dens_raw = net(pos_w, dir_w)
            rgb = torch.sigmoid(rgb_raw.to(torch.float32))
            sigma = torch.exp(torch.clamp(dens_raw.to(torch.float32),
                                          -15.0, 15.0))
            rgb_seg, opac_seg, _ = composite_samples(
                sigma, rgb, s_dt, s_ray, s_k, n_rays, seg_len)
            rgb_acc = rgb_acc + torch.exp(-logT)[:, None] * rgb_seg
            logT = logT - torch.log(torch.clamp(1.0 - opac_seg, min=1e-10))

        opacity = 1.0 - torch.exp(-logT)
        rgb_out = rgb_acc + torch.exp(-logT)[:, None] * bg[None, :3]
        return rgb_out, opacity, total

    @torch.no_grad()
    def render(self, params: Optional[Mapping[str, torch.Tensor]], bitfield,
               camera_matrix, width: Optional[int] = None,
               height: Optional[int] = None, focal: Optional[tuple] = None,
               spp: Optional[int] = None, seed: int = 0) -> torch.Tensor:
        """Render one frame → (H, W, 4) f32 tensor on the bitfield's device.

        ``params`` maps the model's parameter names to tensors (as
        ``bridge.nerf_params_from_numpy`` returns them); None renders with
        the model's own parameters. camera_matrix: (3,4) NGP-convention
        camera→world. spp > 1 jitters pixels with a ``torch.Generator``
        seeded by ``seed``; spp = 1 goes through pixel centres and draws
        no random numbers.
        """
        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx, fy = (focal or (opts.fov_axis_focal,
                            opts.focal_y or opts.fov_axis_focal))
        n_spp = int(spp or opts.spp)
        dev = bitfield.device
        xf = torch.as_tensor(np.asarray(camera_matrix, np.float32),
                             device=dev)
        bg = torch.tensor(opts.background, dtype=torch.float32, device=dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)

        if params is None:
            net = self.model
        else:
            def net(*args):
                return functional_call(self.model, params, args)

        n_chunks = -(-H * W // eff_chunk)
        acc = torch.zeros((n_chunks * eff_chunk, 4), device=dev)
        self.last_n_samples = 0
        for s in range(n_spp):
            jitter_on = (not opts.snap_to_pixel_centers) and s > 0
            for c in range(n_chunks):
                rgb, opac, n = self._render_chunk(
                    net, bitfield, xf, bg, generator, c * eff_chunk,
                    jitter_on, float(fx), float(fy), eff_chunk, W, H)
                self.last_n_samples += n
                lo = c * eff_chunk
                acc[lo:lo + eff_chunk] += torch.cat([rgb, opac[:, None]],
                                                    -1) / n_spp

        img = acc[:H * W].view(H, W, 4)
        rgb = img[..., :3]
        if opts.exposure != 0.0:
            rgb = rgb * (2.0 ** opts.exposure)
        if opts.linear_out:
            rgb = srgb_to_linear(torch.clamp(rgb, min=0.0))
        return torch.cat([rgb, img[..., 3:]], -1)
