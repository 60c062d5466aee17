"""Single-NeRF renderer (port of ``ngp_tpu/render/nerf_render.py``): the
static path and the wave renderers.

On the static path each pixel chunk marches the closed-form cone lattice through the
occupancy bitfield, then walks the lattice in ``march_segments``
front-to-back segments: saturated rays drop out (transmittance early-out),
rays over the per-segment sample cap are decimated with dt compensation,
the live samples are compacted, evaluated by the network in one batch
and composited with per-ray lattice transmittance. The network outputs
sRGB; exposure and the tonemap curve apply there, then ``linear_out``
converts the frame to linear like the JAX renderer.

Besides SHADE, every render mode of the static path (NORMALS, POSITIONS
with ``show_accel``, DEPTH, AO, COST, ENCODING_VIS, SLICE and DISTORTION),
glow, the render AABB crop, thin-lens depth of field and per-ray motion
blur / rolling shutter between two camera matrices; the perspective,
OpenCV, F-theta and LatLong lenses; VR / lenticular quilting with the
parallax head shift; an environment map behind each ray. NORMALS is the
gradient of the density with respect to the warped position, taken by
autograd through the f32 encode (K1 forward, K3 backward on the card).

Under the int8 encode modes (``encode_int8`` "fwd" or "full", the
trainer's; the JAX encoding reads ``NGP_TPU_ENCODE_INT8``) each frame
quantises the table once and encodes every chunk through the int8 table
(K4 on the card).

Mask3D masks (``render/multi_nerf.py``) scale each sample's alpha, folded
into its optical depth together with glow mode 4's mask.

``render_multichip`` splits a frame's chunks over the data ranks of a
``dist.mesh`` grid and gives every rank the whole frame, ``render``'s.

The wave (live-sample) renderers (``wave``; False by default, as in the
JAX package) evaluate the network on the live samples of a whole ray
instead of the static path's per-segment slot budget, for SHADE, DEPTH,
AO and COST without glow (``_wave_supported``; every other mode renders on
the static path, as in the JAX package). Two dispatches:

- ``wave_dispatch="host"``: work items (chunk, spp) are pipelined: item
  k+1's march (lattice, hierarchical or flat) and its count are enqueued
  before item k's count is read, so the host waits on a march, not on a
  network body. ``wave_sync="bulk"`` reads one count per item;
  ``"exact"`` one per segment. ``wave_fused`` runs one body per ray with
  the whole-ray cap; unfused, ``march_segments`` bodies with the
  transmittance early-out between them.
- ``wave_dispatch="device"``: a group of ``dispatch_chunks`` items marches
  to compacted segment streams (``march_segment_stream``), fits each ray's
  decimation cap on the device so that the kept total fits
  ``wave2_top_bucket``, and composites with a two-level exclusive optical
  depth; the group waits on the host twice, for its segment counts and
  for its kept totals.

The JAX package sizes its streams by power-of-two buckets and bounds
(``wave_hier_frac``, ``wave2_frac``, the bucket list) and falls back to the
flat march where a segment stream overflows. Here (an intended
divergence, as ``compact_samples``') the device dispatch sizes its streams
by the live counts, so nothing overflows and those options do not change
the image; the host dispatch keeps the JAX package's hierarchical segment
bound and its fallback to the flat march (the same lattice, bit for bit),
but, as the JAX device dispatch does, marches flat from the first
overflow on instead of trying the bound again on every chunk. (The
coarse mask is a union over the coarser mips, each dilated: near any
content its finer mips are all set, and it culls little but the segments
past the box.)

Intended divergence: an end camera equal to the start camera renders the
static frame (no per-ray interpolation and no time draws); the JAX
package interpolates between the two equal matrices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.common import (NerfActivation, RenderMode, TonemapCurve,
                                  network_activation, srgb_to_linear)
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.grid.occupancy import mip_from_pos
from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.kernels.blocked_grid import quantize_table_i8
from ngp_tpu_torch.nn.encodings import BlockedGridEncoding
from ngp_tpu_torch.rays.camera import (LENS_MODES, apply_quilting,
                                       f_theta_undistort,
                                       iterative_opencv_undistort,
                                       latlong_to_dir, ray_aabb_intersect,
                                       xform_slerp)
from ngp_tpu_torch.rays.marching import (coarse_segments, compact_samples,
                                         composite_samples, march_rays,
                                         march_rays_hier,
                                         march_segment_stream,
                                         merge_excess_samples, merged_count,
                                         ray_sums, stream_slots)
from ngp_tpu_torch.render.buffer import tonemap
from ngp_tpu_torch.render.multi_nerf import apply_masks
from ngp_tpu_torch.utils.profiling import count, span, spanned


@dataclasses.dataclass
class RenderOptions:
    width: int = 1080
    height: int = 1920
    fov_axis_focal: float = 1375.0       # focal length in pixels (x)
    focal_y: Optional[float] = None
    principal: tuple = (0.5, 0.5)
    spp: int = 1
    render_mode: RenderMode = RenderMode.SHADE
    # OpenCV k1 k2 p1 p2, or F-theta p0..p4 and the native (w, h)
    lens_params: tuple = (0.0, 0.0, 0.0, 0.0)
    lens_mode: str = "auto"   # auto | perspective | opencv | ftheta | latlong
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    linear_out: bool = True              # return linear RGB (like run.py eval)
    min_transmittance: float = 1e-4
    chunk: int = 1 << 14                 # rays per pixel chunk
    march_steps: int = 1024
    samples_per_chunk_factor: int = 48   # per-ray sample cap per segment
    march_segments: int = 4              # early-out granularity
    # thin-lens DoF (ref: pixel_to_ray aperture, common_device.cuh:260-317)
    aperture_size: float = 0.0
    focus_z: float = 1.0
    # crop box (ref: m_render_aabb); None → full training AABB
    render_aabb_min: Optional[tuple] = None
    render_aabb_max: Optional[tuple] = None
    exposure: float = 0.0
    tonemap_curve: TonemapCurve = TonemapCurve.IDENTITY
    snap_to_pixel_centers: bool = False  # eval protocol (ref run.py:228-241)
    # VR / lenticular quilting + parallax head shift (ref: apply_quilting,
    # common_device.cuh:541-560; pixel_to_ray :302-306). quilting_dims
    # (2, 1) is stereo VR (parallax_shift[0] = IPD); larger grids are
    # HoloPlay view fans
    parallax_shift: tuple = (0.0, 0.0, 0.0)
    quilting_dims: tuple = (1, 1)
    slice_plane_z: float = 0.0           # SLICE mode plane offset
    visualized_level: int = 0            # ENCODING_VIS level
    # density-grid visualization in POSITIONS mode (ref: m_nerf.show_accel,
    # testbed_nerf.cu:948-957); −1 = off
    show_accel: int = -1
    # glow bitmask (ref: composite_kernel_nerf :843-940): 1 green grid,
    # 2 cutline, 4 mask-to-alpha, 8 radial, 16 grid-only
    glow_mode: int = 0
    glow_y_cutoff: float = 0.0
    # the wave (live-sample) renderers, with the JAX package's options and
    # defaults (module docstring): the per-ray sample cap per segment
    # (whole-ray cap wave_cap · march_segments when fused); one body per
    # ray; one count per item ("bulk") or per segment ("exact"); the
    # host-dispatch march, "hier" (coarse-mask segment culling, its segment
    # stream bound R·K/8/wave_hier_frac) or "flat"
    wave: bool = False
    wave_cap: int = 64
    wave_fused: bool = True
    wave_sync: str = "bulk"
    wave_march: str = "hier"
    wave_hier_frac: int = 8
    # "device" (compacted segment streams, decimation fitted on the device,
    # two host waits per group of dispatch_chunks items) or "host"
    wave_dispatch: str = "device"
    # the JAX package's segment stream bound R·K/8/wave2_frac: sizes
    # buffers there only; here the streams are sized by the live counts
    wave2_frac: int = 2
    # the device dispatch's largest sample stream per chunk: beyond it the
    # per-ray cap halves on the device until the kept total fits
    wave2_top_bucket: int = 1 << 18
    dispatch_chunks: int = 16


class RayDraws(NamedTuple):
    """The random numbers of one chunk's rays, all in [0, 1); None where
    the frame draws none: pixel jitter (R, 2) (None → pixel centres),
    shutter time (R,) (None → no motion) and the lens sample (R, 2) (None
    → pinhole). The JAX package draws them from ``jax.random.split(key,
    3)`` in this order."""
    jitter: Optional[torch.Tensor] = None
    time: Optional[torch.Tensor] = None
    lens: Optional[torch.Tensor] = None


class NerfRenderer:
    """Renders frames from a NeRF (model + parameters + occupancy bitfield).

    ``aabb_min``/``aabb_size`` are the training AABB's scalar corner and
    side (the trainer's ``0.5 - aabb_scale/2`` and ``aabb_scale``).
    ``envmap_sampler`` maps (N, 3) unit directions to the (N, 4) RGBA
    environment behind each ray, blended over the background.
    ``distortion_sampler`` maps (N, 2) screen uv to the learned (N, 2) ray
    offset the DISTORTION mode shows. ``masks`` is a list of
    ``multi_nerf.Mask3D``. ``encode_int8`` is the int8 encode mode
    (``""``, ``"fwd"`` or ``"full"``; a blocked grid's only)."""

    def __init__(self, model, aabb_min, aabb_size, cone_angle: float,
                 max_cascade: int, opts: Optional[RenderOptions] = None,
                 masks=None, envmap_sampler: Optional[Callable] = None,
                 distortion_sampler: Optional[Callable] = None,
                 encode_int8: str = ""):
        self.model = model
        # f32 values, and their f32 sum, as the JAX package computes them
        self.aabb_min = float(np.float32(aabb_min))
        self.aabb_size = float(np.float32(aabb_size))
        self.aabb_max = float(np.float32(aabb_min) + np.float32(aabb_size))
        self.cone_angle = cone_angle
        self.max_cascade = max_cascade
        self.opts = opts = opts or RenderOptions()
        self.envmap_sampler = envmap_sampler
        self.distortion_sampler = distortion_sampler
        self.masks = list(masks or [])
        for name, allowed in (("wave_sync", ("bulk", "exact")),
                              ("wave_march", ("hier", "flat")),
                              ("wave_dispatch", ("device", "host"))):
            if getattr(opts, name) not in allowed:
                raise ValueError(f"{name} {getattr(opts, name)!r} is not one "
                                 f"of {allowed}")
        if opts.lens_mode not in ("auto",) + LENS_MODES:
            raise ValueError(f"lens mode {opts.lens_mode!r} is not one of "
                             f"{('auto',) + LENS_MODES}")
        blocked_grid_cuda.check_int8_mode(encode_int8)
        if encode_int8 and not isinstance(model.pos_encoding,
                                          BlockedGridEncoding):
            raise ValueError("the int8 encode modes exist for the blocked "
                             "grid only")
        self.encode_int8 = encode_int8
        # samples the last ``render`` call sent through the network, and
        # the host's waits on events of its own (the wave host dispatch's
        # count reads; a sync the card's sync debug mode does not see)
        self.last_n_samples = 0
        self.last_event_waits = 0
        self._wave_samples = 0
        # set once a chunk's hierarchical segment stream overflowed: the
        # host dispatch then marches flat (the same lattice) from there on
        self._wave_flat_sticky = False
        self._crop_box = None

    @classmethod
    def for_trainer(cls, trainer, opts: Optional[RenderOptions] = None,
                    **kw):
        """A renderer of a trainer's scene: its model, AABB, cone angle,
        cascades and int8 encode mode."""
        kw.setdefault("encode_int8", trainer.tcfg.encode_int8)
        return cls(trainer.model, trainer.aabb_min, trainer.aabb_size,
                   trainer.cone_angle, trainer.max_cascade, opts, **kw)

    # ------------------------------------------------------------------
    # ray generation
    # ------------------------------------------------------------------

    @spanned("ngp.sample")
    def draws(self, generator, n_rays: int, jitter_on: bool, motion: bool,
              device) -> RayDraws:
        """One chunk's random numbers from ``generator``, in the order
        jitter, time, lens; none at all for an spp-1 pinhole still."""
        def u(*shape):
            return torch.rand(shape, generator=generator, device=device)
        return RayDraws(u(n_rays, 2) if jitter_on else None,
                        u(n_rays) if motion else None,
                        u(n_rays, 2) if self.opts.aperture_size > 0.0
                        else None)

    @spanned("ngp.sample")
    def _gen_rays(self, pix0: int, n_rays: int, W: int, H: int, fx: float,
                  fy: float, xf: torch.Tensor, draws: RayDraws = RayDraws(),
                  xf_end: Optional[torch.Tensor] = None,
                  rolling_shutter=(0.0, 0.0, 0.0, 1.0)):
        """Pixel idx → (o, d, u, v): world rays of one chunk and their
        screen position within their panel, with quilting and the parallax
        head shift, per-pixel jitter, the lens (OpenCV undistortion,
        F-theta, LatLong), per-ray camera interpolation towards ``xf_end``
        (``pixel_t = rs.x + rs.y·u + rs.z·v + rs.w·time``) and thin-lens
        depth of field."""
        opts = self.opts
        dev = xf.device
        cx, cy = opts.principal
        idx = pix0 + torch.arange(n_rays, dtype=torch.int64, device=dev)
        px = (idx % W).to(torch.float32)
        py = (idx // W).to(torch.float32)
        qx, qy = (int(q) for q in opts.quilting_dims)
        We, He = W, H
        ps = None           # the per-ray parallax shift, where there is one
        if (qx, qy) != (1, 1):
            px, py, ps = apply_quilting(px, py, (W, H), opts.parallax_shift,
                                        (qx, qy))
            We, He = W // qx, H // qy
        elif any(opts.parallax_shift):
            ps = torch.tensor(opts.parallax_shift, dtype=torch.float32,
                              device=dev).expand(n_rays, 3)
        if draws.jitter is not None:
            jx, jy = draws.jitter[:, 0], draws.jitter[:, 1]
        else:
            jx = jy = 0.5
        u = (px + jx) / We
        v = (py + jy) / He
        lens_mode = opts.lens_mode
        if lens_mode == "auto":
            lens_mode = ("opencv" if any(abs(p) > 0 for p in
                                         opts.lens_params[:4])
                         else "perspective")
        if lens_mode == "latlong":
            d_cam = latlong_to_dir(torch.stack([u, v], -1))
        elif lens_mode == "ftheta":
            lp = torch.tensor(opts.lens_params, dtype=torch.float32,
                              device=dev).expand(n_rays, 7)
            d_cam = f_theta_undistort(torch.stack([u - cx, v - cy], -1), lp,
                                      lp.new_tensor([0.0, 0.0, 1.0]))
        else:
            # f32 divisors like the JAX package's; filled on the device (a
            # host tensor copied to the card waits for it)
            fx32 = torch.full((), fx, dtype=torch.float32, device=dev)
            fy32 = torch.full((), fy, dtype=torch.float32, device=dev)
            dx = (u - cx) * We / fx32
            dy = (v - cy) * He / fy32
            if lens_mode == "opencv":
                k1, k2, p1, p2 = opts.lens_params[:4]
                dx, dy = iterative_opencv_undistort(dx, dy, k1, k2, p1, p2)
            d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        if draws.time is None and draws.lens is None and ps is None:
            d_world = d_cam @ xf[:, :3].T
            o_world = xf[:, 3].expand(n_rays, 3)
        else:
            if draws.time is not None:
                rs = rolling_shutter
                pixel_t = torch.clamp(rs[0] + rs[1] * u + rs[2] * v
                                      + rs[3] * draws.time, 0.0, 1.0)
                xfs = xform_slerp(xf, xf_end, pixel_t)       # (N, 3, 4)
            else:
                xfs = xf.expand(n_rays, 3, 4)
            if ps is not None:
                # the parallax head shift (ref: pixel_to_ray :302-306):
                # rays leave the camera-space head position and tilt
                # toward it
                o_cam = torch.cat([ps[:, :2], torch.zeros_like(ps[:, :1])],
                                  -1)
                d_cam = d_cam - o_cam * ps[:, 2:3]
            else:
                o_cam = torch.zeros_like(d_cam)
            if draws.lens is not None:
                # Shirley square→disk (ref: square2disk_shirley)
                ab = draws.lens * 2.0 - 1.0
                a, b = ab[:, 0], ab[:, 1]
                cond = torch.abs(a) > torch.abs(b)
                r = torch.where(cond, a, b)
                phi = torch.where(
                    cond, (math.pi / 4) * (b / torch.where(a == 0, 1.0, a)),
                    (math.pi / 2) - (math.pi / 4)
                    * (a / torch.where(b == 0, 1.0, b)))
                blur = opts.aperture_size * torch.stack(
                    [r * torch.cos(phi), r * torch.sin(phi)], -1)
                lookat = o_cam + d_cam * opts.focus_z
                o_cam = o_cam + torch.cat(
                    [blur, torch.zeros_like(blur[:, :1])], -1)
                d_cam = (lookat - o_cam) / opts.focus_z
            d_world = torch.einsum("nij,nj->ni", xfs[:, :, :3], d_cam)
            o_world = xfs[:, :, 3] + torch.einsum("nij,nj->ni",
                                                  xfs[:, :, :3], o_cam)
        d_world = d_world / (torch.linalg.vector_norm(d_world, dim=-1,
                                                      keepdim=True) + 1e-9)
        return o_world, d_world, u, v

    # ------------------------------------------------------------------
    # one chunk
    # ------------------------------------------------------------------

    def _normals_rgb(self, params, pos_w: torch.Tensor) -> torch.Tensor:
        """Surface normals from the density gradient with respect to the
        warped position, colour-coded as n·0.5 + 0.5. Only the positions
        carry a gradient (K3 on the card; no table or weight gradient)."""
        frozen = {k: v.detach() for k, v in params.items()}
        with torch.enable_grad():
            pw = pos_w.detach().requires_grad_()
            raw = functional_call(self.model, frozen, (pw,))[..., 0]
            dens = network_activation(raw, NerfActivation.EXPONENTIAL)
            g, = torch.autograd.grad(dens.sum(), pw)
        nrm = -g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-9)
        return nrm * 0.5 + 0.5

    def _encoding_rgb(self, params, pos_w: torch.Tensor,
                      quantized=None) -> torch.Tensor:
        """|features| of one hash level at each sample (ref:
        visualize_activation / EncodingVis), through the int8 table when
        the frame has one."""
        enc = self.model.pos_encoding
        if quantized is not None:
            feats = blocked_grid_cuda.encode_quantized(
                *quantized, pos_w.contiguous(), enc.meta)
        else:
            feats = blocked_grid_cuda.blocked_grid_encode(
                params["pos_encoding.table"], pos_w.contiguous(), enc.meta)
        lvl = self.opts.visualized_level
        f = feats[:, 2 * lvl: 2 * lvl + 2].to(torch.float32)
        return torch.stack([torch.abs(f[:, 0]), torch.abs(f[:, 1]),
                            torch.abs(f).mean(-1)], -1) * 16.0

    def _accel_rgb(self, pos: torch.Tensor) -> torch.Tensor:
        """POSITIONS with ``show_accel``: each sample coloured by its
        occupancy-grid mip and a hash of its cell (ref: show_accel branch,
        testbed_nerf.cu:948-957), in uint32 arithmetic."""
        mip = torch.clamp(mip_from_pos(pos, self.max_cascade),
                          min=self.opts.show_accel)
        res = (128 >> torch.clamp(mip, 0, 7)).to(torch.float32)
        cell = (pos * res[:, None]).to(torch.int32).to(torch.int64)
        seed = (cell[:, 0] + cell[:, 1] * 232323 + cell[:, 2] * 727272) \
            & 0xFFFFFFFF

        def hash8(mult: int) -> torch.Tensor:
            # (seed · mult) mod 2^32 in int64 halves, then the top byte
            lo = (seed & 0xFFFF) * mult
            hi = ((seed >> 16) * mult) & 0xFFFF
            return ((lo + (hi << 16)) & 0xFFFFFFFF) >> 24
        mipf = mip.to(torch.float32)
        return torch.stack([1.0 - mipf / 7.0,
                            hash8(2654435761).to(torch.float32) / 255.0,
                            hash8(805459861).to(torch.float32) / 255.0], -1)

    def _slice_mode(self, net, o, d, xf, bg):
        """SLICE: rgbσ on the plane through the scene centre offset by
        ``slice_plane_z`` along the camera's forward axis; no marching
        (ref: testbed_nerf.cu:2412-2476)."""
        fwd = xf[:, 2]
        center = torch.tensor([0.5, 0.5, 0.5], device=o.device) \
            + self.opts.slice_plane_z * fwd
        denom = d @ fwd
        tp = ((center - o) @ fwd) / torch.where(torch.abs(denom) < 1e-6,
                                                1e-6, denom)
        pos = o + tp[:, None] * d
        pos_w = (pos - self.aabb_min) / self.aabb_size
        inside = torch.all((pos_w >= 0) & (pos_w <= 1), -1) & (tp > 0)
        rgb_raw, dens_raw = net(pos_w, d * 0.5 + 0.5)
        rgb = torch.sigmoid(rgb_raw.to(torch.float32))
        sigma = torch.exp(torch.clamp(dens_raw.to(torch.float32), -15., 15.))
        alpha = torch.where(inside, 1.0 - torch.exp(-sigma * 0.01), 0.0)
        rgb_out = rgb * alpha[:, None] + bg[None, :3] * (1 - alpha[:, None])
        return rgb_out, alpha, 0

    def _render_chunk(self, net, params, bitfield, xf, bg, draws: RayDraws,
                      pix0: int, fx: float, fy: float, n_rays: int, W: int,
                      H: int, xf_end=None, rolling_shutter=None,
                      quantized=None):
        """One pixel chunk → (rgb (R,3) in network colour space, opacity
        (R,), samples evaluated). ``quantized`` is the frame's int8 table,
        where it has one."""
        opts = self.opts
        mode = opts.render_mode
        o, d, u, v = self._gen_rays(pix0, n_rays, W, H, fx, fy, xf, draws,
                                    xf_end, rolling_shutter)
        dev = o.device
        if mode == RenderMode.SLICE:
            return self._slice_mode(net, o, d, xf, bg)
        if mode == RenderMode.DISTORTION:
            # the learned ray-distortion grid as a 2D flow
            # (ref: ERenderMode::Distortion overlay)
            off = (self.distortion_sampler(torch.stack([u, v], -1))
                   if self.distortion_sampler is not None
                   else torch.zeros((n_rays, 2), device=dev))
            rgb = torch.cat([0.5 + off * 10.0,
                             torch.full((n_rays, 1), 0.5, device=dev)], -1)
            return rgb, torch.ones((n_rays,), device=dev), 0
        with span("ngp.march"):
            t, dt, emit = march_rays(
                bitfield, o, d, None, n_rays, opts.march_steps,
                self.cone_angle, self.max_cascade, self.aabb_min,
                self.aabb_size, t_start_min=0.05)
            emit = self._crop(o, d, t, emit)
        bg_ray = self._bg_rays(d, bg)

        nseg = max(opts.march_segments, 1)
        seg_len = opts.march_steps // nseg
        rgb_acc = torch.zeros((n_rays, 3), device=dev)
        depth_acc = torch.zeros((n_rays,), device=dev)
        cost_acc = torch.zeros((n_rays,), device=dev)
        logT = torch.zeros((n_rays,), device=dev)
        total = 0
        for si in range(nseg):
            sl = slice(si * seg_len, (si + 1) * seg_len)
            alive = torch.exp(-logT) > opts.min_transmittance
            emit_s = emit[:, sl] & alive[:, None]
            emit_s, dt_m = merge_excess_samples(
                emit_s, dt[:, sl], opts.samples_per_chunk_factor)
            s_t, s_dt, s_ray, counts, _, s_k = compact_samples(t[:, sl], dt_m,
                                                               emit_s)
            total += s_ray.numel()
            pos, pos_w, rgb, sigma = self._shade(net, o, d, s_ray, s_t)
            if mode == RenderMode.NORMALS:
                rgb = self._normals_rgb(params, pos_w)
            elif mode == RenderMode.ENCODING_VIS:
                rgb = self._encoding_rgb(params, pos_w, quantized)
            elif mode == RenderMode.POSITIONS:
                rgb = self._accel_rgb(pos) if opts.show_accel >= 0 else pos_w
            if mode == RenderMode.POSITIONS and opts.show_accel >= 0:
                # every sample opaque, so the first cell wins
                sigma = torch.full_like(sigma, 1e6)
            alpha_mult = self._alpha_mult(pos)
            if opts.glow_mode:
                rgb, glow_mask = apply_glow(rgb, pos, xf[:, 3],
                                            opts.glow_mode,
                                            opts.glow_y_cutoff)
                if opts.glow_mode & 4:
                    alpha_mult = (glow_mask if alpha_mult is None
                                  else alpha_mult * glow_mask)
            s_dt_eff = _fold_alpha(sigma, s_dt, alpha_mult)
            rgb_seg, opac_seg, w = composite_samples(
                sigma, rgb, s_dt_eff, s_ray, s_k, n_rays, seg_len)
            T_in = torch.exp(-logT)
            rgb_acc = rgb_acc + T_in[:, None] * rgb_seg
            if mode == RenderMode.DEPTH:
                depth_acc = depth_acc + T_in * ray_sums(
                    w * s_t, s_ray, s_k, n_rays, seg_len)
            cost_acc = cost_acc + counts.to(torch.float32)
            logT = logT - torch.log(torch.clamp(1.0 - opac_seg, min=1e-10))

        opacity = 1.0 - torch.exp(-logT)
        rgb_out = self._mode_rgb(rgb_acc + torch.exp(-logT)[:, None] * bg_ray,
                                 opacity, depth_acc, cost_acc)
        return rgb_out, opacity, total

    @spanned("ngp.network")
    def _shade(self, net, o, d, rid, s_t):
        """The network on a sample stream, at ray ``rid[i]``'s point at
        time ``s_t[i]``: (the points, the same in the unit cube, colour
        (the sigmoid of the network's), density σ)."""
        pos = o[rid] + s_t[:, None] * d[rid]
        pos_w = (pos - self.aabb_min) / self.aabb_size
        rgb_raw, dens_raw = net(pos_w, d[rid] * 0.5 + 0.5)
        return pos, pos_w, torch.sigmoid(rgb_raw.to(torch.float32)), \
            torch.exp(torch.clamp(dens_raw.to(torch.float32), -15.0, 15.0))

    def _alpha_mult(self, pos):
        """The masks' alpha multiplier at each point, or None."""
        return apply_masks(self.masks, pos) if self.masks else None

    def _crop(self, o, d, t, emit, ray=None):
        """``emit`` cut to the render AABB crop, where there is one (its
        corners on the device, made once a frame by ``render``): ``t`` rows
        are rays, or ``ray[row]``'s samples."""
        if self._crop_box is None:
            return emit
        ct0, ct1 = ray_aabb_intersect(o, d, *self._crop_box)
        if ray is not None:
            ct0, ct1 = ct0[ray], ct1[ray]
        return emit & (t >= ct0[:, None]) & (t <= ct1[:, None])

    def _bg_rays(self, d, bg):
        """The environment, or the constant background, behind each ray."""
        if self.envmap_sampler is None:
            return bg[None, :3]
        env = self.envmap_sampler(d)
        return env[:, :3] + bg[None, :3] * (1.0 - env[:, 3:4])

    def _mode_rgb(self, rgb, opacity, depth, cost):
        """A chunk's output colour in the render mode: the composite, or
        DEPTH, AO or COST as grey."""
        mode, n_rays = self.opts.render_mode, opacity.shape[0]
        if mode == RenderMode.DEPTH:
            return (depth / torch.clamp(opacity, min=1e-6))[:, None].expand(
                n_rays, 3)
        if mode == RenderMode.AO:
            return opacity[:, None].expand(n_rays, 3)
        if mode == RenderMode.COST:
            return (cost.to(torch.float32)[:, None] / 128.0).expand(n_rays, 3)
        return rgb

    # ------------------------------------------------------------------
    # the wave (live-sample) renderers
    # ------------------------------------------------------------------

    def _wave_supported(self) -> bool:
        """The JAX package's rule: SHADE, DEPTH, AO and COST without glow
        render on the wave path, with ``march_steps`` a multiple of 8 on the
        device dispatch and of ``march_segments`` on the unfused host one;
        everything else on the static path."""
        o = self.opts
        if not (o.wave and o.glow_mode == 0 and o.render_mode in (
                RenderMode.SHADE, RenderMode.DEPTH, RenderMode.AO,
                RenderMode.COST)):
            return False
        if o.wave_dispatch == "device":
            return o.march_steps % 8 == 0
        return o.wave_fused or o.march_steps % max(o.march_segments, 1) == 0

    @property
    def last_wave_samples(self) -> int:
        """The samples the last wave frame composited (the JAX package's
        count: exact on the host dispatch, the decimated per-ray counts
        on the device one). The host dispatch keeps it on the device and
        reads it here, when asked, not inside ``render``."""
        return int(self._wave_samples)

    def _wave_layout(self):
        """(segments, steps a segment, per-ray cap) of the host dispatch:
        one segment with the whole-ray cap when fused."""
        o = self.opts
        if o.wave_fused:
            return 1, o.march_steps, min(
                o.wave_cap * max(o.march_segments, 1), o.march_steps)
        nseg = max(o.march_segments, 1)
        return nseg, o.march_steps // nseg, o.wave_cap

    @spanned("ngp.march")
    def _wave_march(self, bitfield, coarse, o, d, hier: bool):
        """The host dispatch's march of one chunk: (t, dt, emit) on the
        (R, K) lattice, cut to the crop, and the hierarchical march's
        surviving-segment total with its bound (None on the flat march)."""
        opts, n_rays = self.opts, o.shape[0]
        args = (n_rays, opts.march_steps, self.cone_angle, self.max_cascade,
                self.aabb_min, self.aabb_size)
        if hier:
            bound = max(n_rays * (opts.march_steps // 8)
                        // max(opts.wave_hier_frac, 1), 512)
            t, dt, emit, seg_total = march_rays_hier(
                bitfield, coarse, o, d, None, *args, t_start_min=0.05,
                seg_capacity=bound)
            segs = (seg_total, bound)
        else:
            t, dt, emit = march_rays(bitfield, o, d, None, *args,
                                     t_start_min=0.05)
            segs = None
        return t, dt, self._crop(o, d, t, emit), segs

    def _wave_bounds(self, emit):
        """Per segment, the samples the body can keep: Σ over rays of what
        ``merge_excess_samples`` keeps of the ray's live samples. The
        early-out only drops whole rays, so this bounds the body's count,
        and it is the count itself where no ray has saturated (always when
        fused). The JAX package's bound is Σ min(live, cap); either only
        sizes the body's stream."""
        nseg, seg_len, cap = self._wave_layout()
        live = emit.view(emit.shape[0], nseg, seg_len).sum(-1)
        return merged_count(live, cap).sum(0)

    def _to_host(self, x: torch.Tensor):
        """Start copying ``x`` to the host without waiting: into pinned
        memory behind an event on the card; ``_read_host`` waits for it."""
        if not x.is_cuda:
            return x, None
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    @spanned("ngp.wait")
    def _read_host(self, pending) -> list:
        buf, event = pending
        if event is not None:
            event.synchronize()
            self.last_event_waits += 1
        return buf.tolist()

    def _wave_start(self, bitfield, coarse, bg, o, d) -> dict:
        """Phase 1 of a host-dispatch work item: the march and, under
        "bulk", the per-segment bounds and the segment total on their way
        to the host. Nothing here waits."""
        opts = self.opts
        t, dt, emit, segs = self._wave_march(
            bitfield, coarse, o, d,
            opts.wave_march == "hier" and not self._wave_flat_sticky)
        st = dict(o=o, d=d, t=t, dt=dt, emit=emit, segs=segs,
                  bg_ray=self._bg_rays(d, bg))
        if opts.wave_sync == "bulk":
            with span("ngp.march"):
                seg_total = (segs[0] if segs else
                             emit.new_zeros((), dtype=torch.int64))
                st["counts"] = self._to_host(torch.cat(
                    [self._wave_bounds(emit), seg_total.view(1)]))
        return st

    def _wave_finish(self, net, bitfield, coarse, st):
        """Phase 2: read the item's counts (the one host wait under
        "bulk"; one per segment under "exact"), redo the march flat where
        the hierarchical segment stream overflowed its bound (as the JAX
        package does; the flat march gives the same lattice) and march
        flat from then on (an intended divergence, as the JAX device
        dispatch sticks to its flat program: the JAX host dispatch tries
        the hierarchical march on every chunk and waits twice on each
        that overflows), and run the
        compact → network → composite body per segment with the
        transmittance early-out. Returns (rgb, opacity, composited
        samples (a device scalar), samples evaluated)."""
        opts = self.opts
        nseg, seg_len, cap = self._wave_layout()
        o, d, t, dt, emit, segs = (st[k] for k in ("o", "d", "t", "dt",
                                                  "emit", "segs"))
        bulk = opts.wave_sync == "bulk"
        if bulk:
            *bounds, seg_total = self._read_host(st["counts"])
        elif segs is not None:
            seg_total = int(segs[0])
        if segs is not None and seg_total > segs[1]:
            self._wave_flat_sticky = True
            t, dt, emit, _ = self._wave_march(bitfield, coarse, o, d, False)
            if bulk:
                with span("ngp.wait"):
                    bounds = self._wave_bounds(emit).tolist()
        n_rays, dev = o.shape[0], o.device
        with span("ngp.composite"):
            logT = torch.zeros((n_rays,), device=dev)
            rgb_acc = torch.zeros((n_rays, 3), device=dev)
            depth_acc = torch.zeros((n_rays,), device=dev)
            cost_acc = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
        evaluated = 0
        for si in range(nseg):
            if bulk and bounds[si] == 0:
                continue
            sl = slice(si * seg_len, (si + 1) * seg_len)
            with span("ngp.march"):
                alive = torch.exp(-logT) > opts.min_transmittance
                keep, dt_m = merge_excess_samples(
                    emit[:, sl] & alive[:, None], dt[:, sl], cap)
                total = bounds[si] if bulk else int(keep.sum())
            if total == 0:
                continue
            evaluated += total
            logT = self._wave_body(net, o, d, t[:, sl], dt_m, keep, total,
                                   logT, rgb_acc, depth_acc)
            with span("ngp.composite"):
                cost_acc += keep.sum(1)
        with span("ngp.composite"):
            opacity = 1.0 - torch.exp(-logT)
            rgb = self._mode_rgb(
                rgb_acc + torch.exp(-logT)[:, None] * st["bg_ray"], opacity,
                depth_acc, cost_acc)
            return rgb, opacity, cost_acc.sum(), evaluated

    def _wave_body(self, net, o, d, t, dt, keep, S: int, logT, rgb_acc,
                   depth_acc):
        """One segment's kept samples compacted into a stream of ``S`` ≥
        their count (slots past them evaluate and weigh nothing), the
        network, the masks, and the composite with lattice transmittance
        and fixed-order per-ray sums, accumulated behind the segments
        before it (``rgb_acc``, ``depth_acc`` in place). Returns the
        optical depth behind the segment."""
        n_rays, L = t.shape
        with span("ngp.march"):
            slots = stream_slots(keep, S)
            valid = slots < n_rays * L
            s_ray, s_k = slots // L, slots % L      # row n_rays past them
            flat = torch.clamp(slots, max=n_rays * L - 1)
            s_t = t.reshape(-1)[flat]
            s_dt = torch.where(valid, dt.reshape(-1)[flat], 0.0)
        pos, _, rgb, sigma = self._shade(
            net, o, d, torch.clamp(s_ray, max=n_rays - 1), s_t)
        with span("ngp.composite"):
            s_dt = _fold_alpha(sigma, s_dt, self._alpha_mult(pos))
            # the slots past the kept samples write to a spare row n_rays
            rgb_seg, opac_seg, w = composite_samples(sigma, rgb, s_dt, s_ray,
                                                     s_k, n_rays + 1, L)
            T_in = torch.exp(-logT)
            rgb_acc += T_in[:, None] * rgb_seg[:n_rays]
            if self.opts.render_mode == RenderMode.DEPTH:
                depth_acc += T_in * ray_sums(w * s_t, s_ray, s_k, n_rays + 1,
                                             L)[:n_rays]
            return logT - torch.log(torch.clamp(1.0 - opac_seg[:n_rays],
                                                min=1e-10))

    def _render_wave_host(self, net, bitfield, bg, rays, n_items: int, add):
        """The host dispatch over ``n_items`` work items, pipelined: item
        k+1's march and count are enqueued before item k's count is read."""
        with span("ngp.march"):
            coarse = _coarse_mask(bitfield)
        samples, evaluated = [], 0
        st = self._wave_start(bitfield, coarse, bg, *rays(0))
        for k in range(n_items):
            nxt = (self._wave_start(bitfield, coarse, bg, *rays(k + 1))
                   if k + 1 < n_items else None)
            rgb, opac, n, n_eval = self._wave_finish(net, bitfield, coarse,
                                                     st)
            add(k, rgb, opac)
            samples.append(n)
            evaluated += n_eval
            st = nxt
        self._wave_samples = torch.stack(samples).sum()
        self.last_n_samples = evaluated

    def _wave2_layout(self, n_rays: int):
        """(steps a segment, segments a ray, per-ray cap, top, candidate
        caps) of the device dispatch: 8-step segments, or one segment of
        the whole ray on the flat march; ``top`` the largest sample stream
        of a chunk (``wave2_top_bucket`` rounded up to a power of two) and
        the halving caps the fit may fall back to, as the JAX package picks
        them (its top bucket; the buckets below it only size its
        buffers)."""
        o = self.opts
        K = o.march_steps
        seg = K if o.wave_march == "flat" else 8
        cap = min(o.wave_cap * max(o.march_segments, 1), K)
        top = min(max(o.wave2_top_bucket, 4096),
                  1 << (n_rays * cap - 1).bit_length())
        top = 1 << (top - 1).bit_length()     # the bucket that holds it
        cands = [cap]
        while n_rays * cands[-1] > top and cands[-1] > 1:
            cands.append(max(cands[-1] // 2, 1))
        return seg, K // seg, cap, top, len(cands)

    @spanned("ngp.march")
    def _wave2_stream(self, bitfield, coarse, o, d, segments, n_segs: int):
        """Stage 2 of a device-dispatch item: the segment stream of its
        ``n_segs`` live segments (the whole lattice on the flat march),
        each ray's live count and each sample's rank along its ray, and the
        decimation cap fitted on the device so that the kept total fits the
        top stream: d(c, cap') = ceil(c / ceil(c / cap')) kept per ray,
        the first of the halving caps whose total fits (else the cap
        itself, whose stream the top one cuts, as the JAX package's).
        No host sync."""
        opts, n_rays = self.opts, o.shape[0]
        seg, _, cap, top, n_cands = self._wave2_layout(n_rays)
        args = (n_rays, opts.march_steps, self.cone_angle, self.max_cascade,
                self.aabb_min, self.aabb_size)
        if segments is None:
            t_s, dt_s, emit_s = march_rays(bitfield, o, d, None, *args,
                                           t_start_min=0.05)
            seg_ray = torch.arange(n_rays, device=o.device)
            seg_k = torch.zeros_like(seg_ray)
        else:
            _, _, seg_ray, seg_k, t_s, dt_s, emit_s, _ = march_segment_stream(
                bitfield, coarse, o, d, *args, n_segs, seg=seg,
                t_start_min=0.05, segments=segments)
        rid0 = torch.clamp(seg_ray, max=n_rays - 1)
        emit_s = self._crop(o, d, t_s, emit_s, rid0)

        # per-ray live counts (exact integers; the stream is ray-major and
        # each ray's segments rise, so a stream-wide cumsum less the ray's
        # base is each sample's rank along its ray)
        c_ray = torch.zeros((n_rays + 1,), dtype=torch.int64,
                            device=o.device).index_add_(
            0, seg_ray, emit_s.sum(1))[:n_rays]
        base = torch.cumsum(c_ray, 0) - c_ray
        rank = (torch.cumsum(emit_s.reshape(-1), 0) - 1).view(
            emit_s.shape) - base[rid0][:, None]

        cands = torch.full((n_cands,), cap, dtype=torch.int64,
                           device=o.device) >> torch.arange(
            n_cands, device=o.device)
        d_j = merged_count(c_ray[:, None], cands[None])           # (R, J)
        tot_j = d_j.sum(0)
        over = tot_j[0] > top
        # the first cap that fits, picked on the device (a 0-dim tensor as
        # an index would be read on the host)
        j_fit = torch.argmax((tot_j <= top).to(torch.int32)).view(1)
        capx = torch.where(over, cands.index_select(0, j_fit)[0], cap)
        dcnt = torch.where(over, d_j.index_select(1, j_fit)[:, 0], d_j[:, 0])
        m = torch.clamp(-torch.div(-c_ray, capx, rounding_mode="floor"),
                        min=1)[rid0][:, None]
        keep = emit_s & (torch.remainder(rank, m) == 0)
        grp = torch.minimum(m, c_ray[rid0][:, None] - rank).to(dt_s.dtype)
        return dict(o=o, d=d, seg_ray=seg_ray, seg_k=seg_k, rid0=rid0,
                    t_s=t_s, dt_eff=torch.where(keep, dt_s * grp, dt_s),
                    keep=keep, dcnt=dcnt, total=dcnt.sum())

    def _wave2_composite(self, net, st, S: int, bg):
        """Stage 3 of a device-dispatch item: the kept samples compacted
        into a stream of ``S`` (the kept total, cut to the top stream), the
        network and the masks, the exclusive optical depth in two levels (a
        prefix within each segment on the (S1, seg) stream, then a prefix
        over each ray's segments on an (R, K/seg) lattice), and per-ray
        sums in the same two fixed-order levels. Returns (rgb, opacity)."""
        o, d, seg_ray, seg_k, rid0 = (st[k] for k in ("o", "d", "seg_ray",
                                                      "seg_k", "rid0"))
        n_rays = o.shape[0]
        S1, seg = st["keep"].shape
        n_seg = self.opts.march_steps // seg
        bg_ray = self._bg_rays(d, bg)
        if S == 0:
            with span("ngp.composite"):
                zero = torch.zeros((n_rays,), device=o.device)
                return self._mode_rgb(bg_ray.expand(n_rays, 3), zero, zero,
                                      st["dcnt"]), zero
        with span("ngp.march"):
            slots = stream_slots(st["keep"], S)
            v = slots < S1 * seg
            row, kk = slots // seg, slots % seg      # row S1 past the kept
            row0 = torch.clamp(row, max=S1 - 1)
            flat = torch.clamp(slots, max=S1 * seg - 1)
            s_t = st["t_s"].reshape(-1)[flat]
        pos, _, rgb, sigma = self._shade(net, o, d, rid0[row0], s_t)
        with span("ngp.composite"):
            s_dt = _fold_alpha(sigma, st["dt_eff"].reshape(-1)[flat],
                               self._alpha_mult(pos))
            sdt = torch.where(v, sigma * s_dt, 0.0)

            def ray_total(x):
                """Per-ray sums of the stream's x, in segment then ray
                order."""
                per_seg = ray_sums(x, row, kk, S1 + 1, seg)[:S1]
                return ray_sums(per_seg, seg_ray, seg_k, n_rays + 1,
                                n_seg)[:n_rays]

            # the prefixes run down the columns of (step, segment) and
            # (segment, ray) lattices: the card's scan along rows of 8 or K/8
            # took ~4 ms a chunk, along the outer dimension a fraction of it
            lat = sdt.new_zeros((seg, S1 + 1))
            lat[kk, row] = sdt
            in_seg = torch.cumsum(lat, 0) - lat
            lat2 = sdt.new_zeros((n_seg, n_rays + 1))
            lat2[seg_k, seg_ray] = lat[:, :S1].sum(0)
            before = torch.cumsum(lat2, 0) - lat2
            excl = before[seg_k[row0], rid0[row0]] + in_seg[kk, row]
            w = torch.where(v, torch.exp(-excl) * (1.0 - torch.exp(-sdt)), 0.0)
            odepth = lat2[:, :n_rays].sum(0)
            opacity = 1.0 - torch.exp(-odepth)
            depth = (ray_total(w * s_t)
                     if self.opts.render_mode == RenderMode.DEPTH else None)
            return self._mode_rgb(ray_total(w[:, None] * rgb)
                                  + torch.exp(-odepth)[:, None] * bg_ray,
                                  opacity, depth, st["dcnt"]), opacity

    def _render_wave_device(self, net, bitfield, bg, rays, n_items: int,
                            n_rays: int, add):
        """The device dispatch, in groups of ``dispatch_chunks`` work
        items: every item's rays and coarse segments, one host wait for
        the group's segment counts (none on the flat march), every item's
        segment stream and fitted decimation, one host wait for the
        group's kept totals, then every item's network and composite."""
        opts = self.opts
        flat = opts.wave_march == "flat"
        with span("ngp.march"):
            coarse = None if flat else _coarse_mask(bitfield)
        group = max(opts.dispatch_chunks, 1)
        top = self._wave2_layout(n_rays)[3]
        samples = evaluated = 0
        for lo in range(0, n_items, group):
            ks = range(lo, min(lo + group, n_items))
            items = []
            for k in ks:
                o, d = rays(k)
                with span("ngp.march"):
                    items.append((o, d, None if flat else coarse_segments(
                        coarse, o, d, n_rays, opts.march_steps,
                        self.cone_angle, self.max_cascade, self.aabb_min,
                        self.aabb_size, t_start_min=0.05)))
            with span("ngp.wait"):
                n_segs = ([0] * len(items) if flat else
                          torch.stack([segs[2].sum() for _, _, segs in items])
                          .tolist())
            streams = [self._wave2_stream(bitfield, coarse, o, d, segs, n)
                       for (o, d, segs), n in zip(items, n_segs)]
            with span("ngp.wait"):
                totals = torch.stack([st["total"] for st in streams]).tolist()
            for k, st, total in zip(ks, streams, totals):
                add(k, *self._wave2_composite(net, st, min(total, top), bg))
                samples += total
                evaluated += min(total, top)
        self._wave_samples = samples
        self.last_n_samples = evaluated

    # ------------------------------------------------------------------

    def _frame_network(self, params):
        """(params, net, quantized) of a frame: the model's own parameters
        for None; ``net(*args)`` the model on them; under an int8 encode
        mode the table quantised once for the frame (else None)."""
        own = params is None
        if own:
            params = dict(self.model.named_parameters())
        quantized = (quantize_table_i8(params["pos_encoding.table"])
                     if self.encode_int8 else None)
        kw = {} if quantized is None else {"quantized": quantized}

        def net(*args):
            return (self.model(*args, **kw) if own else
                    functional_call(self.model, params, args, kw))
        return params, net, quantized

    @torch.no_grad()
    def render_multichip(self, mesh, params, bitfield, camera_matrix,
                         width: Optional[int] = None,
                         height: Optional[int] = None,
                         focal: Optional[tuple] = None,
                         spp: Optional[int] = None,
                         seed: int = 0) -> torch.Tensor:
        """Frame-parallel rendering over the ``data`` axis of ``mesh``
        (``dist.mesh.make_mesh``; port of the JAX package's
        ``render_multichip``): the frame's pixel chunks are split into
        n_data runs of ``ceil(chunks / n_data)``, the last run padded as
        the JAX package pads it (the padding past the frame is not
        rendered), and data rank r renders the r-th run through the static
        chunk path. Every rank returns the whole (H, W, 4) frame:
        the runs are summed over the ``data`` group, each pixel's value on
        one rank and zeros on the others. Each chunk draws what ``render``
        draws for it: every rank walks ``render``'s work items (spp, then
        chunk) and draws every item's numbers, keeping those of its own,
        so any world gives ``render``'s image of a still camera. As in the
        JAX package, ``linear_out`` is applied and the exposure and the
        tonemap are not; every rank of the group calls it."""
        from ngp_tpu_torch.dist.mesh import all_reduce_
        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx, fy = (focal or (opts.fov_axis_focal,
                            opts.focal_y or opts.fov_axis_focal))
        fx, fy = float(fx), float(fy)
        n_spp = int(spp or opts.spp)
        dev = bitfield.device
        xf = torch.as_tensor(np.asarray(camera_matrix, np.float32),
                             device=dev)
        bg = torch.tensor(opts.background, dtype=torch.float32, device=dev)
        self._crop_box = (None if opts.render_aabb_min is None else tuple(
            torch.tensor(c, dtype=torch.float32, device=dev)
            for c in (opts.render_aabb_min, opts.render_aabb_max)))
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        params, net, quantized = self._frame_network(params)
        n_chunks = -(-H * W // eff_chunk)
        per_dev = -(-n_chunks // mesh.n_data)
        mine = range(mesh.data_index * per_dev,
                     min((mesh.data_index + 1) * per_dev, n_chunks))
        acc = torch.zeros((per_dev * mesh.n_data * eff_chunk, 4), device=dev)
        self.last_n_samples = 0
        for s in range(n_spp):
            jitter_on = (not opts.snap_to_pixel_centers) and s > 0
            for c in range(n_chunks):
                draws = self.draws(generator, eff_chunk, jitter_on, False,
                                   dev)
                if c not in mine:
                    continue
                rgb, opac, n = self._render_chunk(
                    net, params, bitfield, xf, bg, draws, c * eff_chunk, fx,
                    fy, eff_chunk, W, H, None, (0.0, 0.0, 0.0, 1.0),
                    quantized)
                self.last_n_samples += n
                lo = c * eff_chunk
                acc[lo:lo + eff_chunk] += torch.cat([rgb, opac[:, None]],
                                                    -1) / n_spp
        all_reduce_(acc, mesh.data_group)
        img = acc[:H * W].view(H, W, 4)
        rgb = img[..., :3]
        if opts.linear_out:
            rgb = srgb_to_linear(torch.clamp(rgb, min=0.0))
        return torch.cat([rgb, img[..., 3:]], -1)

    @torch.no_grad()
    @spanned("ngp.frame")
    def render(self, params: Optional[Mapping[str, torch.Tensor]], bitfield,
               camera_matrix, width: Optional[int] = None,
               height: Optional[int] = None, focal: Optional[tuple] = None,
               spp: Optional[int] = None, seed: int = 0,
               camera_matrix_end=None,
               rolling_shutter=(0.0, 0.0, 0.0, 1.0)) -> torch.Tensor:
        """Render one frame → (H, W, 4) f32 tensor on the bitfield's device.

        ``params`` maps the model's parameter names to tensors (as
        ``bridge.nerf_params_from_numpy`` returns them); None renders with
        the model's own parameters. camera_matrix: (3,4) NGP-convention
        camera→world; when ``camera_matrix_end`` differs from it, each ray's
        camera is interpolated between the two with the
        ``rolling_shutter`` (x0, y-row, x-col, motion-time) weights. The
        random numbers (jitter for spp > 1, shutter time, lens samples)
        come from a ``torch.Generator`` seeded by ``seed``, work item by
        work item (spp, then chunk) on every path; an spp-1 pinhole still
        draws none. Under an int8 encode mode the table is quantised once
        for the frame.
        """
        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx, fy = (focal or (opts.fov_axis_focal,
                            opts.focal_y or opts.fov_axis_focal))
        fx, fy = float(fx), float(fy)
        n_spp = int(spp or opts.spp)
        dev = bitfield.device
        cam = np.asarray(camera_matrix, np.float32)
        xf = torch.as_tensor(cam, device=dev)
        motion = (camera_matrix_end is not None
                  and not np.array_equal(np.asarray(camera_matrix_end,
                                                    np.float32), cam))
        xf_end = (torch.as_tensor(np.asarray(camera_matrix_end, np.float32),
                                  device=dev) if motion else None)
        rsh = tuple(float(x) for x in rolling_shutter)
        bg = torch.tensor(opts.background, dtype=torch.float32, device=dev)
        self._crop_box = (None if opts.render_aabb_min is None else tuple(
            torch.tensor(c, dtype=torch.float32, device=dev)
            for c in (opts.render_aabb_min, opts.render_aabb_max)))
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        params, net, quantized = self._frame_network(params)

        n_chunks = -(-H * W // eff_chunk)
        items = [(s, c) for s in range(n_spp) for c in range(n_chunks)]
        acc = torch.zeros((n_chunks * eff_chunk, 4), device=dev)

        def item_draws(k):
            jitter_on = (not opts.snap_to_pixel_centers) and items[k][0] > 0
            return self.draws(generator, eff_chunk, jitter_on, motion, dev)

        def add(k, rgb, opac):
            lo = items[k][1] * eff_chunk
            with span("ngp.composite"):
                acc[lo:lo + eff_chunk] += torch.cat([rgb, opac[:, None]],
                                                    -1) / n_spp

        self.last_n_samples = self.last_event_waits = 0
        if self._wave_supported():
            def rays(k):
                return self._gen_rays(items[k][1] * eff_chunk, eff_chunk, W,
                                      H, fx, fy, xf, item_draws(k), xf_end,
                                      rsh)[:2]
            if opts.wave_dispatch == "device":
                self._render_wave_device(net, bitfield, bg, rays, len(items),
                                         eff_chunk, add)
            else:
                self._render_wave_host(net, bitfield, bg, rays, len(items),
                                       add)
        else:
            for k, (_, c) in enumerate(items):
                rgb, opac, n = self._render_chunk(
                    net, params, bitfield, xf, bg, item_draws(k),
                    c * eff_chunk, fx, fy, eff_chunk, W, H, xf_end, rsh,
                    quantized)
                self.last_n_samples += n
                add(k, rgb, opac)
        count("samples", self.last_n_samples)

        with span("ngp.composite"):
            img = acc[:H * W].view(H, W, 4)
            rgb = img[..., :3]
            if opts.exposure != 0.0:
                rgb = rgb * (2.0 ** opts.exposure)
            if opts.tonemap_curve != TonemapCurve.IDENTITY:
                rgb = tonemap(torch.clamp(rgb, min=0.0), opts.tonemap_curve)
            if opts.linear_out:
                rgb = srgb_to_linear(torch.clamp(rgb, min=0.0))
            return torch.cat([rgb, img[..., 3:]], -1)

def _coarse_mask(bitfield: torch.Tensor) -> torch.Tensor:
    """The 16³ conservative coarse mask of a bitfield (the hierarchical
    marches' segment test), built once a frame."""
    return occ._build_coarse_mask(bitfield.view(occ.NERF_CASCADES, occ.GH,
                                                occ.GH, occ.GH))


def _fold_alpha(sigma, s_dt, alpha_mult):
    """The step that gives each sample the alpha α' = m·α of its mask
    value m: σΔt' = -log(1 - m·(1 - e^{-σΔt})), folded into the optical
    depth; ``s_dt`` itself where there is no mask."""
    if alpha_mult is None:
        return s_dt
    alpha = 1.0 - torch.exp(-sigma * s_dt)
    return -torch.log1p(-torch.clamp(alpha_mult * alpha, 0.0, 1.0 - 1e-7)) \
        / torch.clamp(sigma, min=1e-10)


def apply_glow(rgb, pos, cam_pos, glow_mode: int, glow_y_cutoff: float):
    """Per-sample glow effect (ref: composite_kernel_nerf glow block,
    src/testbed_nerf.cu:843-940). Returns (rgb, alpha mask)."""
    green_grid = bool(glow_mode & 1)
    green_cutline = bool(glow_mode & 2)
    radial = bool(glow_mode & 8)
    grid_mode = bool(glow_mode & 16)

    if radial:
        dist = torch.linalg.vector_norm(pos - cam_pos[None], dim=-1)
        dist = torch.minimum(dist, (4.5 - pos[:, 1]) * 0.333)
    else:
        dist = pos[:, 1]

    if grid_mode:
        glow = 1.0 / torch.clamp(dist, min=1.0)
        mask = torch.ones_like(dist)
    else:
        y = glow_y_cutoff - dist
        y80 = y * 80.0
        mask = torch.where(y > 0, torch.clamp(y80, max=1.0), 0.0)
        glow = torch.zeros_like(dist)
        if green_cutline:
            glow = glow + torch.where(
                y > 0, torch.clamp(1.0 - torch.abs(1.0 - y80), min=0.0) * 4.0,
                0.0)
        y2 = torch.where(y80 > 1.0, 1.0 - (y80 - 1.0) * 0.05, y80)
        if green_grid:
            glow = glow + torch.where(
                y > 0, torch.clamp(y2 / torch.clamp(dist, min=1.0), min=0.0),
                0.0)

    line = torch.zeros_like(dist)
    for scale in (2.0, 4.0, 8.0, 16.0):
        for ax in range(3):
            line = line + torch.clamp(
                torch.cos(pos[:, ax] * scale * math.pi * 16.0) - 0.975,
                min=0.0)
    if grid_mode:
        g = glow * line * 15.0
        rgb = torch.stack([g * 0.25, g, g * 0.5], -1)
    else:
        g = glow * glow * 0.25 + glow * line * 15.0
        rgb = rgb + torch.stack([g * 0.25, g, g * 0.5], -1)
    return rgb, mask
