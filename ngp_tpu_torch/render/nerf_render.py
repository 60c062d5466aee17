"""Single-NeRF renderer, static path (port of the static chunk path of
``ngp_tpu/render/nerf_render.py``).

Each pixel chunk marches the closed-form cone lattice through the
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

Not ported yet, and raising NotImplementedError: the wave renderers
(``wave``; False by default in the JAX package too), which come with the
port of ``dist/*`` (ROADMAP.md §1).

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
from ngp_tpu_torch.grid.occupancy import mip_from_pos
from ngp_tpu_torch.kernels import blocked_grid_cuda
from ngp_tpu_torch.kernels.blocked_grid import quantize_table_i8
from ngp_tpu_torch.nn.encodings import BlockedGridEncoding
from ngp_tpu_torch.rays.camera import (LENS_MODES, apply_quilting,
                                       f_theta_undistort,
                                       iterative_opencv_undistort,
                                       latlong_to_dir, ray_aabb_intersect,
                                       xform_slerp)
from ngp_tpu_torch.rays.marching import (compact_samples, composite_samples,
                                         march_rays, merge_excess_samples,
                                         ray_sums)
from ngp_tpu_torch.render.buffer import tonemap
from ngp_tpu_torch.render.multi_nerf import apply_masks


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
    # the JAX package's live-sample renderers: not ported yet (they come
    # with dist/*)
    wave: bool = False


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
        if opts.wave:
            raise NotImplementedError(
                "the wave renderers are not ported yet: they come with the "
                "port of dist/* (ROADMAP.md §1)")
        if opts.lens_mode not in ("auto",) + LENS_MODES:
            raise ValueError(f"lens mode {opts.lens_mode!r} is not one of "
                             f"{('auto',) + LENS_MODES}")
        blocked_grid_cuda.check_int8_mode(encode_int8)
        if encode_int8 and not isinstance(model.pos_encoding,
                                          BlockedGridEncoding):
            raise ValueError("the int8 encode modes exist for the blocked "
                             "grid only")
        self.encode_int8 = encode_int8
        # samples the last ``render`` call sent through the network
        self.last_n_samples = 0

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
            fx32 = torch.tensor(fx, dtype=torch.float32, device=dev)
            fy32 = torch.tensor(fy, dtype=torch.float32, device=dev)
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
        t, dt, emit = march_rays(
            bitfield, o, d, None, n_rays, opts.march_steps, self.cone_angle,
            self.max_cascade, self.aabb_min, self.aabb_size,
            t_start_min=0.05)
        if opts.render_aabb_min is not None:
            ct0, ct1 = ray_aabb_intersect(
                o, d, torch.tensor(opts.render_aabb_min, device=dev),
                torch.tensor(opts.render_aabb_max, device=dev))
            emit = emit & (t >= ct0[:, None]) & (t <= ct1[:, None])
        # the environment, or the constant background, behind each ray
        if self.envmap_sampler is not None:
            env = self.envmap_sampler(d)
            bg_ray = env[:, :3] + bg[None, :3] * (1.0 - env[:, 3:4])
        else:
            bg_ray = bg[None, :3]

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
            pos = o[s_ray] + s_t[:, None] * d[s_ray]
            pos_w = (pos - self.aabb_min) / self.aabb_size
            dir_w = d[s_ray] * 0.5 + 0.5
            rgb_raw, dens_raw = net(pos_w, dir_w)
            if mode == RenderMode.NORMALS:
                rgb = self._normals_rgb(params, pos_w)
            elif mode == RenderMode.ENCODING_VIS:
                rgb = self._encoding_rgb(params, pos_w, quantized)
            elif mode == RenderMode.POSITIONS:
                rgb = self._accel_rgb(pos) if opts.show_accel >= 0 else pos_w
            else:
                rgb = torch.sigmoid(rgb_raw.to(torch.float32))
            sigma = torch.exp(torch.clamp(dens_raw.to(torch.float32),
                                          -15.0, 15.0))
            if mode == RenderMode.POSITIONS and opts.show_accel >= 0:
                # every sample opaque, so the first cell wins
                sigma = torch.full_like(sigma, 1e6)
            s_dt_eff = s_dt
            alpha_mult = apply_masks(self.masks, pos) if self.masks else None
            if opts.glow_mode:
                rgb, glow_mask = apply_glow(rgb, pos, xf[:, 3],
                                            opts.glow_mode,
                                            opts.glow_y_cutoff)
                if opts.glow_mode & 4:
                    alpha_mult = (glow_mask if alpha_mult is None
                                  else alpha_mult * glow_mask)
            if alpha_mult is not None:
                # α' = m·α folded into the optical depth:
                # σΔt' = -log(1 - m·(1 - e^{-σΔt}))
                alpha = 1.0 - torch.exp(-sigma * s_dt)
                s_dt_eff = -torch.log1p(-torch.clamp(
                    alpha_mult * alpha, 0.0, 1.0 - 1e-7)) \
                    / torch.clamp(sigma, min=1e-10)
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
        rgb_out = rgb_acc + torch.exp(-logT)[:, None] * bg_ray
        if mode == RenderMode.DEPTH:
            rgb_out = (depth_acc / torch.clamp(opacity, min=1e-6))[:, None] \
                .expand(n_rays, 3)
        elif mode == RenderMode.AO:
            rgb_out = opacity[:, None].expand(n_rays, 3)
        elif mode == RenderMode.COST:
            rgb_out = (cost_acc[:, None] / 128.0).expand(n_rays, 3)
        return rgb_out, opacity, total

    @torch.no_grad()
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
        come from a ``torch.Generator`` seeded by ``seed``; an spp-1
        pinhole still draws none. Under an int8 encode mode the table is
        quantised once for the frame.
        """
        opts = self.opts
        W = int(width or opts.width)
        H = int(height or opts.height)
        eff_chunk = min(opts.chunk, max(((W * H + 255) // 256) * 256, 256))
        fx, fy = (focal or (opts.fov_axis_focal,
                            opts.focal_y or opts.fov_axis_focal))
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
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)

        own = params is None
        if own:
            params = dict(self.model.named_parameters())
        quantized = (quantize_table_i8(params["pos_encoding.table"])
                     if self.encode_int8 else None)
        kw = {} if quantized is None else {"quantized": quantized}

        def net(*args):
            return (self.model(*args, **kw) if own else
                    functional_call(self.model, params, args, kw))

        n_chunks = -(-H * W // eff_chunk)
        acc = torch.zeros((n_chunks * eff_chunk, 4), device=dev)
        self.last_n_samples = 0
        for s in range(n_spp):
            jitter_on = (not opts.snap_to_pixel_centers) and s > 0
            for c in range(n_chunks):
                draws = self.draws(generator, eff_chunk, jitter_on, motion,
                                   dev)
                rgb, opac, n = self._render_chunk(
                    net, params, bitfield, xf, bg, draws, c * eff_chunk,
                    float(fx), float(fy), eff_chunk, W, H, xf_end, rsh,
                    quantized)
                self.last_n_samples += n
                lo = c * eff_chunk
                acc[lo:lo + eff_chunk] += torch.cat([rgb, opac[:, None]],
                                                    -1) / n_spp

        img = acc[:H * W].view(H, W, 4)
        rgb = img[..., :3]
        if opts.exposure != 0.0:
            rgb = rgb * (2.0 ** opts.exposure)
        if opts.tonemap_curve != TonemapCurve.IDENTITY:
            rgb = tonemap(torch.clamp(rgb, min=0.0), opts.tonemap_curve)
        if opts.linear_out:
            rgb = srgb_to_linear(torch.clamp(rgb, min=0.0))
        return torch.cat([rgb, img[..., 3:]], -1)


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
