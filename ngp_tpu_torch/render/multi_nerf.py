"""The multi-NeRF render engine and the Blender ``RenderRequest`` data model
(port of ``ngp_tpu/render/multi_nerf.py``; ref: src/nerf_renderer.cu and
include/neural-graphics-primitives/nerf/*).

A ``RenderRequest`` names snapshots through ``NerfDescriptor``s; each
snapshot loads once into a cached ``NeuralRadianceField`` (network and
occupancy bitfield on the renderer's device), and each descriptor places
it in the world as a proxy with its own transform, 3D SDF masks and
opacity. All proxies are sampled on one shared world-space cone lattice
and composited along the camera rays, segment by segment.

``"nearest"`` compositing (the default) lets the first proxy in
descriptor order claim a lattice point, the shared-lattice limit of the
reference's nearest-proxy cull (src/nerf_renderer.cu:376-428); ``"sum"``
superposes the densities of every proxy at the point.

Determinism: each proxy adds its samples' σ·Δt and colour to the
segment's (ray, slot) lattice with one write per cell (a proxy's samples
occupy distinct cells), and proxies add in descriptor order; per-ray sums
are reductions of lattice rows. A request rendered twice gives the same
bits, and ``chunk`` (rays per chunk) does not change the frame.

Intended divergences from the JAX package:

- Colour space. The network's rgb is in the training colour space, sRGB
  (ref: ``nerf_render.py`` ``linear_out``), so the composite is an sRGB
  frame: ``color_space="srgb"`` returns it clipped to [0, 1] and
  ``"linear"`` returns ``srgb_to_linear`` of it. The JAX package treats
  the composite as linear: it returns it unchanged for ``"linear"`` and
  applies ``linear_to_srgb`` on top for ``"srgb"``, the curve twice.
- A reference snapshot builds a ``NerfNetwork(grid_impl="tcnn")``; the
  JAX package selects the tcnn grid by setting the process-wide
  ``NGP_TPU_GRID_IMPL`` for a while, which races with a render or a model
  build on another thread (``request_nerf_render_async``).
- The compacted sample stream is sized by the live count (no per-segment
  capacity), and a chunk holds only its own rays (no padding).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ngp_tpu_torch.common import (TonemapCurve, resolve_device,
                                  srgb_to_linear)
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.rays.marching import (calc_dt, compact_samples,
                                         merge_excess_samples, step_lattice)
from ngp_tpu_torch.render.buffer import tonemap

MASK_SHAPES = ("box", "cylinder", "sphere", "all")
CAMERA_MODELS = ("perspective", "spherical_quadrilateral",
                 "quadrilateral_hexahedron")


# --------------------------------------------------------------------------
# data model (ref: nerf/render_request.cuh, nerf_descriptor.cuh, mask_3D.cuh)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Mask3D:
    """SDF-based render mask (ref: nerf/mask_3D.cuh:129-255)."""
    shape: str = "box"            # box | cylinder | sphere | all
    mode: str = "add"             # add | subtract
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    dims: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    radius: float = 0.5
    height: float = 1.0
    feather: float = 0.0
    opacity: float = 1.0

    @classmethod
    def All(cls, mode: str = "add") -> "Mask3D":
        return cls(shape="all", mode=mode)

    def key(self) -> tuple:
        """Every field as plain Python values: equal keys, equal masks."""
        return (self.shape, self.mode,
                tuple(np.asarray(self.transform, np.float64).ravel().tolist()),
                tuple(np.asarray(self.dims, np.float64).ravel().tolist()),
                float(self.radius), float(self.height), float(self.feather),
                float(self.opacity))

    def _sdf(self, p: torch.Tensor) -> torch.Tensor:
        if self.shape == "all":
            return torch.full(p.shape[:-1], -1e10, device=p.device)
        if self.shape == "sphere":
            return torch.linalg.vector_norm(p, dim=-1) - self.radius
        if self.shape == "cylinder":
            dxy = torch.linalg.vector_norm(p[..., :2], dim=-1) - self.radius
            dz = torch.abs(p[..., 2]) - self.height * 0.5
            return torch.maximum(dxy, dz)
        if self.shape != "box":
            raise ValueError(f"mask shape {self.shape!r} is not one of "
                             f"{MASK_SHAPES}")
        half = torch.as_tensor(np.asarray(self.dims, np.float32),
                               device=p.device) * 0.5
        q = torch.abs(p) - half
        return (torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
                + torch.clamp(torch.amax(q, dim=-1), max=0.0))

    def sample(self, p_world: torch.Tensor) -> torch.Tensor:
        """Signed alpha at world points (N, 3): positive inside an add
        mask, negative inside a subtract mask (ref: Mask3D::sample)."""
        m = torch.as_tensor(np.linalg.inv(self.transform).astype(np.float32),
                            device=p_world.device)
        p = p_world @ m[:3, :3].T + m[:3, 3]
        feather = max(self.feather, 1e-6)
        a = torch.clamp(-self._sdf(p) / feather, 0.0, 1.0) * self.opacity
        return a if self.mode == "add" else -a


def apply_masks(masks: List[Mask3D], p_world: torch.Tensor) -> torch.Tensor:
    """Merged mask alpha in [0, 1] at world points (N, 3). A list that
    starts with an add mask starts from nothing, the complement "All" the
    reference prepends (ref: render_modifiers.cuh:47-61); one that starts
    with a subtract mask starts from everything."""
    if not masks:
        return torch.ones(p_world.shape[:-1], device=p_world.device)
    alpha = torch.full(p_world.shape[:-1],
                       0.0 if masks[0].mode == "add" else 1.0,
                       device=p_world.device)
    for m in masks:
        alpha = torch.clamp(alpha + m.sample(p_world), 0.0, 1.0)
    return alpha


def masks_key(masks: List[Mask3D]) -> tuple:
    return tuple(m.key() for m in masks)


@dataclasses.dataclass
class NerfDescriptor:
    """ref: nerf/nerf_descriptor.cuh:15-35."""
    snapshot_path: str = ""
    aabb_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    aabb_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    masks: List[Mask3D] = dataclasses.field(default_factory=list)
    opacity: float = 1.0


@dataclasses.dataclass
class DownsampleInfo:
    """Progressive preview mip (ref: DownsampleInfo::MakeFromMip,
    common.h:337-355)."""
    scale: int = 1

    @classmethod
    def MakeFromMip(cls, mip: int) -> "DownsampleInfo":
        return cls(scale=1 << mip)


@dataclasses.dataclass
class RenderOutputProperties:
    width: int = 640
    height: int = 480
    downsample: DownsampleInfo = dataclasses.field(
        default_factory=DownsampleInfo)
    spp: int = 1
    color_space: str = "linear"          # linear | srgb
    tonemap_curve: TonemapCurve = TonemapCurve.IDENTITY
    exposure: float = 0.0
    background_color: tuple = (0.0, 0.0, 0.0, 0.0)
    flip_y: bool = True                  # Blender convention


@dataclasses.dataclass
class RenderCameraProperties:
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    model: str = "perspective"   # perspective|spherical_quadrilateral|quadrilateral_hexahedron
    focal_length: float = 800.0
    near_distance: float = 0.05
    aperture_size: float = 0.0
    focus_z: float = 1.0
    # spherical quadrilateral params
    sq_width: float = 1.0
    sq_height: float = 1.0
    sq_curvature: float = 0.0
    # quadrilateral hexahedron: 8 corners (front 4 + back 4)
    qh_corners: Optional[np.ndarray] = None


@dataclasses.dataclass
class RenderRequest:
    output: RenderOutputProperties
    camera: RenderCameraProperties
    nerfs: List[NerfDescriptor]
    modifiers: List[Mask3D] = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# per-snapshot radiance field (ref: nerf/neural_radiance_field.cuh)
# --------------------------------------------------------------------------

class NeuralRadianceField:
    """A snapshot loaded for rendering on ``device``: the network with its
    EMA parameters, the occupancy bitfield built from the snapshot's
    density grid, and the AABB and cone angle of its ``aabb_scale``.

    A snapshot of either package (``ngp_tpu_ema_params``) builds the
    blocked grid, with the ``log2_rows``/``row_hash`` its config carries;
    a reference snapshot (``params_binary``) builds the tcnn-layout grid
    through ``import_reference_snapshot``."""

    def __init__(self, snapshot_path, device="cuda"):
        from ngp_tpu_torch import bridge
        from ngp_tpu_torch.io.snapshot import (import_reference_snapshot,
                                               load_snapshot)
        from ngp_tpu_torch.nn.models import NerfNetwork

        dev = resolve_device(device)
        doc = load_snapshot(snapshot_path)
        snap = doc["snapshot"]
        aabb_scale = int(snap["nerf"]["aabb_scale"])
        if "ngp_tpu_ema_params" in snap:
            config = {k: v for k, v in doc.items() if k != "snapshot"}
            self.grid_impl = "blocked"
            tree = snap["ngp_tpu_ema_params"]
        else:
            config, tree, _ = import_reference_snapshot(snapshot_path)
            self.grid_impl = "tcnn"
        self.model = NerfNetwork(config, aabb_scale, device=dev,
                                 grid_impl=self.grid_impl)
        params = bridge.nerf_params_from_numpy(tree, self.model)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])
        self.model.requires_grad_(False)
        self.aabb_scale = aabb_scale
        self.max_cascade = int(snap.get("max_cascade", 0))
        # f32 values, and their f32 sum, as the JAX package computes them
        self.aabb_min = float(np.float32(0.5 - aabb_scale / 2.0))
        self.aabb_size = float(np.float32(aabb_scale))
        self.aabb_max = float(np.float32(self.aabb_min)
                              + np.float32(self.aabb_size))
        self.cone_angle = 1.0 / 256.0 if aabb_scale > 1 else 0.0
        if "density_grid" not in snap:
            raise ValueError(f"{snapshot_path}: the snapshot has no density "
                             "grid")
        density = torch.as_tensor(
            snap["density_grid"][: occ.GRID_VOLUME * (self.max_cascade + 1)],
            dtype=torch.float32, device=dev)
        self.bitfield = occ.rebuild_bitfield(occ.init_grid(
            self.max_cascade, dev)._replace(density=density)).bitfield


# --------------------------------------------------------------------------
# camera models (ref: camera_models.cuh:27-240)
# --------------------------------------------------------------------------

def generate_global_rays(cam: RenderCameraProperties, W: int, H: int,
                         rng: Optional[np.random.Generator] = None,
                         device="cpu"):
    """World rays (o, d), (W·H, 3) f32 each, row-major pixels, on
    ``device``. The random numbers are the JAX package's: from ``rng``,
    the pixel jitter (``rng.random(2)``), then for thin-lens depth of field
    the lens angle and radius per ray; without ``rng`` rays leave pixel
    centres through a pinhole. Pixel coordinates are f64 until the camera
    model's f32 cast, as there."""
    dev = torch.device(device)
    jitter = np.full(2, 0.5) if rng is None else rng.random(2)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev),
                            indexing="ij")
    u = (xs.reshape(-1) + float(jitter[0])) / W
    v = (ys.reshape(-1) + float(jitter[1])) / H
    xf = torch.as_tensor(np.asarray(cam.transform, np.float32)[:3, :4],
                         device=dev)
    R, t = xf[:, :3], xf[:, 3]
    if cam.model == "perspective":
        d = torch.stack([(u - 0.5) * W / cam.focal_length,
                         (v - 0.5) * H / cam.focal_length,
                         torch.ones_like(u)], -1).to(torch.float32)
        if cam.aperture_size > 0 and rng is not None:
            # per-ray thin-lens DoF (ref: pixel_to_ray DoF,
            # common_device.cuh:260-317)
            n = d.shape[0]
            ang = torch.as_tensor(rng.random(n).astype(np.float32),
                                  device=dev) * np.float32(2 * np.pi)
            rad = torch.sqrt(torch.as_tensor(
                rng.random(n).astype(np.float32), device=dev))
            lens = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang),
                                torch.zeros_like(ang)], -1) \
                * np.float32(cam.aperture_size)
            focus = np.float32(cam.focus_z)
            d = (d * focus - lens) / focus
            o = lens @ R.T + t
        else:
            o = t.expand(d.shape[0], 3).clone()
        dw = d @ R.T
    elif cam.model == "spherical_quadrilateral":
        # curved-display rays leave a spherical patch along its normal
        sx = (u - 0.5) * cam.sq_width
        sy = (v - 0.5) * cam.sq_height
        c = cam.sq_curvature
        z = c * (sx ** 2 + sy ** 2)
        p_local = torch.stack([sx, sy, z], -1).to(torch.float32)
        n_local = torch.stack([-2 * c * sx, -2 * c * sy, torch.ones_like(sx)],
                              -1).to(torch.float32)
        n_local = n_local / torch.linalg.vector_norm(n_local, dim=-1,
                                                     keepdim=True)
        o = p_local @ R.T + t
        dw = n_local @ R.T
    elif cam.model == "quadrilateral_hexahedron":
        qc = torch.as_tensor(np.asarray(cam.qh_corners, np.float32).reshape(
            2, 2, 2, 3), device=dev)
        uu, vv = u.to(torch.float32)[:, None], v.to(torch.float32)[:, None]

        def bilerp(q):  # q: (2, 2, 3)
            top = q[0, 0] * (1 - uu) + q[0, 1] * uu
            bot = q[1, 0] * (1 - uu) + q[1, 1] * uu
            return top * (1 - vv) + bot * vv

        front, back = bilerp(qc[0]), bilerp(qc[1])
        o = front @ R.T + t
        dw = (back - front) @ R.T
    else:
        raise ValueError(f"camera model {cam.model!r} is not one of "
                         f"{CAMERA_MODELS}")
    dw = dw / (torch.linalg.vector_norm(dw, dim=-1, keepdim=True) + 1e-12)
    return o, dw


# --------------------------------------------------------------------------
# renderer
# --------------------------------------------------------------------------

class _Proxy(NamedTuple):
    """A descriptor's field placed in the world: the inverse transform
    (world → local rotation/scale ``R3`` and translation ``tr``), its
    length scale, its masks (request-level first) and opacity."""
    field: NeuralRadianceField
    R3: torch.Tensor
    tr: torch.Tensor
    scale: float
    masks: list
    opacity: float


class MultiNerfRenderer:
    """The field cache and the composite render loop (ref: RenderData
    cache, nerf/render_data.cuh:23-98; pipeline
    src/nerf_renderer.cu:565-791), on ``device``: the card unless the
    caller asks for another.

    ``march_steps`` lattice steps per ray in ``march_segments`` segments,
    with a transmittance early-out between segments; each proxy keeps at
    most ``samples_per_ray`` samples of a ray per segment, decimating the
    rest with Δt compensation; ``chunk`` rays per chunk."""

    def __init__(self, march_steps: int = 512, chunk: int = 1 << 13,
                 samples_per_ray: int = 32, march_segments: int = 8,
                 composite_mode: str = "nearest", device="cuda"):
        if composite_mode not in ("sum", "nearest"):
            raise ValueError("composite_mode must be 'sum' or 'nearest'")
        self.device = resolve_device(device)
        self.fields: dict[str, NeuralRadianceField] = {}
        self.march_steps = march_steps
        self.chunk = chunk
        self.samples_per_ray = samples_per_ray
        self.march_segments = march_segments
        self.composite_mode = composite_mode

    def _field(self, path: str) -> NeuralRadianceField:
        if path not in self.fields:
            self.fields[path] = NeuralRadianceField(path, self.device)
        return self.fields[path]

    def _proxies(self, request: RenderRequest) -> list:
        proxies = []
        for desc in request.nerfs:
            inv = np.linalg.inv(np.asarray(desc.transform, np.float32))
            proxies.append(_Proxy(
                self._field(desc.snapshot_path),
                torch.as_tensor(inv[:3, :3], device=self.device),
                torch.as_tensor(inv[:3, 3], device=self.device),
                float(np.linalg.norm(inv[:3, 0])),
                list(request.modifiers) + list(desc.masks),
                float(desc.opacity)))
        return proxies

    @torch.no_grad()
    def render(self, request: RenderRequest) -> np.ndarray:
        """One frame → (H, W, 4) f32 numpy, H and W the output size over
        the downsample scale; rows bottom-up under ``flip_y``."""
        out = request.output
        if out.color_space not in ("linear", "srgb"):
            raise ValueError(f"color_space {out.color_space!r} is not "
                             "'linear' or 'srgb'")
        ds = out.downsample.scale
        W, H = max(out.width // ds, 1), max(out.height // ds, 1)
        cam = request.camera
        dev = self.device
        proxies = self._proxies(request)
        near = max(cam.near_distance, 1e-4)

        # spp accumulation: sample 0 at pixel centres, later samples
        # jittered; depth of field draws from an rng on every sample
        n_spp = max(int(out.spp), 1)
        frame = torch.zeros((H * W, 4), device=dev)
        for s in range(n_spp):
            rng = (np.random.default_rng(s)
                   if (s > 0 or cam.aperture_size > 0) else None)
            o_all, d_all = generate_global_rays(cam, W, H, rng, dev)
            for i in range(0, H * W, self.chunk):
                sl = slice(i, min(i + self.chunk, H * W))
                rgb, opac = self._render_chunk(proxies, o_all[sl], d_all[sl],
                                               near)
                frame[sl, :3] += rgb
                frame[sl, 3] += opac
        frame /= n_spp

        # background, exposure and tonemap (ref: bl_render_frame +
        # accumulate/tonemap, src/testbed.cu:2687-2691)
        bg = torch.tensor(out.background_color, dtype=torch.float32,
                          device=dev)
        a = frame[:, 3:4]
        rgb = (frame[:, :3] + (1 - a) * bg[None, :3]) * (2.0 ** out.exposure)
        alpha = a + (1 - a) * bg[3]
        if out.tonemap_curve != TonemapCurve.IDENTITY:
            rgb = tonemap(torch.clamp(rgb, min=0.0), out.tonemap_curve)
        # the composite is sRGB, the network's colour space (module
        # docstring: an intended divergence)
        if out.color_space == "srgb":
            rgb = torch.clamp(rgb, 0.0, 1.0)
        else:
            rgb = srgb_to_linear(torch.clamp(rgb, min=0.0))
        img = torch.cat([rgb, alpha], -1).view(H, W, 4)
        if out.flip_y:
            img = img.flip(0)
        return np.ascontiguousarray(img.cpu().numpy(), np.float32)

    def _render_chunk(self, proxies, o, d, near: float):
        """One chunk of rays → (rgb (R, 3), opacity (R,)): every proxy on
        the shared world lattice, segment by segment."""
        n_rays, dev = o.shape[0], o.device
        K = self.march_steps
        cone = max((p.field.cone_angle for p in proxies), default=1.0 / 256.0)
        nseg = max(self.march_segments, 1)
        seg_len = K // nseg
        t_all = step_lattice(torch.full((n_rays,), near, device=dev), cone, K)
        dt_all = calc_dt(t_all, cone)
        dls = []
        for p in proxies:
            dl = d @ p.R3.T
            dls.append(dl / (torch.linalg.vector_norm(dl, dim=-1,
                                                      keepdim=True) + 1e-12))

        rgb_acc = torch.zeros((n_rays, 3), device=dev)
        logT = torch.zeros((n_rays,), device=dev)
        for si in range(nseg):
            sl = slice(si * seg_len, (si + 1) * seg_len)
            t, dt = t_all[:, sl], dt_all[:, sl]
            alive = torch.exp(-logT) > 1e-4
            if not bool(alive.any()):
                break       # the remaining segments would add zeros
            flat_pw = (o[:, None, :] + t[..., None] * d[:, None, :]
                       ).reshape(-1, 3)
            sigma_sum = torch.zeros((n_rays, seg_len), device=dev)
            rgb_sum = torch.zeros((n_rays, seg_len, 3), device=dev)
            # "nearest": lattice points claimed by an earlier proxy are
            # dead to later ones
            claimed = torch.zeros((n_rays, seg_len), dtype=torch.bool,
                                  device=dev)
            for p, dl in zip(proxies, dls):
                f = p.field
                pl = flat_pw @ p.R3.T + p.tr                # local positions
                inside = ((pl >= f.aabb_min) & (pl <= f.aabb_max)).all(-1)
                mip = occ.mip_from_dt(dt.reshape(-1) * p.scale, pl,
                                      f.max_cascade)
                occd = occ.occupied_at(f.bitfield, pl, mip)
                active = (inside & occd).view(n_rays, seg_len) \
                    & alive[:, None]
                if self.composite_mode == "nearest":
                    active = active & ~claimed
                    claimed = claimed | active
                # rays over the per-segment budget are decimated with Δt
                # compensation, keeping their optical depth
                active, dt_m = merge_excess_samples(active, dt,
                                                    self.samples_per_ray)
                s_t, s_dt, s_ray, _, _, s_k = compact_samples(t, dt_m, active)
                if s_ray.numel() == 0:
                    continue
                pw_s = o[s_ray] + s_t[:, None] * d[s_ray]  # world samples
                pl_s = pw_s @ p.R3.T + p.tr
                pl_w = (pl_s - f.aabb_min) / f.aabb_size
                dir_w = dl[s_ray] * 0.5 + 0.5
                rgb_raw, dens_raw = f.model(pl_w, dir_w)
                sig = torch.exp(torch.clamp(dens_raw.to(torch.float32),
                                            -15.0, 15.0))
                rgb = torch.sigmoid(rgb_raw.to(torch.float32))
                mask_alpha = apply_masks(p.masks, pw_s) if p.masks else 1.0
                # σ·Δt in the proxy's local metric with the merged Δt, so
                # decimated samples carry their optical depth
                contrib = sig * p.opacity * mask_alpha * p.scale * s_dt
                # one write per (ray, slot): a fixed summation order
                cell = (s_ray, s_k)
                sigma_sum.index_put_(cell, sigma_sum[cell] + contrib)
                rgb_sum.index_put_(cell, rgb_sum[cell]
                                   + contrib[:, None] * rgb)

            # composite this segment onto the accumulated rays
            mean_rgb = rgb_sum / torch.clamp(sigma_sum, min=1e-12)[..., None]
            sdt = sigma_sum                                 # already σ·Δt
            alpha = 1.0 - torch.exp(-sdt)
            T = torch.exp(-(torch.cumsum(sdt, dim=1) - sdt))
            wgt = T * alpha
            T_in = torch.exp(-logT)
            rgb_acc = rgb_acc + T_in[:, None] * torch.sum(
                wgt[..., None] * mean_rgb, dim=1)
            logT = logT + torch.sum(sdt, dim=1)
        return rgb_acc, 1.0 - torch.exp(-logT)
