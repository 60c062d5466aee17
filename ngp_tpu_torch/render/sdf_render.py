"""SDF sphere-tracing renderer (port of ``ngp_tpu/render/sdf_render.py``;
ref: the SphereTracer and shading of src/testbed_sdf.cu:669-988).

Each chunk of pixel rays is sphere-traced through the unit cube: every
iteration evaluates the network at the rays still alive (a ray dies on a
hit, |d| < hit_epsilon, or when it leaves the cube), up to ``max_iters``
or until none is alive. Normals come from central differences or, with
``analytic_normals``, from autograd through the network: the encode's
position backward (K3 on the card, in every int8 mode: it reads the f32
table, as the JAX package's int8 backward does). The network runs in the
options' ``encode_int8`` mode. Hit points are shaded with a sun
(Lambert and a Phong-like specular lobe with the BRDF knobs), soft shadows
marched towards the sun, an ambient term and the background colour.

A model with the Takikawa octree encoding is traced through its octree,
as the reference traces it (the SphereTracer's octree jumps): outside the
finest level's cells the features are 0, and the tracer steps by the
empty cell's width instead of the network's output
(``TakikawaEncoding.empty_space_distance``), and counts no hit there. The
JAX renderer has no octree path: its rays stop at the first point outside
the octree, where the network reads 0 (an intended divergence).

The JAX renderer evaluates every ray of a chunk at every iteration and
masks the dead ones; here only the live rays are evaluated, and shadows
and shading only at hits. A ray's result does not depend on the others,
so the frames agree. Everything runs under ``torch.inference_mode()``
except the analytic-normals pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ngp_tpu_torch.rays.camera import ray_aabb_intersect


@dataclasses.dataclass
class SdfRenderOptions:
    width: int = 512
    height: int = 512
    focal: float = 512.0
    max_iters: int = 128
    distance_scale: float = 1.0      # zero_offset/scale knobs (ref GUI)
    hit_epsilon: float = 5e-4
    chunk: int = 1 << 15
    encode_int8: str = ""            # the encode's int8 mode (the trainer's)
    analytic_normals: bool = False
    fd_normals_epsilon: float = 1e-3
    sun_dir: tuple = (0.577, 0.577, 0.577)
    background: tuple = (1.0, 1.0, 1.0)
    surface_color: tuple = (0.75, 0.6, 0.5)
    # shading (ref: BRDFParams + shadow rays in render_sdf)
    shadows: bool = True
    shadow_sharpness: float = 2048.0
    specular: float = 0.5
    roughness: float = 0.5
    metallic: float = 0.0
    ambient: tuple = (0.15, 0.17, 0.2)


# secondary-ray marching steps towards the sun per hit
SHADOW_STEPS = 32


class SdfRenderer:
    """Renders an SDF ``EncodedNetwork`` (N, 3) → (N, 1) on the device of
    the parameters it is given."""

    def __init__(self, model, opts: Optional[SdfRenderOptions] = None):
        self.model = model
        self.opts = opts or SdfRenderOptions()

    def _octree(self):
        """The model's octree encoding (Takikawa), or None."""
        enc = getattr(self.model, "encoding", None)
        return enc if hasattr(enc, "empty_space_distance") else None

    def _dist(self, params, p: torch.Tensor) -> torch.Tensor:
        d = functional_call(self.model, params, (p,), {
            "int8": self.opts.encode_int8})[:, 0].to(
            torch.float32) * self.opts.distance_scale
        octree = self._octree()
        if octree is not None:
            gap = octree.empty_space_distance(p)
            d = torch.where(gap > 0, gap, d)
        return d

    def _trace(self, params, o, d):
        """Sphere trace; returns (t, hit) per ray."""
        opts = self.opts
        tmin, tmax = ray_aabb_intersect(o, d, 0.0, 1.0)
        t = torch.clamp(tmin, min=0.0)
        valid = tmax > t
        alive = valid.clone()
        for _ in range(opts.max_iters):
            idx = torch.nonzero(alive).squeeze(1)
            if idx.numel() == 0:
                break
            sd = self._dist(params, o[idx] + t[idx, None] * d[idx])
            t_new = t[idx] + torch.abs(sd)
            t[idx] = t_new
            alive[idx] = ~((torch.abs(sd) < opts.hit_epsilon)
                           | (t_new > tmax[idx]))
        p = o + t[:, None] * d
        sd = self._dist(params, p)
        hit = valid & (torch.abs(sd) < opts.hit_epsilon * 10) & (t < tmax)
        if self._octree() is not None:
            hit &= self._octree().contains(p)
        return t, hit

    def _normals(self, params, p: torch.Tensor) -> torch.Tensor:
        """Unnormalised gradients of the distance at ``p`` (N, 3)."""
        opts = self.opts
        if opts.analytic_normals:
            # outside inference mode: a gradient by position through the
            # encode; the parameters are detached so only dpos is formed
            q = p.clone().requires_grad_(True)
            detached = {k: v.detach() for k, v in params.items()}
            with torch.enable_grad():
                out = functional_call(self.model, detached, (q,), {
                    "int8": opts.encode_int8})[:, 0]
                (g,) = torch.autograd.grad(out.to(torch.float32).sum(), q)
            return g
        eps = opts.fd_normals_epsilon
        with torch.inference_mode():
            g = []
            for a in range(3):
                e = torch.zeros((1, 3), dtype=torch.float32, device=p.device)
                e[0, a] = eps
                g.append(self._dist(params, p + e) - self._dist(params, p - e))
            return torch.stack(g, -1)

    def _shade(self, params, p, n, d):
        """Colours (N, 3) of hit points ``p`` with normals ``n`` seen along
        ``d``."""
        opts = self.opts
        dev = p.device

        def vec(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)
        sun = vec(opts.sun_dir)
        sun = sun / torch.linalg.norm(sun)
        if opts.shadows:
            # the smallest cone ratio along a secondary ray towards the sun
            # (ref: shadow rays + shadow_sharpness)
            st = torch.full_like(p[:, 0], 2e-2)
            shadow = torch.ones_like(st)
            for _ in range(SHADOW_STEPS):
                sd = self._dist(params, p + st[:, None] * sun[None])
                shadow = torch.minimum(shadow, torch.clamp(
                    opts.shadow_sharpness * sd / torch.clamp(st, min=1e-4),
                    0.0, 1.0))
                st = st + torch.clamp(torch.abs(sd), min=1e-3)
        else:
            shadow = torch.ones_like(p[:, 0])
        ndl = torch.clamp(torch.sum(n * sun[None], -1), 0.0, 1.0)
        h = sun[None] - d
        h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-9)
        ndh = torch.clamp(torch.sum(n * h, -1), 0.0, 1.0)
        shininess = 2.0 / max(opts.roughness ** 2, 1e-3)
        spec = opts.specular * ndh ** shininess
        base = vec(opts.surface_color)[None]
        diffuse = base * (1.0 - opts.metallic)
        light = (ndl * shadow)[:, None]
        col = diffuse * (vec(opts.ambient)[None] + light) + \
            (base * opts.metallic + (1 - opts.metallic)) * \
            (spec * shadow * ndl)[:, None]
        return torch.clamp(col, 0.0, 1.0)

    def render_rays(self, params, o: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
        """(N, 4) rgb + hit of rays ``o``, ``d`` (N, 3) on the device."""
        with torch.inference_mode():
            t, hit = self._trace(params, o, d)
            idx = torch.nonzero(hit).squeeze(1)
            p = o[idx] + t[idx, None] * d[idx]
        # the hit points leave inference mode for the analytic normals
        p = p.clone()
        g = self._normals(params, p)
        with torch.inference_mode():
            n = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-9)
            out = torch.empty((o.shape[0], 4), dtype=torch.float32,
                              device=o.device)
            out[:, :3] = torch.tensor(self.opts.background,
                                      dtype=torch.float32, device=o.device)
            out[idx, :3] = self._shade(params, p, n, d[idx])
            out[:, 3] = hit.to(torch.float32)
        return out

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

    def render(self, params, camera_matrix: np.ndarray,
               width: Optional[int] = None,
               height: Optional[int] = None) -> np.ndarray:
        """(H, W, 4) numpy frame: rgb, and 1 where the ray hit the
        surface. ``params`` are the model's parameters by name (the
        inference ones), on the device the frame is rendered on."""
        W, H = width or self.opts.width, height or self.opts.height
        o, d = self.camera_rays(camera_matrix, W, H)
        dev = next(iter(params.values())).device
        o = torch.from_numpy(o).to(dev)
        d = torch.from_numpy(d).to(dev)
        out = torch.cat([self.render_rays(params, oc, dc) for oc, dc in
                         zip(o.split(self.opts.chunk),
                             d.split(self.opts.chunk))])
        return out.reshape(H, W, 4).cpu().numpy()
