"""Seeded synthetic data for the cells, made on the device.

- A scene of opaque Lambertian spheres in the unit cube, seen by pinhole
  cameras on an orbit of the upper hemisphere, shaped like the NeRF
  synthetic (Blender) scenes: square RGBA views with a transparent
  background. The views come from closed-form ray–sphere intersection (no
  march). Replaces ``chip_smoke.sphere_views``/``_orbit_xforms``, which
  march a soft-shelled density with a few hundred steps.
- The spheres' analytic occupancy on the 128³ occupancy grid, packed into
  the occupancy bitfield's layout (a frozen copy of the packing and mip
  max-pool of ``ngp_tpu_torch/grid/occupancy.rebuild_bitfield``).
- A test image: ``chip_smoke.synth_image``'s pattern (colour gradients, a
  12-pixel grating in one quadrant, hard-edged discs), rewritten in torch
  for the device; the disc parameters come from numpy's generator.

Everything is a function of the parameters and the seed alone: the same
seed gives the same bytes on the same device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GRID = 128                 # occupancy grid cells per side
CASCADES = 8               # bitfield mips
AMBIENT = 0.2              # the spheres' ambient share of their albedo


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=1e-12) ** (1.0 / 2.4)
                       - 0.055)


def spheres(p: dict, device) -> dict:
    """The scene's spheres from its own seed: centres (S, 3), radii (S,),
    linear albedos (S, 3)."""
    rng = np.random.default_rng(int(p["scene_seed"]))
    n = int(p["n_spheres"])
    lo, hi = p["centre_range"]
    centres = rng.uniform(lo, hi, (n, 3))
    radii = rng.uniform(*p["radius_range"], n)
    albedo = rng.uniform(0.15, 0.95, (n, 3))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    return {"centres": t(centres), "radii": t(radii), "albedo": t(albedo)}


def look_at(eye: np.ndarray, target=(0.5, 0.5, 0.5)) -> np.ndarray:
    """NGP camera→world (3, 4): columns right, down, forward, position."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, eye], 1)


def orbit(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """(training cameras (I, 3, 4), held-out cameras (V, 3, 4)) on the
    upper hemisphere around the cube's centre, from the scene's seed:
    uniform azimuths, heights uniform in ``height_range`` of the radius."""
    rng = np.random.default_rng(int(p["scene_seed"]) + 1)
    r = float(p["camera_radius"])
    out = []
    for n in (int(p["n_views"]), int(p["n_held_out"])):
        az = rng.uniform(0.0, 2 * math.pi, n)
        z = rng.uniform(*p["height_range"], n)
        eyes = np.stack([np.sqrt(1 - z * z) * np.cos(az),
                         np.sqrt(1 - z * z) * np.sin(az), z], -1) * r + 0.5
        out.append(np.stack([look_at(e) for e in eyes]).astype(np.float32))
    return out[0], out[1]


def focal_px(p: dict) -> float:
    """Focal length in pixels from the horizontal field of view."""
    return 0.5 * int(p["resolution"]) / math.tan(
        0.5 * float(p["camera_angle_x"]))


def pixel_rays(xf: torch.Tensor, W: int, H: int, focal: float):
    """Pixel-centre rays (o (N, 3), unit d (N, 3)) of camera ``xf`` (3, 4),
    row-major, principal point at the centre."""
    dev = xf.device
    x = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
    y = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    d = torch.stack([(xx - 0.5) * W / focal, (yy - 0.5) * H / focal,
                     torch.ones_like(xx)], -1).reshape(-1, 3) @ xf[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return xf[:, 3].expand_as(d), d


def shade(sph: dict, o: torch.Tensor, d: torch.Tensor, light) -> torch.Tensor:
    """Linear RGBA (N, 4) of rays through the opaque spheres: the nearest
    hit's albedo · (ambient + diffuse · max(0, n·l)), transparent where no
    sphere is hit."""
    c, r = sph["centres"], sph["radii"]
    oc = o[:, None, :] - c[None]                               # (N, S, 3)
    b = torch.sum(oc * d[:, None, :], -1)
    disc = b * b - (torch.sum(oc * oc, -1) - r * r)
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 0), t, torch.inf)
    tmin, idx = torch.min(t, -1)
    hit = torch.isfinite(tmin)
    pos = o + torch.where(hit, tmin, 0.0)[:, None] * d
    n = (pos - c[idx]) / r[idx][:, None]
    lam = torch.clamp(n @ light, min=0.0)
    rgb = sph["albedo"][idx] * (AMBIENT + (1.0 - AMBIENT) * lam)[:, None]
    a = hit.to(torch.float32)
    return torch.cat([rgb * a[:, None], a[:, None]], -1)


def light_dir(device) -> torch.Tensor:
    v = torch.tensor([0.3, 0.5, 0.8], device=device)
    return v / torch.linalg.vector_norm(v)


def to_u8(rgba: torch.Tensor) -> torch.Tensor:
    """Linear premultiplied RGBA with alpha 0 or 1 → sRGB uint8 RGBA."""
    rgb = linear_to_srgb(torch.clamp(rgba[:, :3], 0.0, 1.0))
    return torch.round(torch.cat([rgb, rgba[:, 3:]], -1) * 255).to(
        torch.uint8)


def views(p: dict, xfs: np.ndarray, device) -> torch.Tensor:
    """(I, H, W, 4) sRGB uint8 views of the spheres from cameras ``xfs``,
    made on ``device``."""
    sph = spheres(p, device)
    res = int(p["resolution"])
    fl = focal_px(p)
    light = light_dir(device)
    out = torch.empty((len(xfs), res, res, 4), dtype=torch.uint8,
                      device=device)
    for i, xf in enumerate(torch.from_numpy(xfs).to(device)):
        o, d = pixel_rays(xf, res, res, fl)
        out[i] = to_u8(shade(sph, o, d, light)).view(res, res, 4)
    return out


def u8_to_linear(u8: torch.Tensor) -> torch.Tensor:
    """sRGB uint8 RGBA → linear premultiplied RGBA (f32)."""
    c = u8.to(torch.float32) / 255.0
    return torch.cat([srgb_to_linear(c[..., :3]) * c[..., 3:], c[..., 3:]],
                     -1)


def sphere_occupancy(p: dict, device) -> torch.Tensor:
    """(128³,) bool, z-y-x order: the cells of the unit cube whose bounding
    sphere meets a scene sphere (conservative, so every surface sample is
    marched)."""
    sph = spheres(p, device)
    i = torch.arange(GRID, device=device, dtype=torch.float32)
    z, y, x = torch.meshgrid(i, i, i, indexing="ij")
    centre = (torch.stack([x, y, z], -1).reshape(-1, 3) + 0.5) / GRID
    half = 0.5 * math.sqrt(3.0) / GRID
    occ = torch.zeros(centre.shape[0], dtype=torch.bool, device=device)
    for c, r in zip(sph["centres"], sph["radii"]):
        occ |= torch.linalg.vector_norm(centre - c, dim=-1) <= r + half
    return occ


def pack_bitfield(occ: torch.Tensor, n_cascades: int = 1) -> torch.Tensor:
    """(n_cascades·128³,) bool cells → the (8·128³/8,) uint8 occupancy
    bitfield: byte = linear index of (x//2, y//2, z//2) in a 64³ grid, bit
    = x&1 | (y&1)<<1 | (z&1)<<2; mip m+1's centre half holds mip m's 2³
    any-pool (frozen copy of the port's packing)."""
    G, GH = GRID, GRID // 2
    occ = occ.view(n_cascades, G, G, G)
    w = torch.arange(2, device=occ.device)
    weights = (1 << (w[:, None, None] * 4 + w[None, :, None] * 2
                     + w[None, None, :])).view(1, 2, 1, 2, 1, 2)
    q = G // 4
    packed = []
    for m in range(CASCADES):
        cur = (occ[m].clone() if m < n_cascades else
               torch.zeros((G, G, G), dtype=torch.bool, device=occ.device))
        if m > 0:
            cur[q:3 * q, q:3 * q, q:3 * q] |= packed[m - 1] != 0
        b = cur.view(GH, 2, GH, 2, GH, 2).to(torch.int32)
        packed.append(torch.sum(b * weights, dim=(1, 3, 5)).to(torch.uint8))
    return torch.stack(packed).reshape(-1)


def unpack_bitfield(bitfield: torch.Tensor) -> torch.Tensor:
    """The (128³,) bool cells of the bitfield's first mip, z-y-x order: the
    inverse of ``pack_bitfield`` there."""
    GH = GRID // 2
    w = torch.arange(2, device=bitfield.device)
    weights = (1 << (w[:, None, None] * 4 + w[None, :, None] * 2
                     + w[None, None, :])).view(1, 2, 1, 2, 1, 2)
    b = bitfield[:GH ** 3].to(torch.int32).view(GH, 1, GH, 1, GH, 1)
    return ((b & weights) != 0).reshape(-1)


def synth_image(p: dict, device) -> torch.Tensor:
    """(res, res, 3) sRGB uint8 image from ``image_seed``: colour
    gradients, a sinusoidal grating of ``grating_px`` pixels in the upper
    right quadrant, and ``n_discs`` hard-edged discs of random colours."""
    rng = np.random.default_rng(int(p["image_seed"]))
    res = int(p["resolution"])
    c = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res
    y, x = torch.meshgrid(c, c, indexing="ij")
    img = torch.stack([0.2 + 0.6 * x, 0.2 + 0.6 * y, 0.8 - 0.6 * x * y], -1)
    theta = float(rng.uniform(0.0, np.pi))
    grating = 0.5 + 0.45 * torch.sin(2 * math.pi * res / float(p["grating_px"])
                                     * (x * math.cos(theta)
                                        + y * math.sin(theta)))
    quad = (x > 0.5) & (y < 0.5)
    img = torch.where(quad[..., None], grating[..., None], img)
    for _ in range(int(p["n_discs"])):
        cx, cy = rng.random(2)
        r = float(rng.uniform(*p["disc_radius_range"]))
        col = torch.tensor(rng.random(3), dtype=torch.float32, device=device)
        lo = np.clip([cy - r, cx - r], 0, 1) * res
        hi = np.clip([cy + r, cx + r], 0, 1) * res
        ys, xs = slice(int(lo[0]), int(hi[0]) + 1), slice(int(lo[1]),
                                                          int(hi[1]) + 1)
        inside = (x[ys, xs] - cx) ** 2 + (y[ys, xs] - cy) ** 2 < r * r
        img[ys, xs] = torch.where(inside[..., None], col, img[ys, xs])
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8)
