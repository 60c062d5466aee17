"""Camera/ray math used by the renderer (port of the matching parts of
``ngp_tpu/rays/camera.py``)."""
from __future__ import annotations

import torch


def iterative_opencv_undistort(u, v, k1, k2, p1, p2, iters: int = 8):
    """Invert the Brown-Conrady distortion by fixed-point iteration
    (ref: iterative_opencv_lens_undistortion, common_device.cuh)."""
    x, y = u, v
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * k2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (u - dx) / radial
        y = (v - dy) / radial
    return x, y


def pixel_to_ray_train(xy, xform, focal, principal, resolution, lens_params,
                       use_opencv: bool, lens_mode: str = None):
    """Training rays (ref: generate_training_samples_nerf,
    src/testbed_nerf.cu:1166-1184), perspective and OpenCV lenses.

    xy (N,2) in [0,1]; xform (N,3,4); focal (N,2); principal (N,2);
    resolution (N,2) float; lens_params (N,≥4). Returns (origin (N,3),
    unnormalised direction (N,3))."""
    if lens_mode is None:
        lens_mode = "opencv" if use_opencv else "perspective"
    if lens_mode not in ("perspective", "opencv"):
        raise NotImplementedError(f"lens mode {lens_mode!r} is not ported "
                                  "yet")
    dx = (xy[:, 0] - principal[:, 0]) * resolution[:, 0] / focal[:, 0]
    dy = (xy[:, 1] - principal[:, 1]) * resolution[:, 1] / focal[:, 1]
    if lens_mode == "opencv":
        dx, dy = iterative_opencv_undistort(
            dx, dy, lens_params[:, 0], lens_params[:, 1], lens_params[:, 2],
            lens_params[:, 3])
    d = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    world_d = torch.einsum("nij,nj->ni", xform[:, :, :3], d)
    return xform[:, :, 3], world_d


def ray_aabb_intersect(o: torch.Tensor, d: torch.Tensor, aabb_min, aabb_max):
    """Slab test; returns (tmin, tmax), empty when tmin > tmax
    (ref: BoundingBox::ray_intersect, bounding_box.cuh)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    t0 = (aabb_min - o) * inv
    t1 = (aabb_max - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmin, tmax
