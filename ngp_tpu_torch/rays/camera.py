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


# ---------------------------------------------------------------------------
# per-ray camera interpolation (rolling shutter / motion blur)
# ---------------------------------------------------------------------------

def quat_from_mat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation → quaternion (..., 4) as (w, x, y, z), for every
    rotation: Shepperd's method, each matrix picking the pivot of the
    largest 4·{w,x,y,z}² (a w-only construction turns a 180° rotation into
    the identity)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    s = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                     1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    pivot = torch.argmax(s, -1, keepdim=True)
    r = torch.sqrt(torch.clamp(torch.gather(s, -1, pivot)[..., 0],
                               min=1e-12))
    inv = 0.5 / r               # = 1/(2r)
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    h = 0.5 * r
    cands = torch.stack([
        torch.stack([h, d21 * inv, d02 * inv, d10 * inv], -1),
        torch.stack([d21 * inv, h, s01 * inv, s02 * inv], -1),
        torch.stack([d02 * inv, s01 * inv, h, s12 * inv], -1),
        torch.stack([d10 * inv, s02 * inv, s12 * inv, h], -1)], -2)
    q = torch.gather(cands, -2, pivot[..., None].expand(
        *pivot.shape[:-1], 1, 4))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_slerp(qa, qb, t):
    """Short-path slerp; qa/qb (..., 4), t (N,) → (N, 4)."""
    dot = torch.sum(qa * qb, -1)
    qb = torch.where(dot[..., None] < 0, -qb, qb)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    s = torch.clamp(torch.sin(theta), min=1e-6)
    w1 = torch.sin((1 - t) * theta) / s
    w2 = torch.sin(t * theta) / s
    lin = (1 - t)[..., None] * qa + t[..., None] * qb
    sph = w1[..., None] * qa + w2[..., None] * qb
    q = torch.where((dot > 0.9995)[..., None], lin, sph)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternion (w, x, y, z) → (N, 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def xform_slerp(xf_a: torch.Tensor, xf_b: torch.Tensor, t: torch.Tensor):
    """Interpolate (3, 4) camera matrices: translation lerp + rotation
    slerp (ref: get_xform_given_rolling_shutter,
    common_device.cuh:224-234). Broadcasts (3,4)+(N,) or (N,3,4)+(N,)."""
    if xf_a.dim() == 2:
        pos = xf_a[:, 3][None] + (xf_b[:, 3] - xf_a[:, 3])[None] * t[:, None]
        qa = quat_from_mat(xf_a[:, :3])[None]
        qb = quat_from_mat(xf_b[:, :3])[None]
    else:
        pos = xf_a[:, :, 3] + (xf_b[:, :, 3] - xf_a[:, :, 3]) * t[:, None]
        qa = quat_from_mat(xf_a[:, :, :3])
        qb = quat_from_mat(xf_b[:, :, :3])
    R = quat_to_mat(quat_slerp(qa, qb, t))
    return torch.cat([R, pos[:, :, None]], -1)
