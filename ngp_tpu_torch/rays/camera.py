"""Camera/ray math (port of ``ngp_tpu/rays/camera.py``): pixel → ray for
the four lens models, AABB intersection, per-ray camera interpolation, and
the VR / lenticular helpers (quilting, reprojection, motion vectors)."""
from __future__ import annotations

import math

import torch

LENS_MODES = ("perspective", "opencv", "ftheta", "latlong")


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
    src/testbed_nerf.cu:1166-1184): perspective, OpenCV undistortion,
    F-theta fisheye and LatLong equirect lenses.

    xy (N,2) in [0,1]; xform (N,3,4); focal (N,2); principal (N,2);
    resolution (N,2) float; lens_params (N,≥4), (N,7) for F-theta.
    Returns (origin (N,3), unnormalised direction (N,3)). An unknown lens
    mode raises ValueError (the JAX package takes it as perspective)."""
    if lens_mode is None:
        lens_mode = "opencv" if use_opencv else "perspective"
    if lens_mode not in LENS_MODES:
        raise ValueError(f"lens mode {lens_mode!r} is not one of "
                         f"{LENS_MODES}")
    if lens_mode == "latlong":
        d = latlong_to_dir(xy)
    elif lens_mode == "ftheta":
        d = f_theta_undistort(xy - principal, lens_params,
                              xy.new_tensor([0.0, 0.0, 1.0]))
    else:
        dx = (xy[:, 0] - principal[:, 0]) * resolution[:, 0] / focal[:, 0]
        dy = (xy[:, 1] - principal[:, 1]) * resolution[:, 1] / focal[:, 1]
        if lens_mode == "opencv":
            dx, dy = iterative_opencv_undistort(
                dx, dy, lens_params[:, 0], lens_params[:, 1],
                lens_params[:, 2], lens_params[:, 3])
        d = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    world_d = torch.einsum("nij,nj->ni", xform[:, :, :3], d)
    return xform[:, :, 3], world_d


def latlong_to_dir(xy: torch.Tensor) -> torch.Tensor:
    """Equirectangular pixel (N, 2) in [0,1] → unit direction (N, 3)
    (ref: common_device.cuh:248-258)."""
    theta = (xy[:, 1] - 0.5) * math.pi
    phi = (xy[:, 0] - 0.5) * 2.0 * math.pi
    ct = torch.cos(theta)
    return torch.stack([ct * torch.sin(phi), torch.sin(theta),
                        ct * torch.cos(phi)], -1)


def f_theta_undistort(xy_rel: torch.Tensor, params: torch.Tensor,
                      default_dir: torch.Tensor) -> torch.Tensor:
    """F-theta (fisheye polynomial) undistortion (ref:
    f_theta_undistortion, common_device.cuh:236-249). ``xy_rel`` (..., 2)
    is the uv offset from the principal point; ``params`` (..., 7) holds
    p0..p4 and the intrinsics' native (w, h), into whose pixel frame the
    offsets are scaled before the polynomial θ(r). Where cos θ ≤ 1e-37 or
    r = 0 the direction is ``default_dir``."""
    p = params
    xpix = xy_rel[..., 0] * p[..., 5]
    ypix = xy_rel[..., 1] * p[..., 6]
    r = torch.sqrt(xpix * xpix + ypix * ypix)
    theta = p[..., 0] + r * (p[..., 1] + r * (p[..., 2] + r * (
        p[..., 3] + r * p[..., 4])))
    cos_t = torch.cos(theta)
    sin_r = torch.sin(theta) / torch.clamp(r, min=1e-9)
    d = torch.stack([sin_r * xpix, sin_r * ypix, cos_t], -1)
    bad = (cos_t <= 1e-37) | (r == 0.0)
    return torch.where(bad[..., None], default_dir, d)


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


# ---------------------------------------------------------------------------
# VR / lenticular-display helpers (ref: common_device.cuh:320-400,541-560)
# ---------------------------------------------------------------------------

def apply_quilting(x: torch.Tensor, y: torch.Tensor, resolution,
                   parallax_shift, quilting_dims):
    """Full-frame pixel coordinates → coordinates within their panel of a
    quilt, and each panel's parallax head shift (ref: apply_quilting,
    common_device.cuh:541-560). ``quilting_dims`` (2, 1) is VR stereo
    (``parallax_shift[0]`` is the IPD: the left panel's head moves by +½ of
    it, the right one's by −½); any other grid is a HoloPlay-style fan of
    views over ±17.5°.

    x, y: (N,) pixel coordinates; resolution (W, H) of the whole frame;
    parallax_shift (3,). Returns (x_panel, y_panel, parallax_shift (N, 3))."""
    qx, qy = int(quilting_dims[0]), int(quilting_dims[1])
    resx = resolution[0] / qx
    resy = resolution[1] / qy
    panelx = torch.floor(x / resx)
    panely = torch.floor(y / resy)
    x = x - panelx * resx
    y = y - panely * resy
    idx = panelx + qx * panely
    ps = torch.as_tensor(parallax_shift, dtype=torch.float32,
                         device=x.device).expand(*x.shape, 3)
    if (qx, qy) == (2, 1):
        px = torch.where(idx > 0, -0.5 * ps[..., 0], 0.5 * ps[..., 0])
    else:
        ang = 17.5 * math.pi / 180.0 * ((idx + 0.5) * 2.0
                                        / float(qx * qy) - 1.0)
        px = torch.arctan(ang) / torch.clamp(ps[..., 2], min=1e-9)
    return x, y, torch.cat([px[..., None], ps[..., 1:]], -1)


def pos_to_pixel(pos: torch.Tensor, resolution, focal, xform: torch.Tensor,
                 screen_center, parallax_shift=(0.0, 0.0, 0.0),
                 lens_params=None, lens_is_opencv: bool = False):
    """World positions (N, 3) → pixel coordinates (N, 2) of the camera
    ``xform`` (3, 4) camera→world: the inverse of the pinhole pixel → ray,
    with the parallax head shift and the forward OpenCV distortion (ref:
    pos_to_pixel, common_device.cuh:320-355)."""
    ps = [float(v) for v in parallax_shift]
    head = pos.new_tensor([ps[0], ps[1], 0.0])
    R = xform[:, :3]
    origin = R @ head + xform[:, 3]
    d = (pos - origin[None]) @ R       # R⁻¹ = Rᵀ applied row-wise
    d = d / d[:, 2:3]
    d = d + head[None] * ps[2]
    u, v = d[:, 0], d[:, 1]
    if lens_is_opencv and lens_params is not None:
        k1, k2, p1, p2 = (float(lens_params[i]) for i in range(4))
        r2 = u * u + v * v
        rad = k1 * r2 + k2 * r2 * r2
        du = u * rad + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        dv = v * rad + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
        u, v = u + du, v + dv
    return torch.stack([u * focal[0] + screen_center[0] * resolution[0],
                        v * focal[1] + screen_center[1] * resolution[1]], -1)


def motion_vector_3d(pixel_xy: torch.Tensor, resolution, focal,
                     xform: torch.Tensor, prev_xform: torch.Tensor,
                     screen_center, depth: torch.Tensor,
                     parallax_shift=(0.0, 0.0, 0.0), lens_params=None,
                     lens_is_opencv: bool = False) -> torch.Tensor:
    """Screen-space motion vectors (N, 2): each pixel's hit point, at
    ``depth`` (N,) along its pinhole ray, projected through the previous
    camera, minus the pixel (ref: motion_vector_3d,
    common_device.cuh:356-400)."""
    ps = [float(v) for v in parallax_shift]
    u = (pixel_xy[:, 0] / resolution[0] - screen_center[0]) \
        * resolution[0] / focal[0]
    v = (pixel_xy[:, 1] / resolution[1] - screen_center[1]) \
        * resolution[1] / focal[1]
    head = pixel_xy.new_tensor([ps[0], ps[1], 0.0])
    d_cam = torch.stack([u, v, torch.ones_like(u)], -1) - head[None] * ps[2]
    R = xform[:, :3]
    pos = (R @ head + xform[:, 3])[None] + (d_cam @ R.T) * depth[:, None]
    prev = pos_to_pixel(pos, resolution, focal, prev_xform, screen_center,
                        parallax_shift, lens_params, lens_is_opencv)
    return prev - pixel_xy
