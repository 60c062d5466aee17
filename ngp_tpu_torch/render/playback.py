"""Frozen-model playback: bake a trained NeRF into a dense cascaded voxel
cache and render camera paths from it (port of
``ngp_tpu/render/playback.py``; the reference renders trained scenes "in
tens of milliseconds at 1920x1080", ref: docs/index.html:317).

  * BAKE: the trained field once on a dense D³ lattice per occupancy
    cascade (σ-premultiplied rgb and σ), only where the occupancy bitfield
    holds the voxel's cell, into (D, D, D, 4) bf16 volumes on the device.
    The network is ``NerfNetwork.rgb_sigma``: its encode is K1 on the card.
  * RENDER: perspective shear-warp slice compositing (Lacroute & Levoy
    '94). Rays are parameterised by their angles about the dominant view
    axis; resampling a volume slice onto that angle-uniform ray grid is
    separable, two interpolation products per slice (``torch.matmul``, as
    the JAX package computes them outside its kernels). Slices composite
    front to back in blocks of ``zb``; nested cascades composite exactly
    through a per-ray front/back split at the inner cube's entry and exit.
    The frame's one gather is the 4-tap warp of the ray grid onto the
    screen (JAX's tap weights), which also absorbs the lens distortion.

Cache files are ``.npz`` with the JAX package's keys (``n``, ``sides``,
``sh_degree``, ``vol<i>`` in float32), so either package reads the
other's. Supported camera: pinhole with OpenCV distortion.

Intended divergences (both fixes of ADVICE.md): a renderer keeps at most
two orientations of each cascade's volume (``MAX_ORIENTATIONS``, least
recently used out) and at most two sets of screen directions, where the
JAX renderer keeps every orientation it has used; the bake gives each
voxel the occupancy cell of its centre, where JAX takes the cell of its
lower corner (the same for the default D, multiples of 128), and a
renderer refuses a cascade whose D is not a multiple of ``zb``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ngp_tpu_torch.common import NERF_GRIDSIZE, srgb_to_linear_np
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.rays.camera import (iterative_opencv_undistort,
                                       ray_aabb_intersect)

# orientations (dominant axis, flip) of one cascade's volume a renderer
# keeps on the device, and screen-direction sets it keeps
MAX_ORIENTATIONS = 2
MAX_SCREEN_DIRS = 2


class PlaybackCache(NamedTuple):
    """Baked radiance/density volumes, one per occupancy cascade.

    vols[c] (Dz, Dy, Dx, 3B+1) bf16 on the device = [rgb·σ (B SH
    coefficients each), σ], covering the cube centred at 0.5 with side 2^c
    (the occupancy cascades). σ-premultiplied colour interpolates near
    occupancy boundaries as a density-weighted average instead of bleeding
    toward black. A region a finer cascade covers keeps its values: the
    renderer's front/back split excludes that interval, and the live
    values keep trilinear taps at cascade seams right."""
    vols: tuple
    sides: tuple
    sh_degree: int = 0


def sh_basis(dirs: np.ndarray, degree: int) -> np.ndarray:
    """Real spherical harmonics up to degree 2 evaluated at unit dirs
    (..., 3) → (..., (degree+1)^2). Standard constants."""
    x, y, zc = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [np.full_like(x, 0.282095)]
    if degree >= 1:
        out += [0.488603 * y, 0.488603 * zc, 0.488603 * x]
    if degree >= 2:
        out += [1.092548 * x * y, 1.092548 * y * zc,
                0.315392 * (3 * zc * zc - 1.0),
                1.092548 * x * zc,
                0.546274 * (x * x - y * y)]
    if degree >= 3:
        raise ValueError("sh_degree <= 2 supported")
    return np.stack(out, -1).astype(np.float32)


def _sh_basis_torch(d: torch.Tensor, degree: int) -> torch.Tensor:
    """``sh_basis`` of (..., 3) directions, basis first: (B, ...)."""
    x, y, zc = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.282095)]
    if degree >= 1:
        out += [0.488603 * y, 0.488603 * zc, 0.488603 * x]
    if degree >= 2:
        out += [1.092548 * x * y, 1.092548 * y * zc,
                0.315392 * (3 * zc * zc - 1.0),
                1.092548 * x * zc,
                0.546274 * (x * x - y * y)]
    return torch.stack(out, 0)


def _fibonacci_dirs(m: int) -> np.ndarray:
    i = np.arange(m, dtype=np.float64) + 0.5
    phi = np.pi * (1 + 5 ** 0.5) * i
    z = 1 - 2 * i / m
    r = np.sqrt(np.maximum(1 - z * z, 0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    -1).astype(np.float32)


def _cascade_lattice(D: int, side: float) -> np.ndarray:
    """World-space voxel-center coordinates (1D per axis) of a cascade
    cube (centered at 0.5, side ``side``)."""
    lo = 0.5 - side / 2
    return (lo + (np.arange(D, dtype=np.float64) + 0.5)
            * (side / D)).astype(np.float32)


def voxel_cells(Dc: int) -> np.ndarray:
    """The occupancy cell (of NERF_GRIDSIZE per axis) of each of Dc voxel
    centres along an axis: ((2i + 1)·G) // (2·Dc)."""
    return np.minimum(((2 * np.arange(Dc, dtype=np.int64) + 1)
                       * NERF_GRIDSIZE) // (2 * Dc),
                      NERF_GRIDSIZE - 1).astype(np.uint32)


def occupied_voxels(bitfield_level: np.ndarray, Dc: int) -> np.ndarray:
    """Flat (z, y, x) indices of the Dc³ voxels whose centre's cell is set
    in one cascade's packed bitfield, factorised per axis (a dense int64
    broadcast at Dc = 512 would need GBs of host memory)."""
    cell = voxel_cells(Dc)
    half = cell >> 1
    byte = ((half[:, None, None] * occ.GH + half[None, :, None]) * occ.GH
            + half[None, None, :])                             # (z, y, x)
    par = (cell & 1).astype(np.uint8)
    bit = (par[None, None, :] | (par[None, :, None] << 1)
           | (par[:, None, None] << 2))
    mask = (bitfield_level[byte] >> bit) & 1 > 0
    return np.nonzero(mask.reshape(-1))[0]


@torch.no_grad()
def bake_playback_cache(trainer, D=256, D_inner: Optional[int] = None,
                        params=None, ref_eye=None, batch: int = 1 << 17,
                        extra=None, sh_degree: int = 0,
                        sh_dirs: int = 0) -> PlaybackCache:
    """Evaluate the trained field on dense cascade lattices, on the
    trainer's device.

    Only voxels whose occupancy cell bit is set are evaluated (the rest
    stay zero), in batches of ``batch``. ``D`` is the side of every
    cascade (or a list by cascade, the last repeated), ``D_inner`` that of
    cascade 0. View dependence: ``sh_degree`` 0 bakes diffuse rgb toward
    ``ref_eye`` (default: the mean training-camera position; "nearest":
    each voxel toward its nearest training camera); degree L ≥ 1 fits
    (L+1)² spherical-harmonic coefficients by least squares to ``sh_dirs``
    (default 2× the basis size, at least 12) Fibonacci directions.
    """
    if params is None:
        params = trainer.inference_params()
    dev = next(iter(params.values())).device
    cams = np.asarray(trainer.dataset.xforms)[:, :3, 3]
    nearest_cams = None
    if isinstance(ref_eye, str) and ref_eye == "nearest":
        nearest_cams = torch.as_tensor(cams, device=dev)
        ref_eye = None
    if ref_eye is None:
        ref_eye = cams.mean(0)
    eye = torch.as_tensor(np.asarray(ref_eye, np.float32), device=dev)
    bitfield = trainer.grid.bitfield.cpu().numpy()
    aabb_min = float(np.float32(trainer.aabb_min))
    aabb_size = float(np.float32(trainer.aabb_size))
    B = (sh_degree + 1) ** 2 if sh_degree else 1
    if sh_degree:
        M = sh_dirs or max(2 * B, 12)
        dirs_m = _fibonacci_dirs(M)
        pinv = torch.as_tensor(np.linalg.pinv(sh_basis(dirs_m, sh_degree)),
                               device=dev)
        dirs_m = torch.as_tensor(dirs_m, device=dev)

    def rgb_sigma(pos01, dir01):
        return trainer.model.rgb_sigma(pos01, dir01, extra=extra,
                                       params=params)

    def eval_batch(idx, Dc, ax):
        pos = torch.stack([ax[idx % Dc], ax[(idx // Dc) % Dc],
                           ax[idx // (Dc * Dc)]], -1)
        pos01 = (pos - aabb_min) / aabb_size
        if sh_degree:
            rgbs, sigma = [], None
            for m in range(dirs_m.shape[0]):
                dm = dirs_m[m].expand(len(idx), 3)
                rgb_m, sigma = rgb_sigma(pos01, dm * 0.5 + 0.5)
                rgbs.append(rgb_m.to(torch.float32))
            coef = torch.einsum("bm,nmc->nbc", pinv, torch.stack(rgbs, 1))
            sigma = sigma.to(torch.float32)[:, None]
            return torch.cat([coef.reshape(len(idx), 3 * B) * sigma, sigma],
                             -1)
        if nearest_cams is not None:
            d2 = ((pos[:, None, :] - nearest_cams[None]) ** 2).sum(-1)
            d = pos - nearest_cams[torch.argmin(d2, 1)]
        else:
            d = pos - eye[None]
        d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)
        rgb, sigma = rgb_sigma(pos01, d * 0.5 + 0.5)
        sigma = sigma.to(torch.float32)[:, None]
        return torch.cat([rgb.to(torch.float32) * sigma, sigma], -1)

    vols, sides = [], []
    d_list = list(D) if isinstance(D, (list, tuple)) else None
    gv8 = occ.GRID_VOLUME // 8
    for c in range(trainer.max_cascade + 1):
        side = float(2.0 ** c)
        if d_list is not None:
            Dc = d_list[min(c, len(d_list) - 1)]
        else:
            Dc = D_inner if (c == 0 and D_inner) else D
        idx = torch.as_tensor(occupied_voxels(
            bitfield[c * gv8:(c + 1) * gv8], Dc), device=dev)
        vol = torch.zeros((Dc ** 3, 3 * B + 1), dtype=torch.float32,
                          device=dev)
        ax = torch.as_tensor(_cascade_lattice(Dc, side), device=dev)
        for ib in idx.split(batch):
            vol[ib] = eval_batch(ib, Dc, ax)
        vols.append(vol.reshape(Dc, Dc, Dc, 3 * B + 1).to(torch.bfloat16))
        sides.append(side)
    return PlaybackCache(vols=tuple(vols), sides=tuple(sides),
                         sh_degree=sh_degree)


def save_playback_cache(path: str, cache: PlaybackCache):
    np.savez_compressed(path, n=len(cache.vols),
                        sides=np.asarray(cache.sides, np.float32),
                        sh_degree=int(cache.sh_degree),
                        **{f"vol{i}": v.float().cpu().numpy()
                           for i, v in enumerate(cache.vols)})


def load_playback_cache(path: str, device="cuda") -> PlaybackCache:
    """A cache file of either package, its volumes as bf16 on
    ``device``."""
    z = np.load(path)
    n = int(z["n"])
    return PlaybackCache(
        vols=tuple(torch.as_tensor(z[f"vol{i}"], device=device).to(
            torch.bfloat16) for i in range(n)),
        sides=tuple(float(s) for s in z["sides"]),
        sh_degree=int(z["sh_degree"]) if "sh_degree" in z else 0)


@dataclass(frozen=True)
class PlaybackOptions:
    width: int = 1920
    height: int = 1080
    background: tuple = (0.0, 0.0, 0.0, 0.0)
    linear_out: bool = True
    principal: tuple = (0.5, 0.5)
    lens_params: tuple = (0.0, 0.0, 0.0, 0.0)
    lens_mode: str = "auto"        # auto | perspective | opencv
    # ray-grid (intermediate image) resolution relative to the screen;
    # outer cascades composite at a coarser grid (their content is 2x+
    # coarser per voxel anyway) and are upsampled onto the fine grid
    int_scale: float = 1.0
    outer_int_scale: float = 0.5
    # slices composited per block
    zb: int = 8
    # minimum z'-component of the unit ray direction along the dominant
    # axis; rays below it (extreme off-axis) see background only
    min_dz: float = 0.05
    t_start_min: float = 0.05      # near clip (matches the live renderer)


def _frame_angles(d_cam: torch.Tensor, M: torch.Tensor, min_dz: float):
    """d_cam (HW, 3) camera directions, M (3, 3) rotation + permutation +
    flip → ab (HW, 2) angle coordinates, dz_ok (HW,), and
    [amin, amax, bmin, bmax] as floats."""
    d_p = d_cam @ M.T
    d_p = d_p / (torch.linalg.norm(d_p, dim=-1, keepdim=True) + 1e-9)
    dz_ok = d_p[:, 2] > min_dz
    safe = torch.where(dz_ok, d_p[:, 2], 1.0)
    ab = torch.stack([torch.arctan(d_p[:, 0] / safe),
                      torch.arctan(d_p[:, 1] / safe)], -1)
    big = 1e9
    rng = torch.stack([torch.where(dz_ok, ab[:, 0], big).min(),
                       torch.where(dz_ok, ab[:, 0], -big).max(),
                       torch.where(dz_ok, ab[:, 1], big).min(),
                       torch.where(dz_ok, ab[:, 1], -big).max()])
    return ab, dz_ok, [float(v) for v in rng.cpu()]


def _angle_grid(rng: torch.Tensor, n: int) -> torch.Tensor:
    """The n angles of a ray-grid axis: rng = [first edge, step]."""
    dev = rng.device
    return rng[0] + (torch.arange(n, dtype=torch.float32, device=dev)
                     + 0.5) * rng[1]


def _grid_setup(prange, qrange, e, P: int, Q: int, degree: int,
                has_inner: bool, S, s_in: float):
    """Per-cascade ray-grid geometry: the inner cube's entry/exit t per
    grid ray (+inf where there is none) and the SH basis at the rays'
    world directions (S maps permuted directions to world axes)."""
    rx = torch.tan(_angle_grid(prange, P))[None, :].expand(Q, P)
    ry = torch.tan(_angle_grid(qrange, Q))[:, None].expand(Q, P)
    nrm = torch.sqrt(rx * rx + ry * ry + 1.0)
    d_p = torch.stack([rx / nrm, ry / nrm, 1.0 / nrm], -1)     # (Q, P, 3)
    if has_inner:
        lo = torch.full((3,), 0.5 - s_in / 2, device=e.device)
        hi = torch.full((3,), 0.5 + s_in / 2, device=e.device)
        t0, t1 = ray_aabb_intersect(e.expand(Q, P, 3), d_p, lo, hi)
        miss = t0 > t1
        t_in = torch.where(miss, torch.inf, t0)
        t_out = torch.where(miss, torch.inf, t1)
    else:
        t_in = torch.full((Q, P), torch.inf, device=e.device)
        t_out = t_in
    if degree:
        basis = _sh_basis_torch(torch.einsum("ij,qpj->qpi", S, d_p), degree)
    else:
        basis = torch.ones((1, Q, P), device=e.device)
    return t_in, t_out, basis


def _interp_weights(u: torch.Tensor, n: int) -> torch.Tensor:
    """Linear-interpolation weights (..., n) of sample coordinates u over
    n taps, in bf16 (the JAX package's slice weights)."""
    j = torch.arange(n, dtype=torch.float32, device=u.device)
    return torch.clamp(1.0 - torch.abs(u[..., None] - j), 0.0, 1.0).to(
        torch.bfloat16)


def composite_cascade(vol, zs, e, prange, qrange, side: float, t_in, t_out,
                      basis, P: int, Q: int, zb: int, t_near: float):
    """Composite one cascade onto the (Q, P) ray grid, front to back.

    vol (D, C, D, D) bf16 channel-second slices, t ascending along z';
    zs (D,) slice centres; e (3,) the eye in permuted coordinates;
    prange/qrange (2,) [first angle, step]; t_in/t_out (Q, P) the inner
    cube's entry and exit per ray; basis (B, Q, P). Returns (rgb_f (3,Q,P),
    od_f (Q,P), rgb_b, od_b): what lies in front of the inner cube and
    behind it."""
    D, C = vol.shape[0], vol.shape[1]
    B = (C - 1) // 3
    rx = torch.tan(_angle_grid(prange, P))                      # (P,)
    ry = torch.tan(_angle_grid(qrange, Q))                      # (Q,)
    norm = torch.sqrt(rx[None, :] ** 2 + ry[:, None] ** 2 + 1.0)  # (Q, P)
    vox = side / D
    dt_img = vox * norm
    lo = 0.5 - side / 2
    rgb_f = torch.zeros((3, Q, P), device=vol.device)
    rgb_b = torch.zeros_like(rgb_f)
    od_f = torch.zeros((Q, P), device=vol.device)
    od_b = torch.zeros_like(od_f)
    for k0 in range(0, D, zb):
        slabs, z_blk = vol[k0:k0 + zb], zs[k0:k0 + zb]
        # each slice's separable map onto the ray grid: two interpolation
        # products (the first in bf16, the second accumulated in f32)
        h = z_blk - e[2]                                        # (zb,)
        ux = (e[0] + rx[None, :] * h[:, None] - lo) / vox - 0.5   # (zb, P)
        uy = (e[1] + ry[None, :] * h[:, None] - lo) / vox - 0.5   # (zb, Q)
        a = torch.matmul(_interp_weights(uy, D)[:, None], slabs)  # kcqx
        smp = torch.matmul(a.float(), _interp_weights(ux, D).float()
                           .transpose(1, 2)[:, None])           # (zb,C,Q,P)
        t_k = h[:, None, None] * norm                           # (zb, Q, P)
        sig = torch.clamp(smp[:, C - 1], min=0.0)
        cols = smp[:, :3 * B].reshape(len(h), B, 3, Q, P)
        rgb_k = torch.clamp((cols * basis[None, :, None]).sum(1), min=0.0) \
            / torch.clamp(sig, min=1e-9)[:, None]
        od_k = sig * dt_img
        live = t_k > t_near
        od_kf = torch.where(live & (t_k < t_in), od_k, 0.0)
        od_kb = torch.where(live & (t_k > t_out), od_k, 0.0)
        for od, od_kx, rgb in ((od_f, od_kf, rgb_f), (od_b, od_kb, rgb_b)):
            # optical depth in front of each slice of the block
            before = od + torch.cumsum(od_kx, 0) - od_kx
            w = torch.exp(-before) * (1.0 - torch.exp(-od_kx))
            rgb += (w[:, None] * rgb_k).sum(0)
            od += od_kx.sum(0)
    return rgb_f, od_f, rgb_b, od_b


# axis permutations: _PERMS[a] = world axes taking the (x', y', z') slots
# when world axis ``a`` is the dominant (z') one
_PERMS = ((2, 1, 0), (0, 2, 1), (0, 1, 2))


class PlaybackRenderer:
    """Camera-path renderer over a PlaybackCache (see the module
    docstring). Volumes permuted and flipped for a dominant view axis are
    kept per cascade, at most MAX_ORIENTATIONS of them (a camera path
    changes its dominant axis rarely)."""

    def __init__(self, cache: PlaybackCache, opts: PlaybackOptions):
        for v in cache.vols:
            if v.shape[0] % opts.zb:
                raise ValueError(f"a cascade of side {v.shape[0]} is not "
                                 f"a multiple of zb = {opts.zb}")
        self.cache = cache
        self.opts = opts
        self._vol_cache = OrderedDict()
        self._dirs_cache = OrderedDict()

    @property
    def device(self):
        return self.cache.vols[0].device

    def orientations(self, ci: int) -> list:
        """The (axis, flip) orientations of cascade ``ci`` held now, least
        recently used first."""
        return [k[1:] for k in self._vol_cache if k[0] == ci]

    def _screen_dirs(self, W, H, fx, fy) -> torch.Tensor:
        """(H·W, 3) camera-space ray directions with the lens distortion,
        at the pixel centres (the eval protocol's deterministic sampling,
        ref: scripts/run.py:228-241), on the device."""
        key = (W, H, float(fx), float(fy))
        hit = self._dirs_cache.get(key)
        if hit is not None:
            self._dirs_cache.move_to_end(key)
            return hit
        o = self.opts
        cx, cy = o.principal
        px = (np.arange(W, dtype=np.float32) + 0.5) / W
        py = (np.arange(H, dtype=np.float32) + 0.5) / H
        u, v = np.meshgrid(px, py)
        dx = torch.as_tensor(((u - cx) * W / fx).ravel(), device=self.device)
        dy = torch.as_tensor(((v - cy) * H / fy).ravel(), device=self.device)
        mode = o.lens_mode
        if mode == "auto":
            mode = "opencv" if any(abs(p) > 0 for p in o.lens_params[:4]) \
                else "perspective"
        if mode == "opencv":
            dx, dy = iterative_opencv_undistort(dx, dy, *o.lens_params[:4])
        out = torch.stack([dx.float(), dy.float(), torch.ones_like(dx)], -1)
        self._dirs_cache[key] = out
        while len(self._dirs_cache) > MAX_SCREEN_DIRS:
            self._dirs_cache.popitem(last=False)
        return out

    def _get_vol(self, ci, axis, flip):
        key = (ci, axis, flip)
        if key in self._vol_cache:
            self._vol_cache.move_to_end(key)
            return self._vol_cache[key]
        held = [k for k in self._vol_cache if k[0] == ci]
        for k in held[:len(held) - MAX_ORIENTATIONS + 1]:
            del self._vol_cache[k]
        perm = _PERMS[axis]
        # storage (worldZ, worldY, worldX, C) → channel-second (z', C, y',
        # x'), t ascending along z'
        v = self.cache.vols[ci].permute(2 - perm[2], 3, 2 - perm[1],
                                        2 - perm[0])
        if flip:
            v = v.flip(0)
        self._vol_cache[key] = v.contiguous()
        return self._vol_cache[key]

    @torch.no_grad()
    def render(self, xform, W=None, H=None, focal=None) -> np.ndarray:
        """One frame: (H, W, 4) float32 numpy (rgb + alpha)."""
        opts = self.opts
        W = W or opts.width
        H = H or opts.height
        if focal is None:
            raise ValueError("focal required")
        fx, fy = (focal, focal) if np.isscalar(focal) else focal
        dev = self.device
        xf = np.asarray(xform, np.float32).reshape(3, 4)
        d_cam = self._screen_dirs(W, H, fx, fy)
        fwd = xf[:, 2]
        axis = int(np.argmax(np.abs(fwd)))
        perm = _PERMS[axis]
        flip = bool(fwd[axis] < 0)
        e = xf[:, 3][list(perm)].copy()
        if flip:
            # mirror z' → 1 - z' (cascade cubes are centred at 0.5; the
            # volumes are flipped in _get_vol)
            e[2] = 1.0 - e[2]
        # world rotation + axis permutation + flip as one 3x3: row j gives
        # the permuted direction's component j
        M = np.asarray(xf[:, :3])[list(perm), :].copy()
        if flip:
            M[2] *= -1.0
        ab, dz_ok, (pmin, pmax, qmin, qmax) = _frame_angles(
            d_cam, torch.as_tensor(M, device=dev), opts.min_dz)
        e_t = torch.as_tensor(e, device=dev)
        S = np.zeros((3, 3), np.float32)
        S[perm[0], 0] = 1.0
        S[perm[1], 1] = 1.0
        S[perm[2], 2] = -1.0 if flip else 1.0
        S = torch.as_tensor(S, device=dev)
        grids = []
        for ci in range(len(self.cache.vols)):
            D = int(self.cache.vols[ci].shape[0])
            scale = opts.int_scale if ci == 0 else opts.outer_int_scale
            P = max(int(round(W * scale)), 64)
            Q = max(int(round(H * scale)), 64)
            side = self.cache.sides[ci]
            vol = self._get_vol(ci, axis, flip)
            zs = torch.as_tensor(_cascade_lattice(D, side), device=dev)
            prange = torch.as_tensor(np.asarray([pmin, (pmax - pmin) / P],
                                                np.float32), device=dev)
            qrange = torch.as_tensor(np.asarray([qmin, (qmax - qmin) / Q],
                                                np.float32), device=dev)
            t_in, t_out, basis = _grid_setup(
                prange, qrange, e_t, P, Q, int(self.cache.sh_degree), ci > 0,
                S, self.cache.sides[ci - 1] if ci else 1.0)
            res = composite_cascade(vol, zs, e_t, prange, qrange, side, t_in,
                                    t_out, basis, P, Q, opts.zb,
                                    float(opts.t_start_min))
            grids.append((res, P, Q, prange, qrange))
        # combine innermost-out on the cascade-0 ray grid:
        # R_c = F_c OVER (R_{c-1} OVER B_c)
        (comb_rgb, comb_od, _, _), P0, Q0, prange0, qrange0 = grids[0]
        for (rgb_f, od_f, rgb_b, od_b), P, Q, prange, qrange in grids[1:]:
            rgb_f, od_f = _regrid(rgb_f, od_f, prange, qrange, prange0,
                                  qrange0, P0, Q0)
            rgb_b, od_b = _regrid(rgb_b, od_b, prange, qrange, prange0,
                                  qrange0, P0, Q0)
            inner_rgb = comb_rgb + torch.exp(-comb_od)[None] * rgb_b
            inner_od = comb_od + od_b
            comb_rgb = rgb_f + torch.exp(-od_f)[None] * inner_rgb
            comb_od = od_f + inner_od
        img = _warp_to_screen(comb_rgb, comb_od, prange0, qrange0, P0, Q0,
                              ab, dz_ok, torch.as_tensor(
                                  opts.background, dtype=torch.float32,
                                  device=dev), H, W).cpu().numpy()
        # the baked rgb is in the model's composite space (sRGB unless the
        # trainer trained in linear colours): linear_out converts it as
        # the live renderer does
        if opts.linear_out:
            img = np.concatenate(
                [srgb_to_linear_np(np.clip(img[..., :3], 0.0, None)),
                 img[..., 3:4]], -1).astype(np.float32)
        return img


def _regrid(rgb, od, prange_s, qrange_s, prange_d, qrange_d, P: int, Q: int):
    """Bilinearly resample a (rgb (3,Q,P), od (Q,P)) ray grid onto another
    grid of the same parameterisation (another resolution): two
    interpolation products, edge rows renormalised."""
    Qs, Ps = rgb.shape[1], rgb.shape[2]
    dev = rgb.device
    up = (_angle_grid(prange_d, P) - prange_s[0]) / prange_s[1] - 0.5
    uq = (_angle_grid(qrange_d, Q) - qrange_s[0]) / qrange_s[1] - 0.5
    Wp = torch.clamp(1.0 - torch.abs(
        up[:, None] - torch.arange(Ps, dtype=torch.float32, device=dev)),
        0, 1)
    Wq = torch.clamp(1.0 - torch.abs(
        uq[:, None] - torch.arange(Qs, dtype=torch.float32, device=dev)),
        0, 1)
    Wp = Wp / torch.clamp(Wp.sum(-1, keepdim=True), min=1e-9)
    Wq = Wq / torch.clamp(Wq.sum(-1, keepdim=True), min=1e-9)
    x = torch.cat([rgb, od[None]], 0)                          # (4, Qs, Ps)
    b = torch.matmul(torch.matmul(Wq, x), Wp.T)                # (4, Q, P)
    return b[:3], b[3]


def _warp_to_screen(rgb, od, prange, qrange, P: int, Q: int, ab, dz_ok, bg,
                    H: int, W: int) -> torch.Tensor:
    """The bilinear ray-grid → screen warp (4 taps a pixel, gathered) and
    the background composite → (H, W, 4)."""
    u = (ab[:, 0] - prange[0]) / prange[1] - 0.5
    v = (ab[:, 1] - qrange[0]) / qrange[1] - 0.5
    u = torch.clamp(u, 0.0, P - 1.0)
    v = torch.clamp(v, 0.0, Q - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, P - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, Q - 2)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    x = torch.cat([rgb, od[None]], 0).permute(1, 2, 0).reshape(Q * P, 4)
    i00 = v0 * P + u0
    g = (x[i00] * (1 - fu) * (1 - fv) + x[i00 + 1] * fu * (1 - fv)
         + x[i00 + P] * (1 - fu) * fv + x[i00 + P + 1] * fu * fv)
    od_s = torch.where(dz_ok, g[:, 3], 0.0)
    T = torch.exp(-od_s)
    rgb_s = torch.where(dz_ok[:, None], g[:, :3], 0.0) \
        + T[:, None] * bg[None, :3]
    return torch.cat([rgb_s, (1.0 - T)[:, None]], -1).reshape(H, W, 4)
