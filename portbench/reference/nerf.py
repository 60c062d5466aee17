"""Plain PyTorch reference of the NeRF configuration (instant-ngp's
``configs/nerf/base.json`` on an aabb_scale-1 scene): the network, the
occupancy grid's first full sweep, a training step and a rendered frame.

Written from instant-ngp's description (Müller et al. 2022, §4 and
Appendix E; ``src/testbed_nerf.cu``'s conventions: the NGP camera matrix,
the cone-stepped lattice of Δ = √3/1024 with cone angle 0 at aabb_scale 1,
the 128³ occupancy grid thresholded at min(mean, 0.01), Huber loss α = 0.1
over 5 in sRGB with a random background, the density regularisers,
per-ray compositing front to back, Adam under Ema). It imports nothing
of the program and takes nothing the program made: weights, views and
cameras are the benchmark's, the random draws are recorded where the
program takes them, and the occupancy grid is swept again here and
marched by the reference's steps.

Departures, each one that the program shares with instant-ngp: the
network's products run on bf16-rounded operands in f32 (the
configuration's FullyFusedMLP in the program's numerics), and a frame
keeps at most ``cap`` samples a ray, every m-th, each standing for the m
it replaces (the renderer's decimation).
"""
from __future__ import annotations

import math

import torch

from portbench.lib import geometry as geo
from portbench.reference import plain

STEP = math.sqrt(3.0) / 1024          # the lattice step at aabb_scale 1
GRID = 128
NEAR_DISTANCE = 0.2                   # the trainer's near-plane penalty
MIN_OPTICAL_THICKNESS = 0.01
LEAVES = ("pos_encoding.table", "density_net.weights.0",
          "density_net.weights.1", "rgb_net.weights.0", "rgb_net.weights.1",
          "rgb_net.weights.2")
MATRICES = set(LEAVES[1:])


def grid_meta(config: dict) -> geo.GridMeta:
    return geo.grid_meta(config["encoding"], 3, 2048.0)


def network(params: dict, pos01, dir01, meta, prec="f32"):
    """(rgb_raw (N, 3), density_raw (N,)): the density MLP on the grid's
    features, its 16 outputs with the SH-4 encoded direction into the RGB
    MLP."""
    h = plain.mlp(plain.encode(params["pos_encoding.table"], pos01, meta,
                               prec),
                  [params["density_net.weights.0"],
                   params["density_net.weights.1"]], prec)
    rgb = plain.mlp(torch.cat([h, plain.sh4(dir01)], -1),
                    [params[f"rgb_net.weights.{i}"] for i in range(3)], prec)
    return rgb, h[:, 0]


def density_raw(params: dict, pos01, meta, prec="f32"):
    """The density MLP's first output at ``pos01`` (N,)."""
    return plain.mlp(plain.encode(params["pos_encoding.table"], pos01, meta,
                                  prec),
                     [params["density_net.weights.0"],
                      params["density_net.weights.1"]], prec)[:, 0]


def sigma_of(raw):
    return torch.exp(torch.clamp(raw, -15.0, 15.0))


def aabb_hits(o, d, lo=0.0, hi=1.0):
    """Slab test of rays against the cube [lo, hi]³: (t_in, t_out)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    return (torch.amax(torch.minimum(t0, t1), -1),
            torch.amin(torch.maximum(t0, t1), -1))


def occupied(occ: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 128³ grid's (z-y-x bool) cell of each point, clamped to the
    grid."""
    c = torch.clamp((((pos - 0.5) + 0.5) * GRID).to(torch.int32), 0,
                    GRID - 1).to(torch.int64)
    return occ[(c[:, 2] * GRID + c[:, 1]) * GRID + c[:, 0]]


def lattice(occ, o, d, t_start, steps: int, jitter=None):
    """(t (R, K), live (R, K)): the lattice t_k = t_0 + k·Δ from the cube's
    entry (at least ``t_start``; offset by jitter·Δ), live where inside the
    cube and in an occupied cell."""
    tmin, tmax = aabb_hits(o, d)
    tmin = torch.clamp(tmin, min=t_start)
    t0 = tmin if jitter is None else tmin + STEP * jitter
    k = torch.arange(steps, dtype=torch.float32, device=o.device)
    t = t0[:, None] + k[None, :] * STEP
    pos = o[:, None, :] + t[..., None] * d[:, None, :]
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]
    return t, inside & occupied(occ, pos.reshape(-1, 3)).view(t.shape)


def composite(sigma, rgb, sdt_dt, ray, k, n_rays: int, steps: int):
    """Front-to-back compositing of samples (ray ``ray``, lattice slot
    ``k``) with transmittance from each ray's own running optical depth:
    (rgb (R, 3), optical depth (R,))."""
    sdt = sigma * sdt_dt
    lat = torch.zeros((n_rays, steps), device=sdt.device)
    lat[ray, k] = sdt
    before = (torch.cumsum(lat, 1) - lat)[ray, k]
    w = torch.exp(-torch.clamp(before, 0.0, 88.0)) * (1.0 - torch.exp(-sdt))
    out = torch.zeros((n_rays, 3), device=sdt.device).index_add(
        0, ray, w[:, None] * rgb)
    depth = torch.zeros(n_rays, device=sdt.device).index_add(
        0, ray, torch.clamp(sdt, max=88.0))
    return out, depth


# --- the occupancy grid's first sweep ----------------------------------------

def seen_cells(xforms, focal, res) -> torch.Tensor:
    """(128³,) bool: cells whose bounding sphere some training camera's
    frustum reaches (the reference's culling of untrained cells)."""
    dev = xforms.device
    i = torch.arange(GRID ** 3, device=dev)
    pos = (torch.stack([i % GRID, (i // GRID) % GRID, i // GRID ** 2], -1)
           .to(torch.float32) + 0.5) / GRID
    radius = 0.5 * math.sqrt(3.0) / GRID
    seen = torch.zeros(pos.shape[0], dtype=torch.bool, device=dev)
    for xf, f, r in zip(xforms, focal, res):
        p = pos - xf[:, 3]
        x, y, z = p @ xf[:, 0], p @ xf[:, 1], p @ xf[:, 2]
        seen |= ((z > 0) & (torch.abs(x) - radius < z / f[0] * (r[0] * 0.5))
                 & (torch.abs(y) - radius < z / f[1] * (r[1] * 0.5)))
    return seen


@torch.no_grad()
def first_sweep(params, meta, positions, seen, prec="f32",
                chunk: int = 1 << 18) -> torch.Tensor:
    """The occupancy of a full sweep from an empty grid: each seen cell's
    σ·Δ at its sample position (``positions``, one per cell in z-y-x
    order), thresholded at min(mean, 0.01)."""
    dens = torch.cat([sigma_of(density_raw(params, c, meta, prec))
                      for c in positions.split(chunk)]) * STEP
    dens = torch.where(seen, dens, -1.0)
    mean = torch.mean(torch.clamp(dens, min=0.0))
    return dens > torch.clamp(mean, max=MIN_OPTICAL_THICKNESS), mean


# --- training ----------------------------------------------------------------

def train_rays(data: dict, draws: dict):
    """Each ray's image, target texel (linear premultiplied RGBA) and world
    ray (o, unit d) from the step's uniforms."""
    I = data["u8"].shape[0]
    H, W = data["u8"].shape[1:3]
    img = torch.clamp((draws["u_img"] * I).to(torch.int64), 0, I - 1)
    xy = draws["u_xy"]
    res = torch.tensor([W, H], device=xy.device)
    pix = torch.minimum(torch.clamp((xy * res).to(torch.int64), min=0),
                        res - 1)
    raw = data["u8"][img, pix[:, 1], pix[:, 0]].to(torch.float32) \
        * (1.0 / 255.0)
    tex = torch.cat([plain.srgb_to_linear(raw[:, :3]) * raw[:, 3:],
                     raw[:, 3:]], -1)
    xf = data["xforms"][img]
    focal = data["focal"]
    dcam = torch.stack([(xy[:, 0] - 0.5) * W / focal,
                        (xy[:, 1] - 0.5) * H / focal,
                        torch.ones_like(xy[:, 0])], -1)
    d = torch.einsum("nij,nj->ni", xf[:, :, :3], dcam)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-9)
    return tex, xf[:, :, 3], d


def step_loss(params, meta, occ, occ_mean, data, draws, steps: int,
              capacity: int, prec="f32"):
    """(RGB loss, the loss with the regularisers times the loss scale) of
    one training step whose sample stream holds ``capacity`` samples: past
    it, whole segments of 8 lattice steps are dropped, ray by ray."""
    tex, o, d = train_rays(data, draws)
    n = o.shape[0]
    t, live = lattice(occ, o, d, 0.0, steps, draws["u_march"])
    live &= (tex[:, 0] >= 0.0)[:, None]
    segs = live.view(n, steps // 8, 8)
    fits = torch.cumsum(segs.sum(-1).reshape(-1), 0) <= capacity
    live = (segs & fits.view(n, -1, 1)).view(n, steps)
    ray, k = live.nonzero(as_tuple=True)
    s_t = t[ray, k]
    pos = o[ray] + s_t[:, None] * d[ray]
    rgb_raw, dens_raw = network(params, pos, d[ray] * 0.5 + 0.5, meta, prec)
    rgb_ray, depth = composite(sigma_of(dens_raw), torch.sigmoid(rgb_raw),
                               torch.full_like(s_t, STEP), ray, k, n, steps)
    bg_lin = plain.srgb_to_linear(draws["bg"])
    target = plain.linear_to_srgb(tex[:, :3] + (1.0 - tex[:, 3:]) * bg_lin)
    pred = rgb_ray + torch.exp(-depth)[:, None] \
        * plain.linear_to_srgb(bg_lin)
    diff = torch.abs(pred - target)
    huber = torch.where(diff < 0.1, 0.5 * diff * diff / 0.1,
                        diff - 0.05) / 5.0
    has = torch.zeros(n, dtype=torch.bool, device=o.device)
    has[ray] = True
    loss = torch.sum(huber * has[:, None]) / torch.clamp(has.sum(), min=1)
    near = torch.where((dens_raw > -10.0) & (s_t < NEAR_DISTANCE),
                       1e-4 * dens_raw, 0.0).sum()
    l1 = float(occ_mean < MIN_OPTICAL_THICKNESS) * (
        -1e-4 * torch.clamp(dens_raw, max=0.0)).sum()
    return loss, (loss + (near + l1) / plain.LOSS_SCALE) * plain.LOSS_SCALE


def follow(params: dict, config: dict, data: dict, occ, occ_mean,
           draws: list, steps: int, capacity: int, prec="f32") -> dict:
    """Train ``len(draws)`` steps from ``params`` on the occupancy ``occ``
    (128³ bool) of mean density ``occ_mean``: each step's loss (RGB loss /
    3), each leaf's norm of the first gradient as Adam takes it, and each
    leaf's norm of the change after the last step of the parameters and of
    their moving average (Ema)."""
    meta = grid_meta(config)
    cfg = plain.adam_config(config["optimizer"])
    start = {k: v.detach().clone() for k, v in params.items()}
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    state = {"step": 0, "m": {k: torch.zeros_like(v) for k, v in p.items()},
             "v": {k: torch.zeros_like(v) for k, v in p.items()},
             "ema": {k: v.clone() for k, v in start.items()}}
    losses, first = [], None
    for dr in draws:
        loss, scaled = step_loss(p, meta, occ, occ_mean, data, dr, steps,
                                 capacity, prec)
        g = dict(zip(LEAVES, torch.autograd.grad(scaled,
                                                  [p[k] for k in LEAVES])))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(v)) for k, v in
                     plain.grad_as_adam_sees(p, g, MATRICES,
                                             cfg["l2"]).items()}
        plain.adam_step(p, g, state, cfg, MATRICES)
        losses.append(float(loss.detach()) / 3.0)
    return {"loss": losses, "grad": first,
            "change": {k: float(torch.linalg.vector_norm(
                p[k].detach() - start[k])) for k in LEAVES},
            "ema_change": {k: float(torch.linalg.vector_norm(
                state["ema"][k] - start[k])) for k in LEAVES}}


# --- a rendered frame --------------------------------------------------------

@torch.no_grad()
def frame(params, config, occ, cam, W: int, H: int, focal: float,
          cap: int, steps: int, prec="f32", chunk: int = 1 << 14):
    """(H, W, 4) linear RGB and opacity of a pinhole frame at pixel centres
    over a transparent background: at most ``cap`` samples a ray, every
    m-th of its live samples (m = ⌈live / cap⌉), each with Δ times the
    number of samples it stands for."""
    meta = grid_meta(config)
    dev = cam.device
    out = []
    for p0 in range(0, W * H, chunk):
        idx = torch.arange(p0, min(p0 + chunk, W * H), device=dev)
        u = ((idx % W).to(torch.float32) + 0.5) / W
        v = ((idx // W).to(torch.float32) + 0.5) / H
        f = torch.full((), focal, dtype=torch.float32, device=dev)
        dcam = torch.stack([(u - 0.5) * W / f, (v - 0.5) * H / f,
                            torch.ones_like(u)], -1)
        d = dcam @ cam[:, :3].T
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9)
        o = cam[:, 3].expand_as(d)
        t, live = lattice(occ, o, d, 0.05, steps)
        count = live.sum(1, keepdim=True)
        m = torch.clamp(-torch.div(-count, cap, rounding_mode="floor"), min=1)
        rank = torch.cumsum(live.to(torch.int32), 1) - 1
        keep = live & (torch.remainder(rank, m) == 0)
        stands = torch.minimum(m, count - rank).to(torch.float32)
        ray, k = keep.nonzero(as_tuple=True)
        s_t = t[ray, k]
        rgb_raw, dens_raw = network(params, o[ray] + s_t[:, None] * d[ray],
                                    d[ray] * 0.5 + 0.5, meta, prec)
        rgb, depth = composite(sigma_of(dens_raw), torch.sigmoid(rgb_raw),
                               STEP * stands[ray, k], ray, k, o.shape[0],
                               steps)
        out.append(torch.cat([plain.srgb_to_linear(torch.clamp(rgb, min=0.0)),
                              (1.0 - torch.exp(-depth))[:, None]], -1))
    return torch.cat(out).view(H, W, 4)
