"""Plain PyTorch reference of the image configuration (instant-ngp's
``configs/image/base.json``): the network at image positions, a training
step and a frame of the whole image.

Written from instant-ngp's description (Müller et al. 2022, §5.1;
``src/testbed_image.cu``: targets read bilinearly from the image's
sRGB values, L2 loss, the network's output taken as sRGB and converted to
linear for display). It imports nothing of the program and takes
nothing the program made: weights, image and positions are the
benchmark's. The network's products run on bf16-rounded operands in f32,
the configuration's FullyFusedMLP in the program's numerics.
"""
from __future__ import annotations

import torch

from portbench.lib import geometry as geo
from portbench.reference import plain

LEAVES = ("encoding.table", "net.weights.0", "net.weights.1",
          "net.weights.2")
MATRICES = set(LEAVES[1:])


def grid_meta(config: dict, width: int, height: int) -> geo.GridMeta:
    return geo.grid_meta(config["encoding"], 2, max(width, height) / 2.0)


def network(params, pos, meta, prec="f32"):
    return plain.mlp(plain.encode(params["encoding.table"], pos, meta, prec),
                     [params[k] for k in LEAVES[1:]], prec)


def targets(image_lin: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of the image's sRGB values (from its linear f32
    (H, W, 3) pixels) at ``pos`` (N, 2) in [0, 1]², pixel centres at
    (i + 0.5) / W."""
    H, W = image_lin.shape[:2]
    res = torch.tensor([W, H], dtype=torch.float32, device=pos.device)
    hi = torch.tensor([W - 1, H - 1], device=pos.device)
    p = torch.minimum(torch.clamp(pos * res - 0.5, min=0.0), res - 1.0001)
    p0 = p.to(torch.int32)
    w = p - p0.to(torch.float32)
    i0 = torch.minimum(torch.clamp(p0, min=0), hi - 1).long()
    x0, y0, wx, wy = i0[:, 0], i0[:, 1], w[:, 0:1], w[:, 1:2]

    def at(x, y):
        return plain.linear_to_srgb(image_lin[y, x])
    return ((1 - wx) * (1 - wy) * at(x0, y0) + wx * (1 - wy) * at(x0 + 1, y0)
            + (1 - wx) * wy * at(x0, y0 + 1) + wx * wy * at(x0 + 1, y0 + 1))


def follow(params: dict, config: dict, image_lin, positions: list,
           prec="f32") -> dict:
    """Train ``len(positions)`` steps from ``params``: each step's loss, each
    leaf's norm of the first gradient as Adam takes it, and each leaf's
    norm of the change of the parameters after the last step."""
    H, W = image_lin.shape[:2]
    meta = grid_meta(config, W, H)
    cfg = plain.adam_config(config["optimizer"])
    start = {k: v.detach().clone() for k, v in params.items()}
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    state = {"step": 0, "m": {k: torch.zeros_like(v) for k, v in p.items()},
             "v": {k: torch.zeros_like(v) for k, v in p.items()}}
    losses, first = [], None
    for pos in positions:
        err = network(p, pos, meta, prec) - targets(image_lin, pos)
        loss = torch.mean(err * err)
        g = dict(zip(LEAVES, torch.autograd.grad(
            loss * plain.LOSS_SCALE, [p[k] for k in LEAVES])))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(v)) for k, v in
                     plain.grad_as_adam_sees(p, g, MATRICES,
                                             cfg["l2"]).items()}
        plain.adam_step(p, g, state, cfg, MATRICES)
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad": first,
            "change": {k: float(torch.linalg.vector_norm(
                p[k].detach() - start[k]))
                       for k in LEAVES}}


@torch.no_grad()
def frame(params, config, image_wh: tuple, W: int, H: int, prec="f32",
          chunk: int = 1 << 18) -> torch.Tensor:
    """(H, W, 3) linear RGB of the fitted image sampled at the frame's
    pixel centres."""
    meta = grid_meta(config, *image_wh)
    x = (torch.arange(W, dtype=torch.float32, device=params[LEAVES[0]].device)
         + 0.5) / W
    y = (torch.arange(H, dtype=torch.float32, device=x.device) + 0.5) / H
    pos = torch.stack(torch.meshgrid(x, y, indexing="xy"), -1).reshape(-1, 2)
    out = torch.cat([network(params, c, meta, prec)
                     for c in pos.split(chunk)])
    return plain.srgb_to_linear(out).view(H, W, 3)
