"""The plain PyTorch pieces both references are built from.

Written from the published descriptions (instant-ngp, Müller et al. 2022,
§3–§5; tiny-cuda-nn's FullyFusedMLP and Adam), on the blocked grid's
frozen geometry (``portbench/lib/geometry.py``). Nothing here imports
the program.

``prec`` is the precision a piece computes in: ``"f32"`` is what the
configurations state (the table and its gradient in f32; the MLPs on
bf16-rounded operands, each product accumulated in f32); ``"bf16"`` is the
control one step below it (the table, its gradient and every MLP product
in bf16).
"""
from __future__ import annotations

import torch

from portbench.lib import geometry as geo

LOSS_SCALE = 128.0   # the trainers' loss scale (instant-ngp's, testbed.h)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def encode(table: torch.Tensor, pos: torch.Tensor, meta: geo.GridMeta,
           prec: str = "f32") -> torch.Tensor:
    """Multiresolution blocked-grid features (N, L·F): each level's 2^D
    corners gathered from the level's table and blended by their
    interpolation weights. Differentiable in ``table``."""
    L, F, N = meta.n_levels, meta.n_features, pos.shape[0]
    if prec == "bf16":
        table = _RoundGrad.apply(bf16(table))
    idx, w = geo.corner_index(meta, pos)
    flat = table.reshape(L, -1)
    feats = [torch.sum(torch.gather(flat, 1, (idx + f).reshape(L, -1))
                       .view(idx.shape) * w, -1) for f in range(F)]
    return torch.stack(feats, -1).transpose(0, 1).reshape(N, L * F)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to bf16 (the control's
    table gradient)."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return bf16(g)


def mlp(x: torch.Tensor, weights: list, prec: str = "f32") -> torch.Tensor:
    """Bias-free ReLU MLP, tiny-cuda-nn's FullyFusedMLP: operands rounded to
    bf16, activations re-rounded between layers, no output activation."""
    h = bf16(x)
    for i, w in enumerate(weights):
        if prec == "bf16":
            h = (h.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
        else:
            h = h @ bf16(w)
        if i < len(weights) - 1:
            h = bf16(torch.relu(h))
    return h


def sh4(d01: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4 (16 terms) of the direction
    d = 2·d01 − 1, tiny-cuda-nn's polynomials."""
    d = d01 * 2.0 - 1.0
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], -1)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=1e-12) ** (1.0 / 2.4)
                       - 0.055)


def _f32_pow(base: float, e: int, device) -> torch.Tensor:
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                     torch.tensor(float(e), dtype=torch.float32,
                                  device=device))


def adam_config(cfg: dict) -> dict:
    """Adam's settings from a tcnn optimizer config: the Ema and
    ExponentialDecay wrappers unwrapped."""
    out = {"ema": 0.0, "decay_start": 0, "decay_interval": 0,
           "decay_base": 1.0}
    node = cfg
    while node.get("otype", "Adam").lower() in ("ema", "exponentialdecay"):
        if node["otype"].lower() == "ema":
            out["ema"] = float(node.get("decay", 0.99))
        else:
            out.update(decay_start=int(node.get("decay_start", 0)),
                       decay_interval=int(node.get("decay_interval", 0)),
                       decay_base=float(node.get("decay_base", 1.0)))
        node = node["nested"]
    out.update(lr=float(node.get("learning_rate", 1e-3)),
               b1=float(node.get("beta1", 0.9)),
               b2=float(node.get("beta2", 0.999)),
               eps=float(node.get("epsilon", 1e-8)),
               l2=float(node.get("l2_reg", 0.0)))
    return out


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, cfg: dict,
              matrices: set) -> None:
    """One step of tiny-cuda-nn's Adam, in place: the gradient divided by
    the loss scale, L2 regularisation on the MLP matrices only, bias
    correction, the learning-rate decay, and entries of the other
    parameters (the table) whose gradient is exactly 0 left as they are,
    moments included. ``state`` holds ``step``, ``m`` and ``v``, and with
    Ema configured ``ema``: the moving average of the parameters after
    each step, ``decay`` · average + (1 − ``decay``) · parameters, which
    starts at the initial parameters (as the system states it; tcnn
    debiases an average that starts at 0)."""
    step = state["step"] + 1
    dev = next(iter(params.values())).device
    lr = torch.tensor(cfg["lr"], dtype=torch.float32, device=dev)
    if cfg["decay_interval"] > 0 and step >= cfg["decay_start"]:
        n = (step - cfg["decay_start"]) // cfg["decay_interval"] + 1
        lr = lr * _f32_pow(cfg["decay_base"], n, dev)
    bc1 = 1.0 - _f32_pow(cfg["b1"], step, dev)
    bc2 = 1.0 - _f32_pow(cfg["b2"], step, dev)
    for k, p in params.items():
        g = grads[k] * (1.0 / LOSS_SCALE)
        if k in matrices:
            g = g + cfg["l2"] * p
        m = cfg["b1"] * state["m"][k] + (1.0 - cfg["b1"]) * g
        v = cfg["b2"] * state["v"][k] + (1.0 - cfg["b2"]) * g * g
        new = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg["eps"])
        if k not in matrices:
            hit = grads[k] != 0
            new = torch.where(hit, new, p)
            m = torch.where(hit, m, state["m"][k])
            v = torch.where(hit, v, state["v"][k])
        p.copy_(new)
        state["m"][k].copy_(m)
        state["v"][k].copy_(v)
    if cfg["ema"] > 0.0:
        d = cfg["ema"]
        for k, e in state["ema"].items():
            e.copy_(d * e + (1.0 - d) * params[k])
    state["step"] = step


def grad_as_adam_sees(params: dict, grads: dict, matrices: set,
                      l2: float) -> dict:
    """The gradient as Adam takes it: unscaled, with the L2 term of the
    matrices."""
    return {k: grads[k] / LOSS_SCALE
            + (l2 * params[k].detach() if k in matrices else 0.0)
            for k in params}
