"""Per-element losses (port of ``ngp_tpu/opt/losses.py``): the NeRF loss
menu (ref: loss_and_gradient, src/testbed_nerf.cu:96-195,1263-1278) and
tcnn's Loss otypes, which the image and SDF trainers take from their
configs (``create_loss``).

Each returns the per-element loss; gradients come from autograd. Where the
reference treats a normaliser as a constant in its hand-derived gradient,
it is detached here."""
from __future__ import annotations

import torch

from ngp_tpu_torch.common import LossType


def l2(target, pred):
    d = pred - target
    return d * d


def relative_l2(target, pred):
    d = pred - target
    return d * d * (1.0 / (pred * pred + 1e-2)).detach()


def l1(target, pred):
    return torch.abs(pred - target)


def huber(target, pred, alpha: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < alpha, 0.5 * d * d / alpha, d - 0.5 * alpha)


def log_l1(target, pred):
    return torch.log(1.0 + torch.abs(pred - target))


def mape(target, pred):
    d = torch.abs(pred - target)
    return d * (1.0 / (torch.abs(pred) + 1e-2)).detach()


def smape(target, pred):
    d = torch.abs(pred - target)
    return d * (1.0 / (0.5 * (torch.abs(pred) + torch.abs(target))
                       + 1e-2)).detach()


def _huber_nerf(target, pred):
    return huber(target, pred, 0.1) / 5.0


_NERF_LOSSES = {LossType.L2: l2, LossType.RELATIVE_L2: relative_l2,
                LossType.L1: l1, LossType.MAPE: mape, LossType.SMAPE: smape,
                LossType.HUBER: _huber_nerf, LossType.LOG_L1: log_l1}


def loss_fn(loss_type: LossType):
    """NeRF per-ray RGB loss. The reference divides Huber (α = 0.1) by 5."""
    try:
        return _NERF_LOSSES[loss_type]
    except KeyError:
        raise ValueError(loss_type) from None


# tcnn's Loss otypes, lower case without dashes (the JAX package's table)
_TCNN_LOSSES = {"l2": l2, "relativel2": relative_l2, "l1": l1,
                "mape": mape, "smape": smape, "huber": huber,
                "logl1": log_l1}


def create_loss(cfg: dict):
    """tcnn::create_loss for the image and SDF trainers: the per-element
    loss of ``cfg["otype"]`` (L2 when absent)."""
    otype = cfg.get("otype", "L2").lower().replace("-", "")
    try:
        return _TCNN_LOSSES[otype]
    except KeyError:
        raise ValueError(f"unknown loss otype {cfg.get('otype')!r}") from None
