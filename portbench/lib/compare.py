"""The numbers that decide ``correct``, each beside its limit.

Training (the first steps of the window's own trainer against the plain
reference that follows them from the same weights and inputs):

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the worst leaf's gap between the two norms of the first
  gradient as Adam takes it, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change``: the same for the norm of each leaf's change after the last
  step followed; ``change_median``, the median leaf's gap of that norm;
- ``ema_change_median``: the same median for the moving average of the
  parameters that inference uses (Ema), where the optimizer keeps one.

A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of ``change``.

A frame (one the window produced, against the reference's frame of the
same camera): ``rel_mean``, the mean |Δ| over the mean |reference|, and
``share_off``, the share of pixels with a channel off by more than
``OFF``.
"""
from __future__ import annotations

import statistics

import torch

OFF = 0.02          # a pixel channel this far off counts as off
QUIET = 1e-3        # of the median leaf's gradient: a leaf that does not move


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(abs(ref[k]), med)
                for k in ref if keep(k)), default=0.0)


def leaf_detail(prog: dict, ref: dict) -> dict:
    """Each leaf's gaps (first gradient, change) and the reference's norms,
    for a look at which leaf sets a number."""
    gmed = statistics.median(ref["grad"].values())
    keys = [k for k in ("change", "ema_change") if k in ref]
    meds = {key: statistics.median(ref[key].values()) for key in keys}
    return {k: {"grad": abs(prog["grad"][k] - g) / max(g, gmed),
                "ref_grad": g,
                **{key: abs(prog[key][k] - ref[key][k])
                   / max(ref[key][k], meds[key]) for key in keys},
                **{"ref_" + key: ref[key][k] for key in keys}}
            for k, g in ref["grad"].items()}


def training(prog: dict, ref: dict, limits: dict) -> list:
    """[(name, value, limit)] of a training cell, the numbers that
    ``limits`` names (``training_numbers``)."""
    numbers = training_numbers(prog, ref)
    return [(k, numbers[k], lim) for k, lim in limits.items()]


def training_numbers(prog: dict, ref: dict) -> dict:
    """``loss`` (the worst step) or ``loss_first`` (the first step, before
    any update carries round-off forward), ``grad``, and ``change`` (the
    worst leaf) or ``change_median`` (the median leaf, where one small
    leaf's round-off sets the worst); where the optimizer keeps a moving
    average of the parameters (Ema), ``ema_change_median``, the median
    leaf's gap of the norm of the average's change."""
    med = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= QUIET * med]

    def gaps(key):
        cmed = statistics.median(ref[key][k] for k in moving)
        return [abs(prog[key][k] - ref[key][k]) / max(ref[key][k], cmed)
                for k in moving]
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss": max(steps), "loss_first": steps[0],
           "grad": _leaf_gap(prog["grad"], ref["grad"], lambda k: True),
           "change": max(gaps("change")),
           "change_median": statistics.median(gaps("change"))}
    if "ema_change" in ref:
        out["ema_change_median"] = statistics.median(gaps("ema_change"))
    return out


def frame_numbers(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got = torch.as_tensor(got, device=ref.device, dtype=torch.float32)
    err = (got - ref).abs()
    return {"rel_mean": float(err.mean() / ref.abs().mean().clamp(min=1e-12)),
            "share_off": float((err > OFF).any(-1).float().mean())}


def frames(pairs: list, limits: dict) -> list:
    """[(name, value, limit)] over (got, reference) frame pairs: each
    number's worst frame."""
    nums = [frame_numbers(g, r) for g, r in pairs]
    return [(k, max(n[k] for n in nums), limits[k]) for k in limits]
