"""Network weights drawn from the run's seed on the device, in a few large
calls of a ``torch.Generator`` on the card, named as the program's
parameters are.

Shapes follow the configuration: the blocked grid's (L, rows, 128) table,
and each bias-free MLP's (in, out) matrices. The default draw is the
initialisation of tiny-cuda-nn (table uniform in ±1e-4, matrices
Glorot-uniform). A draw may set other ranges: ``table`` (low, high) for
the table, ``density`` (low, high) for the density MLP's matrices, and
``mlp_scale``, a factor on the Glorot limit of the other matrices.
"""
from __future__ import annotations

import math

import torch

from portbench.lib import geometry as geo


def mlp_shapes(n_in: int, n_out: int, cfg: dict) -> list:
    width, hidden = int(cfg.get("n_neurons", 64)), int(
        cfg.get("n_hidden_layers", 1))
    if hidden == 0:
        return [(n_in, n_out)]
    return [(n_in, width)] + [(width, width)] * (hidden - 1) + [(width, n_out)]


def nerf_shapes(config: dict, meta: geo.GridMeta) -> dict:
    """Parameter name → shape of the NeRF network: the grid, the density MLP
    (16 outputs) and the RGB MLP on those and the SH-4 direction."""
    feats = meta.n_levels * meta.n_features
    shapes = {"pos_encoding.table": (meta.n_levels, meta.rows, geo.LANES)}
    for i, s in enumerate(mlp_shapes(feats, 16, config["network"])):
        shapes[f"density_net.weights.{i}"] = s
    for i, s in enumerate(mlp_shapes(16 + 16, 3, config["rgb_network"])):
        shapes[f"rgb_net.weights.{i}"] = s
    return shapes


def image_shapes(config: dict, meta: geo.GridMeta) -> dict:
    shapes = {"encoding.table": (meta.n_levels, meta.rows, geo.LANES)}
    for i, s in enumerate(mlp_shapes(meta.n_levels * meta.n_features, 3,
                                     config["network"])):
        shapes[f"net.weights.{i}"] = s
    return shapes


def draw(shapes: dict, seed: int, device, table=(-1e-4, 1e-4),
         density=None, mlp_scale: float = 1.0) -> dict:
    """Weights of ``shapes`` from ``seed``: one uniform draw for the table
    and one for all matrices, each matrix then mapped to its range."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, shape in shapes.items():
        if name.endswith("table"):
            u = torch.rand(shape, generator=g, device=device)
            out[name] = u * (table[1] - table[0]) + table[0]
    mats = [n for n in shapes if not n.endswith("table")]
    flat = torch.rand(sum(math.prod(shapes[n]) for n in mats), generator=g,
                      device=device)
    for name, part in zip(mats, flat.split([math.prod(shapes[n])
                                            for n in mats])):
        fan_in, fan_out = shapes[name]
        if density is not None and name.startswith("density_net."):
            lo, hi = density
        else:
            lim = mlp_scale * math.sqrt(6.0 / (fan_in + fan_out))
            lo, hi = -lim, lim
        out[name] = (part * (hi - lo) + lo).view(fan_in, fan_out)
    return out


@torch.no_grad()
def load_into(targets: list, weights: dict) -> None:
    """Copy ``weights`` into each of ``targets`` (dicts of the program's
    parameters and their copies, by name); every name must match."""
    for t in targets:
        if set(t) != set(weights):
            raise KeyError(f"parameter names differ: {sorted(t)} vs "
                           f"{sorted(weights)}")
        for k, v in weights.items():
            t[k].copy_(v)
