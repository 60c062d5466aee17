"""State between the JAX package and the port, as numpy: the network
parameters, the Adam state and the occupancy grid.

The JAX ``NerfNetwork`` keeps its parameters as a pytree
``{"pos_encoding": (L, R, 128), "dir_encoding": nested () tuples,
"density_net": ((in, out), ...), "rgb_net": ((in, out), ...)}``; the
same tree, as numpy arrays, is what a snapshot stores. The port's
``NerfNetwork`` holds the same arrays as parameters named
``pos_encoding.table`` and ``<net>.weights.<i>``. A tcnn-layout network
(``grid_impl="tcnn"``; ``NGP_TPU_GRID_IMPL=tcnn`` in the JAX package)
has the same tree with a flat (n_params · F,) ``pos_encoding`` table,
which ``io/snapshot.import_reference_snapshot`` gives and
``export_reference_snapshot`` takes.

Under table parallelism (``dist/``) a rank holds its row shard of a
blocked table, axis 1 of the (L, R, 128) array: the NeRF model's
``pos_encoding`` and ``TpImageTrainer``'s ``table``, whose JAX tree is
``{"table": (L, R, 128), "net": (W, ...)}``. ``shard_tree`` and
``join_trees`` cut a tree's table into a rank's shard and join the ranks'
shards back; ``shard_adam`` and ``join_adam`` do the same to the Adam
fields, whose ``mu``, ``nu`` and ``ema_params`` are parameter trees.

The JAX ``EncodedNetwork`` (the image and SDF engines) keeps
``{"encoding": <the encoding's tree>, "net": (W, ...)}``: a grid's table,
``()`` for an analytic encoding, a tuple of the parts' trees for a
Composite. The port's ``EncodedNetwork`` holds the tables as
``encoding.table`` (``encoding.parts.<i>.table`` inside a Composite) and
the matrices as ``net.weights.<i>``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ngp_tpu_torch.grid.occupancy import OccupancyGrid
from ngp_tpu_torch.nn.encodings import Composite
from ngp_tpu_torch.nn.models import EncodedNetwork, NerfNetwork
from ngp_tpu_torch.opt.optimizers import AdamState


def _dir_skeleton(enc):
    """The JAX parameter tree of a parameterless direction encoding."""
    if isinstance(enc, Composite):
        return tuple(_dir_skeleton(p) for p in enc.parts)
    return ()


def _check_empty(tree, what: str):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _check_empty(t, what)
    elif tree is not None and np.size(tree) != 0:
        raise ValueError(f"{what}: expected no parameters, got an array")


def nerf_params_from_numpy(tree: Mapping, model: NerfNetwork
                           ) -> dict[str, torch.Tensor]:
    """JAX NerfNetwork pytree (numpy leaves) → {parameter name: tensor} on
    the model's device, shapes checked against the model."""
    _check_empty(tree.get("dir_encoding", ()), "dir_encoding")
    flat = {"pos_encoding.table": tree["pos_encoding"]}
    for net in ("density_net", "rgb_net"):
        for i, w in enumerate(tree[net]):
            flat[f"{net}.weights.{i}"] = w
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: {sorted(flat)} vs "
                         f"{sorted(own)}")
    out = {}
    for name, value in flat.items():
        a = np.asarray(value, np.float32)
        if a.shape != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {a.shape} != "
                             f"{tuple(own[name].shape)}")
        out[name] = torch.from_numpy(a.copy()).to(own[name].device)
    return out


def nerf_params_to_numpy(params: Mapping[str, torch.Tensor],
                         model: NerfNetwork) -> dict:
    """Inverse of ``nerf_params_from_numpy``: the JAX pytree, numpy
    leaves."""
    def mats(net):
        n = len(getattr(model, net).weights)
        return tuple(params[f"{net}.weights.{i}"].detach().cpu().numpy()
                     for i in range(n))
    return {"pos_encoding": params["pos_encoding.table"].detach().cpu().numpy(),
            "dir_encoding": _dir_skeleton(model.dir_encoding),
            "density_net": mats("density_net"),
            "rgb_net": mats("rgb_net")}


def jax_leaf_names(model: NerfNetwork) -> list[str]:
    """The port's parameter names in the order of ``jax.tree.leaves`` of
    the JAX parameter dict: sorted keys (density_net, dir_encoding — no
    leaves —, pos_encoding, rgb_net), each MLP's matrices in layer order."""
    def mats(net):
        return [f"{net}.weights.{i}"
                for i in range(len(getattr(model, net).weights))]
    return mats("density_net") + ["pos_encoding.table"] + mats("rgb_net")


def nerf_params_to_flat(params: Mapping[str, torch.Tensor],
                        model) -> np.ndarray:
    """All parameters of a NerfNetwork or an EncodedNetwork as one f32
    vector in the JAX package's leaf order, the pyngp ``params`` vector:
    one taken from either package's testbed loads into the other's."""
    return np.concatenate([params[k].detach().cpu().numpy().astype(
        np.float32).ravel() for k in leaf_names(model)])


def nerf_params_from_flat(flat, model) -> dict[str, torch.Tensor]:
    """Inverse of ``nerf_params_to_flat``: {parameter name: tensor} on the
    model's device; the vector's length must match the model's."""
    flat = np.asarray(flat, np.float32).ravel()
    own = dict(model.named_parameters())
    names = leaf_names(model)
    need = sum(own[k].numel() for k in names)
    if flat.size != need:
        raise ValueError(f"param vector has {flat.size} floats, model needs "
                         f"{need}")
    out, off = {}, 0
    for k in names:
        n = own[k].numel()
        out[k] = torch.from_numpy(flat[off:off + n].reshape(
            tuple(own[k].shape)).copy()).to(own[k].device)
        off += n
    return out


def _encoding_tree(enc, params: Mapping[str, torch.Tensor], prefix: str):
    """The JAX parameter tree of encoding ``enc`` (named ``prefix``), its
    tables taken from ``params``, as numpy."""
    if isinstance(enc, Composite):
        return tuple(_encoding_tree(part, params, f"{prefix}.parts.{i}")
                     for i, part in enumerate(enc.parts))
    if hasattr(enc, "table"):
        return params[f"{prefix}.table"].detach().cpu().numpy()
    return ()


def _encoding_names(enc, tree, prefix: str, out: dict):
    """Inverse of ``_encoding_tree``: each table of ``tree`` into ``out``
    under its parameter name; a parameterless part must hold no array."""
    if isinstance(enc, Composite):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(enc.parts):
            raise ValueError(f"{prefix}: expected a tuple of "
                             f"{len(enc.parts)} parts")
        for i, (part, sub) in enumerate(zip(enc.parts, tree)):
            _encoding_names(part, sub, f"{prefix}.parts.{i}", out)
    elif hasattr(enc, "table"):
        out[f"{prefix}.table"] = tree
    else:
        _check_empty(tree, prefix)


def encoded_params_from_numpy(tree: Mapping, model: EncodedNetwork
                              ) -> dict[str, torch.Tensor]:
    """JAX EncodedNetwork pytree (numpy leaves) → {parameter name: tensor}
    on the model's device, names and shapes checked against the model."""
    flat = {}
    _encoding_names(model.encoding, tree["encoding"], "encoding", flat)
    for i, w in enumerate(tree["net"]):
        flat[f"net.weights.{i}"] = w
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: {sorted(flat)} vs "
                         f"{sorted(own)}")
    out = {}
    for name, value in flat.items():
        a = np.asarray(value, np.float32)
        if a.shape != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {a.shape} != "
                             f"{tuple(own[name].shape)}")
        out[name] = torch.from_numpy(a.copy()).to(own[name].device)
    return out


def encoded_params_to_numpy(params: Mapping[str, torch.Tensor],
                            model: EncodedNetwork) -> dict:
    """Inverse of ``encoded_params_from_numpy``: the JAX pytree, numpy
    leaves."""
    return {"encoding": _encoding_tree(model.encoding, params, "encoding"),
            "net": tuple(params[f"net.weights.{i}"].detach().cpu().numpy()
                         for i in range(len(model.net.weights)))}


def encoded_leaf_names(model: EncodedNetwork) -> list[str]:
    """The port's parameter names in the order of ``jax.tree.leaves`` of
    the JAX EncodedNetwork's parameters: the encoding's tables (parts in
    order), then the MLP's matrices in layer order."""
    return sorted((n for n, _ in model.named_parameters()
                   if n.startswith("encoding.")),
                  key=lambda n: [int(k) if k.isdigit() else k
                                 for k in n.split(".")]) + [
        f"net.weights.{i}" for i in range(len(model.net.weights))]


def leaf_names(model) -> list[str]:
    """``jax_leaf_names`` or ``encoded_leaf_names``, by the model's kind."""
    return (encoded_leaf_names(model) if isinstance(model, EncodedNetwork)
            else jax_leaf_names(model))


def adam_state_to_numpy(state: AdamState, model: NerfNetwork) -> dict:
    """The port's optimizer state → the fields of the JAX ``AdamState``:
    ``step`` (int32 0-d), and ``mu``, ``nu``, ``ema_params`` as JAX
    parameter pytrees with numpy leaves."""
    return {"step": np.asarray(state.step, np.int32),
            "mu": nerf_params_to_numpy(state.mu, model),
            "nu": nerf_params_to_numpy(state.nu, model),
            "ema_params": nerf_params_to_numpy(state.ema_params, model)}


def adam_state_from_numpy(step, mu: Mapping, nu: Mapping,
                          ema_params: Mapping,
                          model: NerfNetwork) -> AdamState:
    """The JAX ``AdamState`` fields (numpy leaves) → the port's optimizer
    state, on the model's device."""
    return AdamState(step=int(np.asarray(step)),
                     mu=nerf_params_from_numpy(mu, model),
                     nu=nerf_params_from_numpy(nu, model),
                     ema_params=nerf_params_from_numpy(ema_params, model))


def grid_to_numpy(grid: OccupancyGrid) -> dict:
    """The port's occupancy grid → the fields of the JAX ``OccupancyGrid``
    as numpy (``ema_step`` int32 0-d)."""
    return {"density": grid.density.cpu().numpy(),
            "bitfield": grid.bitfield.cpu().numpy(),
            "mean": grid.mean.cpu().numpy(),
            "ema_step": np.asarray(grid.ema_step, np.int32),
            "coarse": grid.coarse.cpu().numpy()}


def grid_from_numpy(density, bitfield, mean, ema_step, coarse,
                    device=None) -> OccupancyGrid:
    """The JAX ``OccupancyGrid`` fields (numpy) → the port's grid."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return OccupancyGrid(density=t(density, torch.float32),
                         bitfield=t(bitfield, torch.uint8),
                         mean=t(mean, torch.float32),
                         ema_step=int(np.asarray(ema_step)),
                         coarse=t(coarse, torch.uint8))


def camera_state_to_numpy(trainer) -> tuple[dict, dict, dict]:
    """The port trainer's camera parameters and their Adam moments → the
    JAX trainer's ``cam_params``, ``cam_m`` and ``cam_v`` (dicts of numpy
    arrays with the same keys)."""
    return tuple({k: v.detach().cpu().numpy() for k, v in d.items()}
                 for d in (trainer.cam_params, trainer.cam_m, trainer.cam_v))


def camera_state_from_numpy(trainer, cam_params: Mapping, cam_m: Mapping,
                            cam_v: Mapping):
    """Load the JAX trainer's ``cam_params``, ``cam_m`` and ``cam_v`` into
    the port trainer, in place; the keys and shapes must match."""
    for own, src in ((trainer.cam_params, cam_params),
                     (trainer.cam_m, cam_m), (trainer.cam_v, cam_v)):
        if set(own) != set(src):
            raise ValueError(f"camera keys differ: {sorted(src)} vs "
                             f"{sorted(own)}")
        for k, t in own.items():
            a = np.asarray(src[k], np.float32)
            if a.shape != tuple(t.shape):
                raise ValueError(f"camera {k}: shape {a.shape} != "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(a.copy()))


def shard_rows(table: np.ndarray, model_index: int, n_model: int
               ) -> np.ndarray:
    """Rank ``model_index``'s rows of an (L, R, 128) table split over
    ``n_model`` ranks (``dist.mesh.table_sharding``)."""
    from ngp_tpu_torch.dist.mesh import _range
    return np.ascontiguousarray(
        table[:, _range(table.shape[1], n_model, model_index, "rows")])


def join_rows(shards) -> np.ndarray:
    """The (L, R, 128) table of the ranks' row shards, in rank order."""
    return np.concatenate([np.asarray(s) for s in shards], axis=1)


def shard_tree(tree: Mapping, key: str, model_index: int,
               n_model: int) -> dict:
    """A JAX parameter tree with its table ``tree[key]`` (``"pos_encoding"``
    or ``"table"``) cut to rank ``model_index``'s rows."""
    return {**tree, key: shard_rows(np.asarray(tree[key]), model_index,
                                    n_model)}


def join_trees(trees, key: str) -> dict:
    """The whole tree of the ranks' trees (one per model index, in order):
    their tables ``key`` joined, the rest from the first."""
    return {**trees[0], key: join_rows([t[key] for t in trees])}


def shard_adam(adam: Mapping, key: str, model_index: int,
               n_model: int) -> dict:
    """The JAX ``AdamState`` fields (``step``, and ``mu``, ``nu``,
    ``ema_params`` as parameter trees) with each tree's table cut to the
    rank's rows."""
    return {"step": adam["step"], **{
        f: shard_tree(adam[f], key, model_index, n_model)
        for f in ("mu", "nu", "ema_params")}}


def join_adam(adams, key: str) -> dict:
    """Inverse of ``shard_adam`` over the ranks' fields, in rank order."""
    return {"step": adams[0]["step"], **{
        f: join_trees([a[f] for a in adams], key)
        for f in ("mu", "nu", "ema_params")}}

