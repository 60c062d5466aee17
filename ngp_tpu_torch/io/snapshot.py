"""Snapshot save and load (port of ``save_snapshot``/``load_snapshot`` in
``ngp_tpu/io/snapshot.py``; msgpack is imported where it is used).

A snapshot is one msgpack document holding the network config plus a
``snapshot`` section: parameters as a named pytree of arrays
(``ngp_tpu_params``, and the EMA copy the renderer uses under
``ngp_tpu_ema_params``), the fp16 density grid in the reference's Morton
order, and scene metadata. Arrays come back as numpy; ``bridge.py`` turns
the parameter tree into the port's parameters.

The image and SDF trainers write the same schema with their
``EncodedNetwork``'s tree, parameters and EMA only, as the JAX testbed
writes them for its generic trainers (``save_encoded_snapshot``,
``load_encoded_snapshot_state``): a snapshot of either package loads in
the other.

A reference (tiny-cuda-nn) snapshot holds its parameters instead as one
flat ``params_binary`` buffer in the tcnn layout:
``import_reference_snapshot`` and ``export_reference_snapshot`` move it
to and from the parameter tree of a ``NerfNetwork(grid_impl="tcnn")``,
``import_reference_snapshot_encoded`` and
``export_reference_snapshot_encoded`` to and from that of an
``EncodedNetwork(grid_impl="tcnn")``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ngp_tpu_torch.grid.occupancy import density_from_morton, density_to_morton


SNAPSHOT_FORMAT_VERSION = 2


def _pack_array(a) -> dict:
    a = np.asarray(a)
    return {"__ndarray__": True, "dtype": str(a.dtype),
            "shape": list(a.shape), "data": a.tobytes()}


def _pack_tree(tree):
    if isinstance(tree, dict):
        return {k: _pack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__tuple__": True, "items": [_pack_tree(v) for v in tree]}
    if tree is None or isinstance(tree, (int, float, str, bool, bytes)):
        return tree
    return _pack_array(tree)


def _unpack_array(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _unpack_tree(obj):
    if isinstance(obj, dict):
        if obj.get("__ndarray__"):
            return _unpack_array(obj)
        if obj.get("__tuple__"):
            return tuple(_unpack_tree(v) for v in obj["items"])
        return {k: _unpack_tree(v) for k, v in obj.items()}
    return obj


def save_snapshot(path, network_config: dict, params, ema_params,
                  density_grid: Optional[np.ndarray] = None,
                  max_cascade: int = 0, training_step: int = 0,
                  loss: float = 0.0, aabb_scale: int = 1,
                  aabb_min=None, aabb_max=None,
                  rays_per_batch: int = 4096,
                  dataset_meta: Optional[dict] = None,
                  extra: Optional[dict] = None) -> None:
    """Write a snapshot msgpack in the JAX package's schema (ref:
    src/testbed.cu:3008-3042): parameter trees of numpy arrays (as
    ``bridge.nerf_params_to_numpy`` gives them), the density grid as fp16
    in the reference's Morton order, and ``extra`` entries merged into
    the snapshot section."""
    import msgpack  # only snapshot I/O needs it

    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "ngp_tpu_params": _pack_tree(params),
        "ngp_tpu_ema_params": _pack_tree(ema_params),
        "density_grid_size": 128,
        "max_cascade": int(max_cascade),
        "training_step": int(training_step),
        "loss": float(loss),
        "bounding_radius": float(aabb_scale) * (3.0 ** 0.5) / 2.0,
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {"rays_per_batch": int(rays_per_batch)},
            "dataset": _pack_tree(dataset_meta or {}),
        },
    }
    if density_grid is not None:
        snap["density_grid_binary"] = density_to_morton(
            np.asarray(density_grid, np.float16)).tobytes()
    if aabb_min is not None:
        snap["aabb"] = {"min": [float(x) for x in np.atleast_1d(aabb_min)],
                        "max": [float(x) for x in np.atleast_1d(aabb_max)]}
    if extra:
        snap.update(_pack_tree(extra))
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def load_snapshot(path) -> dict:
    """Read a snapshot; returns the full document with arrays decoded and
    the density grid in linear layout under ``snapshot["density_grid"]``."""
    import msgpack  # only snapshot I/O needs it

    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc.get("snapshot")
    if snap is None:
        raise ValueError(f"{path}: not a snapshot msgpack")
    version = snap.get("version", 0)
    if "ngp_tpu_params" in snap:
        snap["ngp_tpu_params"] = _unpack_tree(snap["ngp_tpu_params"])
        snap["ngp_tpu_ema_params"] = _unpack_tree(snap["ngp_tpu_ema_params"])
    elif "params_binary" not in snap:
        raise ValueError(
            f"snapshot version {version}: neither ngp_tpu_params nor a "
            "reference params_binary payload present")
    if "density_grid_binary" in snap:
        snap["density_grid"] = density_from_morton(np.frombuffer(
            snap["density_grid_binary"], np.float16).astype(np.float32))
    if "nerf" in snap and "dataset" in snap["nerf"]:
        snap["nerf"]["dataset"] = _unpack_tree(snap["nerf"]["dataset"])
    return doc


def load_msgpack_config(path) -> dict:
    """The network config embedded in a snapshot msgpack: the document
    without its ``snapshot`` section (ref: load_network_config accepting
    .msgpack, src/testbed.cu:120-146)."""
    import msgpack  # only snapshot I/O needs it

    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    doc.pop("snapshot", None)
    return doc


def save_encoded_snapshot(path, network_config: dict, trainer) -> None:
    """A snapshot of an image, SDF or volume trainer (``model`` an
    EncodedNetwork, ``params``, ``opt_state``, ``training_step``): its
    parameters, their EMA and the step, as the JAX testbed saves a generic
    trainer
    (ngp_tpu/api/testbed.py:870-888)."""
    from ngp_tpu_torch import bridge
    save_snapshot(
        path, network_config,
        params=bridge.encoded_params_to_numpy(trainer.params, trainer.model),
        ema_params=bridge.encoded_params_to_numpy(
            trainer.opt_state.ema_params, trainer.model),
        training_step=trainer.training_step)


def load_encoded_snapshot_state(path, trainer) -> dict:
    """Restore an image, SDF or volume trainer's parameters, EMA and step,
    in place, from a snapshot of either package; returns the document."""
    import torch

    from ngp_tpu_torch import bridge
    doc = load_snapshot(path)
    snap = doc["snapshot"]
    with torch.no_grad():
        # the Ema first: with no Ema its tensors are the parameters
        # (optimizers.init_state), whose own values must win
        for dst, tree in ((trainer.opt_state.ema_params,
                           snap["ngp_tpu_ema_params"]),
                          (trainer.params, snap["ngp_tpu_params"])):
            for k, v in bridge.encoded_params_from_numpy(
                    tree, trainer.model).items():
                dst[k].copy_(v)
    trainer.training_step = int(snap.get("training_step", 0))
    return doc


# --------------------------------------------------------------------------
# Reference (tiny-cuda-nn) snapshot interchange
# --------------------------------------------------------------------------
#
# TCNN ABI ASSUMPTIONS, the JAX package's table (ngp_tpu/io/snapshot.py),
# for both codecs:
#
# | # | rule | reference evidence |
# |---|------|--------------------|
# | 1 | params_binary is ONE flat buffer of all trainable params, fp16  |
# |   | (snapshot["params_type"] == "__half")                           |
# |   |   ref: src/testbed.cu:3008-3106 save/load_snapshot              |
# | 2 | NerfNetwork param order: density MLP, rgb MLP, pos encoding,    |
# |   | dir encoding (SH: no params)                                    |
# |   |   ref: nerf_network.h:361-394 set_params                        |
# | 3 | NetworkWithInputEncoding (sdf/image/volume Testbed modes) param |
# |   | order: MLP first, then encoding — same member order as rule 2   |
# |   |   ref: nerf_network.h pattern; testbed.cu:2290-2360 builds      |
# |   |   NetworkWithInputEncoding for the non-NeRF modes               |
# | 4 | MLP matrices are (n_out, n_in) ROW-major; our x·W layout is the |
# |   | transpose                                                       |
# |   |   ref: tcnn FullyFusedMLP weight layout (usage:                 |
# |   |   nerf_network.h:81-99 width plumbing)                          |
# | 5 | MLP input widths pad to the next multiple of 16; output widths  |
# |   | pad to 16 (density MLP emits 16 = 1 density + 15 latent)        |
# |   |   ref: nerf_network.h:81-99; padded rgb out rule :169           |
# | 6 | HashGrid levels concatenate; per-level entries = min(res^D, T)  |
# |   | rounded UP to a multiple of 8; F features interleave per entry  |
# |   |   ref: grid resolution rules mirrored in                        |
# |   |   kernels/hashgrid.py:HashGridMeta (level_params)               |
# | 7 | density_grid_binary is fp16 in MORTON order, 128^3 per cascade  |
# |   |   ref: cascaded_grid_idx_at (testbed_nerf.cu)                   |

# params_type → the dtype of params_binary. Intended divergence: the JAX
# package decodes every buffer as fp16 without reading params_type, so a
# "float" snapshot decodes to garbage there. An absent type reads as fp16,
# as the JAX package's tests write it.
_PARAMS_TYPES = {"__half": np.float16, "float": np.float32}


def _params_dtype(snap: dict):
    ptype = snap.get("params_type", "__half")
    try:
        return _PARAMS_TYPES[ptype]
    except KeyError:
        raise ValueError(f"params_type {ptype!r} is not one of "
                         f"{sorted(_PARAMS_TYPES)}") from None


def _nerf_grid_meta(doc: dict, aabb_scale: int):
    from ngp_tpu_torch.config import autofill_hashgrid_config
    from ngp_tpu_torch.kernels.hashgrid import HashGridMeta
    enc_cfg = autofill_hashgrid_config(dict(doc["encoding"]), 3, 2048.0,
                                       aabb_scale=aabb_scale)
    return HashGridMeta.from_config(enc_cfg)


def _tcnn_mlp_widths(doc: dict, meta):
    """The (n_in, n_out) sequences tcnn allocates for the NerfNetwork's two
    MLPs, with tcnn's 16-multiple padding (ref: nerf_network.h:81-99 +
    set_params order :361-394)."""
    n_neurons = int(doc["network"].get("n_neurons", 64))
    n_hidden = int(doc["network"].get("n_hidden_layers", 1))
    rgb_neurons = int(doc.get("rgb_network", {}).get("n_neurons", 64))
    rgb_hidden = int(doc.get("rgb_network", {}).get("n_hidden_layers", 2))
    pos_padded = ((meta.n_output_dims + 15) // 16) * 16
    density_widths = [(pos_padded, n_neurons)]
    density_widths += [(n_neurons, n_neurons)] * (n_hidden - 1)
    density_widths += [(n_neurons, 16)]
    rgb_in = 32  # next_multiple(16 density out + 16 SH, 16)
    rgb_widths = [(rgb_in, rgb_neurons)]
    rgb_widths += [(rgb_neurons, rgb_neurons)] * (rgb_hidden - 1)
    rgb_widths += [(rgb_neurons, 16)]  # padded output; rgb = first 3
    return density_widths, rgb_widths


def _dir_skeleton(cfg: dict):
    """The parameter tree of a parameterless direction encoding: () for
    one encoding, a tuple of its parts' trees for a Composite (the JAX
    package's ``init_params``)."""
    if cfg.get("otype", "").lower() == "composite":
        return tuple(_dir_skeleton(sub) for sub in cfg.get("nested", []))
    return ()


def export_reference_snapshot(path, network_config: dict, params,
                              aabb_scale: int = 1,
                              density_grid: Optional[np.ndarray] = None,
                              training_step: int = 0, loss: float = 0.0,
                              rays_per_batch: int = 4096,
                              dataset_meta: Optional[dict] = None) -> None:
    """Write a tcnn ``params_binary`` snapshot (fp16, ``"__half"``) that the
    CUDA reference and ``import_reference_snapshot`` load.

    ``params`` is the parameter tree of a tcnn-layout ``NerfNetwork`` as
    numpy (``bridge.nerf_params_to_numpy``): {"pos_encoding": the flat
    table, "density_net": (W, ...), "rgb_net": (W, ...)}. The buffer
    order is NerfNetwork::set_params's (ABI rule 2); each matrix is
    written (n_out, n_in) row-major, zero-padded to tcnn's widths (rules
    4–5). The format has no ``max_cascade``: a reader takes 0, so
    ``density_grid`` is one 128³ cascade."""
    import msgpack  # only snapshot I/O needs it

    meta = _nerf_grid_meta(network_config, aabb_scale)
    density_widths, rgb_widths = _tcnn_mlp_widths(network_config, meta)

    def emit_mlp(mats, widths):
        out = []
        for w, (n_in, n_out) in zip(mats, widths):
            w = np.asarray(w, np.float32)
            full = np.zeros((n_in, n_out), np.float32)
            full[: w.shape[0], : w.shape[1]] = w
            out.append(full.T.reshape(-1))   # (n_out, n_in) row-major
        return out

    chunks = emit_mlp(params["density_net"], density_widths)
    chunks += emit_mlp(params["rgb_net"], rgb_widths)
    table = np.asarray(params["pos_encoding"], np.float32).reshape(-1)
    want = meta.n_params * meta.n_features_per_level
    if table.size != want:
        raise ValueError(f"table size {table.size} != tcnn layout {want}")
    chunks.append(table)
    flat = np.concatenate(chunks).astype(np.float16)

    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "n_params": int(flat.size),
        "params_type": "__half",
        "params_binary": flat.tobytes(),
        "density_grid_size": 128,
        "training_step": int(training_step),
        "loss": float(loss),
        "bounding_radius": float(aabb_scale) * (3.0 ** 0.5) / 2.0,
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {"rays_per_batch": int(rays_per_batch),
                    "measured_batch_size": 1 << 18,
                    "measured_batch_size_before_compaction": 1 << 18},
            "dataset": _pack_tree(dataset_meta or {}),
        },
    }
    if density_grid is not None:
        snap["density_grid_binary"] = density_to_morton(
            np.asarray(density_grid, np.float16)).tobytes()
    half = aabb_scale / 2.0
    snap["aabb"] = {"min": [0.5 - half] * 3, "max": [0.5 + half] * 3}
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def import_reference_snapshot(path):
    """Read a reference snapshot (tcnn Trainer::serialize): its
    ``params_binary`` decoded by ``params_type`` (fp16 for ``"__half"`` or
    no type, f32 for ``"float"``, ValueError for any other), cut into the
    density MLP, the rgb MLP and the flat hash table (ABI rules 2–6), the
    padded widths trimmed to the network's.

    Returns (network_config, params, snapshot): the config as stored, the
    parameter tree of ``NerfNetwork(config, aabb_scale,
    grid_impl="tcnn")`` as numpy (for ``bridge.nerf_params_from_numpy``)
    and the raw snapshot section."""
    import msgpack  # only snapshot I/O needs it

    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc["snapshot"]
    raw = snap.get("params_binary")
    if raw is None:
        raise ValueError("no params_binary: not a reference snapshot")
    flat = np.frombuffer(raw, _params_dtype(snap)).astype(np.float32)

    aabb_scale = int(snap.get("nerf", {}).get("aabb_scale", 1))
    meta = _nerf_grid_meta(doc, aabb_scale)
    density_widths, rgb_widths = _tcnn_mlp_widths(doc, meta)
    n_table = meta.n_params * meta.n_features_per_level
    need = sum(a * b for a, b in density_widths + rgb_widths) + n_table
    if flat.size < need:
        raise ValueError(f"params_binary holds {flat.size} values; the "
                         f"network needs {need}")

    def take_mlp(off, widths):
        mats = []
        for n_in, n_out in widths:
            n = n_in * n_out
            mats.append(flat[off: off + n].reshape(n_out, n_in).T.copy())
            off += n
        return tuple(mats), off

    density_net, off = take_mlp(0, density_widths)
    rgb_net, off = take_mlp(off, rgb_widths)
    table = flat[off: off + n_table].copy()

    # trim the padded widths down to the network's exact shapes
    density_net = (density_net[0][: meta.n_output_dims],) + density_net[1:]
    rgb_net = rgb_net[:-1] + (rgb_net[-1][:, :3],)
    cfg = {k: v for k, v in doc.items() if k != "snapshot"}
    params = {"pos_encoding": table,
              "dir_encoding": _dir_skeleton(cfg.get(
                  "dir_encoding", {"otype": "SphericalHarmonics"})),
              "density_net": density_net, "rgb_net": rgb_net}
    return cfg, params, snap


def _tcnn_encoded_widths(network_cfg: dict, enc_out: int,
                         n_output_dims: int):
    """The (n_in, n_out) sequence tcnn allocates for a
    NetworkWithInputEncoding's MLP (ABI rules 4–5): the encoding's output
    padded to 16 feeds the first layer; the last layer's output pads to
    16."""
    n = int(network_cfg.get("n_neurons", 64))
    hidden = int(network_cfg.get("n_hidden_layers", 1))
    in_pad = (enc_out + 15) // 16 * 16
    out_pad = max((n_output_dims + 15) // 16 * 16, 16)
    return [(in_pad, n)] + [(n, n)] * (hidden - 1) + [(n, out_pad)]


def _encoded_meta(doc: dict, n_input_dims: int, desired_resolution: float):
    from ngp_tpu_torch.config import autofill_hashgrid_config
    from ngp_tpu_torch.kernels.hashgrid import HashGridMeta
    enc_cfg = autofill_hashgrid_config(dict(doc["encoding"]), n_input_dims,
                                       desired_resolution)
    return HashGridMeta.from_config(enc_cfg)


def export_reference_snapshot_encoded(
        path, network_config: dict, params, n_input_dims: int,
        n_output_dims: int, desired_resolution: float = 2048.0,
        training_step: int = 0, loss: float = 0.0,
        extra: Optional[dict] = None) -> None:
    """Write a tcnn ``params_binary`` snapshot (fp16, ``"__half"``) of a
    NetworkWithInputEncoding (the reference's image, SDF and volume
    modes): the MLP first, then the hash table (ABI rule 3). ``params`` is
    the tree of an ``EncodedNetwork(grid_impl="tcnn")`` as numpy
    (``bridge.encoded_params_to_numpy``): {"encoding": the flat table,
    "net": (W, ...)}; each matrix is written (n_out, n_in) row-major,
    zero-padded to tcnn's widths."""
    import msgpack  # only snapshot I/O needs it

    meta = _encoded_meta(network_config, n_input_dims, desired_resolution)
    widths = _tcnn_encoded_widths(network_config["network"],
                                  meta.n_output_dims, n_output_dims)
    chunks = []
    for w, (n_in, n_out) in zip(params["net"], widths):
        w = np.asarray(w, np.float32)
        full = np.zeros((n_in, n_out), np.float32)
        full[: w.shape[0], : w.shape[1]] = w
        chunks.append(full.T.reshape(-1))       # (n_out, n_in) row-major
    table = np.asarray(params["encoding"], np.float32).reshape(-1)
    want = meta.n_params * meta.n_features_per_level
    if table.size != want:
        raise ValueError(f"table size {table.size} != tcnn layout {want}")
    chunks.append(table)
    flat = np.concatenate(chunks).astype(np.float16)
    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "n_params": int(flat.size),
        "params_type": "__half",
        "params_binary": flat.tobytes(),
        "training_step": int(training_step),
        "loss": float(loss),
    }
    if extra:
        snap.update(_pack_tree(extra))
    doc = dict(network_config)
    doc["snapshot"] = snap
    Path(path).write_bytes(msgpack.packb(doc, use_bin_type=True))


def import_reference_snapshot_encoded(path, n_input_dims: int,
                                      n_output_dims: int,
                                      desired_resolution: float = 2048.0):
    """Read a tcnn NetworkWithInputEncoding snapshot (the reference's
    image, SDF and volume modes): ``params_binary`` decoded by
    ``params_type`` (intended divergence, as in
    ``import_reference_snapshot``: the JAX package decodes it as fp16
    always), cut into the MLP and the flat hash table, the padded widths
    trimmed. Returns (network_config, params, snapshot): the tree of an
    ``EncodedNetwork(grid_impl="tcnn")`` as numpy
    (``bridge.encoded_params_from_numpy``) and the raw snapshot
    section."""
    import msgpack  # only snapshot I/O needs it

    doc = msgpack.unpackb(Path(path).read_bytes(), raw=False,
                          strict_map_key=False)
    snap = doc["snapshot"]
    raw = snap.get("params_binary")
    if raw is None:
        raise ValueError("no params_binary: not a reference snapshot")
    flat = np.frombuffer(raw, _params_dtype(snap)).astype(np.float32)
    meta = _encoded_meta(doc, n_input_dims, desired_resolution)
    widths = _tcnn_encoded_widths(doc["network"], meta.n_output_dims,
                                  n_output_dims)
    n_table = meta.n_params * meta.n_features_per_level
    need = sum(a * b for a, b in widths) + n_table
    if flat.size < need:
        raise ValueError(f"params_binary holds {flat.size} values; the "
                         f"network needs {need}")
    off, mats = 0, []
    for n_in, n_out in widths:
        n = n_in * n_out
        mats.append(flat[off: off + n].reshape(n_out, n_in).T.copy())
        off += n
    table = flat[off: off + n_table].copy()
    # trim the tcnn padding back to the network's shapes
    mats[0] = mats[0][: meta.n_output_dims]
    mats[-1] = mats[-1][:, :n_output_dims]
    cfg = {k: v for k, v in doc.items() if k != "snapshot"}
    return cfg, {"encoding": table, "net": tuple(mats)}, snap
