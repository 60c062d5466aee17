"""Snapshot save and load (port of ``save_snapshot``/``load_snapshot`` in
``ngp_tpu/io/snapshot.py``; msgpack is imported where it is used).

A snapshot is one msgpack document holding the network config plus a
``snapshot`` section: parameters as a named pytree of arrays
(``ngp_tpu_params``, and the EMA copy the renderer uses under
``ngp_tpu_ema_params``), the fp16 density grid in the reference's Morton
order, and scene metadata. Arrays come back as numpy; ``bridge.py`` turns
the parameter tree into the port's parameters.
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
