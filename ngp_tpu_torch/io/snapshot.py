"""Snapshot loading (port of ``load_snapshot`` in
``ngp_tpu/io/snapshot.py``).

A snapshot is one msgpack document holding the network config plus a
``snapshot`` section: parameters as a named pytree of arrays
(``ngp_tpu_params``, and the EMA copy the renderer uses under
``ngp_tpu_ema_params``), the fp16 density grid in the reference's Morton
order, and scene metadata. Arrays come back as numpy; ``bridge.py`` turns
the parameter tree into the port's parameters.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ngp_tpu_torch.grid.occupancy import density_from_morton


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


def load_snapshot(path) -> dict:
    """Read a snapshot; returns the full document with arrays decoded and
    the density grid in linear layout under ``snapshot["density_grid"]``."""
    import msgpack  # only snapshot loading needs it

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
