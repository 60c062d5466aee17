"""The check that nothing of the JAX package, or JAX itself, is loaded in
the process that measures the port.

A module counts by its top-level name (the part before the first dot),
compared whole: ``ngp_tpu_torch`` begins with ``ngp_tpu`` and is allowed.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ngp_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
