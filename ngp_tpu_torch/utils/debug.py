"""Numerics debugging (port of ``ngp_tpu/utils/debug.py``): NaN/Inf checks
over named tensors and nested dicts, lists and tuples of them (SURVEY §5:
the functional substitute for the sanitizers the reference lacks)."""
from __future__ import annotations

import torch


def _leaves(tree, path: str):
    """(path, leaf) pairs of a nested structure, with the JAX package's
    key style (``jax.tree_util.keystr``): ``['key']`` for a dict entry,
    ``[i]`` for a list or tuple item."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def find_nonfinite(tree, prefix: str = "") -> list[str]:
    """Paths of the floating-point tensors of ``tree`` that hold a NaN or
    an Inf."""
    return [path for path, leaf in _leaves(tree, prefix)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and not bool(torch.isfinite(leaf).all())]


def assert_finite(tree, name: str = "pytree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"{name} has non-finite leaves: {bad}")
