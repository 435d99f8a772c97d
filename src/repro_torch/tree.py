"""Minimal pytree helpers over nested dicts, lists and tuples.

Leaf order is jax's canonical flatten order: dict keys sorted, lists and
tuples in order.  The trainer tree the checkpoint store persists (one
``leaf_<i>`` per leaf) therefore has the same layout on disk as the
reference writes.  ``None`` is an empty subtree, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch import resolve_device


def leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def unflatten(template, flat) -> Any:
    """Rebuild ``template``'s structure with the leaves of ``flat`` (in
    ``leaves`` order)."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping ``tree``'s structure."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    structure.  ``path`` is the leaf's key path from the root: dict keys
    as they are (strings), sequence indices as ints; the leaves are
    visited in ``leaves`` order (what ``jax.tree_util.tree_map_with_path``
    gives the reference's sharding rules)."""
    out = []

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, sub in enumerate(t):
                walk(sub, path + (i,))
        else:
            out.append(fn(path, t))

    walk(tree, ())
    return unflatten(tree, out)


def params_from_jax(tree, device=None) -> Any:
    """A parameter tree of the reference (numpy arrays, or anything
    ``np.asarray`` takes), same layout, as tensors on ``device``."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def own_copy(a, device) -> torch.Tensor:
    """A private copy of a tensor or array on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    return torch.tensor(np.asarray(a), device=device)
