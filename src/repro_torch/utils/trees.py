"""Parameter trees without JAX: nested dicts, lists and tuples whose
leaves are numpy arrays, torch tensors or scalars.

Port of the part of ``repro.utils.trees`` that the one-shot baselines
use. ``tree_structure`` plays the role of a JAX treedef: dict keys are
taken in sorted order (as ``jax.tree`` takes them), ``None`` is an empty
subtree, and two trees map together only where their structures are
equal. The stacking helpers and ``tree_global_norm`` / ``tree_cast``
come with the LM's train step (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _children(node) -> Tuple[str, tuple, list]:
    """(kind, keys, children) of an inner node, or ("leaf", (), [])."""
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return "dict", keys, [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, (), list(node)
    if node is None:
        return "none", (), []
    return "leaf", (), []


def tree_structure(tree):
    """A hashable description of ``tree``'s nesting (no leaf values)."""
    kind, keys, kids = _children(tree)
    if kind == "leaf":
        return "*"
    return (kind, keys, tuple(tree_structure(c) for c in kids))


def tree_leaves(tree) -> List[Any]:
    """The leaves in the order ``tree_map`` visits them."""
    kind, _, kids = _children(tree)
    if kind == "leaf":
        return [tree]
    return [leaf for c in kids for leaf in tree_leaves(c)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over ``tree`` and trees of its structure."""
    want = tree_structure(tree)
    for other in rest:
        if tree_structure(other) != want:
            raise ValueError("tree_map: trees of different structures")
    return _map(fn, tree, rest)


def _map(fn, node, rest):
    kind, keys, kids = _children(node)
    if kind == "leaf":
        return fn(node, *rest)
    if kind == "none":
        return None
    others = [_children(r)[2] for r in rest]
    mapped = [_map(fn, c, [o[i] for o in others]) for i, c in enumerate(kids)]
    if kind == "dict":
        return dict(zip(keys, mapped))
    return type(node)(mapped)


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(x)


def tree_zeros_like(tree):
    return tree_map(_zeros_like, tree)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_mean(trees):
    """Mean of a list of trees with identical structure."""
    out = trees[0]
    for t in trees[1:]:
        out = tree_add(out, t)
    return tree_scale(out, 1.0 / len(trees))


def leaf_shape(leaf) -> tuple:
    """A leaf's shape, for tensors, arrays and scalars alike."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.asarray(leaf).dtype.itemsize  # repro: allow[wire-cost-honesty] reason=in-memory tree footprint, as the reference's tree_size_bytes, not a wire price


def tree_size_bytes(tree) -> int:
    """Total bytes of all leaves."""
    return sum(int(np.prod(leaf_shape(leaf))) * _itemsize(leaf) for leaf in tree_leaves(tree))


def tree_count_params(tree) -> int:
    return sum(int(np.prod(leaf_shape(leaf))) for leaf in tree_leaves(tree))
