"""Parameter trees without JAX: nested dicts, lists and tuples whose
leaves are numpy arrays, torch tensors or scalars.

Port of ``repro.utils.trees``. ``tree_structure`` plays the role of a
JAX treedef: dict keys are taken in sorted order (as ``jax.tree`` takes
them), ``None`` is an empty subtree, and two trees map together only
where their structures are equal. ``tree_flatten_with_path`` names each leaf by the key string the
reference's checkpoints use (``"/"``-joined dict keys and sequence
indices), and ``tree_unflatten`` rebuilds a tree from a structure and
its leaves. ``tree_global_norm`` returns a 0-d fp32 tensor (on the
leaves' device), as the reference returns a 0-d array.
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


def tree_flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``tree_leaves`` order; the key is JAX's path
    of the leaf as ``repro.checkpoint`` spells it: dict keys and sequence
    indices joined by ``"/"`` (a bare leaf has the key ``""``)."""
    kind, keys, kids = _children(tree)
    if kind == "leaf":
        return [("", tree)]
    names = keys if kind == "dict" else range(len(kids))
    return [(f"{name}/{sub}" if sub else str(name), leaf)
            for name, c in zip(names, kids) for sub, leaf in tree_flatten_with_path(c)]


def tree_unflatten(structure, leaves) -> Any:
    """The tree of ``structure`` (a ``tree_structure``) whose leaves, in
    ``tree_leaves`` order, are ``leaves``."""
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, _END) is not _END:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


_END = object()
_SEQUENCES = {"list": list, "tuple": tuple}


def _build(structure, it):
    if structure == "*":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("tree_unflatten: fewer leaves than the structure holds")
        return leaf
    kind, keys, kids = structure
    if kind == "none":
        return None
    built = [_build(c, it) for c in kids]
    if kind == "dict":
        return dict(zip(keys, built))
    if kind not in _SEQUENCES:
        raise TypeError(f"tree_unflatten: cannot rebuild a {kind} node")
    return _SEQUENCES[kind](built)


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


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs, dim=0)
    return np.stack(xs, axis=0)


def tree_stack(trees):
    """Stack a list of trees along a new leading (member) axis."""
    return tree_map(lambda *xs: _stack(xs), trees[0], *trees[1:])


def tree_unstack(tree):
    """Inverse of tree_stack: list of trees from a member-stacked tree."""
    leaves = tree_leaves(tree)
    structure = tree_structure(tree)
    n = leaf_shape(leaves[0])[0]
    return [tree_unflatten(structure, [leaf[i] for leaf in leaves]) for i in range(n)]


def tree_index(tree, i):
    """Select member ``i`` from a member-stacked tree."""
    return tree_map(lambda x: x[i], tree)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    leaves = [torch.as_tensor(x).float() for x in tree_leaves(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    x = np.asarray(x)
    return x.astype(dtype) if np.issubdtype(x.dtype, np.floating) else x


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype`` (a torch dtype for tensor leaves,
    a numpy dtype for arrays); other leaves unchanged."""
    return tree_map(lambda x: _cast(x, dtype), tree)
