"""Checkpointing: tree <-> npz with a json manifest.

Port of ``repro.checkpoint.manager``. Leaves are numpy arrays, torch
tensors or scalars; a leaf is stored under JAX's path key
(``utils.trees.tree_flatten_with_path``: ``"/"``-joined dict keys and
sequence indices), so an ``arrays.npz`` written by either package
restores in the other. The manifest carries the same fields as the
reference's (``step``, ``keys``, ``treedef``, ``nbytes``); ``treedef``
is the port's ``tree_structure`` as text, which restore never reads:
``restore_checkpoint`` takes the structure from ``like``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.trees import (
    leaf_shape,
    tree_flatten_with_path,
    tree_structure,
    tree_unflatten,
)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; bfloat16, which numpy lacks, is stored as
    fp32 (exact) and cast back by ``_like`` on restore."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` as ``leaf``'s kind: a tensor of its dtype on its device,
    else a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=leaf.device,
                                                               dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in tree_flatten_with_path(tree)}


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    os.makedirs(path, exist_ok=True)
    arrays = _flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "treedef": str(tree_structure(tree)),
        "nbytes": int(sum(a.nbytes for a in arrays.values())),  # repro: allow[wire-cost-honesty] reason=manifest sizes are storage, not comm
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes checked; each leaf
    takes ``like``'s leaf type, dtype and device)."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    leaves = []
    for key, leaf in tree_flatten_with_path(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf_shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {leaf_shape(leaf)}")
        leaves.append(_like(arr, leaf))
    return tree_unflatten(tree_structure(like), leaves)


def save_payload(path: str, blob: bytes, step: Optional[int] = None) -> str:
    """Persist a ``repro_torch.comm`` wire payload through the checkpoint
    format (one uint8 leaf), so encoded uploads and ensembles round-trip
    the same npz + manifest machinery as model trees."""
    from repro_torch.comm.wire import payload_to_tree

    return save_checkpoint(path, payload_to_tree(blob), step=step)


def restore_payload(path: str) -> bytes:
    """Inverse of ``save_payload``: the exact wire bytes back."""
    from repro_torch.comm.wire import tree_to_payload

    with np.load(os.path.join(path, "arrays.npz")) as data:
        return tree_to_payload({"wire": data["wire"]})


class CheckpointManager:
    """Step-indexed checkpoints with max_to_keep retention."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def save(self, step: int, tree: Any) -> str:
        path = save_checkpoint(self._step_dir(step), tree, step=step)
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            shutil.rmtree(self._step_dir(steps.pop(0)), ignore_errors=True)
        return path

    def restore_latest(self, like: Any):
        steps = self.all_steps()
        if not steps:
            return None, None
        step = steps[-1]
        return restore_checkpoint(self._step_dir(step), like), step
