"""Host utilities of the port: parameter trees, metrics, logging, seeds,
the Threefry key chain and the device policy.

``accuracy`` and ``binary_cross_entropy`` come with the LM's train step
(ROADMAP queue 1 item 13).
"""
from repro_torch.utils.trees import (
    tree_zeros_like,
    tree_add,
    tree_scale,
    tree_mean,
    tree_size_bytes,
    tree_count_params,
)
from repro_torch.utils.metrics import roc_auc
from repro_torch.utils.logging import get_logger, kv

__all__ = [
    "tree_zeros_like",
    "tree_add",
    "tree_scale",
    "tree_mean",
    "tree_size_bytes",
    "tree_count_params",
    "roc_auc",
    "get_logger",
    "kv",
]
