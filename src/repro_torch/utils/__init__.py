"""Host utilities of the port: parameter trees, metrics, logging, seeds,
the Threefry key chain and the device policy."""
from repro_torch.utils.trees import (
    tree_zeros_like,
    tree_add,
    tree_scale,
    tree_mean,
    tree_size_bytes,
    tree_count_params,
    tree_stack,
    tree_unstack,
    tree_index,
    tree_global_norm,
)
from repro_torch.utils.metrics import accuracy, binary_cross_entropy, roc_auc
from repro_torch.utils.logging import get_logger, kv

__all__ = [
    "tree_zeros_like",
    "tree_add",
    "tree_scale",
    "tree_mean",
    "tree_size_bytes",
    "tree_count_params",
    "tree_stack",
    "tree_unstack",
    "tree_index",
    "tree_global_norm",
    "roc_auc",
    "accuracy",
    "binary_cross_entropy",
    "get_logger",
    "kv",
]
