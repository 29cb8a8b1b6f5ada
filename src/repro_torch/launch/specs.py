"""Meta-tensor stand-ins and logical axes for every step kind.

A port of ``repro.launch.specs``. Everything the dry-run runs is built
here on the ``meta`` device, which allocates nothing: parameters
(``models.abstract_params``), optimizer state, batches and caches. The
same logical-axis trees place the real tensors in ``launch.train``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models import (
    ModelConfig,
    abstract_cache,
    abstract_params,
    cache_logical_axes,
    logical_axes,
)
from repro_torch.optim import adamw, chain, clip_by_global_norm


def make_optimizer(lr: float = 3e-4):
    """Global-norm clipping at 1.0, then AdamW with weight decay 0.1."""
    return chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=0.1))


def abstract_opt_state(cfg: ModelConfig):
    """``make_optimizer``'s state over ``abstract_params``: the moments
    ``meta`` tensors, the step counter a real 0-d int32 tensor."""
    return make_optimizer().init(abstract_params(cfg))


def opt_state_logical(cfg: ModelConfig):
    """Logical axes for chain(clip, adamw) state: moments mirror params."""
    la = logical_axes(cfg)
    return ({}, {"step": (), "mu": la, "nu": la})


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta batch, logical axes) for a train/prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    la = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.n_patches:
        batch["patches"] = _meta((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        la["patches"] = ("batch", None, "embed")
    if cfg.is_encdec:
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        la["frames"] = ("batch", None, "embed")
    if shape.kind == "prefill":
        del batch["labels"], la["labels"]
    return batch, la


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(meta (tokens, cache), logical axes) for one decode step."""
    B, S = shape.global_batch, shape.seq_len
    tokens = _meta((B, 1), torch.int32)
    return ((tokens, abstract_cache(cfg, B, kv_len=S)),
            (("batch", None), cache_logical_axes(cfg, B, kv_len=S)))


def prefill_cache_specs(cfg: ModelConfig, shape: InputShape):
    B, S = shape.global_batch, shape.seq_len
    return abstract_cache(cfg, B, kv_len=S), cache_logical_axes(cfg, B, kv_len=S)
