"""The LM of the deep path: config, parameters, layers, forward passes
(ports of ``repro.models``; the dense family only)."""
from repro_torch.models.config import ModelConfig, active_param_count, param_count
from repro_torch.models.layers import blocked_attention
from repro_torch.models.model import (
    cache_spec,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    lm_loss,
    make_decode_step,
    make_eval_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.params import init_params, model_specs, param_tree

__all__ = [
    "ModelConfig",
    "param_count",
    "active_param_count",
    "init_params",
    "model_specs",
    "param_tree",
    "blocked_attention",
    "forward_train",
    "forward_prefill",
    "forward_decode",
    "init_cache",
    "cache_spec",
    "lm_loss",
    "make_train_step",
    "make_eval_step",
    "make_prefill_step",
    "make_decode_step",
]
