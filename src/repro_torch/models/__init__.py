"""The LM of the deep path: config, parameters, layers, forward passes
(ports of ``repro.models``: the dense, MoE, SSM, hybrid, VLM and
encoder-decoder families), and ``ShardCtx``, the LM mesh's sharding
context."""
from repro_torch.models.config import (
    ModelConfig,
    active_param_count,
    param_count,
    uncounted_params,
)
from repro_torch.models.layers import ShardCtx, blocked_attention
from repro_torch.models.model import (
    abstract_cache,
    cache_logical_axes,
    cache_nbytes,
    cache_spec,
    encode,
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
from repro_torch.models.params import (
    abstract_params,
    init_params,
    logical_axes,
    model_specs,
    param_tree,
)

__all__ = [
    "ModelConfig",
    "param_count",
    "active_param_count",
    "uncounted_params",
    "init_params",
    "abstract_params",
    "logical_axes",
    "model_specs",
    "param_tree",
    "ShardCtx",
    "blocked_attention",
    "forward_train",
    "encode",
    "forward_prefill",
    "forward_decode",
    "init_cache",
    "abstract_cache",
    "cache_logical_axes",
    "cache_spec",
    "cache_nbytes",
    "lm_loss",
    "make_train_step",
    "make_eval_step",
    "make_prefill_step",
    "make_decode_step",
]
