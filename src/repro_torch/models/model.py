"""Model assembly: embeddings -> a loop over layers -> LM head.

Three entry modes share one sub-layer implementation, as in
``repro/models/model.py``:
  * train    full-sequence forward (``forward_train``), ``lm_loss``,
             ``make_train_step`` (gradients from ``torch.autograd``,
             the update from a ``repro_torch.optim`` optimizer),
             ``make_eval_step``;
  * prefill  full-sequence forward that fills the KV / SSM cache,
             returns the last position's logits;
  * decode   one token against the cache.

The reference scans over stacked super-blocks; the port loops over
``params.blocks`` in Python, layer i of kind ``sublayer_kinds()[i %
period]``: attention or the Mamba2 mixer (``models/ssm.py``), then the
SwiGLU MLP, the MoE or no FFN. The MoE layers' aux losses are summed
in layer order and ``forward_train`` returns the sum. The cache keeps
the reference's per-layer layout as a list with one entry per layer,
``{"attn": {k, v (B, W, K, hd), pos (B, W) int32, -1 empty}}`` or
``{"mamba": {ssm (B, H, N, P) fp32, conv (B, K - 1, d_inner + 2N)}}``,
and ``step`` as a Python int. Prefill and decode update the cache's
tensors in place and return the same dict.

The reference's train-only knobs act in train mode as its XLA path
makes them act: ``cast_grads`` casts the trunk's gradient to
``cfg.dtype`` at the top of the stack (``_GradCast``, the reference's
``_grad_cast``); ``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``), ``remat="dots"`` saves only the outputs
of the blocks' matmuls without batch dimensions (the projections, the
router and the MLP, as ``dots_with_no_batch_dims_saveable`` does) and
recomputes the rest, the experts' and the SSD's batched products
(``aten.bmm``) among it. Neither changes a number. The hand-written
CUDA kernels have no backward, as the reference's Pallas kernels have
none: with ``use_pallas`` a train step on the card raises
(``native.check_cuda``); on the CPU the plain flash version is
differentiable.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import check_buildable, param_tree
from repro_torch.models.ssm import mamba_mixer
from repro_torch.optim import apply_updates
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import tree_leaves, tree_structure, tree_unflatten


class _GradCast(torch.autograd.Function):
    """Identity forward; casts the cotangent to ``dtype`` on the way back."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


# remat="dots": the products without batch dimensions (x @ W, which
# torch.matmul folds into aten.mm) are saved; attention's batched
# einsums (aten.bmm) and the elementwise work are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat: str):
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if remat == "full":
        return noop_context_fn
    raise ValueError(f"unknown remat {remat!r}; use none, dots or full")


# ----------------------------------------------------------------------
# sub-layer
# ----------------------------------------------------------------------

def _apply_sublayer(x, p, kind, cfg: ModelConfig, *, mode: str, positions, cache, step):
    """One (mixer + ffn) sub-layer with pre-norm residuals. Returns (x,
    the MoE's aux loss or None)."""
    mixer, ffn = kind
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if mixer == "attn":
        w = cfg.sliding_window
        if mode == "train":
            h = L.attention_dense(h, p.mixer, cfg, positions, causal=True, window=w)
        elif mode == "prefill":
            h, _ = L.attention_prefill(h, p.mixer, cfg, positions, cache["attn"], window=w)
        else:  # decode
            h, _ = L.attention_decode(h, p.mixer, cfg, step, cache["attn"], window=w)
    else:  # mamba
        h, _ = mamba_mixer(h, p.mixer, cfg, cache=None if cache is None else cache["mamba"],
                           decode=mode == "decode")
    x = x + h
    aux = None
    if ffn != "none":
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        if ffn == "moe":
            h, aux = L.moe(h, p.ffn, cfg)
        else:
            h = L.mlp(h, p.ffn, cfg)
        x = x + h
    return x, aux


def _run_blocks(x, blocks, cfg: ModelConfig, *, mode: str, positions, blocks_cache, step):
    """Returns (x, the sum of the MoE layers' aux losses, fp32)."""
    kinds = cfg.sublayer_kinds()
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    context = _remat_context(cfg.remat) if remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(blocks):
        cache = blocks_cache[i] if blocks_cache is not None else None
        block = functools.partial(_apply_sublayer, p=p, kind=kinds[i % len(kinds)], cfg=cfg,
                                  mode=mode, positions=positions, cache=cache, step=step)
        x, a = checkpoint(block, x, use_reentrant=False, context_fn=context) if remat else block(x)
        if a is not None:
            aux = aux + a
    return x, aux


def _tokens(tokens, params) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Returns (logits over all positions, aux loss: the MoE layers' Switch
    losses summed, 0 without MoE layers)."""
    tokens = _tokens(batch["tokens"], params)
    B, S = tokens.shape
    x = params.embed[tokens]
    x, aux = _run_blocks(x, params.blocks, cfg, mode="train",
                         positions=_positions(B, S, x.device), blocks_cache=None, step=None)
    if cfg.cast_grads:
        x = _GradCast.apply(x, cfg.dtype)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = torch.matmul(x, params.lm_head)
    return logits, aux


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch: Dict[str, Any], cache):
    """tokens (B, S) -> (logits of the last position (B, V), cache), the
    cache filled in place and its ``step`` set to S."""
    tokens = _tokens(batch["tokens"], params)
    B, S = tokens.shape
    x = params.embed[tokens]
    x, _ = _run_blocks(x, params.blocks, cfg, mode="prefill",
                       positions=_positions(B, S, x.device), blocks_cache=cache["blocks"],
                       step=None)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.rms_eps)
    logits = torch.matmul(x, params.lm_head)[:, 0]
    cache["step"] = S
    return logits, cache


@torch.no_grad()
def forward_decode(params, cfg: ModelConfig, tokens, cache):
    """tokens: (B, 1). Returns (logits (B, V), cache), the cache updated
    in place and its ``step`` advanced by one."""
    step = int(cache["step"])
    x = params.embed[_tokens(tokens, params)]
    x, _ = _run_blocks(x, params.blocks, cfg, mode="decode", positions=None,
                       blocks_cache=cache["blocks"], step=step)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = torch.matmul(x, params.lm_head)[:, 0]
    cache["step"] = step + 1
    return logits, cache


# ----------------------------------------------------------------------
# KV / SSM cache
# ----------------------------------------------------------------------

def _sublayer_cache_spec(cfg: ModelConfig, mixer: str, batch: int, kv_len: int) -> dict:
    if mixer == "attn":
        W = min(cfg.sliding_window, kv_len) if cfg.sliding_window else kv_len
        K, hd = cfg.n_kv_heads, cfg.head_dim
        return {"attn": {"k": ((batch, W, K, hd), cfg.dtype),
                         "v": ((batch, W, K, hd), cfg.dtype),
                         "pos": ((batch, W), torch.int32)}}
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"mamba": {"ssm": ((batch, H, N, P), torch.float32),
                      "conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), cfg.dtype)}}


def cache_spec(cfg: ModelConfig, batch: int, kv_len: int):
    """The cache's tree with (shape, dtype) leaves: one entry per layer
    under ``blocks`` (``{"attn": ...}`` or ``{"mamba": ...}``), then
    ``step``."""
    check_buildable(cfg)
    kinds = cfg.sublayer_kinds()
    blocks = [_sublayer_cache_spec(cfg, kinds[i % len(kinds)][0], batch, kv_len)
              for i in range(cfg.n_layers)]
    return {"blocks": blocks, "step": ((), torch.int32)}


def cache_nbytes(spec) -> int:
    """The bytes of a ``cache_spec``'s tensors."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for sub in spec["blocks"] for entry in sub.values()
               for shape, dtype in entry.values())


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device="cuda"):
    """An empty cache on ``device``: k, v and the SSM and conv states
    zeros, pos -1, step 0."""
    dev = resolve_device(device)

    def mk(leaf):
        shape, dtype = leaf
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)

    spec = cache_spec(cfg, batch, kv_len)
    blocks = [{kind: {name: mk(leaf) for name, leaf in entry.items()}
               for kind, entry in sub.items()} for sub in spec["blocks"]]
    return {"blocks": blocks, "step": 0}


# ----------------------------------------------------------------------
# losses & steps
# ----------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token CE over non-ignored positions, in fp32."""
    lg = logits.float()
    labels = torch.as_tensor(labels, device=lg.device)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def optimizer_step(params, opt_state, optimizer, loss_fn):
    """One step on ``loss_fn(params) -> (loss, metrics)``: the loss's
    gradients with respect to every parameter come from
    ``torch.autograd``, ``optimizer`` (a ``repro_torch.optim.Optimizer``
    over ``param_tree(params)``) turns them into updates, and
    ``apply_updates``' new values are copied into ``params`` (built with
    ``trainable=True``). Returns ``(params, opt_state, metrics)``, the
    metrics detached."""
    tree = param_tree(params)
    leaves = tree_leaves(tree)
    if not all(p.requires_grad for p in leaves):
        raise ValueError("the parameters are frozen; build them with trainable=True")
    loss, metrics = loss_fn(params)
    grads = tree_unflatten(tree_structure(tree), torch.autograd.grad(loss, leaves))
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state, tree)
        del grads
        for p, new in zip(leaves, tree_leaves(apply_updates(tree, updates))):
            p.copy_(new)
    return params, opt_state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "aux"})``, as the reference's: the loss is ``lm_loss``
    plus ``router_aux_coef * aux``, one ``optimizer_step`` on it.
    The metrics are 0-d fp32 tensors on the parameters' device."""
    check_buildable(cfg)

    def loss_fn(params, batch):
        logits, aux = forward_train(params, cfg, batch)
        ce = lm_loss(logits, batch["labels"])
        del logits
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def train_step(params, opt_state, batch):
        return optimizer_step(params, opt_state, optimizer,
                              functools.partial(loss_fn, batch=batch))

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = forward_train(params, cfg, batch)
        return lm_loss(logits, batch["labels"])

    return eval_step


def make_prefill_step(cfg: ModelConfig):
    def prefill(params, batch, cache):
        return forward_prefill(params, cfg, batch, cache)

    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode(params, tokens, cache):
        return forward_decode(params, cfg, tokens, cache)

    return decode
