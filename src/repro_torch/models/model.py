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

The VLM (``cfg.n_patches``) takes ``batch["patches"]``, the stub vision
frontend's projected patch embeddings (B, P, d), as a prefix in front of
the token embeddings: positions run over the whole sequence, the prefill
caches the prefix with the prompt (a cache of ``kv_len >= P + prompt +
gen`` keeps it through decode) and sets ``step`` to P + prompt, and
``forward_train`` drops the prefix before the logits. Without patches in
the batch the model reads tokens alone, as the reference's does. The
audio family (``cfg.is_encdec``) runs ``encode`` over ``batch["frames"]``
(B, S_enc, d) first: the learned ``pos``, non-causal self-attention
blocks and ``rms_norm``; each decoder layer then adds a cross-attention
over the encoder's output, whose keys and values the prefill stores in
the layer's cache entry as ``xk`` and ``xv`` (B, S_enc, K, hd) for
decode to read.

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

def _apply_sublayer(x, p, kind, cfg: ModelConfig, *, mode: str, positions, cache, step,
                    enc_out=None, causal: bool = True):
    """One (mixer + ffn) sub-layer with pre-norm residuals, and between
    them the cross-attention over ``enc_out`` where the layer has one.
    Returns (x, the MoE's aux loss or None)."""
    mixer, ffn = kind
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if mixer == "attn":
        w = cfg.sliding_window
        if mode == "train":
            h = L.attention_dense(h, p.mixer, cfg, positions, causal=causal, window=w)
        elif mode == "prefill":
            h, _ = L.attention_prefill(h, p.mixer, cfg, positions, cache["attn"], window=w)
        else:  # decode
            h, _ = L.attention_decode(h, p.mixer, cfg, step, cache["attn"], window=w)
    else:  # mamba
        h, _ = mamba_mixer(h, p.mixer, cfg, cache=None if cache is None else cache["mamba"],
                           decode=mode == "decode")
    x = x + h
    if hasattr(p, "xattn"):   # the encoder-decoder's cross-attention
        h = rms_norm(x, p.norm_x, cfg.rms_eps)
        if mode == "decode":
            enc_kv = (cache["xk"], cache["xv"])
        else:
            enc_kv = L.encode_kv(enc_out, p.xattn, cfg)
            if cache is not None:
                cache["xk"].copy_(enc_kv[0])
                cache["xv"].copy_(enc_kv[1])
        x = x + L.cross_attention(h, p.xattn, cfg, enc_kv)
    aux = None
    if ffn != "none":
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        if ffn == "moe":
            h, aux = L.moe(h, p.ffn, cfg)
        else:
            h = L.mlp(h, p.ffn, cfg)
        x = x + h
    return x, aux


def _run_blocks(x, blocks, cfg: ModelConfig, *, mode: str, positions, blocks_cache, step,
                enc_out=None):
    """Returns (x, the sum of the MoE layers' aux losses, fp32)."""
    kinds = cfg.sublayer_kinds()
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    context = _remat_context(cfg.remat) if remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(blocks):
        cache = blocks_cache[i] if blocks_cache is not None else None
        block = functools.partial(_apply_sublayer, p=p, kind=kinds[i % len(kinds)], cfg=cfg,
                                  mode=mode, positions=positions, cache=cache, step=step,
                                  enc_out=enc_out)
        x, a = checkpoint(block, x, use_reentrant=False, context_fn=context) if remat else block(x)
        if a is not None:
            aux = aux + a
    return x, aux


def _tokens(tokens, params) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ----------------------------------------------------------------------
# encoder (audio / enc-dec)
# ----------------------------------------------------------------------

def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """The encoder (``params``: the model's ``encoder`` node) over the
    stub frontend's frame embeddings, frames (B, S_enc, d): the learned
    ``pos`` added, one non-causal (attn, mlp) sub-layer per encoder layer
    (RoPE over the frames' positions, as in the reference; the flash
    kernel with ``use_pallas``), then ``rms_norm``."""
    frames = torch.as_tensor(frames, device=params.pos.device)
    x = frames.to(cfg.dtype) + params.pos[None, :frames.shape[1]]
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for p in params.blocks:
        x, _ = _apply_sublayer(x, p, ("attn", "mlp"), cfg, mode="train", positions=positions,
                               cache=None, step=None, causal=False)
    return rms_norm(x, params.norm, cfg.rms_eps)


def _inputs(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """The decoder's input embeddings with the VLM's patch prefix in front
    when the config has patches and the batch brings them, the prefix's
    length, the positions over the whole sequence and, for an
    encoder-decoder, the encoder's output."""
    x = params.embed[_tokens(batch["tokens"], params)]
    n_prefix = 0
    if cfg.n_patches and "patches" in batch:
        patches = torch.as_tensor(batch["patches"], device=x.device).to(cfg.dtype)
        n_prefix = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    enc_out = None
    if cfg.is_encdec:
        if "frames" not in batch:
            raise KeyError(f"{cfg.name}: the encoder-decoder needs batch['frames'], the "
                           f"frontend's (B, {cfg.encoder_seq}, {cfg.d_model}) frame "
                           "embeddings; the batch has only " + ", ".join(sorted(batch)))
        enc_out = encode(params.encoder, batch["frames"], cfg)
    return x, n_prefix, _positions(x.shape[0], x.shape[1], x.device), enc_out


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Returns (logits over the token positions, aux loss: the MoE layers'
    Switch losses summed, 0 without MoE layers). ``batch`` holds
    ``tokens`` (B, S) and, as the config asks, ``patches`` (the VLM's
    prefix, dropped before the logits) and ``frames`` (the encoder's
    input)."""
    x, n_prefix, positions, enc_out = _inputs(params, cfg, batch)
    x, aux = _run_blocks(x, params.blocks, cfg, mode="train", positions=positions,
                         blocks_cache=None, step=None, enc_out=enc_out)
    if cfg.cast_grads:
        x = _GradCast.apply(x, cfg.dtype)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = torch.matmul(x, params.lm_head)
    return logits, aux


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch: Dict[str, Any], cache):
    """tokens (B, S) (and ``patches`` / ``frames`` as in ``forward_train``)
    -> (logits of the last position (B, V), cache), the cache filled in
    place and its ``step`` set to the whole length, prefix included."""
    x, _, positions, enc_out = _inputs(params, cfg, batch)
    x, _ = _run_blocks(x, params.blocks, cfg, mode="prefill", positions=positions,
                       blocks_cache=cache["blocks"], step=None, enc_out=enc_out)
    total = x.shape[1]
    x = rms_norm(x[:, -1:], params.final_norm, cfg.rms_eps)
    logits = torch.matmul(x, params.lm_head)[:, 0]
    cache["step"] = total
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
        spec = {"attn": {"k": ((batch, W, K, hd), cfg.dtype),
                         "v": ((batch, W, K, hd), cfg.dtype),
                         "pos": ((batch, W), torch.int32)}}
        if cfg.is_encdec:   # the cross-attention's keys and values
            spec["xk"] = ((batch, cfg.encoder_seq, K, hd), cfg.dtype)
            spec["xv"] = ((batch, cfg.encoder_seq, K, hd), cfg.dtype)
        return spec
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"mamba": {"ssm": ((batch, H, N, P), torch.float32),
                      "conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), cfg.dtype)}}


def cache_spec(cfg: ModelConfig, batch: int, kv_len: int):
    """The cache's tree with (shape, dtype) leaves: one entry per layer
    under ``blocks`` (``{"attn": ...}``, with ``xk`` and ``xv`` beside it
    in an encoder-decoder, or ``{"mamba": ...}``), then ``step``."""
    check_buildable(cfg)
    kinds = cfg.sublayer_kinds()
    blocks = [_sublayer_cache_spec(cfg, kinds[i % len(kinds)][0], batch, kv_len)
              for i in range(cfg.n_layers)]
    return {"blocks": blocks, "step": ((), torch.int32)}


def _map_spec(fn, spec):
    """``fn`` of each (shape, dtype) leaf of a sub-layer's cache spec, in
    its nesting of dicts."""
    if isinstance(spec, dict):
        return {key: _map_spec(fn, sub) for key, sub in spec.items()}
    return fn(spec)


def _spec_leaves(spec):
    if isinstance(spec, dict):
        for sub in spec.values():
            yield from _spec_leaves(sub)
    else:
        yield spec


def cache_nbytes(spec) -> int:
    """The bytes of a ``cache_spec``'s tensors."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for sub in spec["blocks"] for shape, dtype in _spec_leaves(sub))


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device="cuda"):
    """An empty cache on ``device``: k, v, xk, xv and the SSM and conv
    states zeros, pos -1, step 0."""
    dev = resolve_device(device)

    def mk(leaf):
        shape, dtype = leaf
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)

    spec = cache_spec(cfg, batch, kv_len)
    return {"blocks": [_map_spec(mk, sub) for sub in spec["blocks"]], "step": 0}


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
    over ``param_tree(params)``) turns them into updates, and each is
    added into its parameter in place, ``apply_updates``' arithmetic
    (``params`` built with ``trainable=True``). Returns ``(params, opt_state, metrics)``, the
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
        for p, u in zip(leaves, tree_leaves(updates)):
            p.add_(u)   # apply_updates' (p + u) in p's dtype, in place: the same bits
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
