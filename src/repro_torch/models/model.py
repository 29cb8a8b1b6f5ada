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
(``native.refuse_grad``); on the CPU the plain flash version is
differentiable.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx, rms_norm
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

def _copy_into(buf, value) -> None:
    """``buf.copy_(value)`` in place; on a mesh ``value`` is brought to
    ``buf``'s placements and each rank copies its own shard."""
    if isinstance(buf, DTensor):
        if not isinstance(value, DTensor):
            value = DTensor.from_local(value, buf.device_mesh,
                                       [Replicate()] * buf.device_mesh.ndim)
        buf.to_local().copy_(value.redistribute(buf.device_mesh, buf.placements).to_local())
    else:
        buf.copy_(value)


def _apply_sublayer(x, p, kind, cfg: ModelConfig, *, mode: str, positions, cache, step,
                    enc_out=None, causal: bool = True, ctx: ShardCtx = L.NO_SHARDING):
    """One (mixer + ffn) sub-layer with pre-norm residuals, and between
    them the cross-attention over ``enc_out`` where the layer has one.
    Returns (x, the MoE's aux loss or None)."""
    mixer, ffn = kind
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if mixer == "attn":
        w = cfg.sliding_window
        if mode == "train":
            h = L.attention_dense(h, p.mixer, cfg, positions, causal=causal, window=w, ctx=ctx)
        elif mode == "prefill":
            h, _ = L.attention_prefill(h, p.mixer, cfg, positions, cache["attn"], window=w,
                                       ctx=ctx)
        else:  # decode
            h, _ = L.attention_decode(h, p.mixer, cfg, step, cache["attn"], window=w, ctx=ctx)
    else:  # mamba
        h, _ = mamba_mixer(h, p.mixer, cfg, cache=None if cache is None else cache["mamba"],
                           decode=mode == "decode", ctx=ctx)
    # each branch's output is a row-parallel product's partial sum on a
    # mesh: summed here, where the reference's compiler sums it, before
    # the residual meets it (DTensor would otherwise carry the Partial on
    # and gather weights to keep it)
    x = x + ctx.c(h, "batch", "seq", "embed")
    if hasattr(p, "xattn"):   # the encoder-decoder's cross-attention
        h = rms_norm(x, p.norm_x, cfg.rms_eps)
        if mode == "decode":
            enc_kv = (cache["xk"], cache["xv"])
        else:
            enc_kv = L.encode_kv(enc_out, p.xattn, cfg, ctx=ctx)
            if cache is not None:
                _copy_into(cache["xk"], enc_kv[0])
                _copy_into(cache["xv"], enc_kv[1])
        x = x + ctx.c(L.cross_attention(h, p.xattn, cfg, enc_kv, ctx=ctx), "batch", "seq", "embed")
    aux = None
    if ffn != "none":
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        if ffn == "moe":
            h, aux = L.moe(h, p.ffn, cfg, ctx=ctx)
        else:
            h = L.mlp(h, p.ffn, cfg, ctx=ctx)
        x = x + ctx.c(h, "batch", "seq", "embed")
    x = ctx.c(x, "batch", "seq", "embed")
    return x, aux


def _run_blocks(x, blocks, cfg: ModelConfig, *, mode: str, positions, blocks_cache, step,
                enc_out=None, ctx: ShardCtx = L.NO_SHARDING):
    """Returns (x, the sum of the MoE layers' aux losses, fp32)."""
    kinds = cfg.sublayer_kinds()
    remat = mode == "train" and cfg.remat != "none" and torch.is_grad_enabled()
    context = _remat_context(cfg.remat) if remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(blocks):
        cache = blocks_cache[i] if blocks_cache is not None else None
        block = functools.partial(_apply_sublayer, p=p, kind=kinds[i % len(kinds)], cfg=cfg,
                                  mode=mode, positions=positions, cache=cache, step=step,
                                  enc_out=enc_out, ctx=ctx)
        x, a = checkpoint(block, x, use_reentrant=False, context_fn=context) if remat else block(x)
        if a is not None:
            aux = aux + a
    return x, aux


def _tokens(tokens, params) -> torch.Tensor:
    if isinstance(tokens, DTensor):
        return tokens.long()
    return torch.as_tensor(tokens, device=_local(params.embed).device).long()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _rows_local(table, tokens, vocab_lo: int):
    """The rows of this shard of the vocabulary for ``tokens``, 0 where
    another shard holds the token."""
    table, = L.contiguous_grads(table)
    idx = tokens - vocab_lo
    mine = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return rows * mine[..., None].to(rows.dtype)


def _embed(table, tokens, ctx: ShardCtx):
    """The rows of ``table`` for ``tokens``, constrained to ("batch", "seq",
    "embed"). On a mesh each rank looks up the tokens its shard of a
    vocab-sharded table holds and the shards sum (``Partial``), so the
    table is never gathered along the vocabulary; a table sharded along
    ``embed`` (FSDP) is gathered whole there first, and the tokens keep
    their batch sharding on the other mesh dims."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    t_pl, k_pl, o_pl, t_grad = [], [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        if isinstance(tp, Shard) and tp.dim == 0:
            t_pl.append(tp), k_pl.append(Replicate()), o_pl.append(Partial())
            t_grad.append(tp)
        else:
            keep = kp if isinstance(kp, Shard) and kp.dim == 0 else Replicate()
            t_pl.append(Replicate()), k_pl.append(keep), o_pl.append(keep)
            # each rank's batch rows give a part of the table's gradient
            t_grad.append(Partial() if isinstance(keep, Shard) else Replicate())
    _, offset = L.compute_local_shape_and_global_offset(table.shape, mesh, t_pl)
    rows = local_map(functools.partial(_rows_local, vocab_lo=offset[0]), out_placements=o_pl,
                     in_placements=(t_pl, k_pl), in_grad_placements=(t_grad, k_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)
    return ctx.c(rows, "batch", "seq", "embed")


def _batch_input(batch, key, like, dtype):
    """``batch[key]`` (the VLM's patches, the encoder's frames) on the
    model's device in ``dtype``, a ``DTensor`` as it came."""
    t = batch[key]
    if isinstance(t, DTensor):
        return t.to(dtype)
    return torch.as_tensor(t, device=_local(like).device).to(dtype)


# ----------------------------------------------------------------------
# encoder (audio / enc-dec)
# ----------------------------------------------------------------------

def encode(params, frames, cfg: ModelConfig, *, ctx: ShardCtx = L.NO_SHARDING) -> torch.Tensor:
    """The encoder (``params``: the model's ``encoder`` node) over the
    stub frontend's frame embeddings, frames (B, S_enc, d): the learned
    ``pos`` added, one non-causal (attn, mlp) sub-layer per encoder layer
    (RoPE over the frames' positions, as in the reference; the flash
    kernel with ``use_pallas``), then ``rms_norm``."""
    frames = _batch_input({"frames": frames}, "frames", params.pos, cfg.dtype)
    x = ctx.c(frames + params.pos[None, :frames.shape[1]], "batch", "seq", "embed")
    positions = _positions(x.shape[0], x.shape[1], _local(x).device)
    for p in params.blocks:
        x, _ = _apply_sublayer(x, p, ("attn", "mlp"), cfg, mode="train", positions=positions,
                               cache=None, step=None, causal=False, ctx=ctx)
    return rms_norm(x, params.norm, cfg.rms_eps)


def _inputs(params, cfg: ModelConfig, batch: Dict[str, Any], ctx: ShardCtx):
    """The decoder's input embeddings with the VLM's patch prefix in front
    when the config has patches and the batch brings them, the prefix's
    length, the positions over the whole sequence and, for an
    encoder-decoder, the encoder's output."""
    x = _embed(params.embed, _tokens(batch["tokens"], params), ctx)
    n_prefix = 0
    if cfg.n_patches and "patches" in batch:
        patches = _batch_input(batch, "patches", params.embed, cfg.dtype)
        n_prefix = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    x = ctx.c(x, "batch", "seq", "embed")
    enc_out = None
    if cfg.is_encdec:
        if "frames" not in batch:
            raise KeyError(f"{cfg.name}: the encoder-decoder needs batch['frames'], the "
                           f"frontend's (B, {cfg.encoder_seq}, {cfg.d_model}) frame "
                           "embeddings; the batch has only " + ", ".join(sorted(batch)))
        enc_out = encode(params.encoder, batch["frames"], cfg, ctx=ctx)
    return x, n_prefix, _positions(x.shape[0], x.shape[1], _local(x).device), enc_out


# ----------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                  ctx: ShardCtx = L.NO_SHARDING):
    """Returns (logits over the token positions, aux loss: the MoE layers'
    Switch losses summed, 0 without MoE layers). ``batch`` holds
    ``tokens`` (B, S) and, as the config asks, ``patches`` (the VLM's
    prefix, dropped before the logits) and ``frames`` (the encoder's
    input)."""
    with ctx.scope():
        x, n_prefix, positions, enc_out = _inputs(params, cfg, batch, ctx)
        x, aux = _run_blocks(x, params.blocks, cfg, mode="train", positions=positions,
                             blocks_cache=None, step=None, enc_out=enc_out, ctx=ctx)
        if cfg.cast_grads:
            x = _GradCast.apply(x, cfg.dtype)
        x = rms_norm(x, params.final_norm, cfg.rms_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        logits = ctx.c(torch.matmul(x, params.lm_head), "batch", "seq", "vocab")
    return logits, aux


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch: Dict[str, Any], cache, *,
                    ctx: ShardCtx = L.NO_SHARDING):
    """tokens (B, S) (and ``patches`` / ``frames`` as in ``forward_train``)
    -> (logits of the last position (B, V), cache), the cache filled in
    place and its ``step`` set to the whole length, prefix included."""
    with ctx.scope():
        x, _, positions, enc_out = _inputs(params, cfg, batch, ctx)
        x, _ = _run_blocks(x, params.blocks, cfg, mode="prefill", positions=positions,
                           blocks_cache=cache["blocks"], step=None, enc_out=enc_out, ctx=ctx)
        total = x.shape[1]
        x = rms_norm(x[:, -1:], params.final_norm, cfg.rms_eps)
        logits = torch.matmul(x, params.lm_head)[:, 0]
    cache["step"] = total
    return logits, cache


@torch.no_grad()
def forward_decode(params, cfg: ModelConfig, tokens, cache, *, ctx: ShardCtx = L.NO_SHARDING):
    """tokens: (B, 1). Returns (logits (B, V), cache), the cache updated
    in place and its ``step`` advanced by one."""
    step = int(cache["step"])
    with ctx.scope():
        x = _embed(params.embed, _tokens(tokens, params), ctx)
        x, _ = _run_blocks(x, params.blocks, cfg, mode="decode", positions=None,
                           blocks_cache=cache["blocks"], step=step, ctx=ctx)
        x = rms_norm(x, params.final_norm, cfg.rms_eps)
        logits = ctx.c(torch.matmul(x, params.lm_head)[:, 0], "batch", "vocab")
    cache["step"] = step + 1
    return logits, cache


# ----------------------------------------------------------------------
# KV / SSM cache
# ----------------------------------------------------------------------

def _sublayer_cache_spec(cfg: ModelConfig, mixer: str, batch: int, kv_len: int) -> dict:
    if mixer == "attn":
        W = min(cfg.sliding_window, kv_len) if cfg.sliding_window else kv_len
        K, hd = cfg.n_kv_heads, cfg.head_dim
        kv = ("batch", "kv_seq", "kv_heads", "head_dim")
        spec = {"attn": {"k": ((batch, W, K, hd), kv, cfg.dtype),
                         "v": ((batch, W, K, hd), kv, cfg.dtype),
                         "pos": ((batch, W), ("batch", "kv_seq"), torch.int32)}}
        if cfg.is_encdec:   # the cross-attention's keys and values
            xkv = ("batch", None, "kv_heads", "head_dim")
            spec["xk"] = ((batch, cfg.encoder_seq, K, hd), xkv, cfg.dtype)
            spec["xv"] = ((batch, cfg.encoder_seq, K, hd), xkv, cfg.dtype)
        return spec
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"mamba": {
        "ssm": ((batch, H, N, P), ("batch", "ssm_heads", None, None), torch.float32),
        "conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), ("batch", None, "ssm_inner"),
                 cfg.dtype)}}


def cache_spec(cfg: ModelConfig, batch: int, kv_len: int):
    """The cache's tree with (shape, logical axes, dtype) leaves: one entry
    per layer under ``blocks`` (``{"attn": ...}``, with ``xk`` and ``xv``
    beside it in an encoder-decoder, or ``{"mamba": ...}``), then
    ``step``. The logical axes are the reference's without its leading
    ``"layers"`` entry (``models.params``)."""
    check_buildable(cfg)
    kinds = cfg.sublayer_kinds()
    blocks = [_sublayer_cache_spec(cfg, kinds[i % len(kinds)][0], batch, kv_len)
              for i in range(cfg.n_layers)]
    return {"blocks": blocks, "step": ((), (), torch.int32)}


def _map_spec(fn, spec):
    """``fn`` of each (shape, logical, dtype) leaf of a cache spec, in its
    nesting of dicts and lists."""
    if isinstance(spec, dict):
        return {key: _map_spec(fn, sub) for key, sub in spec.items()}
    if isinstance(spec, list):
        return [_map_spec(fn, sub) for sub in spec]
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
               for sub in spec["blocks"] for shape, _, dtype in _spec_leaves(sub))


def cache_logical_axes(cfg: ModelConfig, batch: int, kv_len: int):
    """The cache's tree with each leaf's logical axes (``step``: ``()``)."""
    return _map_spec(lambda leaf: leaf[1], cache_spec(cfg, batch, kv_len))


def abstract_cache(cfg: ModelConfig, batch: int, kv_len: int):
    """The cache's tree with each leaf a ``meta`` tensor (``step`` a 0-d
    int32 one): its shapes and dtypes, no storage."""
    return _map_spec(lambda leaf: torch.empty(leaf[0], dtype=leaf[2], device="meta"),
                     cache_spec(cfg, batch, kv_len))


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, device="cuda"):
    """An empty cache on ``device``: k, v, xk, xv and the SSM and conv
    states zeros, pos -1, step 0."""
    dev = resolve_device(device)

    def mk(leaf):
        shape, _, dtype = leaf
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)

    spec = cache_spec(cfg, batch, kv_len)
    return {"blocks": [_map_spec(mk, sub) for sub in spec["blocks"]], "step": 0}


# ----------------------------------------------------------------------
# losses & steps
# ----------------------------------------------------------------------

def _onehot_local(lg, labels, vocab_lo: int):
    """1 where this shard of the vocabulary holds the position's label."""
    idx = (labels - vocab_lo)[..., None]
    cols = torch.arange(lg.shape[-1], device=lg.device)
    return (cols == idx).to(lg.dtype)


def _onehot(lg, labels):
    """The labels as one-hot rows laid out as ``lg`` (B, S, V) is: each
    rank builds the columns of its shard of the vocabulary."""
    mesh = lg.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    lab_pl = [p if isinstance(p, Shard) and p.dim < labels.ndim else Replicate()
              for p in lg.placements]
    vocab_lo = L._local_offset(lg, lg.ndim - 1)
    return local_map(functools.partial(_onehot_local, vocab_lo=vocab_lo),
                     out_placements=list(lg.placements),
                     in_placements=(list(lg.placements), lab_pl),
                     device_mesh=mesh, redistribute_inputs=True)(lg, labels)


class _ShardedNLL(torch.autograd.Function):
    """Each position's ``logsumexp(lg) - lg[label]`` over logits whose
    vocabulary is sharded, without gathering them: the max and the sum
    of exp(lg - max) over the vocabulary are reductions over the shards,
    the gold logit a sum of one-hot products, and the backward is
    ``(softmax(lg) - onehot) * g`` built shard by shard. (Left to
    itself, DTensor's backward of logsumexp gathers the logits whole.)"""

    @staticmethod
    def forward(ctx, lg, labels):
        m = lg.amax(dim=-1, keepdim=True)
        m = m.redistribute(m.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                           for p in m.placements])
        logz = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
        onehot = _onehot(lg, labels)
        gold = (lg * onehot).sum(dim=-1)
        ctx.save_for_backward(lg, logz, onehot)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        lg, logz, onehot = ctx.saved_tensors
        return (torch.exp(lg - logz[..., None]) - onehot) * g[..., None], None


def _nll_plain(lg, labels):
    logz = torch.logsumexp(lg, dim=-1)
    return logz - torch.gather(lg, -1, labels[..., None])[..., 0]


def _nll(lg, labels):
    """Each position's ``logsumexp(lg) - lg[label]``. On a mesh that
    shards the vocabulary, ``_ShardedNLL``; where each rank holds whole
    rows (a 1 x 1 mesh, a vocabulary that does not divide), the plain
    arithmetic on each rank's rows."""
    if not isinstance(lg, DTensor):
        return _nll_plain(lg, labels)
    if lg.to_local().shape[-1] != lg.shape[-1]:
        return _ShardedNLL.apply(lg, labels)
    mesh = lg.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    rows = [p if isinstance(p, Shard) and p.dim < labels.ndim else Replicate()
            for p in lg.placements]
    lg = lg.redistribute(mesh, rows)    # moves nothing: the vocabulary is whole
    return local_map(lambda a, b: _nll_plain(*L.contiguous_grads(a, b)), out_placements=rows,
                     in_placements=(rows, rows), device_mesh=mesh,
                     redistribute_inputs=True)(lg, labels)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token CE over non-ignored positions, in fp32."""
    lg = logits.float()
    if not isinstance(labels, DTensor):
        labels = torch.as_tensor(labels, device=_local(lg).device)
    nll = _nll(lg, labels.clamp(min=0).long())
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def optimizer_step(params, opt_state, optimizer, loss_fn, ctx: ShardCtx = L.NO_SHARDING):
    """One step on ``loss_fn(params) -> (loss, metrics)``: the loss's
    gradients with respect to every parameter come from
    ``torch.autograd``, ``optimizer`` (a ``repro_torch.optim.Optimizer``
    over ``param_tree(params)``) turns them into updates, and each is
    added into its parameter in place, ``apply_updates``' arithmetic
    (``params`` built with ``trainable=True``). Returns ``(params, opt_state, metrics)``, the
    metrics detached. On a mesh each gradient is brought to its
    parameter's placements before the update (a replicated parameter's
    gradient arrives as a sum over the shards), and the metrics come
    back whole."""
    tree = param_tree(params)
    leaves = tree_leaves(tree)
    if not all(p.requires_grad for p in leaves):
        raise ValueError("the parameters are frozen; build them with trainable=True")
    loss, metrics = loss_fn(params)
    with ctx.scope():   # the backward meets the forward's plain tensors too
        grads = torch.autograd.grad(loss, leaves)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) and g.placements != p.placements else g
             for p, g in zip(leaves, grads)]
    grads = tree_unflatten(tree_structure(tree), grads)
    with torch.no_grad(), ctx.scope():
        updates, opt_state = optimizer.update(grads, opt_state, tree)
        del grads
        for p, u in zip(leaves, tree_leaves(updates)):
            p.add_(u)   # apply_updates' (p + u) in p's dtype, in place: the same bits
    return params, opt_state, {k: _full(v.detach()) for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, optimizer, *, ctx: ShardCtx = L.NO_SHARDING):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "aux"})``, as the reference's: the loss is ``lm_loss``
    plus ``router_aux_coef * aux``, one ``optimizer_step`` on it.
    The metrics are 0-d fp32 tensors on the parameters' device. On a
    mesh (``ctx``) the parameters and the optimizer state are
    ``DTensor``s placed by ``sharding.rules.distribute``, the batch plain
    tensors or ``DTensor``s."""
    check_buildable(cfg)

    def loss_fn(params, batch):
        with ctx.scope():
            logits, aux = forward_train(params, cfg, batch, ctx=ctx)
            ce = lm_loss(logits, batch["labels"])
            del logits
            loss = ce + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def train_step(params, opt_state, batch):
        return optimizer_step(params, opt_state, optimizer,
                              functools.partial(loss_fn, batch=batch), ctx)

    return train_step


def make_eval_step(cfg: ModelConfig, *, ctx: ShardCtx = L.NO_SHARDING):
    @torch.no_grad()
    def eval_step(params, batch):
        with ctx.scope():
            logits, _ = forward_train(params, cfg, batch, ctx=ctx)
            return _full(lm_loss(logits, batch["labels"]))

    return eval_step


def make_prefill_step(cfg: ModelConfig, *, ctx: ShardCtx = L.NO_SHARDING):
    def prefill(params, batch, cache):
        return forward_prefill(params, cfg, batch, cache, ctx=ctx)

    return prefill


def make_decode_step(cfg: ModelConfig, *, ctx: ShardCtx = L.NO_SHARDING):
    def decode(params, tokens, cache):
        return forward_decode(params, cfg, tokens, cache, ctx=ctx)

    return decode
