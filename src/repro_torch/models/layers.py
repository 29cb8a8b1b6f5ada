"""Core layers of the LM: RMSNorm, RoPE, GQA attention (full-sequence,
prefill into the KV cache, one-token decode against it, full or
sliding-window), the SwiGLU MLP and the top-k MoE with capacity dispatch.

Ports of ``repro/models/layers.py``, function for function and with the
reference's layouts: q/k/v ``(B, S, heads, hd)``, ``wq`` ``(d, H, hd)``,
``wo`` ``(H, hd, d)``. ``p`` is a ``ParamNode`` of
``repro_torch.models.params`` whose attributes carry the reference's
parameter names.

``ShardCtx`` carries the LM mesh (``launch.mesh.LmMesh``) and the
sharding rules into the model, as the reference's does. On a mesh the
parameters, batches and caches are ``DTensor``s (``sharding.rules.
distribute``), torch's ops propagate their placements, and ``ctx.c(x,
*logical)`` is the reference's ``with_sharding_constraint``: a
``DTensor.redistribute`` to the placements that ``logical_to_spec``
gives, at the reference's sites. Without a mesh, or on a plain tensor,
``c`` returns its input, and the unsharded path runs exactly as before.
Where torch's sharding propagation would need what the reference's
compiler decides by itself, a region runs on each rank's local shard
(``local_map``): attention on the local heads (``_attend``: q heads
sharded over ``model`` take the kv heads ``h // rep`` of their own q
heads when the kv heads stay replicated, as they do at 8 kv heads on a
16-way axis), the embedding gather from a vocab-sharded table, and the
cache writes into a cache whose ``kv_seq`` is sharded.

The audio family's decoder adds ``cross_attention`` over the encoder's
keys and values (``encode_kv``), dense ``_sdpa`` as in the reference.

Self-attention takes one of three routes, as in the reference
(``_self_attention_out``): with ``cfg.use_pallas`` the ``flash_attention``
kernel (``repro_torch.kernels.ops``: the hand-written CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor); otherwise, above
``BLOCKED_ATTN_THRESHOLD`` tokens, ``blocked_attention`` (a plain PyTorch
online-softmax loop); otherwise dense ``_sdpa``.

The MoE (``moe``, ``moe_local``) routes in fp32 (TF32 is off on the
card, ``utils.device``) and selects with ``top_k``, a stable descending
sort: among equal values the lower index wins, as ``jax.lax.top_k``
does, so tied tokens (the scheduler's all-zero padding rows) route as
in the reference. Its expert products are batched ``torch.bmm``, as
the reference computes them in plain ``jnp`` outside any Pallas kernel.

The cache functions update the cache's tensors in place (the reference
returns a new cache; JAX arrays are immutable) and return the same dict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication, local_map

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingRules, logical_to_spec, placements

NEG_INF = -1e9
# above this sequence length dense attention switches to the blocked path
BLOCKED_ATTN_THRESHOLD = 2048


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carries mesh + rules into the model; no mesh -> constraints no-op."""

    mesh: Optional[object] = None   # a launch.mesh.LmMesh
    rules: ShardingRules = ShardingRules()

    def c(self, x, *logical):
        """``x`` redistributed to the placements of its logical axes; ``x``
        itself without a mesh or when it is not a ``DTensor``."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        want = placements(logical_to_spec(x.shape, logical, self.mesh, self.rules), self.mesh)
        if tuple(x.placements) == want:
            return x
        if any(isinstance(p, Partial) for p in x.placements):
            return _SumPartial.apply(x, want)
        return x.redistribute(self.mesh.device_mesh, want)

    def scope(self):
        """The forward's context: on a mesh, plain tensors made inside the
        model (positions, masks, zeros) count as replicated beside the
        ``DTensor``s."""
        if self.mesh is None or _implicit_replication_on():
            return contextlib.nullcontext()
        return implicit_replication()


def _implicit_replication_on() -> bool:
    # implicit_replication() turns the flag off on exit whatever it was
    # before, so a nested scope (the train step around forward_train)
    # enters it once
    return bool(getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False))


NO_SHARDING = ShardCtx()


class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; a contiguous gradient on the way back. A
    ``local_map`` region hands its inputs' local gradients to ``DTensor``
    as they come (an einsum's may be a permuted view), and a later view
    in the backward, planned from the ``DTensor``'s own strides, fails on
    such a local tensor."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _SumPartial(torch.autograd.Function):
    """``x.redistribute(want)`` of an ``x`` that is a ``Partial`` sum on
    some mesh dim, whose gradient comes back replicated on that dim, as
    the gradient of a sum is. (DTensor's own backward hands back a
    ``Partial`` gradient, and the weight gradient of the row-parallel
    product that made ``x`` then gathers its other operand.)"""

    @staticmethod
    def forward(ctx, x, want):
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.back), None


class _GradTo(torch.autograd.Function):
    """Identity forward; the gradient brought to ``placements`` on the way
    back. A k or v read in part by each rank gets its gradient as a
    ``Partial``: summed here, at once, as the reference's compiler sums
    it, where DTensor's backward of the projection would otherwise
    gather the partial gradient along the batch."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def contiguous_grads(*ts):
    """Each tensor of ``ts`` through ``_ContiguousGrad`` where it needs a
    gradient (a local_map region's inputs)."""
    return tuple(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad
                 else t for t in ts)


def _local_offset(t: DTensor, dim: int) -> int:
    """The global index of ``t``'s first local element along ``dim``."""
    _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return offset[dim]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    nrm = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (nrm * scale.float()).to(x.dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Split-halves rotation
    (the first half pairs with the second), not interleaved."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention primitives
# ----------------------------------------------------------------------

def _project_local(x, w):
    x, w = contiguous_grads(x, w)
    return torch.matmul(x, w.flatten(1)).unflatten(-1, w.shape[1:])


def _project(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd). On a mesh, as a
    column-parallel product on each rank's shards: heads sharded over a
    mesh dim stay local (x whole there; its gradient the sum over the
    ranks' heads), batch rows stay local (w whole there, gathered from
    its FSDP shards; its gradient the sum over the rows). DTensor's own
    propagation may shard the flattened H * hd over a mesh dim that H
    does not divide (8 kv heads on 16), which no view can then split."""
    if not isinstance(w, DTensor):
        return _project_local(x, w)
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)
    x_pl, w_pl, o_pl, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if _is_shard(wp, 1):
            row = (Replicate(), wp, Shard(2), Partial(), wp)
        elif _is_shard(xp, 0):
            row = (xp, Replicate(), xp, xp, Partial())
        else:
            row = (Replicate(),) * 5
        for out, pl in zip((x_pl, w_pl, o_pl, x_grad, w_grad), row):
            out.append(pl)
    return local_map(_project_local, out_placements=o_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def _proj_qkv(x: torch.Tensor, p, cfg: ModelConfig, ctx: ShardCtx = NO_SHARDING):
    q, k, v = _project(x, p.wq), _project(x, p.wk), _project(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = ctx.c(q, "batch", "seq", "heads", "head_dim")
    k = ctx.c(k, "batch", "seq", "kv_heads", "head_dim")
    v = ctx.c(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _out_proj(out: torch.Tensor, p) -> torch.Tensor:
    """(B, S, H, hd) @ wo (H, hd, d) -> (B, S, d)."""
    return torch.matmul(out.flatten(2), p.wo.flatten(0, 1))


def _sdpa(q, k, v, mask: Optional[torch.Tensor]):
    """Dense scaled-dot-product attention with GQA.

    q: (B, Sq, H, hd)  k, v: (B, Skv, K, hd)  mask: bool (B|1, Sq, Skv) or
    None. The scores are taken in the inputs' dtype and cast to fp32, the
    probabilities cast back to ``v.dtype`` before PV, as the reference does.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg, k).float()
    logits = logits / math.sqrt(hd)
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF)  # (B|1, Sq, Skv)
        logits = logits + bias[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v)
    return out.reshape(B, Sq, H, hd)


def _kv_heads_of(lo: int, n: int, rep: int) -> torch.Tensor:
    """The kv head each of q heads ``lo .. lo + n - 1`` reads (head h reads
    ``h // rep``), as few as keep the grouping even: one per whole group
    when the q heads cover whole groups, the one group's when they lie in
    one, else one for each q head."""
    if n % rep == 0:
        return torch.arange(lo // rep, (lo + n) // rep)
    if rep % n == 0:
        return torch.tensor([lo // rep])
    return torch.arange(lo, lo + n) // rep


def _is_shard(p, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _attend(fn, q, k, v, mask=None, q_offset_kw: Optional[str] = None):
    """``fn(q, k, v[, mask])``, attention over (B, S, heads, hd), on each
    rank's local batch rows and heads.

    Off a mesh ``fn`` runs on the tensors as they are. On a mesh, for
    each mesh dim: a batch-sharded q takes k, v and the mask's rows
    sharded alike; a head-sharded q takes k and v sharded on their heads
    when they are, else whole and cut to the kv heads of the rank's own q
    heads (``_kv_heads_of``: 8 kv heads stay replicated on a 16-way
    model axis); a sequence-sharded q (the context-parallel
    ``attn_q_seq``) takes k and v whole, and ``fn`` gets the rank's first
    query position as the keyword ``q_offset_kw``. The gradient of a k
    or v that each rank reads only in part is the sum over that mesh dim
    (``Partial``). ``fn`` sees contiguous local tensors."""
    if not isinstance(q, DTensor):
        return fn(q, k, v) if mask is None else fn(q, k, v, mask)
    mesh = q.device_mesh
    whole = [Replicate()] * mesh.ndim
    k, v = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, whole) for t in (k, v))
    q_pl, kv_pl, kv_grad = [], [], []
    for qp, kp in zip(q.placements, k.placements):
        if _is_shard(qp, 0):
            q_pl.append(qp), kv_pl.append(qp), kv_grad.append(qp)
        elif _is_shard(qp, 2) and _is_shard(kp, 2):
            q_pl.append(qp), kv_pl.append(kp), kv_grad.append(kp)
        elif _is_shard(qp, 2) or (_is_shard(qp, 1) and q_offset_kw is not None):
            q_pl.append(qp), kv_pl.append(Replicate()), kv_grad.append(Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate()), kv_grad.append(Replicate())
    if any(isinstance(p, Partial) for p in kv_grad):
        k, v = (_GradTo.apply(t, tuple(t.placements)) if t.requires_grad else t for t in (k, v))
    _, q_off = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    cut = None
    if any(_is_shard(a, 2) and not _is_shard(b, 2) for a, b in zip(q_pl, kv_pl)):
        n_local = q.shape[2] // math.prod(mesh.size(i) for i, a in enumerate(q_pl)
                                          if _is_shard(a, 2))
        cut = _kv_heads_of(q_off[2], n_local, q.shape[2] // k.shape[2])
    kw = {q_offset_kw: q_off[1]} if q_offset_kw is not None else {}

    def local(ql, kl, vl, *ml):
        ql, kl, vl = contiguous_grads(ql, kl, vl)
        if cut is not None:
            kl, vl = kl[:, :, cut.to(kl.device)], vl[:, :, cut.to(vl.device)]
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous(), *ml, **kw)

    ins, grads, args = [q_pl, kv_pl, kv_pl], [q_pl, kv_grad, kv_grad], [q, k, v]
    if mask is not None:
        m_pl = [p if _is_shard(p, 0) and mask.shape[0] > 1 else Replicate() for p in q_pl]
        if not isinstance(mask, DTensor):
            mask = DTensor.from_local(mask, mesh, whole).redistribute(mesh, m_pl)
        ins.append(m_pl), grads.append(m_pl), args.append(mask)
    return local_map(local, out_placements=q_pl, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 1024, block_skip: bool = False, q_offset: int = 0):
    """Flash-style online-softmax attention in plain PyTorch; never
    materializes Sq x Skv. Shapes as ``_sdpa``.

    A loop over query chunks and, inside, KV chunks, with the reference's
    arithmetic: scores in fp32, masked with -1e9 (padded keys by length),
    the probabilities cast to ``v.dtype`` before PV and the accumulator in
    fp32. ``block_skip`` skips KV chunks that are fully masked for the
    whole query chunk (beyond the causal frontier, outside the window).
    ``q_offset`` is the global position of query 0 (a rank's share of a
    sequence-sharded q); keys start at position 0.
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = H // K
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq = -(-Sq // q_chunk)
    nk = -(-Skv // kv_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - Skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - Skv))
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    out = torch.empty((B, nq * q_chunk, H, hd), dtype=q.dtype, device=dev)
    for qi in range(nq):
        q_lo = qi * q_chunk
        qblk = qp[:, q_lo:q_lo + q_chunk].reshape(B, q_chunk, K, rep, hd)
        q_pos = q_offset + q_lo + torch.arange(q_chunk, device=dev)
        m = torch.full((B, K, rep, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, rep, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, rep, q_chunk, hd), dtype=torch.float32, device=dev)
        for kj in range(nk):
            k_lo = kj * kv_chunk
            if block_skip:
                k_hi = k_lo + kv_chunk - 1
                g_lo, g_hi = q_offset + q_lo, q_offset + q_lo + q_chunk - 1
                if (causal and k_lo > g_hi) or (window > 0 and k_hi <= g_lo - window):
                    continue
            kblk = kp[:, k_lo:k_lo + kv_chunk]
            vblk = vp[:, k_lo:k_lo + kv_chunk]
            k_pos = k_lo + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkrh,bckh->bkrqc", qblk, kblk).float() * scale
            mask = (k_pos < Skv)[None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bkrqc,bckh->bkrqh", p.to(vblk.dtype), vblk).float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-20)[..., None]  # (B, K, rep, qc, hd)
        out[:, q_lo:q_lo + q_chunk] = o.permute(0, 3, 1, 2, 4).reshape(
            B, q_chunk, H, hd).to(q.dtype)
    return out[:, :Sq]


def _self_attention_out(q, k, v, cfg: ModelConfig, causal: bool, window: int,
                        ctx: ShardCtx = NO_SHARDING):
    """The three routes, each on the local heads of a mesh (``_attend``)."""
    S = q.shape[1]
    if cfg.use_pallas:
        return _attend(lambda q, k, v: kops.flash_attention(q, k, v, causal=causal,
                                                            window=window), q, k, v)
    if S > BLOCKED_ATTN_THRESHOLD:
        # context-parallel attention: when q-heads don't divide the model
        # axis they are replicated; shard the query sequence instead
        if cfg.shard_attn_seq:
            q = ctx.c(q, "batch", "attn_q_seq", None, "head_dim")
        return _attend(lambda q, k, v, q_offset=0: blocked_attention(
            q, k, v, causal=causal, window=window, block_skip=cfg.attn_block_skip,
            q_offset=q_offset), q, k, v, q_offset_kw="q_offset")

    def dense(q, k, v):
        mask = causal_mask(S, S, window, device=q.device) if (causal or window) else None
        return _sdpa(q, k, v, mask)

    return _attend(dense, q, k, v)


def causal_mask(Sq: int, Skv: int, window: int = 0, device=None):
    """(1, Sq, Skv) bool: key j visible to query i."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask[None]


def attention_dense(x, p, cfg: ModelConfig, positions, causal: bool = True, window: int = 0, *,
                    ctx: ShardCtx = NO_SHARDING):
    """Self-attention over a full sequence (the training forward)."""
    q, k, v = _proj_qkv(x, p, cfg, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _self_attention_out(q, k, v, cfg, causal, window, ctx)
    out = ctx.c(out, "batch", "seq", "heads", "head_dim")
    return _out_proj(out, p)


def _write_slots(buf, slots: torch.Tensor, values) -> None:
    """``buf[:, slots] = values`` in place: ``buf`` (B, W, ...) a cache
    tensor, ``slots`` (n,) the slots every row writes, ``values`` (B, n,
    ...). On a mesh each rank writes its own shard: ``values`` are
    brought to ``buf``'s placements save along the slots, and a rank whose
    shard of a ``kv_seq``-sharded ``buf`` holds slots ``lo .. lo + w - 1``
    writes those of ``slots`` that fall there."""
    if not isinstance(buf, DTensor):
        buf[:, slots] = values.to(buf.dtype)
        return
    mesh = buf.device_mesh
    want = [Replicate() if _is_shard(p, 1) else p for p in buf.placements]
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim)
    lv = values.redistribute(mesh, want).to_local().to(buf.dtype)
    lb = buf.to_local()
    lo, w = _local_offset(buf, 1), lb.shape[1]
    # the selection on the host: the slots are few, and a meta cache (the
    # dry-run's) cannot take a data-dependent mask
    slots = slots.cpu()
    sel = torch.nonzero((slots >= lo) & (slots < lo + w)).flatten()
    lb[:, (slots[sel] - lo).to(lb.device)] = lv[:, sel.to(lv.device)]


def _whole_seq(t):
    """A cache tensor with its ``kv_seq`` dim gathered (decode attends
    over every slot); anything else as it is."""
    if not isinstance(t, DTensor) or not any(_is_shard(p, 1) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if _is_shard(p, 1) else p
                                          for p in t.placements])


def attention_prefill(x, p, cfg: ModelConfig, positions, cache: dict, window: int = 0, *,
                      ctx: ShardCtx = NO_SHARDING):
    """Full-sequence causal self-attention that also fills the KV cache.

    Cache layout: k, v (B, W, K, hd); pos (B, W) = global position stored
    in each slot (-1 empty). W = sliding window size for SWA, else the
    max decode length. The last min(W, S) positions go to slots
    ``positions % W``; the cache's tensors are written in place.
    """
    q, k, v = _proj_qkv(x, p, cfg, ctx)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _self_attention_out(q, k, v, cfg, causal=True, window=window, ctx=ctx)
    out = ctx.c(out, "batch", "seq", "heads", "head_dim")
    B, S = x.shape[0], x.shape[1]
    W = cache["k"].shape[1]
    keep = min(W, S)
    if isinstance(cache["k"], DTensor):
        # every row holds positions 0 .. S - 1 (forward_prefill's)
        slots = torch.arange(S - keep, S) % W
        _write_slots(cache["k"], slots, k[:, S - keep:])
        _write_slots(cache["v"], slots, v[:, S - keep:])
        _write_slots(cache["pos"], slots, positions[:, S - keep:].to(torch.int32))
        return _out_proj(out, p), cache
    slots = (positions[:, S - keep:] % W).long()  # (B, keep)
    bidx = torch.arange(B, device=x.device)[:, None]
    cache["k"][bidx, slots] = k[:, S - keep:].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, S - keep:].to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions[:, S - keep:].to(cache["pos"].dtype)
    return _out_proj(out, p), cache


def attention_decode(x, p, cfg: ModelConfig, step: int, cache: dict, window: int = 0, *,
                     ctx: ShardCtx = NO_SHARDING):
    """One-token decode against the cache. x: (B, 1, d); step: the global
    position of the token. Writes slot ``step % W`` in place, then
    attends over the slots whose stored position is valid: filled, not
    in the future and, with a window, inside it."""
    B = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg, ctx)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    W = cache["k"].shape[1]
    slot = step % W
    if isinstance(cache["k"], DTensor):
        slots = torch.tensor([slot])
        _write_slots(cache["k"], slots, k)
        _write_slots(cache["v"], slots, v)
        _write_slots(cache["pos"], slots, pos)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = step
    cpos = _whole_seq(cache["pos"])
    valid = (cpos >= 0) & (cpos <= step)
    if window > 0:
        valid &= cpos > step - window
    out = _attend(_sdpa, q, _whole_seq(cache["k"]), _whole_seq(cache["v"]),
                  valid[:, None, :])  # (B, 1, W) mask
    return _out_proj(out, p), cache


def cross_attention(x, p, cfg: ModelConfig, enc_kv, *, ctx: ShardCtx = NO_SHARDING):
    """Decoder cross-attention over the encoder's keys and values
    (``encode_kv``): no RoPE and no mask, dense ``_sdpa`` as in the
    reference, which reaches no kernel here either."""
    q = _project(x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq
    k, v = enc_kv
    return _out_proj(_attend(lambda q, k, v: _sdpa(q, k, v, None), q, k, v), p)


def encode_kv(enc_out, p, cfg: ModelConfig, *, ctx: ShardCtx = NO_SHARDING):
    """The encoder output's keys and values for one cross-attention layer,
    (B, S_enc, K, hd) each; the cache keeps them for decode."""
    k, v = _project(enc_out, p.wk), _project(enc_out, p.wv)
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    return k, v


# ----------------------------------------------------------------------
# FFN: SwiGLU MLP and top-k MoE
# ----------------------------------------------------------------------

def mlp(x, p, cfg: ModelConfig, *, ctx: ShardCtx = NO_SHARDING):
    h = F.silu(torch.matmul(x, p.wg)) * torch.matmul(x, p.wu)
    h = ctx.c(h, "batch", "seq", "mlp")
    return torch.matmul(h, p.wd)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, ties to the lower index (``torch.topk`` gives no tie
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Tokens an expert takes: all of them (dropless) up to 256 tokens,
    else ``capacity_factor * top_k * tokens / n_experts``."""
    if tokens <= 256:
        return tokens
    return min(max(int(cfg.capacity_factor * cfg.top_k * tokens / cfg.n_experts), 1), tokens)


def _route(xt: torch.Tensor, p, cfg: ModelConfig):
    """(..., d) tokens -> (softmax router probabilities, the dense combine
    weights: the renormalised top-k probabilities, 0 elsewhere), fp32."""
    probs = torch.softmax(torch.matmul(xt.float(), p.router), dim=-1)
    topv, topi = top_k(probs, cfg.top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, torch.zeros_like(probs).scatter(-1, topi, topv)


def _switch_aux(probs, w_te, n_experts: int, dims):
    """Switch load-balance loss: E * sum(tokens' share * mean probability)."""
    frac_tokens = (w_te > 0).float().mean(dim=dims)
    return n_experts * torch.sum(frac_tokens * probs.mean(dim=dims))


def _experts(xe: torch.Tensor, p, ctx: ShardCtx = NO_SHARDING, h_axes=()) -> torch.Tensor:
    """SwiGLU of every expert on its own rows: (E, C, d) -> (E, C, d);
    ``h_axes`` the logical axes of the hidden (E, C, f)."""
    h = F.silu(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wu)
    if h_axes:
        h = ctx.c(h, *h_axes)
    return torch.bmm(h, p.wd)


def _on_whole(fn, *args, n_out: int = 1):
    """``fn(*args)``; on a mesh, on every rank over the whole of each
    ``DTensor`` argument (gathered, ``local_map``), its ``n_out`` tensor
    results replicated. The MoE's routing (a stable sort, gathers and a
    scatter-add over every token) runs so: it is the same on every rank,
    and its gradient is the replicated one."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    whole = [Replicate()] * mesh.ndim
    ins = tuple(whole if isinstance(a, torch.Tensor) else None for a in args)
    args = tuple(DTensor.from_local(a, mesh, whole)
                 if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
                 for a in args)
    outs = whole if n_out == 1 else tuple([whole] * n_out)
    return local_map(lambda *a: fn(*contiguous_grads(*a)), out_placements=outs, in_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _dispatch_local(x, w_te, C: int):
    """``moe_local``'s per-row selection: (B, E, C) weights and token
    indices, and the selected rows (B, E, C, d)."""
    B, S, d = x.shape
    E = w_te.shape[-1]
    sel_w, sel_idx = top_k(w_te.transpose(1, 2), C)                     # (B, E, C) over S
    xe = torch.gather(x, 1, sel_idx.reshape(B, E * C, 1).expand(B, E * C, d))
    return sel_w, sel_idx, xe.reshape(B, E, C, d)


def _combine_local(ye, sel_w, sel_idx, S: int):
    """Scatter-add (B, E, C, d) expert outputs, scaled by their weights,
    back to their (B * S, d) rows."""
    B, _, _, d = ye.shape
    ye = ye * sel_w[..., None].to(ye.dtype)
    rows = (sel_idx + S * torch.arange(B, device=sel_idx.device)[:, None, None]).reshape(-1)
    out = torch.zeros((B * S, d), dtype=ye.dtype, device=ye.device)
    return out.index_add(0, rows, ye.reshape(-1, d))


def moe_local(x, p, cfg: ModelConfig, *, ctx: ShardCtx = NO_SHARDING):
    """Per-row dispatch (``cfg.moe_local_dispatch``): each batch row routes
    its own S tokens, with a per-row capacity. Returns (out, aux)."""
    B, S, d = x.shape
    E = cfg.n_experts
    probs, w_te = _route(x, p, cfg)                                     # (B, S, E)
    aux = _switch_aux(probs, w_te, E, (0, 1))
    C = moe_capacity(cfg, S)
    sel_w, sel_idx, xe = _on_whole(_dispatch_local, x, w_te, C, n_out=3)
    xe = ctx.c(xe, "batch", "experts", None, None)
    xe = xe.transpose(0, 1).reshape(E, B * C, d)
    ye = _experts(xe, p, ctx, ("experts", "batch", "expert_mlp"))
    ye = ye.reshape(E, B, C, d).transpose(0, 1)                         # (B, E, C, d)
    out = _on_whole(_combine_local, ye, sel_w, sel_idx, S)
    return out.reshape(B, S, d), aux


def _dispatch(xt, w_te, C: int):
    """``moe``'s selection: each expert's (E, C) weights and token
    indices, and the selected rows (E, C, d)."""
    sel_w, sel_idx = top_k(w_te.t(), C)
    return sel_w, sel_idx, xt[sel_idx]


def _combine(ye, sel_w, sel_idx, T: int):
    E, C, d = ye.shape
    ye = ye * sel_w[..., None].to(ye.dtype)
    out = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    return out.index_add(0, sel_idx.reshape(-1), ye.reshape(E * C, d))


def moe(x, p, cfg: ModelConfig, *, ctx: ShardCtx = NO_SHARDING):
    """Token-choice top-k MoE with per-expert capacity dispatch over all
    B * S tokens: softmax router in fp32, each token's top-k experts with
    their probabilities renormalised, each expert's top-C tokens by that
    weight (C = ``moe_capacity``), gathered, a SwiGLU per expert, scaled
    and scatter-added back. Returns (out, Switch aux loss).
    ``cfg.moe_local_dispatch`` routes per row instead (``moe_local``).
    On a mesh the selection and the scatter-add see every token
    (``_on_whole``); the expert products are constrained as the
    reference's."""
    if cfg.moe_local_dispatch:
        return moe_local(x, p, cfg, ctx=ctx)
    B, S, d = x.shape
    E = cfg.n_experts
    xt = x.reshape(B * S, d)
    probs, w_te = _route(xt, p, cfg)                                    # (T, E)
    aux = _switch_aux(probs, w_te, E, 0)
    C = moe_capacity(cfg, B * S)
    sel_w, sel_idx, xe = _on_whole(_dispatch, xt, w_te, C, n_out=3)     # (E, C), (E, C, d)
    xe = ctx.c(xe, "experts", "batch", None)
    ye = _experts(xe, p, ctx, ("experts", "batch", "expert_mlp"))       # (E, C, d)
    out = _on_whole(_combine, ye, sel_w, sel_idx, B * S)
    return out.reshape(B, S, d), aux
