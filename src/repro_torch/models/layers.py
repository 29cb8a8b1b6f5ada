"""Core layers of the LM: RMSNorm, RoPE, GQA attention (full-sequence,
prefill into the KV cache, one-token decode against it, full or
sliding-window), the SwiGLU MLP and the top-k MoE with capacity dispatch.

Ports of ``repro/models/layers.py``, function for function and with the
reference's layouts: q/k/v ``(B, S, heads, hd)``, ``wq`` ``(d, H, hd)``,
``wo`` ``(H, hd, d)``. ``p`` is a ``ParamNode`` of
``repro_torch.models.params`` whose attributes carry the reference's
parameter names. The reference's ``ShardCtx`` constraints have no
counterpart here yet: the LM mesh is ROADMAP queue 1 item 15.2 (the sim
mesh of ``launch.mesh`` shards the SVM round only).

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

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

NEG_INF = -1e9
# above this sequence length dense attention switches to the blocked path
BLOCKED_ATTN_THRESHOLD = 2048


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

def _proj_qkv(x: torch.Tensor, p, cfg: ModelConfig):
    q = torch.matmul(x, p.wq.flatten(1)).unflatten(-1, p.wq.shape[1:])
    k = torch.matmul(x, p.wk.flatten(1)).unflatten(-1, p.wk.shape[1:])
    v = torch.matmul(x, p.wv.flatten(1)).unflatten(-1, p.wv.shape[1:])
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
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


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 1024, block_skip: bool = False):
    """Flash-style online-softmax attention in plain PyTorch; never
    materializes Sq x Skv. Shapes as ``_sdpa``.

    A loop over query chunks and, inside, KV chunks, with the reference's
    arithmetic: scores in fp32, masked with -1e9 (padded keys by length),
    the probabilities cast to ``v.dtype`` before PV and the accumulator in
    fp32. ``block_skip`` skips KV chunks that are fully masked for the
    whole query chunk (beyond the causal frontier, outside the window).
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
        q_pos = q_lo + torch.arange(q_chunk, device=dev)
        m = torch.full((B, K, rep, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, rep, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, rep, q_chunk, hd), dtype=torch.float32, device=dev)
        for kj in range(nk):
            k_lo = kj * kv_chunk
            if block_skip:
                k_hi, q_hi = k_lo + kv_chunk - 1, q_lo + q_chunk - 1
                if (causal and k_lo > q_hi) or (window > 0 and k_hi <= q_lo - window):
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


def _self_attention_out(q, k, v, cfg: ModelConfig, causal: bool, window: int):
    S = q.shape[1]
    if cfg.use_pallas:
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if S > BLOCKED_ATTN_THRESHOLD:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 block_skip=cfg.attn_block_skip)
    mask = causal_mask(S, S, window, device=q.device) if (causal or window) else None
    return _sdpa(q, k, v, mask)


def causal_mask(Sq: int, Skv: int, window: int = 0, device=None):
    """(1, Sq, Skv) bool: key j visible to query i."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask[None]


def attention_dense(x, p, cfg: ModelConfig, positions, causal: bool = True, window: int = 0):
    """Self-attention over a full sequence (the training forward)."""
    q, k, v = _proj_qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _self_attention_out(q, k, v, cfg, causal, window)
    return _out_proj(out, p)


def attention_prefill(x, p, cfg: ModelConfig, positions, cache: dict, window: int = 0):
    """Full-sequence causal self-attention that also fills the KV cache.

    Cache layout: k, v (B, W, K, hd); pos (B, W) = global position stored
    in each slot (-1 empty). W = sliding window size for SWA, else the
    max decode length. The last min(W, S) positions go to slots
    ``positions % W``; the cache's tensors are written in place.
    """
    q, k, v = _proj_qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _self_attention_out(q, k, v, cfg, causal=True, window=window)
    B, S = x.shape[0], x.shape[1]
    W = cache["k"].shape[1]
    keep = min(W, S)
    slots = (positions[:, S - keep:] % W).long()  # (B, keep)
    bidx = torch.arange(B, device=x.device)[:, None]
    cache["k"][bidx, slots] = k[:, S - keep:].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, S - keep:].to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions[:, S - keep:].to(cache["pos"].dtype)
    return _out_proj(out, p), cache


def attention_decode(x, p, cfg: ModelConfig, step: int, cache: dict, window: int = 0):
    """One-token decode against the cache. x: (B, 1, d); step: the global
    position of the token. Writes slot ``step % W`` in place, then
    attends over the slots whose stored position is valid: filled, not
    in the future and, with a window, inside it."""
    B = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg)
    pos = torch.full((B, 1), step, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    W = cache["k"].shape[1]
    slot = step % W
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = step
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= step)
    if window > 0:
        valid &= cpos > step - window
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, :])  # (B, 1, W) mask
    return _out_proj(out, p), cache


def cross_attention(x, p, cfg: ModelConfig, enc_kv):
    """Decoder cross-attention over the encoder's keys and values
    (``encode_kv``): no RoPE and no mask, dense ``_sdpa`` as in the
    reference, which reaches no kernel here either."""
    q = torch.matmul(x, p.wq.flatten(1)).unflatten(-1, p.wq.shape[1:])
    if cfg.qkv_bias:
        q = q + p.bq
    k, v = enc_kv
    return _out_proj(_sdpa(q, k, v, None), p)


def encode_kv(enc_out, p, cfg: ModelConfig):
    """The encoder output's keys and values for one cross-attention layer,
    (B, S_enc, K, hd) each; the cache keeps them for decode."""
    k = torch.matmul(enc_out, p.wk.flatten(1)).unflatten(-1, p.wk.shape[1:])
    v = torch.matmul(enc_out, p.wv.flatten(1)).unflatten(-1, p.wv.shape[1:])
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    return k, v


# ----------------------------------------------------------------------
# FFN: SwiGLU MLP and top-k MoE
# ----------------------------------------------------------------------

def mlp(x, p, cfg: ModelConfig):
    h = F.silu(torch.matmul(x, p.wg)) * torch.matmul(x, p.wu)
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


def _experts(xe: torch.Tensor, p) -> torch.Tensor:
    """SwiGLU of every expert on its own rows: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wu)
    return torch.bmm(h, p.wd)


def moe_local(x, p, cfg: ModelConfig):
    """Per-row dispatch (``cfg.moe_local_dispatch``): each batch row routes
    its own S tokens, with a per-row capacity. Returns (out, aux)."""
    B, S, d = x.shape
    E = cfg.n_experts
    probs, w_te = _route(x, p, cfg)                                     # (B, S, E)
    aux = _switch_aux(probs, w_te, E, (0, 1))
    C = moe_capacity(cfg, S)
    sel_w, sel_idx = top_k(w_te.transpose(1, 2), C)                     # (B, E, C) over S
    xe = torch.gather(x, 1, sel_idx.reshape(B, E * C, 1).expand(B, E * C, d))
    xe = xe.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    ye = _experts(xe, p).reshape(E, B, C, d).transpose(0, 1)            # (B, E, C, d)
    ye = ye * sel_w[..., None].to(ye.dtype)
    rows = (sel_idx + S * torch.arange(B, device=x.device)[:, None, None]).reshape(-1)
    out = torch.zeros((B * S, d), dtype=ye.dtype, device=x.device)
    out = out.index_add(0, rows, ye.reshape(-1, d))
    return out.reshape(B, S, d), aux


def moe(x, p, cfg: ModelConfig):
    """Token-choice top-k MoE with per-expert capacity dispatch over all
    B * S tokens: softmax router in fp32, each token's top-k experts with
    their probabilities renormalised, each expert's top-C tokens by that
    weight (C = ``moe_capacity``), gathered, a SwiGLU per expert, scaled
    and scatter-added back. Returns (out, Switch aux loss).
    ``cfg.moe_local_dispatch`` routes per row instead (``moe_local``)."""
    if cfg.moe_local_dispatch:
        return moe_local(x, p, cfg)
    B, S, d = x.shape
    E = cfg.n_experts
    xt = x.reshape(B * S, d)
    probs, w_te = _route(xt, p, cfg)                                    # (T, E)
    aux = _switch_aux(probs, w_te, E, 0)
    C = moe_capacity(cfg, B * S)
    sel_w, sel_idx = top_k(w_te.t(), C)                                 # (E, C)
    ye = _experts(xt[sel_idx], p)                                       # (E, C, d)
    ye = ye * sel_w[..., None].to(ye.dtype)
    out = torch.zeros((B * S, d), dtype=ye.dtype, device=x.device)
    out = out.index_add(0, sel_idx.reshape(-1), ye.reshape(E * C, d))
    return out.reshape(B, S, d), aux
