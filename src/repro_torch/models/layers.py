"""Core layers of the dense LM: RMSNorm, RoPE, GQA attention
(full-sequence, prefill into the KV cache, one-token decode against it,
full or sliding-window) and the SwiGLU MLP.

Ports of ``repro/models/layers.py``, function for function and with the
reference's layouts: q/k/v ``(B, S, heads, hd)``, ``wq`` ``(d, H, hd)``,
``wo`` ``(H, hd, d)``. ``p`` is a ``ParamNode`` of
``repro_torch.models.params`` whose attributes carry the reference's
parameter names. The port has no mesh, so the reference's ``ShardCtx``
constraints have no counterpart here (ROADMAP queue 1 item 15).

Attention takes one of three routes, as in the reference
(``_self_attention_out``): with ``cfg.use_pallas`` the ``flash_attention``
kernel (``repro_torch.kernels.ops``: the hand-written CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor); otherwise, above
``BLOCKED_ATTN_THRESHOLD`` tokens, ``blocked_attention`` (a plain PyTorch
online-softmax loop); otherwise dense ``_sdpa``.

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


# ----------------------------------------------------------------------
# FFN: SwiGLU MLP
# ----------------------------------------------------------------------

def mlp(x, p, cfg: ModelConfig):
    h = F.silu(torch.matmul(x, p.wg)) * torch.matmul(x, p.wu)
    return torch.matmul(h, p.wd)
