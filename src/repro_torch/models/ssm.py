"""Mamba2 (SSD, state-space duality) sequence mixer, a port of
``repro/models/ssm.py`` function for function.

Training and prefill use the chunked SSD algorithm [arXiv:2405.21060]:
a quadratic, attention-like form within each chunk and a linear scan
across chunks (a Python loop over the chunks here). Decode is the O(1)
recurrence h <- a h + dt B x, y = C.h + D x.

Two deliberate differences from the reference, both in the decay
terms ``exp(cs_i - cs_j)`` (cs the chunk's cumulative log-decay):
  * the intra-chunk decay is masked to ``-inf`` above the diagonal
    *before* the exponential. Above the diagonal ``cs_i - cs_j`` is
    positive (cs falls with i), and once a chunk's summed log-decay
    passes ~88 it overflows fp32 to ``inf``; the reference multiplies
    that by its 0 mask and gets NaN (at its default chunk of 256 on a
    full-size config). On and below the diagonal the value is the
    reference's ``exp(d) * 1``, above it a zero of the score's sign;
  * cs and its differences are taken in fp64 and rounded once to fp32.
    A difference of two fp32 cumulative sums of magnitude |cs| carries
    their rounding, ~|cs| ulp, into the exponent; the reference's
    ``jnp.cumsum`` (a tree scan on the CPU) keeps that small, and a
    sequential fp32 ``torch.cumsum`` did not (4x the reference's error
    against an fp64 recurrence at chunk 16).

The cache functions update the cache's tensors in place (the reference
returns a new cache) and return the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NO_SHARDING, ShardCtx, contiguous_grads, rms_norm


def _heads_local(fn, x, dt, a_neg, bmat, cmat, h, n_out: int = 2):
    """``fn(x, dt, a_neg, bmat, cmat, h, ...)`` on each rank's batch rows
    and SSM heads: the SSD is independent across heads, so heads sharded
    over the model axis stay local, and B and C, shared by every head,
    come whole (their gradient the sum over the ranks' heads). ``x``
    (B, ., H, P), ``dt`` (B, ., H), ``a_neg`` (H,), ``bmat`` / ``cmat``
    (B, ., N), ``h`` (B, H, N, P); the outputs are laid out as ``x`` and
    ``h``."""
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    a_neg, bmat, cmat, dt = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, whole)
                             for t in (a_neg, bmat, cmat, dt))
    pls = {"x": [], "dt": [], "a": [], "bc": [], "h": [], "bc_grad": [], "a_grad": []}
    for xp in x.placements:
        if isinstance(xp, Shard) and xp.dim == 0:     # batch rows: a's gradient summed
            row = (Shard(0), Shard(0), Replicate(), Shard(0), Shard(0), Shard(0), Partial())
        elif isinstance(xp, Shard) and xp.dim == 2:   # heads: B's and C's gradient summed
            row = (Shard(2), Shard(2), Shard(0), Replicate(), Shard(1), Partial(), Shard(0))
        else:
            row = (Replicate(),) * 7
        for key, pl in zip(pls, row):
            pls[key].append(pl)
    if h is None:
        h = torch.zeros((x.shape[0], x.shape[2], bmat.shape[-1], x.shape[3]),
                        dtype=torch.float32, device=x.device)
    if not isinstance(h, DTensor):
        h = DTensor.from_local(h, mesh, whole)
    ins = (pls["x"], pls["dt"], pls["a"], pls["bc"], pls["bc"], pls["h"])
    grads = (pls["x"], pls["dt"], pls["a_grad"], pls["bc_grad"], pls["bc_grad"], pls["h"])
    return local_map(lambda *a: fn(*contiguous_grads(*a)),
                     out_placements=(pls["x"], pls["h"]), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(x, dt, a_neg, bmat, cmat, h)


def ssd_chunked(x, dt, a_neg, bmat, cmat, chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan (``_ssd_chunked``); on a mesh on each rank's own
    batch rows and heads (``_heads_local``)."""
    if isinstance(x, DTensor):
        return _heads_local(lambda *a: _ssd_chunked(*a[:5], chunk, a[5]),
                            x, dt, a_neg, bmat, cmat, h0)
    return _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk, h0)


def _ssd_chunked(x, dt, a_neg, bmat, cmat, chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P) head inputs; dt: (B, S, H) discretisation steps
    (post-softplus); a_neg: (H,) negative continuous-time decay
    (A = -exp(a_log)); bmat, cmat: (B, S, N) input and output projections
    (one group). Returns y (B, S, H, P) in ``x.dtype`` and the final state
    h (B, H, N, P) in fp32. S is zero-padded to a chunk multiple; dt = 0
    padding is exact (log-decay 0, no state update) and the padded outputs
    are cut off.
    """
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    L = min(chunk, S)
    S_real = S
    if S % L:
        pad = L - S % L
        x, dt, bmat, cmat = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                             for t in (x, dt, bmat, cmat))
        S += pad
    h = h0 if h0 is not None else torch.zeros((B, H, N, P), dtype=torch.float32,
                                              device=x.device)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    ys = []
    for lo in range(0, S, L):
        xc = x[:, lo:lo + L].float()              # (B, L, H, P)
        dtc = dt[:, lo:lo + L].float()            # (B, L, H)
        bc = bmat[:, lo:lo + L].float()           # (B, L, N)
        cc = cmat[:, lo:lo + L].float()
        # inclusive cumulative log-decay (<= 0) and its differences in fp64
        cs64 = torch.cumsum((dtc * a_neg).double(), dim=1)               # (B, L, H)
        cs = cs64.float()
        # ---- intra-chunk (quadratic form), masked before the exponential ----
        scores = torch.einsum("bin,bjn->bij", cc, bc)                     # (B, L, L)
        diff = (cs64[:, :, None, :] - cs64[:, None, :, :]).float()        # (B, i, j, H)
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        m = (scores[..., None] * decay) * dtc[:, None, :, :]              # (B, i, j, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xc)
        # ---- contribution of the incoming state ----
        y_inter = torch.einsum("bin,bhnp->bihp", cc, h) * torch.exp(cs)[..., None]
        # ---- state update ----
        decay_to_end = torch.exp((cs64[:, -1:, :] - cs64).float())        # (B, L, H)
        s_c = torch.einsum("bjn,bjhp->bhnp", bc, (dtc * decay_to_end)[..., None] * xc)
        h = torch.exp(cs[:, -1, :])[:, :, None, None] * h + s_c
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y[:, :S_real], h


def ssd_decode_step(x, dt, a_neg, bmat, cmat, h):
    """One token of the recurrence. x: (B, H, P), dt: (B, H), bmat and
    cmat: (B, N), h: (B, H, N, P) fp32. Returns (y (B, H, P) in
    ``x.dtype``, the new state); on a mesh on each rank's own heads."""
    if isinstance(x, DTensor):
        def one(x, dt, a, b, c, h):
            y, h = _ssd_decode_step(x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], h)
            return y[:, None], h

        y, h = _heads_local(one, x[:, None], dt[:, None], a_neg, bmat[:, None], cmat[:, None], h)
        return y[:, 0], h
    return _ssd_decode_step(x, dt, a_neg, bmat, cmat, h)


def _ssd_decode_step(x, dt, a_neg, bmat, cmat, h):
    a = torch.exp(dt.float() * a_neg)                                     # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", bmat.float(), dt.float()[..., None] * x.float())
    h_new = a[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), h_new)
    return y.to(x.dtype), h_new


def causal_conv(x, w, b):
    """Depthwise causal conv1d in fp32, left-padded by K - 1.
    x: (B, S, C); w: (K, C); b: (C,). Returns (B, S, C) in ``x.dtype``.
    On a mesh each rank convolves its own channels (the conv is
    depthwise: channel-sharded is exact) of its own batch rows."""
    if not isinstance(w, DTensor):
        return _causal_conv(x, w, b)
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)
    x_pl, w_pl, b_pl, wb_grad = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(wp, Shard) and wp.dim == 1:
            x_pl.append(Shard(2)), w_pl.append(wp), b_pl.append(Shard(0))
            wb_grad.append(None)
        elif isinstance(xp, Shard) and xp.dim == 0:
            # each rank's rows give a part of the weights' gradient: summed
            x_pl.append(xp), w_pl.append(Replicate()), b_pl.append(Replicate())
            wb_grad.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), b_pl.append(Replicate())
            wb_grad.append(Replicate())
    w_grad = [g or p for g, p in zip(wb_grad, w_pl)]
    b_grad = [g or p for g, p in zip(wb_grad, b_pl)]
    return local_map(lambda x, w, b: _causal_conv(*contiguous_grads(x, w, b)),
                     out_placements=x_pl, in_placements=(x_pl, w_pl, b_pl),
                     in_grad_placements=(x_pl, w_grad, b_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w, b)


def _causal_conv(x, w, b):
    K, C = w.shape
    lhs = F.pad(x.transpose(1, 2).float(), (K - 1, 0))                    # (B, C, S + K - 1)
    out = F.conv1d(lhs, w.t().float()[:, None, :], groups=C)              # (B, C, S)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def conv_decode_step(x, w, b, state):
    """x: (B, C) the newest sample; state: (B, K - 1, C) the previous
    ones. Returns (y (B, C) in ``x.dtype``, the new state)."""
    window = torch.cat([state, x[:, None, :]], dim=1)                     # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return y.to(x.dtype), window[:, 1:]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) at every x (``F.softplus`` turns
    into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_mixer(x, p, cfg: ModelConfig, cache: Optional[dict] = None, decode: bool = False, *,
                ctx: ShardCtx = NO_SHARDING):
    """The Mamba2 block's mixer. x: (B, S, d). Returns (out, cache): with
    a cache, prefill leaves the last K - 1 pre-conv samples (zero-padded
    at the front when S < K - 1) and the final SSD state in it, and decode
    advances both by one token, in place."""
    B, S, d = x.shape
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = cfg.d_inner
    xin = ctx.c(torch.matmul(x, p.in_x), "batch", "seq", "ssm_inner")
    z = ctx.c(torch.matmul(x, p.in_z), "batch", "seq", "ssm_inner")
    xbc_pre = torch.cat([xin, torch.matmul(x, p.in_b), torch.matmul(x, p.in_c)],
                        dim=-1)                                           # (B, S, conv_dim)
    dtr = torch.matmul(x, p.in_dt)
    if decode:
        y_c, conv_state = conv_decode_step(xbc_pre[:, 0], p.conv_w, p.conv_b, cache["conv"])
        xbc = y_c[:, None, :]
        cache["conv"].copy_(conv_state)
    else:
        xbc = causal_conv(xbc_pre, p.conv_w, p.conv_b)
        if cache is not None:
            K = cfg.ssm_conv
            tail = xbc_pre[:, max(S - (K - 1), 0):]
            if S < K - 1:
                tail = F.pad(tail, (0, 0, K - 1 - S, 0))
            cache["conv"].copy_(tail[:, -(K - 1):])
    xbc = F.silu(xbc)
    xin, bm, cm = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = _softplus(dtr.float() + p.dt_bias)
    a_neg = -torch.exp(p.a_log.float())
    xh = xin.reshape(B, -1, H, P)
    if decode:
        y, h = ssd_decode_step(xh[:, 0], dt[:, 0], a_neg, bm[:, 0], cm[:, 0], cache["ssm"])
        y = y[:, None]
        cache["ssm"].copy_(h)
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, h = ssd_chunked(xh, dt, a_neg, bm, cm, cfg.ssm_chunk, h0)
        if cache is not None:
            cache["ssm"].copy_(h)
    y = y + p.d_skip.float()[None, None, :, None] * xh.float()
    y = y.reshape(B, -1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm, cfg.rms_eps)
    return torch.matmul(y, p.out), cache
