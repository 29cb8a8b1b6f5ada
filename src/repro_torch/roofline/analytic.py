"""Analytic cost of the inner sequence loops of a train or prefill step.

A copy of ``repro.roofline.analytic`` over the port's ``ModelConfig``
and ``BLOCKED_ATTN_THRESHOLD``:

  * blocked attention (train/prefill, S_total > threshold):
      flops_fwd = 4 * B * H * S^2 * hd   (QK^T + PV; all kv blocks, or
      the causal / window frontier's share with ``attn_block_skip``)
      bytes ~ q, k, v read + out write
  * SSD chunk scan (train/prefill mamba layers):
      flops_fwd ~ B*S * (2*L*d_inner + 4*N*d_inner + 2*L*N + 3*L*H)
      bytes ~ x, B, C, dt read + y write + state carry per chunk

Backward (train) multiplies flops and bytes by 3. Quantities are per
chip: batch shards over (pod, data), heads / d_inner over model when
divisible. ``mesh`` is ``None`` (every axis of size 1: the port's one
card) or any object with ``axis_names`` and ``devices.shape``.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BLOCKED_ATTN_THRESHOLD


def _axis_size(mesh, name: str) -> int:
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get(name, 1)


def _shard(n: int, ways: int) -> float:
    return n / ways if n % ways == 0 else n


def inner_scan_cost(cfg: ModelConfig, shape, mesh=None) -> tuple:
    """(flops_per_chip, bytes_per_chip) supplement."""
    if shape.kind == "decode":
        return 0.0, 0.0  # decode paths are straight-line
    B, S = shape.global_batch, shape.seq_len
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    tp = _axis_size(mesh, "model")
    B_loc = max(B / dp, 1.0) if B % dp == 0 else float(B)
    bwd_mult = 3.0 if shape.kind == "train" else 1.0
    itemsize = 2.0  # bf16 activations

    flops = 0.0
    bytes_ = 0.0
    mixers = cfg.mixer_kinds()
    n_attn = sum(1 for m in mixers if m == "attn")
    n_mamba = len(mixers) - n_attn

    s_tot = S + (cfg.n_patches or 0)
    if n_attn and s_tot > BLOCKED_ATTN_THRESHOLD:
        H_loc = _shard(cfg.n_heads, tp)
        K_loc = _shard(cfg.n_kv_heads, tp)
        hd = cfg.head_dim
        # fraction of KV blocks actually computed
        frac = 1.0
        if cfg.attn_block_skip:
            frac = 0.5 + 1024.0 / s_tot  # causal frontier at block granularity
            if cfg.sliding_window:
                frac = min(frac, (cfg.sliding_window + 1024.0) / s_tot)
        if cfg.shard_attn_seq and cfg.n_heads % tp != 0:
            # context-parallel attention: the reference measured XLA
            # splitting the q-chunk dim 2-way under its constraint
            frac *= 0.5
        f_fwd = 4.0 * B_loc * H_loc * float(s_tot) ** 2 * hd * frac
        b_fwd = itemsize * B_loc * s_tot * hd * (2 * H_loc + 2 * K_loc)  # q+out, k+v
        flops += n_attn * f_fwd * bwd_mult
        bytes_ += n_attn * b_fwd * bwd_mult

    if n_mamba:
        di_loc = _shard(cfg.d_inner, tp)
        H_loc = _shard(cfg.ssm_n_heads, tp)
        N = cfg.ssm_state
        L = min(cfg.ssm_chunk, S)
        f_fwd = B_loc * S * (2.0 * L * di_loc + 4.0 * N * di_loc + 2.0 * L * N + 3.0 * L * H_loc)
        n_chunks = max(S // L, 1)
        b_fwd = itemsize * B_loc * S * (2 * di_loc + 4 * N + 2 * H_loc) + 4.0 * B_loc * H_loc * (
            cfg.ssm_head_dim * N
        ) * n_chunks
        flops += n_mamba * f_fwd * bwd_mult
        bytes_ += n_mamba * b_fwd * bwd_mult

    return flops, bytes_
