"""GQA flash attention: the LM path's attention (prefill and the
full-sequence forward, with ``use_pallas``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(the TPU kernel: q, k and v padded to 128-row tiles and transposed to
(B, H, S, hd), grid (B, H, q tile, kv tile) with the kv sweep as the
sequential innermost dimension carrying the softmax statistics and the
accumulator in VMEM). ``csrc/flash_attention.cu`` moves the kv loop
inside one block per (64-row query tile, query head, batch), reads the
(B, S, heads, hd) tensors in place through their strides, stages each
K/V tile in shared memory as fp32 and keeps the statistics and the
accumulator in fp32 registers; see the source for the design.

Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32,
K 8, hd 64, bf16, causal) the bf16 tensor-core bound is 0.0695 ms; the
kernel's fp32 FMAs can reach 1.03 ms at most.

Keys are masked by length (``k_pos < Skv``) on every call, so the
kernel and the plain version agree with the reference's oracle
(``flash_attention_ref``) on every input, including the non-causal
windowed calls on a ragged length that the TPU kernel gets wrong or
refuses.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("flash_attention")

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, Sq, H, hd), k and v (B, Skv, K, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if k.shape[2] < 1 or H % k.shape[2] != 0:
        raise ValueError(f"{name}: {H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain PyTorch version, the kernel's arithmetic in dense form:
    q, k and v cast to fp32, scores scaled by 1/sqrt(hd), masked with
    -1e9, softmax in fp32, P kept in fp32 for PV, the output cast to
    ``q.dtype``. q (B, Sq, H, hd), k and v (B, Skv, K, hd)."""
    _check_shapes("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bskrh,btkh->bkrst", qg, k.float()) * (1.0 / math.sqrt(hd))
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on q's CUDA device. Takes
    contiguous float32 or bfloat16 tensors, all of one type, head dims
    16, 32, 64 or 128, and a query head count that is a multiple of the
    KV head count; raises on anything else."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    native.check_cuda("flash_attention", q.device,
                      dtypes={"q": q.dtype, "k": q.dtype, "v": q.dtype}, q=q, k=k, v=v)
    _check_shapes("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: batch {B} or heads {H} exceed the grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    lib = native.library("flash_attention")
    native.launch(LAUNCHES, q.device, lib.flash_attention_launch,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Skv, H, K, hd, int(q.dtype == torch.bfloat16), int(bool(causal)),
                  int(window), 1.0 / math.sqrt(hd))
    return out
