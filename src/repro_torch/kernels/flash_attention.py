"""GQA flash attention: the LM path's attention (prefill and the
full-sequence forward, with ``use_pallas``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(the TPU kernel: q, k and v padded to 128-row tiles and transposed to
(B, H, S, hd), grid (B, H, q tile, kv tile) with the kv sweep as the
sequential innermost dimension carrying the softmax statistics and the
accumulator in VMEM). Two hand-written kernels, picked by dtype, both
with the kv loop inside one block per (query tile, query head, batch)
and q, k, v read in place from (B, S, heads, hd):

- bfloat16 (the serve path): ``csrc/flash_attention_tc.cu``, the
  FlashAttention-2 shape on ``mma.sync`` tensor cores, 128-row blocks of
  8 warps. K/V tiles double-buffered in shared memory by 16-byte
  ``cp.async``, Q fragments in registers, the online softmax on the fp32
  accumulator fragments, P kept in registers as two bf16 parts (P_hi +
  P_lo, ~16 bits, since the reference keeps P in fp32 for P V)
  multiplied by V.
- float32: ``csrc/flash_attention.cu``, 64-row blocks, fp32 FMAs on
  tiles staged in shared memory (the tensor cores have no full-precision
  product).

Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32,
K 8, hd 64, causal) the bf16 tensor-core bound is 0.0695 ms; in fp32
the FMA limit is 1.03 ms.

Keys are masked by length (``k_pos < Skv``) on every call, so the
kernels and the plain version agree with the reference's oracle
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
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instantiations
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
    """Launch ``csrc/flash_attention_tc.cu`` (bfloat16) or
    ``csrc/flash_attention.cu`` (float32) on q's CUDA device. Takes
    contiguous tensors all of one of those types (bfloat16 ones 16-byte
    aligned, for ``cp.async``), head dims 16, 32, 64 or 128, and a query
    head count that is a multiple of the KV head count; raises on
    anything else."""
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
    if q.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bfloat16 q, k and v must be 16-byte aligned")
        fn = native.library("flash_attention_tc").flash_attention_tc_launch
    else:
        fn = native.library("flash_attention").flash_attention_launch
    native.launch(LAUNCHES, q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, Sq, Skv, H, K, hd, int(bool(causal)), int(window),
                  1.0 / math.sqrt(hd))
    return out
