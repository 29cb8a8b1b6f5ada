"""GQA flash attention: the LM path's attention (prefill and the
full-sequence forward, with ``use_pallas``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(the TPU kernel: q, k and v padded to 128-row tiles and transposed to
(B, H, S, hd), grid (B, H, q tile, kv tile) with the kv sweep as the
sequential innermost dimension carrying the softmax statistics and the
accumulator in VMEM). Hand-written kernels, picked by dtype, all with
the kv loop inside one block per (query tile, query head, batch) and
q, k, v read in place from (B, S, heads, hd):

- bfloat16 (the serve path) and float16: ``csrc/flash_attention_tc.cu``
  (``csrc/flash_attention_tc_f16.cu`` builds it for float16), the
  FlashAttention-2 shape on ``mma.sync`` tensor cores, 128-row blocks of
  8 warps. K/V tiles double-buffered in shared memory by ``cp.async``
  (16 bytes where every row allows it, else 8, 4, or plain loads), Q
  fragments in registers up to hd 128 and read from shared memory past
  it, the online softmax on the fp32 accumulator fragments, P kept in
  registers as two 16-bit parts (P_hi + P_lo, since the reference keeps
  P in fp32 for P V) multiplied by V.
- float32: ``csrc/flash_attention.cu``, 64-row blocks, fp32 FMAs on
  tiles staged in shared memory (the tensor cores have no full-precision
  product).

Every head dim: both are built for the padded widths ``HEAD_DIMS``; a
call's hd is rounded up to the next, the padding columns are zero in
shared memory and never written to o. Past 256 each has a chunked kernel
that splits hd over a thread-block cluster (``csrc/flash_chunked.cuh``):
each CTA stages its slice of at most ``CHUNK`` columns of q, k and v once,
sums its part of Q K^T, and the cluster adds the parts in rank order
through distributed shared memory, so every CTA holds the same S and
writes its own slice of o. Q K^T is summed once a (query tile, kv tile)
up to hd 2,048 (8 CTAs, the portable cluster size); past it once per
256-column group of o. Any batch and head count: the grid folds (query
tile, head, batch) into one dimension, one launch a call.

Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32,
K 8, hd 64, causal) the bf16 tensor-core bound is 0.0695 ms; in fp32
the FMA limit is 1.03 ms. Through the chunked kernels at hd 512 (B 1,
S 2048, H 8, causal) 0.0348 ms and 0.513 ms; ``PERF.md`` has their
times beside SDPA's.

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
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)   # the padded widths built; past 256 chunked
CHUNK = 256   # the chunked kernels' slice of q, k, v and o a CTA stages, in columns
# the element types the kernels take as they are: library and its C launcher
LIBRARIES = {torch.float32: ("flash_attention", "flash_attention_launch"),
             torch.bfloat16: ("flash_attention_tc", "flash_attention_tc_launch"),
             torch.float16: ("flash_attention_tc_f16", "flash_attention_tc_f16_launch")}


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


def run_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.dtype:
    """The type the kernel computes a call in: q's when q, k and v are
    all of one type of ``LIBRARIES``, else float32 (the reference casts
    each input to fp32). The roofline prices a call by it."""
    return q.dtype if q.dtype in LIBRARIES and q.dtype == k.dtype == v.dtype else torch.float32


def kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """q, k and v as the kernel reads them: in ``run_dtype`` (each left
    as it is where it is of that type and contiguous, else cast); a
    non-contiguous one as a contiguous copy. A 16-bit tensor off a
    16-byte boundary is not copied: the kernel's narrower copies read it
    in place."""
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_floating_point():
            raise TypeError(f"flash_attention: {arg} must be a float tensor, got {t.dtype}")
    run = run_dtype(q, k, v)
    return tuple(t.contiguous() if t.dtype == run
                 else t.to(run, memory_format=torch.contiguous_format) for t in (q, k, v))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel for q's dtype on q's CUDA device: q, k and v all
    bfloat16 (``csrc/flash_attention_tc.cu``), all float16
    (``csrc/flash_attention_tc_f16.cu``) or all float32
    (``csrc/flash_attention.cu``), at any head dim, batch and head count,
    with a query head count that is a multiple of the KV head count.

    Other float inputs (q, k and v of mixed types, or float64) take the
    reference's own arithmetic: its kernel casts each of q, k and v to
    fp32 and writes q's dtype, so here each is cast to fp32, the fp32
    kernel runs, and its output is cast to q's dtype. That is the
    hand-written kernel on the reference's numbers, not a fallback. A
    non-contiguous input is copied to a contiguous one first; a 16-bit
    one that does not start on a 16-byte boundary is read in place by
    the kernel's narrower copies. Raises under grad mode when an input
    requires grad (there is no backward) and on shapes that disagree."""
    native.refuse_grad("flash_attention", q=q, k=k, v=v)
    native.check_device("flash_attention", q.device, q=q, k=k, v=v)
    _check_shapes("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    q_, k_, v_ = kernel_inputs(q, k, v)
    out = torch.empty(q_.shape, dtype=q_.dtype, device=q.device)
    if out.numel() == 0:
        return out.to(q.dtype)
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    lib_name, fn_name = LIBRARIES[q_.dtype]
    native.launch(LAUNCHES, q.device, getattr(native.library(lib_name), fn_name),
                  q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), out.data_ptr(),
                  B, Sq, Skv, H, K, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd))
    return out.to(q.dtype)
