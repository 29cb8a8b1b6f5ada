"""RBF Gram between fp32 queries and per-column affine int8 supports:
``QuantizedSVM.predict``'s kernel.

Replaces ``repro/kernels/rbf_gram_q8.py::rbf_gram_q8_pallas`` (grid
(M/128, N/128) over VMEM tiles, the int8 tile dequantised in VMEM).
It launches ``csrc/gram_q8.cu``, a kernel of its own: the cross term
``x . s_j = sum_c (x_c scale_c) q_jc + x . zero`` runs on the bf16
tensor cores (``mma.sync``), with the int8 values exact in bf16 and
``x * scale`` split into three bf16 planes (hi, mid, lo) that carry it
to fp32 accuracy, so no operand is rounded below fp32; ``x . zero`` and
the norms are fp32 on the CUDA cores. A block owns 64 query rows and
walks a run of 128-support tiles (``split_plan``), paying for the x
side once; the int8 tiles arrive raw by ``cp.async`` and are converted
to bf16 once a tile. The fp32 supports never exist in device memory.
Past d 128 (``STAGED_D``) the stripe's planes no longer stay staged: a
chunked instantiation walks the features in chunks of 128 for each
support tile, re-staging the chunk's planes and converting the tile's
chunk, with the accumulators carried across chunks, so it runs the
staged kernel's products in the staged kernel's order and gives its
bits where both run (``rbf_gram_q8_chunked_cuda`` launches it at any d,
for that check).

Padding contract: a padded int8 row dequantises to ``zero``, not 0; the
reference pads and slices, and the kernel writes only the real (m, n)
outputs. An output depends on its query row and its support alone, so
a row's values are the same bits in any chunk of queries.

Bound on the H100: bytes. At the student's 8192 x 4096 x 32 the 134 MB
output takes 0.040 ms at 3.35 TB/s, more than its operations. The
design moves the cross term off the CUDA cores (~32 FMAs and ~16 shared
loads a pair before) and leaves ~6 instructions a pair for the
epilogue (``ex2.approx``) and half a 8-byte store, so the store is the
limit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.rbf_gram import rbf_gram_plain

LAUNCHES = native.LaunchCounter("rbf_gram_q8")

ROWS, TILE = 64, 128          # query rows per block, supports per tile
TARGET_BLOCKS = 3 * 132       # three resident blocks on each SM of an H100: one wave
STAGED_D = 128                # the staged kernel's largest feature dim (8 k steps of 16)


def dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """Per-column affine int8 -> fp32: ``q * scale + zero`` over the last
    axis, a rounded multiply then a rounded add (the reference oracle's
    arithmetic)."""
    return q.to(torch.float32) * scale + zero


def rbf_gram_q8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: x (m, d) fp32, q (n, d) int8, scale and
    zero (d,) -> (m, n): dequantise, then the fp32 Gram."""
    return rbf_gram_plain(x, dequantize(q, scale[None, :], zero[None, :]), gamma)


def split_plan(m: int, n: int) -> tuple:
    """(per_split, splits): support tiles per block and the number of
    blocks a stripe of ROWS queries is split into. As many splits as
    keep ceil(m / ROWS) x splits within TARGET_BLOCKS; split s takes
    tiles s * per_split .. (s + 1) * per_split - 1, and no split is
    empty."""
    tiles = max(1, -(-n // TILE))
    stripes = max(1, -(-m // ROWS))
    want = max(1, min(tiles, TARGET_BLOCKS // stripes))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def _launch(fn_name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            zero: torch.Tensor, gamma: float) -> torch.Tensor:
    x, q, scale, zero = native.prepare("rbf_gram_q8", x.device, dtypes={"q": torch.int8},
                                       x=x, q=q, scale=scale, zero=zero)
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1 or zero.dim() != 1:
        raise ValueError("rbf_gram_q8: want x (m, d), q (n, d), scale (d,), zero (d,)")
    m, d = x.shape
    n = q.shape[0]
    if q.shape[1] != d or scale.shape[0] != d or zero.shape[0] != d:
        raise ValueError(f"rbf_gram_q8: shapes {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)} disagree")
    if d < 1:
        raise ValueError("rbf_gram_q8: the kernel takes d >= 1")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    per_split, splits = split_plan(m, n)
    lib = native.library("gram_q8")
    native.launch(LAUNCHES, x.device, getattr(lib, fn_name),
                  x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                  float(gamma), out.data_ptr(), m, n, d, per_split, splits)
    return out


def rbf_gram_q8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, gamma: float) -> torch.Tensor:
    """Launch ``csrc/gram_q8.cu`` on x's CUDA device: the staged kernel
    up to d ``STAGED_D``, the chunked one past it."""
    return _launch("rbf_gram_q8_launch", x, q, scale, zero, gamma)


def rbf_gram_q8_chunked_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero: torch.Tensor, gamma: float) -> torch.Tensor:
    """The chunked kernel at any d, for holding it bit for bit to the
    staged one where both run; no path of the port calls it."""
    return _launch("rbf_gram_q8_chunked_launch", x, q, scale, zero, gamma)
