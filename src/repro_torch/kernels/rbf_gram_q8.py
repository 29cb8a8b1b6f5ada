"""RBF Gram between fp32 queries and per-column affine int8 supports:
``QuantizedSVM.predict``'s kernel.

Replaces ``repro/kernels/rbf_gram_q8.py::rbf_gram_q8_pallas`` (grid
(M/128, N/128) over VMEM tiles, the int8 tile dequantised in VMEM).
It launches ``csrc/gram.cu``'s 64 x 64 tile, instantiated with the int8
support loader of ``csrc/supports.cuh``: the support chunk is read as
int8 and dequantised to fp32 as ``q * scale + zero`` while it is staged
in shared memory, so the fp32 supports never exist in device memory.

Padding contract: a padded int8 row dequantises to ``zero``, not 0; the
reference pads and slices, and the kernel writes only the real (m, n)
outputs.

Bound on the H100: bytes. At the student's 8192 x 4096 x 32 the 134 MB
output takes 0.040 ms at 3.35 TB/s, more than its operations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.rbf_gram import rbf_gram_plain

LAUNCHES = native.LaunchCounter("rbf_gram_q8")


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


def rbf_gram_q8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, gamma: float) -> torch.Tensor:
    """Launch ``csrc/gram.cu``'s int8 tile on x's CUDA device."""
    native.check_cuda("rbf_gram_q8", x.device, x=x, q=q, scale=scale, zero=zero)
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1 or zero.dim() != 1:
        raise ValueError("rbf_gram_q8: want x (m, d), q (n, d), scale (d,), zero (d,)")
    m, d = x.shape
    n = q.shape[0]
    if q.shape[1] != d or scale.shape[0] != d or zero.shape[0] != d:
        raise ValueError(f"rbf_gram_q8: shapes {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)} disagree")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = native.library("gram")
    native.launch(LAUNCHES, x.device, lib.rbf_gram_q8_launch,
                  x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                  float(gamma), out.data_ptr(), m, n, d)
    return out
