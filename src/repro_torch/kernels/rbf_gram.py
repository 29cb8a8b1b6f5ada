"""RBF Gram matrix for one bandwidth: ``train_svm``'s kernel.

Replaces ``repro/kernels/rbf_gram.py::rbf_gram_pallas`` (the TPU kernel,
grid (M/128, N/128) over VMEM tiles). It runs the device code of
``csrc/gram.cu`` with one device and a scalar gamma, through its own C
launcher, wrapper and launch counter; see ``batched_gram.py`` for the
tile design.

Bound on the H100: bytes at small d; at the pooled-data ideal's
2000 x 2000 x 32 the output write (16 MB) and the 2d + 5 operations per
element come within a factor of four of each other, and the kernel is
far from both.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("rbf_gram")


def rbf_gram_plain(x1: torch.Tensor, x2: torch.Tensor, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: x1 (m, d), x2 (n, d) -> (m, n)
    ``exp(-gamma |x1_i - x2_j|^2)`` via the norm expansion, clamped at 0."""
    sq1 = (x1 * x1).sum(1)[:, None]
    sq2 = (x2 * x2).sum(1)[None, :]
    cross = x1 @ x2.T
    d2 = torch.clamp(sq1 + sq2 - 2.0 * cross, min=0.0)
    return torch.exp(-float(gamma) * d2)


def rbf_gram_cuda(x1: torch.Tensor, x2: torch.Tensor, gamma: float) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` (scalar gamma) on x1's CUDA device."""
    native.check_cuda("rbf_gram", x1.device, x1=x1, x2=x2)
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"rbf_gram: want x1 (m, d), x2 (n, d), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    m, d = x1.shape
    n = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    lib = native.library("gram")
    native.launch(LAUNCHES, x1.device, lib.rbf_gram_launch,
                  x1.data_ptr(), x2.data_ptr(), float(gamma), out.data_ptr(), m, n, d)
    return out
