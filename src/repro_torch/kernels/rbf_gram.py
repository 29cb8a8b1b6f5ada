"""RBF Gram matrix for one bandwidth: ``train_svm``'s kernel.

Replaces ``repro/kernels/rbf_gram.py::rbf_gram_pallas`` (the TPU kernel,
grid (M/128, N/128) over VMEM tiles). It runs the tile body of
``csrc/gram.cu`` with one device and a scalar gamma, as its own kernel
(``rbf_gram_kernel``), through its own C launcher, wrapper and launch
counter, with the tiles of ``batched_gram.tile_plan``; see
``batched_gram.py`` for the design (the cross term on bf16 tensor cores
from three bf16 planes of each fp32 operand, fp32 norms, the epilogue
on the fragments). ``rbf_gram(x1, x2, gamma)`` gives the same bits as
``batched_rbf_gram`` of the same rows with g = 1 and the same gamma.

Bound on the H100: bytes. At the pooled-data ideal's 2000 x 2000 x 32
(x2 is x1, as ``train_svm`` passes it) the 16 MB output and one read of
the rows take 0.0049 ms at 3.35 TB/s, more than the operations (2d + 6
a pair, 2d of them on the tensor cores); instruction issue holds the
kernel (``PERF.md`` section 6).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.batched_gram import launch_plan, launch_slices

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
    """Launch ``csrc/gram.cu`` (scalar gamma) on x1's CUDA device: one
    launch, or runs of rows past the grid (``launch_slices``)."""
    x1, x2 = native.prepare("rbf_gram", x1.device, x1=x1, x2=x2)
    if x1.dim() != 2 or x2.dim() != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"rbf_gram: want x1 (m, d), x2 (n, d), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    m, d = x1.shape
    n = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    rows, staged = launch_plan(m, n, d)
    fn = native.library("gram").rbf_gram_launch
    parts = launch_slices(1, m, rows)
    if len(parts) == 1:
        native.launch(LAUNCHES, x1.device, fn, x1.data_ptr(), x2.data_ptr(), float(gamma),
                      out.data_ptr(), m, n, d, rows, staged)
        return out
    for _, rs in parts:
        (a,) = native.prepare("rbf_gram", x1.device, x1=x1[rs])
        part = torch.empty((a.shape[0], n), dtype=torch.float32, device=x1.device)
        native.launch(LAUNCHES, x1.device, fn, a.data_ptr(), x2.data_ptr(), float(gamma),
                      part.data_ptr(), a.shape[0], n, d, rows, staged)
        out[rs] = part
    return out
