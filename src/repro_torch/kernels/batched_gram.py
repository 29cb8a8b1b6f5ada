"""Batched RBF Gram matrices: the engine's fit and score kernel.

Replaces ``repro/kernels/batched_gram.py::batched_rbf_gram_pallas`` (the
TPU kernel, grid (g, M/bm, N/bn) over VMEM tiles) with the hand-written
CUDA kernel in ``csrc/gram.cu``: one block per 64 x 64 output tile of one
device, the feature dim staged through shared memory in 32-wide chunks,
the cross term in plain fp32 FMA and the norm/clamp/exp epilogue fused
before the only store.

Bound on the H100: bytes. At the engine's shapes (d = 32, b <= 256) each
output element costs about 2d + 5 fp32 operations against 4 bytes
written, under the card's 20 operations per byte of fp32 balance; the
design writes each output once and reads each input row once per tile.

Padding contract (the reference's): a zero-padded row gives
``exp(-gamma |x|^2) != 0``; the engine masks rows and columns after the
call (``sim/engine.py``). Nothing is masked here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("batched_rbf_gram")


def batched_rbf_gram_plain(x1: torch.Tensor, x2: torch.Tensor,
                           gammas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x1 (g, m, d), x2 (g, n, d), gammas (g,)
    -> (g, m, n) with out[t] = exp(-gammas[t] |x1[t,i] - x2[t,j]|^2)."""
    sq1 = (x1 * x1).sum(-1)[:, :, None]
    sq2 = (x2 * x2).sum(-1)[:, None, :]
    cross = torch.bmm(x1, x2.transpose(1, 2))
    d2 = torch.clamp(sq1 + sq2 - 2.0 * cross, min=0.0)
    return torch.exp(-gammas[:, None, None] * d2)


def batched_rbf_gram_cuda(x1: torch.Tensor, x2: torch.Tensor,
                          gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` (per-device gamma) on x1's CUDA device."""
    native.check_cuda("batched_rbf_gram", x1.device, x1=x1, x2=x2, gammas=gammas)
    if x1.dim() != 3 or x2.dim() != 3 or gammas.dim() != 1:
        raise ValueError("batched_rbf_gram: want x1 (g, m, d), x2 (g, n, d), gammas (g,)")
    g, m, d = x1.shape
    n = x2.shape[1]
    if x2.shape[0] != g or x2.shape[2] != d or gammas.shape[0] != g:
        raise ValueError(f"batched_rbf_gram: shapes {tuple(x1.shape)}, "
                         f"{tuple(x2.shape)}, {tuple(gammas.shape)} disagree")
    if g > 65535:
        raise ValueError(f"batched_rbf_gram: at most 65535 devices per call, got {g}")
    out = torch.empty((g, m, n), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    lib = native.library("gram")
    native.launch(LAUNCHES, x1.device, lib.batched_rbf_gram_launch,
                  x1.data_ptr(), x2.data_ptr(), gammas.data_ptr(), out.data_ptr(),
                  g, m, n, d)
    return out
