"""Batched cyclic SDCA on the hinge-loss dual: every local fit and the
pooled-data ideal.

Replaces ``repro/core/svm.py::_sdca``, which is not a Pallas kernel but
an XLA ``fori_loop`` inside ``jit``, vmapped over a bucket of devices by
the reference engine. In eager PyTorch each of its 20 x bucket
coordinate steps would be several launches, so ``csrc/sdca.cu`` runs the
whole solve in one launch: one block per device, alpha and y in shared
memory, and each step's ``Ky[i] . alpha`` a fixed-order block reduction.

Bound on the H100: latency. The steps form one dependent chain per
device, so neither the bytes (each K read once: 64 MB for a 256-device
group of bucket 256) nor the operations bound it; the design keeps each
solve on one SM with two barriers per step and the K rows in L2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("sdca")


def sdca_plain(K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
               lam: float, epochs: int = 20) -> torch.Tensor:
    """Plain PyTorch version, step for step the reference's ``_sdca``
    vectorised over the device axis: K (g, b, b) zero-padded Grams,
    y (g, b) labels padded with +1, n_real (g,) int32 real counts.
    Returns alpha (g, b) in [0, 1], zero on padded coordinates.

    Steps for coordinates i >= max(n_real) only write 0 into an alpha
    that is already 0, so the loop stops there."""
    g, b, _ = K.shape
    Ky = K * y[:, None, :]
    n_f = n_real.to(torch.float32)
    lam_n = lam * n_f
    alpha = torch.zeros((g, b), dtype=torch.float32, device=K.device)
    live = int(n_real.max()) if g else 0
    for _ in range(epochs):
        for i in range(min(live, b)):
            f = (Ky[:, i, :] * alpha).sum(1) / lam_n
            grad = 1.0 - y[:, i] * f
            step = grad * lam * n_f / torch.clamp(K[:, i, i], min=1e-8)
            new = torch.clamp(alpha[:, i] + step, 0.0, 1.0)
            alpha[:, i] = torch.where(i < n_real, new, torch.zeros_like(new))
    return alpha


def sdca_cuda(K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
              lam: float, epochs: int = 20) -> torch.Tensor:
    """Launch ``csrc/sdca.cu`` (one block per device) on K's CUDA device."""
    native.check_cuda("sdca", K.device, dtypes={"n_real": torch.int32},
                      K=K, y=y, n_real=n_real)
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"sdca: want K (g, b, b), got {tuple(K.shape)}")
    g, b, _ = K.shape
    if tuple(y.shape) != (g, b) or tuple(n_real.shape) != (g,):
        raise ValueError(f"sdca: y {tuple(y.shape)} / n_real {tuple(n_real.shape)} "
                         f"do not match K {tuple(K.shape)}")
    lib = native.library("sdca")
    if lib.sdca_smem_bytes(b) > native.MAX_SMEM_BYTES:
        raise ValueError(f"sdca: bucket {b} needs more shared memory than a block may take")
    alpha = torch.empty((g, b), dtype=torch.float32, device=K.device)
    if g == 0 or b == 0:
        return alpha.zero_()
    native.launch(LAUNCHES, K.device, lib.sdca_launch,
                  K.data_ptr(), y.data_ptr(), n_real.data_ptr(), alpha.data_ptr(),
                  g, b, float(lam), int(epochs))
    return alpha
