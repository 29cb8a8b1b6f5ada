"""Fused mean-of-member RBF-SVM scores: every ensemble evaluation and
every ``SVMModel.predict``.

Replaces ``repro/kernels/ensemble_score.py::ensemble_score_pallas``. The
TPU kernel walks a sequential (query tile, member, support tile) grid
and adds each partial into a VMEM scratch accumulator scaled by 1/k;
CUDA blocks run in parallel, so ``csrc/ensemble_score.cu`` moves the
member and support loops inside the block: one block owns 32 queries,
keeps their sums in registers across the whole ensemble, and writes each
score once, with no atomics. Like the reference's oracle it returns the
plain mean (sum / k); the (k, b, n_max) Gram never exists.

Bound on the H100: fp32 operations. A query-support pair costs about
2d + 6 operations and the packed ensemble is read once per block, so
at the full ensemble (k = 2821, n_max ~ 230, d = 32) the arithmetic
outweighs the bytes by two orders of magnitude; the design keeps every
intermediate in registers and shared memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("ensemble_score")

# the plain version materialises (members, b, n_max) Gram slabs; this caps
# one slab at 2^27 fp32 elements (512 MB) so full ensembles fit on the card
_PLAIN_SLAB_ELEMS = 1 << 27


def ensemble_score_plain(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                         gammas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (b, d), sup (k, n_max, d), coef
    (k, n_max), gammas (k,) -> (b,) mean over members of each member's
    ``sum_j coef_j exp(-gamma |x - s_j|^2)``. Members go in slabs so the
    Gram slab stays bounded; per-member scores are stacked and averaged
    as the reference's oracle does."""
    b = x.shape[0]
    k, n_max, _ = sup.shape
    sqx = (x * x).sum(1)[None, :, None]                    # (1, b, 1)
    step = max(1, _PLAIN_SLAB_ELEMS // max(b * n_max, 1))
    scores = []
    for lo in range(0, k, step):
        s = sup[lo: lo + step]
        sqs = (s * s).sum(-1)[:, None, :]                  # (t, 1, n)
        cross = torch.matmul(x[None], s.transpose(1, 2))   # (t, b, n)
        d2 = torch.clamp(sqx + sqs - 2.0 * cross, min=0.0)
        kq = torch.exp(-gammas[lo: lo + step, None, None] * d2)
        scores.append(torch.bmm(kq, coef[lo: lo + step, :, None])[:, :, 0])
    return torch.cat(scores).mean(0)


def ensemble_score_cuda(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                        gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ensemble_score.cu`` on x's CUDA device."""
    native.check_cuda("ensemble_score", x.device, x=x, sup=sup, coef=coef, gammas=gammas)
    if x.dim() != 2 or sup.dim() != 3 or coef.dim() != 2 or gammas.dim() != 1:
        raise ValueError("ensemble_score: want x (b, d), sup (k, n_max, d), "
                         "coef (k, n_max), gammas (k,)")
    b, d = x.shape
    k, n_max, ds = sup.shape
    if ds != d or tuple(coef.shape) != (k, n_max) or gammas.shape[0] != k:
        raise ValueError(f"ensemble_score: shapes {tuple(x.shape)}, {tuple(sup.shape)}, "
                         f"{tuple(coef.shape)}, {tuple(gammas.shape)} disagree")
    if k == 0:
        raise ValueError("ensemble_score: empty ensemble")
    lib = native.library("ensemble_score")
    if lib.ensemble_score_smem_bytes(d) > native.MAX_SMEM_BYTES:
        raise ValueError(f"ensemble_score: feature dim {d} needs more shared "
                         "memory than a block may take")
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    native.launch(LAUNCHES, x.device, lib.ensemble_score_launch,
                  x.data_ptr(), sup.data_ptr(), coef.data_ptr(), gammas.data_ptr(),
                  out.data_ptr(), b, k, n_max, d)
    return out
