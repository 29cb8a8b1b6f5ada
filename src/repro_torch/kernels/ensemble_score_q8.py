"""Fused mean-of-member RBF-SVM scores from int8 supports: every
ensemble evaluation of an int8 round (``QuantizedStackedEnsemble``).

Replaces ``repro/kernels/ensemble_score_q8.py::ensemble_score_q8_pallas``.
It launches ``csrc/ensemble_score.cu``'s kernel (one block owns 32
queries and loops over every member and 64-support tile, sums in
registers, no atomics), instantiated with the int8 support loader of
``csrc/supports.cuh``: each support tile is read as int8 and dequantised
with the member's (d,) scale and zero rows while it is staged in shared
memory. Zero coefficients annihilate padded rows, whose
dequantised value (the zero point) is finite. Returns sum / k.

Bound on the H100: fp32 operations, as ``ensemble_score``; the packed
int8 ensemble is a quarter of the fp32 one's bytes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ensemble_score as _ens
from repro_torch.kernels import native
from repro_torch.kernels.rbf_gram_q8 import dequantize

LAUNCHES = native.LaunchCounter("ensemble_score_q8")


def ensemble_score_q8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                            zero: torch.Tensor, coef: torch.Tensor,
                            gammas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (b, d), q (k, n_max, d) int8, scale and
    zero (k, d), coef (k, n_max), gammas (k,) -> (b,). Each slab of
    members is dequantised, then scored as ``ensemble_score_plain``
    scores it; per-member scores are stacked and averaged."""
    k, n_max, _ = q.shape
    step = _ens.plain_slab(x.shape[0], n_max)
    scores = []
    for lo in range(0, k, step):
        sl = slice(lo, lo + step)
        sup = dequantize(q[sl], scale[sl, None, :], zero[sl, None, :])
        scores.append(_ens.member_scores_plain(x, sup, coef[sl], gammas[sl]))
    return torch.cat(scores).mean(0)


def ensemble_score_q8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, coef: torch.Tensor,
                           gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ensemble_score.cu``'s int8 kernel on x's CUDA device."""
    native.check_cuda("ensemble_score_q8", x.device, dtypes={"q": torch.int8},
                      x=x, q=q, scale=scale, zero=zero, coef=coef, gammas=gammas)
    if (x.dim() != 2 or q.dim() != 3 or scale.dim() != 2 or zero.dim() != 2
            or coef.dim() != 2 or gammas.dim() != 1):
        raise ValueError("ensemble_score_q8: want x (b, d), q (k, n_max, d), scale and "
                         "zero (k, d), coef (k, n_max), gammas (k,)")
    b, d = x.shape
    k, n_max, dq = q.shape
    if (dq != d or tuple(scale.shape) != (k, d) or tuple(zero.shape) != (k, d)
            or tuple(coef.shape) != (k, n_max) or gammas.shape[0] != k):
        raise ValueError(f"ensemble_score_q8: shapes {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)}, "
                         f"{tuple(coef.shape)}, {tuple(gammas.shape)} disagree")
    if k == 0:
        raise ValueError("ensemble_score_q8: empty ensemble")
    lib = native.library("ensemble_score")
    if lib.ensemble_score_smem_bytes(d) > native.MAX_SMEM_BYTES:
        raise ValueError(f"ensemble_score_q8: feature dim {d} needs more shared "
                         "memory than a block may take")
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    native.launch(LAUNCHES, x.device, lib.ensemble_score_q8_launch,
                  x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                  coef.data_ptr(), gammas.data_ptr(), out.data_ptr(), b, k, n_max, d)
    return out
