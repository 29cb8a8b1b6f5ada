"""Fused mean-of-member RBF-SVM scores from int8 supports: every
ensemble evaluation of an int8 round (``QuantizedStackedEnsemble``).

Replaces ``repro/kernels/ensemble_score_q8.py::ensemble_score_q8_pallas``.
It launches ``csrc/ensemble_score.cu``'s template (see
``ensemble_score``: the split plan, the 128-query x 64-support blocks,
partials summed in split order, no atomics) instantiated with the int8
loader of ``csrc/supports.cuh``. At d = 32 each warp copies its int8
rows of an item and the member's scale and zero rows raw with 16-byte
``cp.async`` and dequantises them from shared memory; the support norms
are of the dequantised values. Zero coefficients
annihilate padded rows, whose dequantised value (the zero point) is
finite. Returns sum / k. Past d 220 the chunked partials kernel (see
``ensemble_score``) rings each step's raw int8 chunks and the members'
scale and zero chunks by ``cp.async`` and dequantises them in shared
memory a step ahead of their use, with the same rounding.

Bound on the H100: fp32 operations, as ``ensemble_score`` (5.71 ms at
the full ensemble); the packed int8 ensemble is a quarter of the fp32
one's bytes.
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


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
           coef: torch.Tensor, gammas: torch.Tensor) -> tuple:
    """The inputs as the kernel reads them (``native.prepare``), their
    shapes checked."""
    x, q, scale, zero, coef, gammas = native.prepare(
        "ensemble_score_q8", x.device, dtypes={"q": torch.int8},
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
    return x, q, scale, zero, coef, gammas


def ensemble_score_q8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                           zero: torch.Tensor, coef: torch.Tensor,
                           gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ensemble_score.cu``'s int8 kernel on x's CUDA device
    (staged or chunked by d, as ``ensemble_score_cuda``)."""
    x, q, scale, zero, coef, gammas = _check(x, q, scale, zero, coef, gammas)
    lib = native.library("ensemble_score")
    return _ens.launch_scores("ensemble_score_q8", LAUNCHES, lib.ensemble_score_q8_launch, x,
                              (q, scale, zero), coef, gammas)


def ensemble_score_q8_chunked_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                                   zero: torch.Tensor, coef: torch.Tensor,
                                   gammas: torch.Tensor) -> torch.Tensor:
    """The chunked int8 partials kernel at any d, for holding it bit for
    bit to the staged one where both run; no path of the port calls it."""
    x, q, scale, zero, coef, gammas = _check(x, q, scale, zero, coef, gammas)
    lib = native.library("ensemble_score")
    return _ens.launch_scores("ensemble_score_q8", LAUNCHES,
                              lib.ensemble_score_q8_chunked_launch, x, (q, scale, zero), coef,
                              gammas)
