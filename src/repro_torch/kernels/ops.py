"""Kernel dispatch and registry of the port.

Dispatch policy: a call whose tensors lie on the CPU runs the kernel's
plain PyTorch version; a call whose tensors lie on a CUDA device
launches the hand-written kernel, which raises if it cannot take the
inputs. There is no fallback from one to the other.

``KERNEL_REGISTRY`` mirrors ``repro/kernels/ops.py``'s: each entry holds
the kernel, its plain version, the dispatcher, ``make_inputs(rng)`` (a
positional numpy argument tuple the reference's dispatcher of the same
name also accepts, SDCA aside), ``make_ragged(rng)`` (the same on shapes
off every tile multiple of the CUDA kernels: 64-row tiles, 32-wide
feature chunks, 32-query and 32-row blocks, 64-support tiles, 64-row
query and key tiles) and the
tolerance the parity tests and ``chip_smoke.py`` hold the pair to. ``replaces`` names the TPU kernel
(or, for SDCA, the XLA loop) each entry ports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.kernels import batched_gram, ensemble_score as _ens, rbf_gram as _rbf, sdca as _sdca
from repro_torch.kernels import ensemble_score_q8 as _ens_q8, gram_matvec as _gmv
from repro_torch.kernels import flash_attention as _flash, rbf_gram_q8 as _q8


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def batched_rbf_gram(x1, x2, gammas):
    """Per-device RBF Grams: x1 (g, m, d), x2 (g, n, d), gammas (g,) ->
    (g, m, n) fp32. Callers mask padded rows/cols themselves."""
    if _on_cuda(x1, "batched_rbf_gram"):
        return batched_gram.batched_rbf_gram_cuda(x1, x2, gammas)
    return batched_gram.batched_rbf_gram_plain(x1, x2, gammas)


def rbf_gram(x1, x2, gamma: float):
    """RBF Gram for one bandwidth: x1 (m, d), x2 (n, d) -> (m, n) fp32."""
    if _on_cuda(x1, "rbf_gram"):
        return _rbf.rbf_gram_cuda(x1, x2, gamma)
    return _rbf.rbf_gram_plain(x1, x2, gamma)


def ensemble_score(x, sup, coef, gammas):
    """Mean-of-member RBF-SVM scores: x (b, d), sup (k, n_max, d),
    coef (k, n_max), gammas (k,) -> (b,) fp32."""
    if _on_cuda(x, "ensemble_score"):
        return _ens.ensemble_score_cuda(x, sup, coef, gammas)
    return _ens.ensemble_score_plain(x, sup, coef, gammas)


def gram_matvec(x1, x2, v, gamma: float):
    """Streaming ``K(x1, x2; gamma) @ v``: x1 (m, d), x2 (n, d), v (n,)
    -> (m,) fp32, without the (m, n) Gram."""
    if _on_cuda(x1, "gram_matvec"):
        return _gmv.gram_matvec_cuda(x1, x2, v, gamma)
    return _gmv.gram_matvec_plain(x1, x2, v, gamma)


def rbf_gram_q8(x, q, scale, zero, gamma: float):
    """RBF Gram against per-column affine int8 supports: x (m, d) fp32,
    q (n, d) int8, scale and zero (d,) -> (m, n) fp32."""
    if _on_cuda(x, "rbf_gram_q8"):
        return _q8.rbf_gram_q8_cuda(x, q, scale, zero, gamma)
    return _q8.rbf_gram_q8_plain(x, q, scale, zero, gamma)


def ensemble_score_q8(x, q, scale, zero, coef, gammas):
    """Mean-of-member scores from int8 supports: x (b, d), q (k, n_max, d)
    int8, scale and zero (k, d), coef (k, n_max), gammas (k,) -> (b,)."""
    if _on_cuda(x, "ensemble_score_q8"):
        return _ens_q8.ensemble_score_q8_cuda(x, q, scale, zero, coef, gammas)
    return _ens_q8.ensemble_score_q8_plain(x, q, scale, zero, coef, gammas)


def sdca(K, y, n_real, lam: float, epochs: int = 20):
    """Batched cyclic SDCA: K (g, b, b), y (g, b), n_real (g,) int32 ->
    alpha (g, b)."""
    if _on_cuda(K, "sdca"):
        return _sdca.sdca_cuda(K, y, n_real, lam, epochs)
    return _sdca.sdca_plain(K, y, n_real, lam, epochs)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """GQA attention: q (B, Sq, H, hd), k and v (B, Skv, K, hd) ->
    (B, Sq, H, hd) in q's dtype, with causal and sliding-window masks."""
    if _on_cuda(q, "flash_attention"):
        return _flash.flash_attention_cuda(q, k, v, causal, window)
    return _flash.flash_attention_plain(q, k, v, causal, window)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One ported kernel: CUDA wrapper + plain version + dispatcher."""

    name: str
    kernel: Callable
    plain: Callable
    dispatch: Callable
    make_inputs: Callable[[np.random.Generator], tuple]
    make_ragged: Callable[[np.random.Generator], tuple]
    counter: object
    replaces: str
    source: str
    tol: float = 1e-5


def _mk_rbf_gram(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.normal(size=(40, 12)).astype(np.float32), 0.4)


def _mk_batched_rbf_gram(rng):
    return (rng.normal(size=(4, 48, 12)).astype(np.float32),
            rng.normal(size=(4, 40, 12)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=4).astype(np.float32))


def _mk_ensemble_score(rng):
    return (rng.normal(size=(40, 12)).astype(np.float32),
            rng.normal(size=(3, 48, 12)).astype(np.float32),
            (rng.normal(size=(3, 48)) / 48).astype(np.float32),
            rng.uniform(0.1, 1.0, size=3).astype(np.float32))


def _mk_gram_matvec(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.normal(size=(40, 12)).astype(np.float32),
            rng.normal(size=(40,)).astype(np.float32), 0.4)


def _mk_rbf_gram_q8(rng):
    return (rng.normal(size=(48, 12)).astype(np.float32),
            rng.integers(-127, 128, size=(40, 12)).astype(np.int8),
            rng.uniform(0.005, 0.1, size=12).astype(np.float32),
            rng.normal(size=12).astype(np.float32), 0.4)


def _mk_ensemble_score_q8(rng):
    return (rng.normal(size=(40, 12)).astype(np.float32),
            rng.integers(-127, 128, size=(3, 48, 12)).astype(np.int8),
            rng.uniform(0.005, 0.05, size=(3, 12)).astype(np.float32),
            rng.normal(size=(3, 12)).astype(np.float32),
            (rng.normal(size=(3, 48)) / 48).astype(np.float32),
            rng.uniform(0.1, 1.0, size=3).astype(np.float32))


def make_sdca_problem(rng, g: int, b: int, d: int, n_real, lam: float = 0.01,
                      epochs: int = 20) -> tuple:
    """A padded batch of SDCA problems as the engine builds them: masked
    RBF Grams of random data, labels padded with +1, int32 counts."""
    n_real = np.asarray(n_real, np.int32)
    x = rng.normal(size=(g, b, d)).astype(np.float32)
    y = np.where(rng.random((g, b)) < 0.5, 1.0, -1.0).astype(np.float32)
    gam = np.float32(1.0 / d)
    sq = (x * x).sum(-1)
    d2 = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * x @ x.transpose(0, 2, 1), 0.0)
    K = np.exp(-gam * d2).astype(np.float32)
    valid = np.arange(b)[None, :] < n_real[:, None]
    K = K * (valid[:, :, None] & valid[:, None, :])
    y = np.where(valid, y, np.float32(1.0)).astype(np.float32)
    return K.astype(np.float32), y, n_real, lam, epochs


def _mk_sdca(rng):
    return make_sdca_problem(rng, g=3, b=64, d=12, n_real=[64, 40, 17])


def _ragged_rbf_gram(rng):
    return (rng.normal(size=(130, 37)).astype(np.float32),
            rng.normal(size=(67, 37)).astype(np.float32), 0.03)


def _ragged_batched_rbf_gram(rng):
    return (rng.normal(size=(3, 77, 24)).astype(np.float32),
            rng.normal(size=(3, 45, 24)).astype(np.float32),
            rng.uniform(0.02, 0.2, size=3).astype(np.float32))


def _ragged_ensemble_score(rng):
    return (rng.normal(size=(37, 24)).astype(np.float32),
            rng.normal(size=(5, 77, 24)).astype(np.float32),
            (rng.normal(size=(5, 77)) / 77).astype(np.float32),
            rng.uniform(0.02, 0.2, size=5).astype(np.float32))


def _ragged_gram_matvec(rng):
    return (rng.normal(size=(77, 37)).astype(np.float32),
            rng.normal(size=(131, 37)).astype(np.float32),
            rng.normal(size=(131,)).astype(np.float32), 0.03)


def _ragged_rbf_gram_q8(rng):
    return (rng.normal(size=(130, 37)).astype(np.float32),
            rng.integers(-127, 128, size=(67, 37)).astype(np.int8),
            rng.uniform(0.002, 0.02, size=37).astype(np.float32),
            rng.normal(size=37).astype(np.float32), 0.03)


def _ragged_ensemble_score_q8(rng):
    return (rng.normal(size=(37, 24)).astype(np.float32),
            rng.integers(-127, 128, size=(5, 77, 24)).astype(np.int8),
            rng.uniform(0.002, 0.02, size=(5, 24)).astype(np.float32),
            rng.normal(size=(5, 24)).astype(np.float32),
            (rng.normal(size=(5, 77)) / 77).astype(np.float32),
            rng.uniform(0.02, 0.2, size=5).astype(np.float32))


def _mk_flash_attention(rng):
    return tuple(rng.normal(size=(4, 64, 2, 16)).astype(np.float32) for _ in range(3))


def _ragged_flash_attention(rng):
    return (rng.normal(size=(2, 77, 6, 32)).astype(np.float32),
            rng.normal(size=(2, 77, 2, 32)).astype(np.float32),
            rng.normal(size=(2, 77, 2, 32)).astype(np.float32))


def _ragged_sdca(rng):
    return make_sdca_problem(rng, g=4, b=100, d=24, n_real=[100, 63, 1, 31])


KERNEL_REGISTRY: Dict[str, KernelSpec] = {
    spec.name: spec
    for spec in (
        KernelSpec("batched_rbf_gram", batched_gram.batched_rbf_gram_cuda,
                   batched_gram.batched_rbf_gram_plain, batched_rbf_gram,
                   _mk_batched_rbf_gram, _ragged_batched_rbf_gram, batched_gram.LAUNCHES,
                   replaces="src/repro/kernels/batched_gram.py:54",
                   source="src/repro_torch/kernels/csrc/gram.cu"),
        KernelSpec("rbf_gram", _rbf.rbf_gram_cuda, _rbf.rbf_gram_plain, rbf_gram,
                   _mk_rbf_gram, _ragged_rbf_gram, _rbf.LAUNCHES,
                   replaces="src/repro/kernels/rbf_gram.py:35",
                   source="src/repro_torch/kernels/csrc/gram.cu"),
        KernelSpec("ensemble_score", _ens.ensemble_score_cuda,
                   _ens.ensemble_score_plain, ensemble_score,
                   _mk_ensemble_score, _ragged_ensemble_score, _ens.LAUNCHES,
                   replaces="src/repro/kernels/ensemble_score.py:74",
                   source="src/repro_torch/kernels/csrc/ensemble_score.cu",
                   tol=1e-4),
        KernelSpec("sdca", _sdca.sdca_cuda, _sdca.sdca_plain, sdca, _mk_sdca,
                   _ragged_sdca, _sdca.LAUNCHES, replaces="src/repro/core/svm.py:45",
                   source="src/repro_torch/kernels/csrc/sdca.cu"),
        KernelSpec("gram_matvec", _gmv.gram_matvec_cuda, _gmv.gram_matvec_plain,
                   gram_matvec, _mk_gram_matvec, _ragged_gram_matvec, _gmv.LAUNCHES,
                   replaces="src/repro/kernels/gram_matvec.py:65",
                   source="src/repro_torch/kernels/csrc/gram_matvec.cu"),
        KernelSpec("rbf_gram_q8", _q8.rbf_gram_q8_cuda, _q8.rbf_gram_q8_plain,
                   rbf_gram_q8, _mk_rbf_gram_q8, _ragged_rbf_gram_q8, _q8.LAUNCHES,
                   replaces="src/repro/kernels/rbf_gram_q8.py:53",
                   source="src/repro_torch/kernels/csrc/gram.cu"),
        KernelSpec("ensemble_score_q8", _ens_q8.ensemble_score_q8_cuda,
                   _ens_q8.ensemble_score_q8_plain, ensemble_score_q8,
                   _mk_ensemble_score_q8, _ragged_ensemble_score_q8, _ens_q8.LAUNCHES,
                   replaces="src/repro/kernels/ensemble_score_q8.py:72",
                   source="src/repro_torch/kernels/csrc/ensemble_score.cu",
                   tol=1e-4),
        KernelSpec("flash_attention", _flash.flash_attention_cuda,
                   _flash.flash_attention_plain, flash_attention,
                   _mk_flash_attention, _ragged_flash_attention, _flash.LAUNCHES,
                   replaces="src/repro/kernels/flash_attention.py:68",
                   source="src/repro_torch/kernels/csrc/flash_attention.cu",
                   tol=2e-5),
    )
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per registered kernel since the last reset."""
    return {name: spec.counter.count for name, spec in KERNEL_REGISTRY.items()}


def reset_launch_counts() -> None:
    for spec in KERNEL_REGISTRY.values():
        spec.counter.reset()
