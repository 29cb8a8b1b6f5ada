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
feature chunks, 32-query blocks) and the tolerance the parity tests and
``chip_smoke.py`` hold the pair to. ``replaces`` names the TPU kernel
(or, for SDCA, the XLA loop) each entry ports.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.kernels import batched_gram, ensemble_score as _ens, rbf_gram as _rbf, sdca as _sdca


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


def sdca(K, y, n_real, lam: float, epochs: int = 20):
    """Batched cyclic SDCA: K (g, b, b), y (g, b), n_real (g,) int32 ->
    alpha (g, b)."""
    if _on_cuda(K, "sdca"):
        return _sdca.sdca_cuda(K, y, n_real, lam, epochs)
    return _sdca.sdca_plain(K, y, n_real, lam, epochs)


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
    )
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per registered kernel since the last reset."""
    return {name: spec.counter.count for name, spec in KERNEL_REGISTRY.items()}


def reset_launch_counts() -> None:
    for spec in KERNEL_REGISTRY.values():
        spec.counter.reset()
