"""Kernel-ridge solvers for server-side distillation (Eq. 3 at scale).

Port of ``repro.distill.solvers``. The distillation objective is kernel
ridge regression on the teacher's soft labels over l proxy points:

    min_alpha (1/l) ||K alpha - soft||^2 + eps' alpha^T K alpha,
    K_ij = exp(-gamma ||x'_i - x'_j||^2),  eps' = eps * trace(K)/l

Solvers, registered by name and picked by ``DistillConfig.solver``; each
runs on ``device`` (the plain versions of the kernels on the CPU):

  dense    ``kops.rbf_gram`` for K, one ``torch.linalg.solve``: the
           small-l oracle.
  cg       conjugate gradient on (K + eps I) alpha = soft, its matvec
           ``kops.gram_matvec`` (the (l, l) Gram never exists). The loop
           runs on the device with one host check of the residual per
           iteration; the stopping rule and the 1e-30 floors are the
           reference's.
  nystrom  m seeded landmarks Z; the normal equations
           (Kxz^T Kxz + l eps Kzz) beta = Kxz^T soft, their products
           ``torch.matmul`` in fp32 (TF32 off on the card), the solve in
           fp64. The student shrinks to the m landmarks.
  auto     dense for l <= dense_max, nystrom for l >= nystrom_min, cg
           in between.

``distill_teacher`` dedupes the proxy, derives gamma on the host exactly
as the reference does, queries the teacher once and dispatches.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.svm import SVMModel, default_gamma
from repro_torch.distill.config import DistillConfig
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import current_tracer
from repro_torch.utils.device import resolve_device

# the reference's stream tags: the same seed gives the same proxy draw and
# the same landmarks in both packages
DISTILL_STREAM = 0xD157
_PROXY_KEY = 0
_LANDMARK_KEY = 1


def distill_rng(seed: int) -> np.random.Generator:
    """The proxy draw's own SeedSequence-derived stream — independent
    of how many draws other protocol stages consumed before it."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, DISTILL_STREAM, _PROXY_KEY])
    )


def _landmark_rng(seed: int) -> np.random.Generator:
    """Nystrom landmark stream, keyed apart from the proxy draw."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, DISTILL_STREAM, _LANDMARK_KEY])
    )


SolverFn = Callable[..., SVMModel]
SOLVERS: Dict[str, SolverFn] = {}


def register_solver(name: str) -> Callable[[SolverFn], SolverFn]:
    def deco(fn: SolverFn) -> SolverFn:
        if name in SOLVERS:
            raise ValueError(f"solver {name!r} already registered")
        SOLVERS[name] = fn
        return fn
    return deco


def get_solver(name: str) -> SolverFn:
    if name not in SOLVERS:
        raise KeyError(f"unknown distill solver {name!r}; options {sorted(SOLVERS)}")
    return SOLVERS[name]


def list_solvers() -> Dict[str, str]:
    """name -> first docstring line, for --help style listings."""
    return {
        name: ((fn.__doc__ or "").strip().splitlines() or ["(undocumented)"])[0]
        for name, fn in sorted(SOLVERS.items())
    }


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def _student(support_x: np.ndarray, coef: torch.Tensor, gamma: float,
             dev: torch.device) -> SVMModel:
    return SVMModel(support_x=np.asarray(support_x, np.float32),
                    coef=coef.cpu().numpy().astype(np.float32), gamma=float(gamma),
                    device=str(dev))


@register_solver("dense")
def dense_solve(soft, xp, gamma: float, cfg: DistillConfig, seed: int = 0,
                device="cuda") -> SVMModel:
    """Materialized-Gram LU solve — the small-l oracle."""
    dev = resolve_device(device)
    x = _on(xp, dev)
    K = kops.rbf_gram(x, x, float(gamma))
    l = K.shape[0]
    ridge = cfg.eps * torch.trace(K) / l  # scale-free: eps relative to mean diag
    eye = torch.eye(l, dtype=K.dtype, device=dev)
    alpha = torch.linalg.solve(K + ridge * eye, _on(soft, dev))
    return _student(xp, alpha, gamma, dev)


def _cg_alpha(x: torch.Tensor, b: torch.Tensor, gamma: float, eps: float,
              tol: float, maxiter: int) -> torch.Tensor:
    """CG on (K + eps I) alpha = b with the streamed Gram matvec. The RBF
    diagonal is exp(0) = 1, so trace(K)/l == 1 and the relative ridge is
    just ``eps``. Stops when ``k < maxiter and rs > tol^2 max(|b|^2,
    1e-30)`` fails, as the reference's ``while_loop`` does; the
    iteration count goes to the tracer as a ``distill.cg`` instant."""
    bnorm2 = torch.dot(b, b)
    stop2 = (tol * tol) * torch.clamp(bnorm2, min=1e-30)
    alpha, r, p, rs = torch.zeros_like(b), b.clone(), b.clone(), bnorm2
    k = 0
    while k < maxiter and bool(rs > stop2):
        Ap = kops.gram_matvec(x, x, p, gamma) + eps * p
        a = rs / torch.clamp(torch.dot(p, Ap), min=1e-30)
        alpha = alpha + a * p
        r = r - a * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
        k += 1
    current_tracer().instant("distill.cg", cat="distill", iterations=k)
    return alpha


@register_solver("cg")
def cg_solve(soft, xp, gamma: float, cfg: DistillConfig, seed: int = 0,
             device="cuda") -> SVMModel:
    """Blocked CG — streams tiled Gram blocks, O(l*d) memory."""
    dev = resolve_device(device)
    alpha = _cg_alpha(_on(xp, dev), _on(soft, dev), float(gamma), cfg.eps, cfg.tol,
                      cfg.maxiter)
    return _student(xp, alpha, gamma, dev)


@register_solver("nystrom")
def nystrom_solve(soft, xp, gamma: float, cfg: DistillConfig, seed: int = 0,
                  device="cuda") -> SVMModel:
    """Landmark solver for l >> 10^3; student support = m landmarks."""
    dev = resolve_device(device)
    l = len(xp)
    m = min(cfg.landmarks, l)
    idx = _landmark_rng(seed).choice(l, m, replace=False)
    z = np.asarray(xp, np.float32)[np.sort(idx)]
    x, zt = _on(xp, dev), _on(z, dev)
    Kxz = kops.rbf_gram(x, zt, float(gamma))   # (l, m) — tall-thin, never (l, l)
    Kzz = kops.rbf_gram(zt, zt, float(gamma))  # (m, m)
    A = Kxz.T @ Kxz
    # l*eps*Kzz is the RKHS ridge; the trace jitter guards duplicate or
    # near-duplicate landmark draws
    eye = torch.eye(m, dtype=A.dtype, device=dev)
    reg = l * cfg.eps * Kzz + (1e-7 * torch.trace(A) / m) * eye
    # solved in fp64: the system's condition reaches ~1e6 (2.4e6 on emnist's
    # 4,096 proxy rows), where an fp32 LU's answer moves with the host's
    # thread count by ~1e-2
    beta = torch.linalg.solve((A + reg).double(), (Kxz.T @ _on(soft, dev)).double()).float()
    return _student(z, beta, gamma, dev)


@register_solver("auto")
def auto_solve(soft, xp, gamma: float, cfg: DistillConfig, seed: int = 0,
               device="cuda") -> SVMModel:
    """Size-based dispatch: dense <= dense_max < cg < nystrom_min <= nystrom."""
    l = len(xp)
    if l <= cfg.dense_max:
        return dense_solve(soft, xp, gamma, cfg, seed, device)
    if l < cfg.nystrom_min:
        return cg_solve(soft, xp, gamma, cfg, seed, device)
    return nystrom_solve(soft, xp, gamma, cfg, seed, device)


def dedupe_proxy(proxy_x: np.ndarray) -> np.ndarray:
    """Drop exact duplicate proxy rows (sorted-unique order): each
    duplicate pair makes the ridge-free Gram exactly singular."""
    return np.unique(np.asarray(proxy_x, np.float32), axis=0)


def distill_teacher(
    teacher_predict: Callable[[np.ndarray], np.ndarray],
    proxy_x: np.ndarray,
    gamma: Optional[float] = None,
    cfg: DistillConfig = DistillConfig(),
    seed: int = 0,
    device="cuda",
) -> SVMModel:
    """Distill any teacher into a single kernel expansion on proxy data.

    Dedupes the proxy, derives gamma (sklearn 'scale' heuristic, on the
    host) when not given, queries the teacher ONCE for soft labels, and
    dispatches the configured solver on ``device``. The student's support
    set is proxy data only.
    """
    xp = dedupe_proxy(proxy_x)
    if gamma is None:
        gamma = default_gamma(xp)
    soft = np.asarray(teacher_predict(xp), np.float32)
    return get_solver(cfg.solver)(soft, xp, gamma, cfg, seed, device)
