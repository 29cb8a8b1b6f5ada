"""Batched multi-l distillation — the fig-3 proxy sweep in one solve.

Port of ``repro.distill.sweep``:

  * every trial draws ONE proxy of l_max rows; smaller l are nested
    prefixes of that draw;
  * one ``kops.batched_rbf_gram`` call builds all T trial Grams at l_max;
  * each (trial, l) cell solves the MASKED system — rows/cols >= l are
    replaced by identity so the solve's support is exactly the prefix —
    in one batched ``torch.linalg.solve`` over all T x len(ls) cells.

The teacher is queried once per trial (at l_max); gamma is per trial
(the full draw's scale heuristic, on the host), shared across that
trial's prefixes so a single Gram serves every l.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.svm import SVMModel, default_gamma
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device


def _sweep_alphas(proxies: torch.Tensor, soft: torch.Tensor, gammas: torch.Tensor,
                  ls: Sequence[int], eps: float) -> torch.Tensor:
    """proxies (T, l_max, d), soft (T, l_max), gammas (T,) -> (T, len(ls),
    l_max) dual coefficients, zero outside each prefix."""
    K = kops.batched_rbf_gram(proxies, proxies, gammas)           # (T, l, l)
    l_max = K.shape[1]
    idx = torch.arange(l_max, device=K.device)
    masks = (idx[None, :] < torch.tensor(ls, device=K.device)[:, None]).to(K.dtype)
    # masked system per cell: prefix block of K, identity elsewhere; the
    # RBF diagonal is 1, so trace(K_masked)/l == 1 and the ridge is eps
    Km = K[:, None] * (masks[:, :, None] * masks[:, None, :])[None]   # (T, L, l, l)
    Km = Km + torch.diag_embed(torch.where(masks > 0, eps, 1.0))[None]
    rhs = soft[:, None, :] * masks[None]                               # (T, L, l)
    return torch.linalg.solve(Km, rhs.unsqueeze(-1)).squeeze(-1)


def distill_sweep(
    teacher_predict: Callable[[np.ndarray], np.ndarray],
    proxies: np.ndarray,
    ls: Sequence[int],
    gammas: Optional[np.ndarray] = None,
    eps: float = 1e-6,
    device="cuda",
) -> List[List[SVMModel]]:
    """Distill a teacher at every (trial, proxy-size) cell at once.

    proxies: (T, l_max, d) — one max-size draw per trial; ls: proxy
    sizes, each <= l_max (smaller sizes use the draw's prefix). Returns
    ``students[t][i]`` = the student distilled from ``proxies[t, :ls[i]]``.
    Rows within a trial must be distinct (prefixes are positional, so the
    masked solve cannot dedupe as ``distill_teacher`` does).
    """
    dev = resolve_device(device)
    proxies = np.asarray(proxies, np.float32)
    T, l_max, _ = proxies.shape
    ls = tuple(int(l) for l in ls)
    if any(l < 1 or l > l_max for l in ls):
        raise ValueError(f"every l in {ls} must be in [1, {l_max}]")
    if gammas is None:
        gammas = np.array([default_gamma(p) for p in proxies], np.float32)
    soft = np.stack([
        np.asarray(teacher_predict(p), np.float32) for p in proxies
    ])  # teacher queried once per trial, at l_max
    alphas = _sweep_alphas(
        torch.from_numpy(proxies).to(dev), torch.from_numpy(soft).to(dev),
        torch.from_numpy(np.asarray(gammas, np.float32)).to(dev), ls, float(eps),
    ).cpu().numpy()
    return [
        [
            SVMModel(support_x=proxies[t, :l], coef=alphas[t, i, :l],
                     gamma=float(gammas[t]), device=str(dev))
            for i, l in enumerate(ls)
        ]
        for t in range(T)
    ]
