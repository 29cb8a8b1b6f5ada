"""Server-side distillation (Section 3, Eq. 3) — the SVM path.

Port of ``repro.core.distill.distill_svm``: given unlabeled proxy points
and the teacher's soft labels, fit a student kernel expansion by kernel
ridge regression (ridge relative to trace(K)/l, exact duplicate proxy
rows dropped first). The transformer distillation losses belong to the
LM deep path (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.svm import SVMModel


def distill_svm(
    teacher_predict: Callable[[np.ndarray], np.ndarray],
    proxy_x: np.ndarray,
    gamma: float,
    eps: float = 1e-6,
    solver: str = "dense",
    device="cuda",
) -> SVMModel:
    """Distill any teacher (ensemble) into a single kernel expansion on
    ``device``: ``repro_torch.distill.distill_teacher`` with the dense
    small-l oracle as the default solver."""
    from repro_torch.distill import DistillConfig, distill_teacher

    return distill_teacher(
        teacher_predict, proxy_x, gamma=gamma,
        cfg=DistillConfig(solver=solver, eps=eps), device=device,
    )
