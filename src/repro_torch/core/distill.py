"""Server-side distillation (Section 3, Eq. 3) — the SVM path.

Port of ``repro.core.distill``: ``distill_svm`` fits a student kernel
expansion to the teacher's soft labels on unlabeled proxy points by
kernel ridge regression (ridge relative to trace(K)/l, exact duplicate
proxy rows dropped first); ``distill_loss_l2`` / ``distill_loss_kl``
are the transformer analogues of Eq. 3 over logits, in fp32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

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


# ----------------------------------------------------------------------
# transformer distillation losses
# ----------------------------------------------------------------------

def distill_loss_l2(student_logits, teacher_logits) -> torch.Tensor:
    """Eq. 3 analogue: L2 between prediction vectors."""
    diff = student_logits.float() - teacher_logits.float()
    return torch.mean(torch.square(diff))


def distill_loss_kl(student_logits, teacher_logits, temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) at temperature T (Hinton et al. 2015)."""
    t = temperature
    tp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    return torch.mean(torch.sum(torch.exp(tp) * (tp - sp), dim=-1)) * t * t


DISTILL_LOSSES = {"l2": distill_loss_l2, "kl": distill_loss_kl}
