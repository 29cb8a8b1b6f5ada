"""Distillation configuration — one knob object for the whole subsystem.

Port of ``repro.distill.config``, with the same fields and defaults.
``DistillConfig`` travels through ``run_protocol(distill=...)``; solvers
and proxy sources resolve by name through their registries
(``repro_torch.distill.solvers.SOLVERS``,
``repro_torch.distill.proxy.PROXIES``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Server-side distillation of the selected ensemble (Eq. 3).

    proxy_size   number of unlabeled proxy points l (0 disables)
    solver       "dense" | "cg" | "nystrom" | "auto" (size-based pick)
    proxy        proxy-data source name from the proxy registry
    proxy_params source-specific params (e.g. scenario="dirichlet")
    codec        student DOWNLOAD wire codec; None -> the round's
                 upload codec (the student rides the same ledger)
    eps          ridge, RELATIVE to trace(K)/l (scale-free; the paper's
                 pure least squares is recovered as eps -> 0)
    landmarks    Nystrom landmark count m (also the student's support
                 size on that solver)
    tol          CG relative residual tolerance
    maxiter      CG iteration cap
    dense_max    "auto": largest l routed to the dense oracle
    nystrom_min  "auto": smallest l routed to Nystrom (between the two,
                 blocked CG streams the Gram)
    """

    proxy_size: int = 0
    solver: str = "auto"
    proxy: str = "validation"
    proxy_params: Mapping = dataclasses.field(default_factory=dict)
    codec: Optional[str] = None
    eps: float = 1e-6
    landmarks: int = 256
    tol: float = 1e-5
    maxiter: int = 256
    dense_max: int = 1024
    nystrom_min: int = 8192
