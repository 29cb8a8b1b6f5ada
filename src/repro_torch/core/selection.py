"""Ensemble selection strategies (Section 3).

Port of ``repro.core.selection``'s report-based strategies. Devices
below the dataset's min-sample threshold never participate; strategies
choose k <= m of the eligible local models, and only selected devices
upload. Ranking is host arithmetic, identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class DeviceReport:
    """What the server knows about a device before any model upload
    (scalars only — the cheap pre-round metadata exchange)."""

    device_id: int
    n_train: int
    val_auc: float
    eligible: bool


def cv_selection(
    reports: Sequence[DeviceReport], k: int, auc_baseline: float = 0.5
) -> List[int]:
    """Cross-Validation selection: devices whose validation AUC clears
    the baseline; the server keeps the k best performers."""
    cands = [r for r in reports if r.eligible and r.val_auc >= auc_baseline]
    cands.sort(key=lambda r: (-r.val_auc, r.device_id))
    return [r.device_id for r in cands[:k]]


def data_selection(
    reports: Sequence[DeviceReport], k: int, min_train: int = 0
) -> List[int]:
    """Data selection: the server keeps the k largest local datasets."""
    cands = [r for r in reports if r.eligible and r.n_train >= min_train]
    cands.sort(key=lambda r: (-r.n_train, r.device_id))
    return [r.device_id for r in cands[:k]]


def random_selection(
    reports: Sequence[DeviceReport], k: int, seed: int = 0
) -> List[int]:
    """Random selection: k eligible devices in the seeded draw order."""
    cands = [r.device_id for r in reports if r.eligible]
    rng = np.random.default_rng(seed)
    return [int(i) for i in rng.permutation(cands)[:k]]


STRATEGIES = {
    "cv": cv_selection,
    "data": data_selection,
    "random": random_selection,
}


def select(strategy: str, reports: Sequence[DeviceReport], k: int, **kw) -> List[int]:
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; options {sorted(STRATEGIES)}")
    return STRATEGIES[strategy](reports, k, **kw)
