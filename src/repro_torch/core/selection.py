"""Ensemble selection strategies (Section 3).

Port of ``repro.core.selection``. Devices below the dataset's min-sample
threshold never participate; strategies choose k <= m of the eligible
local models, and only selected devices upload. Ranking is host
arithmetic, identical to the reference's.

Two equivalent entry points: ``select`` ranks a sequence of
``DeviceReport`` objects (the materialised rounds), and
``select_from_columns`` ranks the same scalars held as numpy columns
(``ReportColumns``), the streamed round's representation: a few bytes
a device instead of an object a device at 10^6 scale. The two give the
same ids in the same order.
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


# ----------------------------------------------------------------------
# column representation (the streamed round's server-side state)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ReportColumns:
    """The population's ``DeviceReport`` scalars as parallel arrays, in
    device-id order — everything the server knows pre-upload, at a few
    bytes per device. This is the ONLY per-device state the streamed
    round retains for the whole population."""

    ids: np.ndarray        # (m,) int64 device ids, ascending
    n_train: np.ndarray    # (m,) int64
    val_auc: np.ndarray    # (m,) float64
    eligible: np.ndarray   # (m,) bool

    def __len__(self) -> int:
        return len(self.ids)

    @classmethod
    def from_reports(cls, reports: Sequence[DeviceReport]) -> "ReportColumns":
        order = sorted(range(len(reports)), key=lambda i: reports[i].device_id)
        return cls(
            ids=np.array([reports[i].device_id for i in order], np.int64),
            n_train=np.array([reports[i].n_train for i in order], np.int64),
            val_auc=np.array([reports[i].val_auc for i in order], np.float64),
            eligible=np.array([reports[i].eligible for i in order], bool),
        )

    def report(self, device_id: int) -> DeviceReport:
        """Rehydrate one device's report (e.g. for logging)."""
        p = int(np.searchsorted(self.ids, device_id))
        if p >= len(self.ids) or self.ids[p] != device_id:
            raise KeyError(f"device {device_id} not in columns")
        return DeviceReport(
            int(self.ids[p]), int(self.n_train[p]),
            float(self.val_auc[p]), bool(self.eligible[p]),
        )


def select_from_columns(
    strategy: str, cols: ReportColumns, k: int, *,
    seed: int = 0, auc_baseline: float = 0.5, min_train: int = 0,
) -> List[int]:
    """``select`` over columns: identical ids in identical order.

    The sort keys mirror the report-based strategies exactly —
    ``np.lexsort``'s LAST key is primary, so ``(ids, -metric)`` is the
    ``(-metric, device_id)`` tuple sort — and the random draw permutes
    the same ascending eligible-id array with the same generator state.
    """
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; options {sorted(STRATEGIES)}")
    if strategy == "cv":
        mask = cols.eligible & (cols.val_auc >= auc_baseline)
        order = np.lexsort((cols.ids[mask], -cols.val_auc[mask]))
    elif strategy == "data":
        mask = cols.eligible & (cols.n_train >= min_train)
        order = np.lexsort((cols.ids[mask], -cols.n_train[mask]))
    else:  # random
        cands = cols.ids[cols.eligible]
        rng = np.random.default_rng(seed)
        return [int(i) for i in rng.permutation(cands)[:k]]
    return [int(i) for i in cols.ids[mask][order][:k]]
