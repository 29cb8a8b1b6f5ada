"""Budget-constrained device selection (greedy knapsack).

Port of ``repro.comm.budget``, unchanged in behaviour (numpy and Python
only).

Under a communication budget, ensemble quality is a selection problem
(Allouah et al., 2024): which k models fit the pipe matters as much as
which k score best. This module composes a byte budget with the
existing ``core/selection.py`` strategies:

  * the STRATEGY defines admissibility and the preference order —
    cv's val-AUC ranking, data's n_train ranking, random's seeded draw;
  * the BUDGET is packed greedily in that preference order, skipping
    candidates whose encoded size no longer fits — for cv this is
    exactly the value-greedy knapsack over (val_auc, encoded-size)
    pairs, and for every strategy a budget that binds nobody changes
    nothing.

Rank order (not value/size density) is deliberate: density packing
would re-rank the strategy's preferences even under a slack budget —
turning 'random' into a deterministic cheap-first pick — whereas
rank-greedy degrades to exactly ``select(strategy, ...)[:k]`` whenever
the budget is loose, keeping the unbudgeted protocol unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.selection import DeviceReport, select


@dataclasses.dataclass(frozen=True)
class BudgetedSelection:
    """Outcome of one budgeted pick: who uploads, what it costs, and
    which admissible candidates the budget squeezed out."""

    ids: List[int]
    total_bytes: int
    budget_bytes: Optional[int]
    skipped: Tuple[int, ...]  # admissible, ranked, but unaffordable

    @property
    def k(self) -> int:
        return len(self.ids)


def pack_ranked(
    ranked: Sequence[int],
    k: int,
    sizes: Mapping[int, int],
    budget_bytes: Optional[int] = None,
) -> BudgetedSelection:
    """Greedy pack of an already-ranked candidate list under the byte
    budget — the knapsack core, shared by the report-based
    ``budgeted_select`` and the streamed round's column-based picks."""
    if budget_bytes is None:
        ids = list(ranked[:k])
        return BudgetedSelection(
            ids, sum(int(sizes[i]) for i in ids), None, tuple(ranked[k:])
        )
    # greedy in strategy-rank order with skip: once the budget shrinks
    # past a candidate it stays unaffordable (budget is monotone), so a
    # single pass is exhaustive
    remaining = int(budget_bytes)
    ids: List[int] = []
    skipped: List[int] = []
    for dev in ranked:
        cost = int(sizes[dev])
        if len(ids) < k and cost <= remaining:
            ids.append(dev)
            remaining -= cost
        else:
            skipped.append(dev)
    return BudgetedSelection(
        ids, int(budget_bytes) - remaining, int(budget_bytes), tuple(skipped)
    )


def budgeted_select(
    strategy: str,
    reports: Sequence[DeviceReport],
    k: int,
    sizes: Mapping[int, int],
    budget_bytes: Optional[int] = None,
    **strategy_kw,
) -> BudgetedSelection:
    """Pick <= k devices whose encoded uploads fit ``budget_bytes``.

    ``sizes`` maps device_id -> exact wire-encoded payload size (from
    ``repro.comm.wire``); every admissible candidate must be priced.
    """
    ranked = select(strategy, reports, len(reports), **strategy_kw)
    return pack_ranked(ranked, k, sizes, budget_bytes)
