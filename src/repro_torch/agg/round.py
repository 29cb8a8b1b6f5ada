"""One aggregation cell: the decoded members of the picked ids, built
into the server scorer.

Port of ``repro.agg.round.build_cell`` for aggregators without
device-side extras (the only kind ported), so no extra rides the wire
or the ledger here.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.agg.base import Aggregator


def build_cell(agg: Aggregator, ex, ids: Sequence[int], seed: int):
    """Build one (strategy, k) cell's server scorer from ``ex``'s
    decoded uploads (a ``comm.ModelExchange``)."""
    return agg.build([ex.received(i) for i in ids], seed)
