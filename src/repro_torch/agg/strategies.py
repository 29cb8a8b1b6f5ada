"""The ported aggregator: mean."""
from __future__ import annotations

from typing import Sequence

from repro_torch.agg.base import Aggregator, aggregator
from repro_torch.core.ensemble import Ensemble


@aggregator("mean")
class MeanAggregator(Aggregator):
    """The paper's server: F_k(x) = mean_t f_t(x), the plain
    ``Ensemble`` of the decoded members."""

    def build(self, members: Sequence, seed: int):
        return Ensemble(list(members))
