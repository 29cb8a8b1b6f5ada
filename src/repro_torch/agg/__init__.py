"""repro_torch.agg — the server-side aggregator registry (``mean``)."""
from repro_torch.agg.base import (
    AGGREGATOR_REGISTRY,
    Aggregator,
    aggregator,
    get_aggregator,
)
from repro_torch.agg.round import build_cell
from repro_torch.agg.strategies import MeanAggregator

__all__ = [
    "AGGREGATOR_REGISTRY",
    "Aggregator",
    "aggregator",
    "get_aggregator",
    "build_cell",
    "MeanAggregator",
]
