"""repro_torch.agg — the registered server-side aggregator zoo.

See ``base`` for the registry/strategy contract, ``strategies`` for the
built-ins (mean / fisher / reweight / feature_stats), and ``round`` for
the shared wire + ledger integration (``build_cell``).
"""
from repro_torch.agg.base import (
    AGGREGATOR_REGISTRY,
    Aggregator,
    WeightedEnsemble,
    aggregator,
    get_aggregator,
)
from repro_torch.agg.round import build_cell
from repro_torch.agg.strategies import (
    FeatureStatsAggregator,
    FisherAggregator,
    MeanAggregator,
    ReweightAggregator,
    fisher_fuse_linear,
)

__all__ = [
    "AGGREGATOR_REGISTRY",
    "Aggregator",
    "WeightedEnsemble",
    "aggregator",
    "get_aggregator",
    "build_cell",
    "MeanAggregator",
    "FisherAggregator",
    "ReweightAggregator",
    "FeatureStatsAggregator",
    "fisher_fuse_linear",
]
