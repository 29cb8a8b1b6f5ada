"""Registered server-side aggregation strategies.

Port of ``repro.agg.base``'s registry. An ``Aggregator`` turns the
decoded members of one (strategy, k) cell into the server scorer
(anything with ``predict(x, chunk=...)``). Only ``mean``, the paper's
server, is ported; strategies with device-side extras (fisher,
reweight, feature_stats) wait for ROADMAP queue 1 item 10.
"""
from __future__ import annotations

from typing import Dict, Sequence, Type

AGGREGATOR_REGISTRY: Dict[str, Type["Aggregator"]] = {}

_UNPORTED = ("fisher", "reweight", "feature_stats")


def aggregator(name: str):
    """Class decorator registering an ``Aggregator`` under ``name``."""

    def deco(cls: Type["Aggregator"]) -> Type["Aggregator"]:
        if name in AGGREGATOR_REGISTRY:
            raise ValueError(f"duplicate aggregator {name!r}")
        cls.name = name
        AGGREGATOR_REGISTRY[name] = cls
        return cls

    return deco


class Aggregator:
    """One entry of the aggregator registry."""

    name = "base"

    @property
    def spec(self) -> str:
        return self.name

    def build(self, members: Sequence, seed: int):
        """Decoded members -> server scorer."""
        raise NotImplementedError


def get_aggregator(spec) -> Aggregator:
    """Resolve ``"mean"`` / an Aggregator instance."""
    if isinstance(spec, Aggregator):
        return spec
    name, _, param = str(spec).partition(":")
    if name in _UNPORTED:
        raise NotImplementedError(
            f"aggregator {spec!r} is not ported yet (ROADMAP queue 1 item 10)")
    if name not in AGGREGATOR_REGISTRY:
        raise KeyError(
            f"unknown aggregator {spec!r}; options {sorted(AGGREGATOR_REGISTRY)}"
        )
    if param:
        raise ValueError(f"aggregator {name!r} takes no parameter")
    return AGGREGATOR_REGISTRY[name]()
