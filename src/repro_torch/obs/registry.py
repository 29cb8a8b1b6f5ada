"""Metrics registry — named counters and histograms, one collect().

A host-only copy of the core of ``repro.obs.registry``: the engine
increments the same dotted names (``engine.groups``,
``engine.devices_trained``, ``engine.group_seconds``) into the
process-wide ``default_registry()``; ``reset()`` it between measured
regions. ``collect()`` nests on the dots::

    reg = MetricsRegistry()
    reg.counter("engine.devices_trained").inc(512)
    reg.collect()
    # {"engine": {"devices_trained": {"type": "counter", "value": 512}}}

Histogram percentiles are nearest-rank: a reported p99 is always an
observation that actually happened.
"""
from __future__ import annotations

import math
from typing import Dict, List


def _nearest_rank(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    idx = max(0, min(len(sorted_xs) - 1,
                     math.ceil(q / 100.0 * len(sorted_xs)) - 1))
    return float(sorted_xs[idx])


class Counter:
    """Monotone running total."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        n = int(n)
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n

    def collect(self) -> Dict[str, object]:
        return {"type": "counter", "value": self.value}


class Histogram:
    """Observation set with count/sum/min/max/mean + nearest-rank
    percentiles (p50/p95/p99) at collect time."""

    __slots__ = ("observations",)
    kind = "histogram"

    def __init__(self):
        self.observations: List[float] = []

    def observe(self, v: float) -> None:
        self.observations.append(float(v))

    def collect(self) -> Dict[str, object]:
        xs = sorted(self.observations)
        n = len(xs)
        return {
            "type": "histogram",
            "count": n,
            "sum": float(sum(xs)),
            "min": xs[0] if n else 0.0,
            "max": xs[-1] if n else 0.0,
            "mean": float(sum(xs) / n) if n else 0.0,
            "p50": _nearest_rank(xs, 50),
            "p95": _nearest_rank(xs, 95),
            "p99": _nearest_rank(xs, 99),
        }


_KINDS = {"counter": Counter, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create named metrics; one nested dict out."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = _KINDS[kind]()
        elif m.kind != kind:
            raise TypeError(
                f"metric {name!r} is a {m.kind}, requested as {kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def reset(self) -> None:
        self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)

    def collect(self) -> Dict[str, object]:
        """Dotted names nested into one JSON-serializable dict."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            node = out
            *parents, leaf = name.split(".")
            for p in parents:
                nxt = node.setdefault(p, {})
                if not isinstance(nxt, dict) or "type" in nxt:
                    raise ValueError(
                        f"metric name {name!r} collides with metric {p!r}"
                    )
                node = nxt
            node[leaf] = self._metrics[name].collect()
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry hot paths increment into."""
    return _DEFAULT
