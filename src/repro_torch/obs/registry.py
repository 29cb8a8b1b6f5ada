"""Metrics registry — named counters/gauges/histograms, one collect().

A host-only copy of ``repro.obs.registry``: the engine increments the
same dotted names (``engine.groups``, ``engine.devices_trained``,
``engine.group_seconds``) into the process-wide ``default_registry()``;
``reset()`` it between measured regions. The metric silos —
``comm.CommLedger`` (exact wire bytes), ``fleet.FleetMetrics`` (SLO
accounting) and ``serve.SchedulerStats`` (batching and cache tallies) —
keep their own accounting and export through the adapters below into
one schema-versioned ``envelope()``, the reference's shape.
``collect()`` nests on the dots::

    reg = MetricsRegistry()
    reg.counter("engine.devices_trained").inc(512)
    reg.collect()
    # {"engine": {"devices_trained": {"type": "counter", "value": 512}}}

Histogram percentiles are nearest-rank: a reported p99 is always an
observation that actually happened.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional

SCHEMA_VERSION = 1
SCHEMA = "repro.obs/v1"


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


class Gauge:
    """Last-set value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def collect(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self.value}


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


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


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

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

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


# ----------------------------------------------------------------------
# silo adapters: the existing exact accountings, under one envelope
# ----------------------------------------------------------------------

def comm_section(ledger) -> Dict[str, object]:
    """``comm.CommLedger`` -> envelope section: its exact per-tag byte
    summary, the message count and the representation."""
    return {
        "summary": ledger.summary(),
        "messages": len(ledger),
        "compact": bool(ledger.compact),
    }


def fleet_section(summary: Mapping) -> Dict[str, object]:
    """``fleet.FleetMetrics.summary()`` (or ``ServeFleet.summary()``)
    output -> envelope section, verbatim."""
    return dict(summary)


def scheduler_section(stats: Iterable) -> Dict[str, object]:
    """``serve.SchedulerStats`` instances (e.g. one per cache shard) ->
    summed counter dict plus the shard count."""
    stats = list(stats)
    total: Dict[str, int] = {}
    for s in stats:
        for k, v in dataclasses.asdict(s).items():
            total[k] = total.get(k, 0) + int(v)
    total["shards"] = len(stats)
    return total


def envelope(
    registry: Optional[MetricsRegistry] = None,
    *,
    comm=None,
    fleet: Optional[Mapping] = None,
    scheduler: Optional[Iterable] = None,
    extra: Optional[Mapping] = None,
) -> Dict[str, object]:
    """The schema-versioned export: every silo that exists for this run
    adapted under one dict. Pass the raw objects (a ``CommLedger``, a
    fleet summary dict, ``SchedulerStats``) — adapters normalize."""
    sections: Dict[str, object] = {}
    if registry is not None:
        sections["metrics"] = registry.collect()
    if comm is not None:
        sections["comm"] = comm_section(comm)
    if fleet is not None:
        sections["fleet"] = fleet_section(fleet)
    if scheduler is not None:
        sections["scheduler"] = scheduler_section(scheduler)
    if extra:
        sections.update(dict(extra))
    return {
        "schema": SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "sections": sections,
    }
