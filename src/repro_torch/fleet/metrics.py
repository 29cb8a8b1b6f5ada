"""Fleet metrics — per-tenant and global SLO accounting as a plain dict.

A copy of ``repro.fleet.metrics``: the same float expressions and
``round`` calls, so ``summary()`` serialises to the reference's bytes.

Counters follow a strict conservation law the tests pin down:

    submitted == completed + shed          (every request is accounted)
    shed      == shed_queue_full + shed_quota + shed_hopeless
    completed == deadline_met + deadline_missed

``summary()`` exports everything as one nested plain dict (floats and
ints only, JSON-serializable), the way ``CommLedger.summary()`` does —
the reference's load bench writes it verbatim into
``serve_load_bench.json`` and determinism is asserted on its serialized
bytes.

Latency percentiles use the nearest-rank definition on the sorted
completed-request latencies (no interpolation: deterministic, and a
reported p99 is always a latency that actually happened). Goodput is
deadline-met requests per *simulated* second; batch occupancy is
scored rows over padded bucket rows (how full the kernel shapes ran);
cache hit rate counts LRU answers plus in-flight dedupe fanouts over
admitted requests, aggregated from the shard schedulers'
``SchedulerStats``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Sequence

SHED_REASONS = ("queue_full", "quota", "hopeless")


def nearest_rank(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending sequence; 0.0 if empty."""
    if not sorted_xs:
        return 0.0
    idx = max(0, min(len(sorted_xs) - 1, math.ceil(q / 100.0 * len(sorted_xs)) - 1))
    return float(sorted_xs[idx])


@dataclasses.dataclass
class TenantCounters:
    """Raw per-tenant tallies; derived rates live in ``summary()``."""

    submitted: int = 0
    admitted: int = 0
    shed_queue_full: int = 0
    shed_quota: int = 0
    shed_hopeless: int = 0
    completed: int = 0
    deadline_met: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_quota + self.shed_hopeless


class FleetMetrics:
    """Accumulates per-tenant counters during a fleet run and renders
    the summary dict. The fleet records submissions/sheds/completions
    here; scheduler-level stats (cache, batching) are passed in at
    summary time so this layer never reaches into the data plane."""

    def __init__(self, tenant_names: Sequence[str]):
        self.tenants: Dict[str, TenantCounters] = {
            name: TenantCounters() for name in sorted(tenant_names)
        }

    def _tenant(self, name: str) -> TenantCounters:
        return self.tenants[name]

    def record_submit(self, tenant: str) -> None:
        self._tenant(tenant).submitted += 1

    def record_admit(self, tenant: str) -> None:
        self._tenant(tenant).admitted += 1

    def record_shed(self, tenant: str, reason: str) -> None:
        if reason not in SHED_REASONS:
            raise ValueError(f"shed reason must be one of {SHED_REASONS}, got {reason!r}")
        t = self._tenant(tenant)
        setattr(t, f"shed_{reason}", getattr(t, f"shed_{reason}") + 1)

    def record_complete(self, tenant: str, latency_ms: float, met: bool) -> None:
        t = self._tenant(tenant)
        t.completed += 1
        t.deadline_met += int(met)
        t.latencies_ms.append(float(latency_ms))

    # -- rendering ------------------------------------------------------
    @staticmethod
    def _render(c: TenantCounters, horizon_s: float, sched) -> Dict[str, float]:
        lat = sorted(c.latencies_ms)
        scored = sum(s.scored_rows for s in sched)
        padded = sum(s.padded_rows for s in sched)
        cached = sum(s.answered_from_cache + s.deduped_in_flight for s in sched)
        out = {
            "submitted": c.submitted,
            "admitted": c.admitted,
            "completed": c.completed,
            "shed": c.shed,
            "shed_queue_full": c.shed_queue_full,
            "shed_quota": c.shed_quota,
            "shed_hopeless": c.shed_hopeless,
            "deadline_met": c.deadline_met,
            "deadline_missed": c.completed - c.deadline_met,
            "p50_ms": round(nearest_rank(lat, 50), 6),
            "p95_ms": round(nearest_rank(lat, 95), 6),
            "p99_ms": round(nearest_rank(lat, 99), 6),
            "offered_qps": round(c.submitted / horizon_s, 3) if horizon_s > 0 else 0.0,
            "goodput_qps": round(c.deadline_met / horizon_s, 3) if horizon_s > 0 else 0.0,
            "shed_rate": round(c.shed / c.submitted, 6) if c.submitted else 0.0,
            "deadline_met_rate": (
                round(c.deadline_met / c.completed, 6) if c.completed else 0.0
            ),
            "batch_occupancy": (
                round(scored / (scored + padded), 6) if scored + padded else 0.0
            ),
            "cache_hit_rate": round(cached / c.admitted, 6) if c.admitted else 0.0,
            "conserved": c.submitted == c.completed + c.shed,
        }
        return out

    def summary(
        self,
        horizon_ms: float,
        shard_stats: Mapping[str, Sequence],
    ) -> Dict[str, object]:
        """The exported metrics dict.

        ``shard_stats`` maps tenant -> its shard schedulers'
        ``SchedulerStats`` (one per cache shard). Global numbers are
        recomputed from pooled raw counters/latencies, not averaged
        from per-tenant rates, so they stay exact under skewed tenants.
        """
        horizon_s = horizon_ms / 1000.0
        g = TenantCounters()
        all_sched = []
        tenants_out = {}
        for name, c in self.tenants.items():
            sched = list(shard_stats.get(name, ()))
            tenants_out[name] = self._render(c, horizon_s, sched)
            g.submitted += c.submitted
            g.admitted += c.admitted
            g.shed_queue_full += c.shed_queue_full
            g.shed_quota += c.shed_quota
            g.shed_hopeless += c.shed_hopeless
            g.completed += c.completed
            g.deadline_met += c.deadline_met
            g.latencies_ms.extend(c.latencies_ms)
            all_sched.extend(sched)
        return {
            "horizon_ms": round(float(horizon_ms), 6),
            "global": self._render(g, horizon_s, all_sched),
            "tenants": tenants_out,
        }
