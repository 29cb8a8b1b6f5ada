"""Seeded open-loop traffic for the serve fleet.

A numpy copy of ``repro.fleet.traffic``: for the same seed the arrival
times and query rows are the reference's, bit for bit.

Open-loop means arrival times are drawn up front from the offered-load
model and do NOT react to server backpressure — the canonical way to
measure a latency/goodput-vs-load curve (a closed loop self-throttles
and hides overload behavior). Arrivals are Poisson per tenant
(i.i.d. exponential gaps at the tenant's rate); query rows are drawn
uniformly from a fixed per-tenant pool so repeat traffic exercises the
sharded LRU at a controllable rate (hit rate rises as the pool gets
covered; ``pool_size`` is the knob).

All randomness flows from ``SeedSequence([seed, FLEET_STREAM,
tenant_index, purpose])`` — the same independent-stream discipline as
``derive_device_seed`` in the sim engines — so traffic is independent
of tenant registration order and of every other consumer of the run
seed. The merged trace is sorted by (time, tenant, per-tenant index):
a total order, so simultaneous arrivals replay identically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

import numpy as np

FLEET_STREAM = 0x46554C  # disjoint SeedSequence branch for fleet traffic
_ARRIVALS, _QUERIES, _POOL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of the trace: ``row`` arrives for ``tenant`` at
    simulated time ``t_ms``."""

    t_ms: float
    tenant: str
    row: np.ndarray


def _rng(seed: int, tenant_index: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), FLEET_STREAM, tenant_index, purpose])
    )


def poisson_arrival_times(
    rate_qps: float, horizon_ms: float, seed: int, tenant_index: int = 0
) -> np.ndarray:
    """Poisson arrival times (ms, ascending) on [0, horizon_ms)."""
    if rate_qps <= 0 or horizon_ms <= 0:
        return np.zeros(0, np.float64)
    rng = _rng(seed, tenant_index, _ARRIVALS)
    mean_gap_ms = 1000.0 / rate_qps
    # draw in blocks until the horizon is covered; block size only
    # affects how many draws are discarded, never their values' stream
    gaps: List[np.ndarray] = []
    total = 0.0
    while total < horizon_ms:
        block = rng.exponential(mean_gap_ms, size=max(16, int(rate_qps * horizon_ms / 1000.0) + 1))
        gaps.append(block)
        total += float(block.sum())
    times = np.cumsum(np.concatenate(gaps))
    return times[times < horizon_ms]


def query_pool(pool_size: int, dim: int, seed: int, tenant_index: int = 0) -> np.ndarray:
    """The tenant's fixed set of distinct query rows, (pool_size, dim) fp32."""
    rng = _rng(seed, tenant_index, _POOL)
    return rng.normal(0.0, 1.0, (pool_size, dim)).astype(np.float32)


def open_loop_trace(
    rates_qps: Mapping[str, float],
    *,
    horizon_ms: float,
    dim: int,
    seed: int,
    pool_size: int = 256,
) -> List[Arrival]:
    """The merged multi-tenant trace, sorted by (t_ms, tenant, index).

    ``rates_qps`` maps tenant name -> offered load; tenant streams are
    seeded by the tenant's rank in sorted-name order, so the trace does
    not depend on dict ordering.
    """
    arrivals: List[Tuple[float, str, int, np.ndarray]] = []
    for idx, tenant in enumerate(sorted(rates_qps)):
        times = poisson_arrival_times(rates_qps[tenant], horizon_ms, seed, idx)
        pool = query_pool(pool_size, dim, seed, idx)
        picks = _rng(seed, idx, _QUERIES).integers(0, len(pool), size=len(times))
        for j, (t, p) in enumerate(zip(times, picks)):
            arrivals.append((float(t), tenant, j, pool[p]))
    arrivals.sort(key=lambda a: (a[0], a[1], a[2]))
    return [Arrival(t, tenant, row) for t, tenant, _, row in arrivals]


def offered_qps(trace: List[Arrival], horizon_ms: float) -> Dict[str, float]:
    """Realized per-tenant offered load of a trace (requests / second)."""
    counts: Dict[str, int] = {}
    for a in trace:
        counts[a.tenant] = counts.get(a.tenant, 0) + 1
    return {t: n / (horizon_ms / 1000.0) for t, n in sorted(counts.items())}
