"""ServeFleet — the multi-tenant, SLO-driven serving control plane.

A copy of ``repro.fleet.fleet``: the same event loop, EDF pick, shed
rules and tracer events, one for one. Below it, each shard's
``MicroBatchScheduler`` calls its tenant's ``EnsembleScorer``, so every
scoring dispatch is one scorer launch on the registry's device.

One fleet = N interchangeable *servers* (scoring slots) shared by every
registered tenant, driven entirely in simulated time:

```
arrivals (open-loop trace, sorted by time)
    │ offer(tenant, row, t_ms)
    ▼
admission control ── shed: queue_full (global bound) | quota (per-
    │                tenant bound) | hopeless (deadline < cheapest
    ▼                possible service — provably unmeetable)
(tenant, shard) FIFO queue   shard = crc32(query bytes) % n_shards —
    │                        the tenant's LRU partition; one queue per
    ▼                        cache shard so hits stay shard-local
EDF batch assembly: a free server takes the queue whose HEAD has the
earliest absolute deadline (priority breaks exact ties), pops up to
max_batch requests, shedding any whose deadline can no longer be met
(expired or hopeless) — shed BEFORE scoring, so overload never burns
server time on dead requests
    │
    ▼
shard MicroBatchScheduler.submit + flush  — the single-tenant serve
    │  path unchanged: bucket padding, LRU, in-flight dedupe
    ▼
CostModel.service_ms(calls, bucket rows, cached rows)  — deterministic
simulated service; server busy until start + service; every request in
the dispatch completes then; metrics record latency vs deadline
```

Within one (tenant, shard) queue all requests share the tenant's
relative deadline, so FIFO order IS earliest-deadline order — EDF
reduces to comparing queue heads, O(tenants x shards) per dispatch.
Determinism: queues walk in sorted (tenant, shard) order, idle servers
pop lowest-id first, event ties pop in schedule order, and shard
routing hashes with crc32 — a fleet run is a pure function of
(registry, config, trace): the scores never enter the metrics. See
``clock.py`` for why wall-clock never appears here.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.fleet.clock import CostModel, EventQueue, SimClock
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.registry import Tenant, TenantRegistry, shard_for
from repro_torch.fleet.traffic import Arrival
from repro_torch.serve import MicroBatchScheduler, ServeConfig
from repro_torch.serve.cache import query_key


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Global (cross-tenant) fleet knobs."""

    n_servers: int = 2            # shared scoring slots
    max_global_queue: int = 2048  # bounded admission queue, all tenants
    cost: CostModel = CostModel()

    def __post_init__(self):
        if self.n_servers < 1:
            raise ValueError(f"n_servers must be >= 1, got {self.n_servers}")
        if self.max_global_queue < 1:
            raise ValueError(
                f"max_global_queue must be >= 1, got {self.max_global_queue}"
            )


def nominal_capacity_qps(
    n_servers: int, serve: ServeConfig, cost: CostModel, cost_scale: float = 1.0
) -> float:
    """Upper-bound steady-state throughput: every server scoring
    back-to-back full batches (no cache hits). The load bench sweeps
    offered load as multiples of this."""
    bucket = serve.bucket_for(serve.max_batch)
    return n_servers * serve.max_batch / cost.service_ms(1, bucket, 0, cost_scale) * 1000.0


@dataclasses.dataclass
class _Request:
    rid: int
    tenant: str
    shard: int
    row: np.ndarray
    key: tuple            # serve.cache.query_key — shard scheduler cache key
    t_arrival: float
    t_deadline: float     # absolute simulated deadline


class ServeFleet:
    """The event loop. ``offer`` arrivals in non-decreasing simulated
    time, then ``drain()``; or hand a whole trace to ``run``."""

    def __init__(
        self,
        registry: TenantRegistry,
        config: FleetConfig = FleetConfig(),
        *,
        keep_results: bool = False,
        tracer=None,
    ):
        if len(registry) == 0:
            raise ValueError("fleet needs at least one registered tenant")
        self.registry = registry
        self.config = config
        self.clock = SimClock()
        # fleet events always carry EXPLICIT simulated-ms timestamps —
        # never a wall-clock read — so the trace is byte-reproducible
        # from the traffic seed in any tracer
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = FleetMetrics(registry.names())
        self.results: Optional[Dict[int, np.ndarray]] = {} if keep_results else None
        # one MicroBatchScheduler per (tenant, cache shard) — the shard
        # owns its LRU partition, so entries never duplicate across
        # shards (routing is by query-key hash, see registry.shard_for)
        self._scheds: Dict[str, List[MicroBatchScheduler]] = {
            t.name: [MicroBatchScheduler(t.scorer, t.serve) for _ in range(t.n_shards)]
            for t in registry
        }
        self._queues: Dict[Tuple[str, int], Deque[_Request]] = {
            (t.name, s): deque() for t in registry for s in range(t.n_shards)
        }
        self._queue_keys = sorted(self._queues)  # fixed deterministic walk order
        self._queued_total = 0
        self._queued_by_tenant = {name: 0 for name in registry.names()}
        self._idle: List[int] = list(range(config.n_servers))
        heapq.heapify(self._idle)
        self._busy = EventQueue()
        self._next_rid = 0

    # -- shard stats view (metrics + tests) -----------------------------
    def shard_stats(self) -> Dict[str, list]:
        return {name: [s.stats for s in scheds] for name, scheds in self._scheds.items()}

    def shard_caches(self) -> Dict[str, list]:
        return {name: [s.cache for s in scheds] for name, scheds in self._scheds.items()}

    # -- request side ---------------------------------------------------
    def offer(self, tenant_name: str, row: np.ndarray, t_ms: float) -> int:
        """One arrival at simulated time ``t_ms`` (non-decreasing across
        calls). Returns the request id; whether it was admitted or shed
        is visible in the metrics (and ``results`` if kept)."""
        tenant = self.registry.get(tenant_name)
        self._run_until(t_ms)
        self.clock.advance_to(t_ms)
        rid = self._next_rid
        self._next_rid += 1
        self.metrics.record_submit(tenant_name)

        # admission control: bounded global queue, then per-tenant quota
        if self._queued_total >= self.config.max_global_queue:
            self._shed(tenant_name, "queue_full")
            return rid
        if self._queued_by_tenant[tenant_name] >= tenant.slo.quota:
            self._shed(tenant_name, "quota")
            return rid

        key = query_key(row)
        shard = shard_for(key[2], tenant.n_shards)
        # shed-on-hopeless at the door: an uncached request whose
        # deadline is shorter than the cheapest possible service can
        # never be met, whatever the queues look like
        if key not in self._scheds[tenant_name][shard].cache and (
            tenant.slo.deadline_ms < self._min_service_ms(tenant)
        ):
            self._shed(tenant_name, "hopeless")
            return rid

        req = _Request(
            rid, tenant_name, shard, np.array(row, copy=True), key,
            t_ms, t_ms + tenant.slo.deadline_ms,
        )
        self._queues[(tenant_name, shard)].append(req)
        self._queued_total += 1
        self._queued_by_tenant[tenant_name] += 1
        self.metrics.record_admit(tenant_name)
        self._dispatch()
        return rid

    def run(self, trace: Iterable[Arrival], horizon_ms: Optional[float] = None) -> dict:
        """Offer a whole (time-sorted) trace, drain, and summarize."""
        for a in trace:
            self.offer(a.tenant, a.row, a.t_ms)
        self.drain()
        return self.summary(horizon_ms)

    def drain(self) -> None:
        """Advance simulated time until every queued request is either
        completed or shed (all servers idle, all queues empty)."""
        while self._busy:
            self._pop_busy()
        assert self._queued_total == 0, "drain left queued requests behind"

    def summary(self, horizon_ms: Optional[float] = None) -> dict:
        """The exported metrics dict (``fleet.metrics`` layer). Pass the
        traffic horizon to normalize offered/goodput rates over the
        open-loop window rather than the (longer) drained clock."""
        if horizon_ms is None:
            horizon_ms = self.clock.now_ms
        return self.metrics.summary(horizon_ms, self.shard_stats())

    # -- event loop -----------------------------------------------------
    def _shed(self, tenant_name: str, reason: str) -> None:
        self.metrics.record_shed(tenant_name, reason)
        if self.tracer.enabled:
            self.tracer.instant("fleet.shed", cat="fleet",
                                ts_us=self.clock.now_ms * 1000.0,
                                tenant=tenant_name, reason=reason)

    def _min_service_ms(self, tenant: Tenant) -> float:
        return self.config.cost.min_service_ms(min(tenant.serve.buckets), tenant.cost_scale)

    def _run_until(self, t_ms: float) -> None:
        while self._busy and self._busy.peek_time() <= t_ms:
            self._pop_busy()

    def _pop_busy(self) -> None:
        t_free, server = self._busy.pop()
        self.clock.advance_to(t_free)
        heapq.heappush(self._idle, server)
        self._dispatch()

    def _dispatch(self) -> None:
        """Give every idle server the most urgent assembled batch."""
        while self._idle:
            picked = self._assemble()
            if picked is None:
                return
            tenant_name, shard, batch = picked
            server = heapq.heappop(self._idle)
            service = self._execute(tenant_name, shard, batch)
            self._busy.push(self.clock.now_ms + service, server)

    def _assemble(self) -> Optional[Tuple[str, int, List[_Request]]]:
        """EDF queue pick + batch assembly with shed-on-hopeless.

        Queue heads are each queue's earliest deadline (per-tenant
        relative deadlines make FIFO == EDF within a queue); the pick
        minimizes (head deadline, -priority, tenant, shard). Requests
        that can no longer meet their deadline — expired in queue, or
        closer to it than the cheapest possible service — are shed here,
        before any server time is spent on them; cache-resident queries
        are always kept (a hit costs ~nothing and always meets)."""
        now = self.clock.now_ms
        while True:
            best = None
            for qkey in self._queue_keys:
                q = self._queues[qkey]
                if not q:
                    continue
                tenant = self.registry.get(qkey[0])
                rank = (q[0].t_deadline, -tenant.slo.priority, qkey[0], qkey[1])
                if best is None or rank < best[0]:
                    best = (rank, qkey)
            if best is None:
                return None
            tenant_name, shard = best[1]
            tenant = self.registry.get(tenant_name)
            q = self._queues[(tenant_name, shard)]
            sched = self._scheds[tenant_name][shard]
            min_ms = self._min_service_ms(tenant)
            batch: List[_Request] = []
            while q and len(batch) < tenant.serve.max_batch:
                req = q.popleft()
                self._queued_total -= 1
                self._queued_by_tenant[tenant_name] -= 1
                if req.key not in sched.cache and now + min_ms > req.t_deadline:
                    self._shed(tenant_name, "hopeless")
                    continue
                batch.append(req)
            if batch:
                return tenant_name, shard, batch
            # the pick shed away entirely — fall through to the next queue

    def _execute(self, tenant_name: str, shard: int, batch: List[_Request]) -> float:
        """Score one assembled batch through the shard's scheduler and
        charge the deterministic service time. Every request in the
        dispatch completes at start + service."""
        tenant = self.registry.get(tenant_name)
        sched = self._scheds[tenant_name][shard]
        s = sched.stats
        before = (s.batches, s.scored_rows, s.padded_rows,
                  s.answered_from_cache, s.deduped_in_flight)
        tickets = [sched.submit(req.row) for req in batch]
        sched.flush()
        calls = s.batches - before[0]
        bucket_rows = (s.scored_rows - before[1]) + (s.padded_rows - before[2])
        cached_rows = (s.answered_from_cache - before[3]) + (s.deduped_in_flight - before[4])
        service = self.config.cost.service_ms(
            calls, bucket_rows, cached_rows, tenant.cost_scale
        )
        done = self.clock.now_ms + service
        if self.tracer.enabled:
            self.tracer.complete(
                "fleet.execute", ts_us=self.clock.now_ms * 1000.0,
                dur_us=service * 1000.0, cat="fleet", tenant=tenant_name,
                shard=shard, batch=len(batch), calls=calls,
                bucket_rows=bucket_rows, cached_rows=cached_rows,
            )
        for req, ticket in zip(batch, tickets):
            out = sched.result(ticket)
            self.metrics.record_complete(
                tenant_name, done - req.t_arrival, met=done <= req.t_deadline
            )
            if self.results is not None:
                self.results[req.rid] = out
        return service
