"""Simulated time for the serve fleet — no wall-clock in the control plane.

A copy of ``repro.fleet.clock``. Every timestamp in ``repro_torch.fleet``
is *simulated milliseconds* on a ``SimClock``: arrivals carry their own
times, batch service durations come from a deterministic
:class:`CostModel`, and deadline expiry is a pure comparison against
``clock.now_ms``. A fleet run is therefore a pure function of
(registry, config, traffic) — the same seed replays to a byte-identical
metrics dict on any host, and to the reference's bytes (the committed
``benchmarks/serve_load_bench.json``, ``tests/test_torch_fleet.py``).
The scores that the card computes never enter the metrics; their speed
is measured by ``chip_smoke.py``'s ``fleet`` phase, not by this layer.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, List, Optional, Tuple


class SimClock:
    """Monotone simulated milliseconds."""

    __slots__ = ("_now",)

    def __init__(self, start_ms: float = 0.0):
        self._now = float(start_ms)

    @property
    def now_ms(self) -> float:
        return self._now

    def advance_to(self, t_ms: float) -> float:
        """Move time forward (never backward) to ``t_ms``."""
        t_ms = float(t_ms)
        if t_ms < self._now:
            raise ValueError(
                f"simulated time cannot go backward: {t_ms} < {self._now}"
            )
        self._now = t_ms
        return self._now


class EventQueue:
    """Deterministic time-ordered event heap.

    Ties in time are broken by push order (a monotone sequence number),
    so two events at the same instant always pop in the order they were
    scheduled — no dependence on payload comparability or hash order.
    """

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0

    def push(self, t_ms: float, payload: Any) -> None:
        heapq.heappush(self._heap, (float(t_ms), self._seq, payload))
        self._seq += 1

    def pop(self) -> Tuple[float, Any]:
        t_ms, _, payload = heapq.heappop(self._heap)
        return t_ms, payload

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Deterministic service-time model for one scoring dispatch.

    A dispatch that made ``calls`` scoring calls over ``bucket_rows``
    total padded rows (scored + padding — the shape the kernel actually
    ran) and answered ``cached_rows`` from the LRU / in-flight dedupe
    costs

        calls * batch_overhead_ms
      + bucket_rows * per_row_ms * cost_scale
      + cached_rows * cache_hit_ms

    ``cost_scale`` is the tenant's relative model cost (a k=32 ensemble
    is pricier per row than a distilled student). The parameters are
    abstract capacity units, not measured hardware times: the fleet is
    a discrete-event simulation whose *relative* numbers (goodput vs
    offered load, EDF win, shed behavior) are the product; the scorer's
    time on the card is ``chip_smoke.py``'s to measure.
    """

    batch_overhead_ms: float = 0.5
    per_row_ms: float = 0.02
    cache_hit_ms: float = 0.001

    def service_ms(
        self, calls: int, bucket_rows: int, cached_rows: int, cost_scale: float = 1.0
    ) -> float:
        return (
            calls * self.batch_overhead_ms
            + bucket_rows * self.per_row_ms * cost_scale
            + cached_rows * self.cache_hit_ms
        )

    def min_service_ms(self, min_bucket: int, cost_scale: float = 1.0) -> float:
        """Cheapest possible scoring path for one uncached row: a
        single call at the smallest configured bucket. The hopeless
        check sheds only requests that cannot beat even THIS bound —
        conservative, so no schedulable request is ever shed."""
        return self.service_ms(1, min_bucket, 0, cost_scale)
