"""Micro-batching request scheduler (the serve-path control plane).

Pipeline per flush: bounded queue -> cache lookup -> dynamic batch
assembly (up to ``max_batch`` uncached rows, zero-padded up to the
smallest configured *bucket* size) -> ONE scoring call per batch ->
responses de-multiplexed back to tickets in submission order ->
freshly scored rows inserted into the LRU cache.

Bucket padding keeps the scoring function to a few batch shapes (the
reference's jit compiles once per bucket). The score_fn contract is

    score_fn(batch: np.ndarray (bucket, *row_shape)) -> (bucket, ...)

where row i of the output answers row i of the input; padded rows are
zeros and their outputs are discarded. A copy of
``repro.serve.scheduler`` (numpy only): the same requests and score_fn
give the same outputs and ``SchedulerStats``.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.serve.cache import LRUCache, query_key


class QueueFullError(RuntimeError):
    """Raised by submit() when the bounded request queue is at capacity."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 256                # most uncached rows per scoring call
    max_queue: int = 4096               # bounded queue capacity
    buckets: Tuple[int, ...] = (8, 32, 128, 256)  # padded batch sizes
    cache_size: int = 0                 # LRU entries; 0 disables caching
    max_uncollected: int = 65536        # scored-but-unclaimed results kept

    def __post_init__(self):
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        if self.max_uncollected < self.max_queue:
            # a full queue's worth of results must survive one flush so
            # run() can always harvest the tickets it just scored
            raise ValueError("max_uncollected must be >= max_queue")
        if not self.buckets or any(b < 1 for b in self.buckets):
            raise ValueError("buckets must be non-empty positive sizes")
        # normalize ONCE to an ascending tuple so bucket_for is a
        # binary search, not a per-call sort (it runs on every batch)
        object.__setattr__(self, "buckets", tuple(sorted(self.buckets)))
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (buckets are kept sorted)."""
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise ValueError(f"batch of {n} exceeds largest bucket {self.buckets[-1]}")
        return self.buckets[i]


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    answered_from_cache: int = 0
    deduped_in_flight: int = 0   # intra-flush duplicates fanned out
    evicted_results: int = 0     # abandoned tickets dropped at the cap
    batches: int = 0
    scored_rows: int = 0
    padded_rows: int = 0


@dataclasses.dataclass
class _Pending:
    ticket: int
    row: np.ndarray
    result: Any = None
    done: bool = False
    key: Any = None  # query_key, computed once in flush() when caching


class MicroBatchScheduler:
    """Synchronous micro-batcher: submit() requests, flush() scores them.

    The design is deliberately single-threaded — determinism is what
    the tests and benchmarks need, and the batching/bucketing/caching
    logic is exactly what an async front-end would wrap with a queue
    consumer thread later.
    """

    def __init__(self, score_fn: Callable[[np.ndarray], np.ndarray], config: ServeConfig = ServeConfig()):
        self.score_fn = score_fn
        self.config = config
        self.cache = LRUCache(config.cache_size)
        self.stats = SchedulerStats()
        self._queue: Deque[_Pending] = deque()
        self._results: Dict[int, _Pending] = {}
        # done-but-uncollected tickets in completion order: eviction
        # pops the oldest-completed first in O(1) instead of scanning
        # the whole results dict every flush; result() removes in O(1)
        # so the structure never outgrows the uncollected set
        self._done: "OrderedDict[int, None]" = OrderedDict()
        self._next_ticket = 0

    # -- request side ---------------------------------------------------
    def submit(self, row: np.ndarray) -> int:
        """Enqueue one query row; returns a ticket for result()."""
        if len(self._queue) >= self.config.max_queue:
            raise QueueFullError(f"queue at capacity ({self.config.max_queue})")
        t = self._next_ticket
        self._next_ticket += 1
        # copy: callers may legally reuse one buffer across submits
        p = _Pending(t, np.array(row, copy=True))
        self._queue.append(p)
        self._results[t] = p
        self.stats.submitted += 1
        return t

    def submit_many(self, rows: Sequence[np.ndarray]) -> List[int]:
        """Atomic batch submit: rejects the whole batch if it cannot fit,
        so a QueueFullError never strands already-enqueued orphans."""
        if len(self._queue) + len(rows) > self.config.max_queue:
            raise QueueFullError(
                f"batch of {len(rows)} exceeds remaining queue capacity "
                f"({self.config.max_queue - len(self._queue)})"
            )
        return [self.submit(r) for r in rows]

    # -- scoring side ---------------------------------------------------
    def flush(self) -> int:
        """Drain the queue; returns the number of scoring calls made."""
        calls = 0
        caching = self.cache.capacity > 0  # skip key serialization when off
        while self._queue:
            batch: List[_Pending] = []
            in_batch: Dict[Any, _Pending] = {}
            dups: List[_Pending] = []
            while self._queue and len(batch) < self.config.max_batch:
                p = self._queue.popleft()
                hit = None
                if caching:
                    p.key = query_key(p.row)
                    hit = self.cache.get(p.key)
                if hit is not None:
                    # copy across the cache boundary: a caller mutating
                    # its result must never poison later hits
                    p.result, p.done = np.copy(hit), True
                    self._done[p.ticket] = None
                    self.stats.answered_from_cache += 1
                elif caching and p.key in in_batch:
                    # hot-burst dedupe: identical rows queued before the
                    # cache is warm score once and fan out
                    dups.append(p)
                else:
                    batch.append(p)
                    if caching:
                        in_batch[p.key] = p
            if batch:
                try:
                    self._score_batch(batch)
                except Exception:
                    # re-queue the in-flight batch (and its duplicates) in
                    # submission order so a retrying flush() rescores them
                    # instead of stranding undone tickets forever
                    requeue = sorted(batch + dups, key=lambda p: p.ticket)
                    self._queue.extendleft(reversed(requeue))
                    raise
                calls += 1
            for p in dups:
                p.result, p.done = np.copy(in_batch[p.key].result), True
                self._done[p.ticket] = None
                self.stats.deduped_in_flight += 1
        self._evict_uncollected()
        return calls

    def _evict_uncollected(self) -> None:
        """Bound memory under abandoned tickets: keep at most
        ``max_uncollected`` scored-but-unclaimed results. Oldest-
        COMPLETED go first, popped off the ``_done`` order in
        O(evicted) — no scan of the results dict (which used to cost
        O(all results) on every flush). Unscored entries live in the
        bounded queue, so total state stays bounded."""
        over = len(self._results) - self.config.max_uncollected
        while over > 0 and self._done:
            t, _ = self._done.popitem(last=False)
            if t in self._results:  # invariant: always true (see result())
                del self._results[t]
                self.stats.evicted_results += 1
                over -= 1

    def _score_batch(self, batch: List[_Pending]) -> None:
        n = len(batch)
        bucket = self.config.bucket_for(n)
        rows = np.stack([p.row for p in batch])
        padded = np.zeros((bucket,) + rows.shape[1:], rows.dtype)
        padded[:n] = rows
        out = np.asarray(self.score_fn(padded))
        if out.shape[0] != bucket:
            raise ValueError(
                f"score_fn returned leading dim {out.shape[0]}, expected bucket {bucket}"
            )
        caching = self.cache.capacity > 0
        for i, p in enumerate(batch):
            # copy: out[i] is a view — don't pin the whole bucket output
            # per ticket or expose sibling rows via result.base
            p.result, p.done = np.copy(out[i]), True
            self._done[p.ticket] = None
            if caching:
                self.cache.put(p.key, np.copy(out[i]))
        self.stats.batches += 1
        self.stats.scored_rows += n
        self.stats.padded_rows += bucket - n

    # -- response side --------------------------------------------------
    def result(self, ticket: int):
        p = self._results.get(ticket)
        if p is None:
            raise KeyError(f"unknown ticket {ticket}")
        if not p.done:
            raise RuntimeError(f"ticket {ticket} not scored yet — call flush()")
        del self._results[ticket]
        self._done.pop(ticket, None)  # keep the done order free of stale tickets
        return p.result

    def run(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """Convenience: submit, flush, gather in submission order."""
        tickets = self.submit_many(rows)
        if not tickets:
            return np.zeros((0,), np.float32)
        self.flush()
        return np.stack([self.result(t) for t in tickets])
