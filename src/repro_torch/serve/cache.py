"""Scored-query LRU cache for the serve path.

Requests that repeat an already-scored query (byte-identical feature
row) are answered from the cache and never enter a batch, so cache
hits cost neither padding slots nor kernel time. Keys are the raw row
bytes plus dtype/shape, making collisions impossible rather than
improbable. See the ``repro_torch.serve`` package docstring for where
this sits in the serving pipeline. A copy of ``repro.serve.cache``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional

import numpy as np


def query_key(row: np.ndarray) -> Hashable:
    """Exact cache key for one query row."""
    a = np.ascontiguousarray(row)
    return (a.dtype.str, a.shape, a.tobytes())


class LRUCache:
    """Bounded least-recently-used map. ``capacity <= 0`` disables it
    (every get misses, puts are dropped) so callers need no branching."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        """Stats-free peek: no counter bump, no recency update. The
        fleet's admission/assembly paths use this to ask 'would this
        be a hit?' without polluting the hit-rate metric."""
        return key in self._d

    def get(self, key: Hashable) -> Optional[Any]:
        if self.capacity <= 0:
            # disabled cache: not a miss — counting it would pollute
            # the exported hit-rate metric with lookups that were
            # never cacheable in the first place
            return None
        if key not in self._d:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return self._d[key]

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
