"""Tenant registry: tenant -> servable model + ServeConfig + SLO.

Port of ``repro.fleet.registry``. A *tenant* is one deployed global
model (a distilled student, a full ``Ensemble``, or an int8
``QuantizedStackedEnsemble``) plus the serving contract the fleet
enforces for it:

  * ``TenantSLO`` — the latency deadline (ms of simulated time from
    arrival to completion), a priority for breaking deadline ties, and
    an admission quota (max requests queued at once);
  * a ``ServeConfig`` — batch/bucket/cache shape for this tenant's
    shard schedulers (the same config type the single-tenant serve
    path uses);
  * ``n_shards`` — how many scorer replicas the tenant's scored-query
    LRU is partitioned over (requests route to shards by a stable hash
    of the query key, so no entry is ever duplicated across shards);
  * ``cost_scale`` — the tenant's relative per-row scoring cost in the
    fleet's :class:`~repro_torch.fleet.clock.CostModel`.

Models register either as live objects (anything ``EnsembleScorer``
packs) or straight from wire blobs: ``register_wire`` accepts the exact
bytes ``repro_torch.comm.wire.encode`` (or the reference's) produced —
or a checkpoint directory written by ``checkpoint.manager.save_payload``
— decodes, packs, and serves them. Every model packs on the registry's
``device`` (default ``"cuda"``), and every decode passes it, so a CPU
registry never touches the card.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, Iterator, Union

from repro_torch.serve import EnsembleScorer, ServeConfig


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """The serving contract the fleet schedules against."""

    deadline_ms: float = 50.0   # arrival -> completion budget (simulated ms)
    priority: int = 0           # breaks exact deadline ties (higher wins)
    quota: int = 1024           # max queued requests for this tenant

    def __post_init__(self):
        if self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {self.deadline_ms}")
        if self.quota < 1:
            raise ValueError(f"quota must be >= 1, got {self.quota}")


# fleet-shaped default: small batches/buckets (latency over throughput)
# and the scored-query LRU on — multi-tenant traffic repeats queries
FLEET_SERVE_CONFIG = ServeConfig(
    max_batch=64, max_queue=4096, buckets=(8, 32, 64), cache_size=512
)


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One registered tenant (immutable; the fleet holds runtime state)."""

    name: str
    scorer: EnsembleScorer
    slo: TenantSLO = TenantSLO()
    serve: ServeConfig = FLEET_SERVE_CONFIG
    n_shards: int = 1
    cost_scale: float = 1.0

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.cost_scale <= 0:
            raise ValueError(f"cost_scale must be > 0, got {self.cost_scale}")


def shard_for(key_bytes: bytes, n_shards: int) -> int:
    """Stable shard assignment for a query key: crc32, not ``hash()``
    (Python string hashing is salted per process — routing must be
    identical across runs for the determinism contract)."""
    if n_shards == 1:
        return 0
    return zlib.crc32(key_bytes) % n_shards


class TenantRegistry:
    """Ordered, name-keyed map of tenants. Iteration is sorted by name
    so every fleet walk over tenants is registration-order independent
    (another determinism requirement). Models pack on ``device``."""

    def __init__(self, device="cuda"):
        self.device = device
        self._tenants: Dict[str, Tenant] = {}

    def register(
        self,
        name: str,
        model,
        *,
        slo: TenantSLO = TenantSLO(),
        serve: ServeConfig = FLEET_SERVE_CONFIG,
        n_shards: int = 1,
        cost_scale: float = 1.0,
    ) -> Tenant:
        """Register a live model object (packed once via EnsembleScorer)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if isinstance(model, EnsembleScorer):
            scorer = model
        else:
            scorer = EnsembleScorer(model, device=self.device)
        tenant = Tenant(name, scorer, slo=slo, serve=serve,
                        n_shards=n_shards, cost_scale=cost_scale)
        self._tenants[name] = tenant
        return tenant

    def register_wire(
        self,
        name: str,
        blob_or_path: Union[bytes, str, os.PathLike],
        **kwargs,
    ) -> Tenant:
        """Register a tenant straight from its wire payload: raw
        ``encode`` bytes, or a checkpoint directory written by
        ``checkpoint.manager.save_payload`` (the round's persisted
        artifact). The payload decodes onto the registry's device."""
        from repro_torch.checkpoint.manager import restore_payload
        from repro_torch.comm.wire import decode

        if isinstance(blob_or_path, (str, os.PathLike)):
            blob = restore_payload(os.fspath(blob_or_path))
        else:
            blob = blob_or_path
        return self.register(name, decode(blob, device=self.device), **kwargs)

    def get(self, name: str) -> Tenant:
        if name not in self._tenants:
            raise KeyError(f"unknown tenant {name!r}; registered: {self.names()}")
        return self._tenants[name]

    def names(self):
        return sorted(self._tenants)

    def __len__(self) -> int:
        return len(self._tenants)

    def __iter__(self) -> Iterator[Tenant]:
        for name in self.names():
            yield self._tenants[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tenants
