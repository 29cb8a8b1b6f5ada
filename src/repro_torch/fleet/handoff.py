"""Round -> fleet handoff: deploy a finished one-shot round's artifact.

Port of ``repro.fleet.handoff``. ``serve_round_artifact`` takes the
model a round produced (the distilled student off
``ProtocolResult.student`` / ``PopulationReport.student``, a selected
``Ensemble``, or the aggregated server scorer off ``.server_scorer`` —
weighted/linear aggregates from ``repro_torch.agg`` included) and runs
it through the FULL deployment path:

    encode(model)  ──►  checkpoint.manager.save_payload (wire blob as
         │              an npz checkpoint — the round's persisted form)
         ▼
    TenantRegistry.register_wire(path)  x  SLO classes — the same
         │              deployed model served under different contracts
         ▼              ("premium": tight deadline, high priority;
    ServeFleet.run(     "batch": loose deadline)
      open-loop Poisson trace at `load` x nominal capacity)
         ▼
    metrics summary dict

The tenants deliberately share one model: multi-tenancy here is about
SLO classes contending for the same scoring hardware, which is exactly
what admission control + EDF arbitrate. The model packs on ``device``
(default ``"cuda"``), where every scheduler batch is one scorer launch;
``deploy_round_artifact`` hands back the fleet and its trace before the
run, so a caller can read the fleet's shard stats and kept results.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Tuple

from repro_torch.fleet.fleet import FleetConfig, ServeFleet, nominal_capacity_qps
from repro_torch.fleet.registry import TenantRegistry, TenantSLO
from repro_torch.fleet.traffic import Arrival, open_loop_trace
from repro_torch.serve import ServeConfig

# the two stock SLO classes of the handoff fleet
PREMIUM_SLO = TenantSLO(deadline_ms=20.0, priority=1, quota=512)
BATCH_SLO = TenantSLO(deadline_ms=100.0, priority=0, quota=512)


def _wire_codec(model) -> str:
    """The codec a round artifact re-encodes under: int8 payloads keep
    their wire form (a QuantizedSVM, or an ensemble whose members all
    are), everything else ships lossless."""
    from repro_torch.comm.wire import QuantizedSVM
    from repro_torch.core.ensemble import Ensemble

    if isinstance(model, QuantizedSVM):
        return "int8"
    if isinstance(model, Ensemble) and model.members and all(
        isinstance(m, QuantizedSVM) for m in model.members
    ):
        return "int8"
    return "fp32"


def deploy_round_artifact(
    model,
    *,
    seed: int = 0,
    horizon_ms: float = 250.0,
    load: float = 1.0,
    n_servers: int = 2,
    checkpoint_dir: Optional[str] = None,
    keep_results: bool = False,
    tracer=None,
    device="cuda",
) -> Tuple[ServeFleet, List[Arrival], dict]:
    """Deploy ``model`` behind a two-SLO-class fleet on ``device``:
    (the fleet, not yet run; its open-loop Poisson trace at ``load`` x
    nominal capacity; the handoff config).

    The model round-trips ``encode -> save_payload -> register_wire``
    (via ``checkpoint_dir`` or a temporary directory), so the fleet
    serves exactly what a consumer restoring the round's checkpoint
    would score."""
    from repro_torch.agg import WeightedEnsemble
    from repro_torch.checkpoint.manager import save_payload
    from repro_torch.comm.wire import encode

    # a weighted aggregate deploys as its equivalent plain ensemble —
    # coef-scaled members encode/serve like any mean ensemble
    if isinstance(model, WeightedEnsemble):
        model = model.as_ensemble()
    codec = _wire_codec(model)
    blob = encode(model, codec)

    serve = ServeConfig(max_batch=32, max_queue=4096, buckets=(8, 32), cache_size=256)
    config = FleetConfig(n_servers=n_servers, max_global_queue=1024)

    def _register(registry: TenantRegistry, path: str) -> None:
        registry.register_wire("premium", path, slo=PREMIUM_SLO, serve=serve,
                               n_shards=2)
        registry.register_wire("batch", path, slo=BATCH_SLO, serve=serve,
                               n_shards=2)

    registry = TenantRegistry(device=device)
    if checkpoint_dir is not None:
        _register(registry, save_payload(checkpoint_dir, blob))
    else:
        with tempfile.TemporaryDirectory(prefix="fleet_handoff_") as tmp:
            _register(registry, save_payload(os.path.join(tmp, "artifact"), blob))

    capacity = nominal_capacity_qps(config.n_servers, serve, config.cost)
    rate = load * capacity / len(registry)
    trace = open_loop_trace(
        {name: rate for name in registry.names()},
        horizon_ms=horizon_ms,
        dim=int(registry.get("premium").scorer.stacked.d),
        seed=seed,
        pool_size=128,
    )
    fleet = ServeFleet(registry, config, keep_results=keep_results,
                       tracer=tracer)
    handoff = {
        "codec": codec,
        "wire_nbytes": len(blob),
        "seed": int(seed),
        "load_x_capacity": float(load),
        "nominal_capacity_qps": round(capacity, 3),
        "n_servers": config.n_servers,
        "requests": len(trace),
    }
    return fleet, trace, handoff


def serve_round_artifact(model, *, horizon_ms: float = 250.0, **deploy) -> dict:
    """Deploy ``model`` (``deploy_round_artifact``'s keywords: ``seed``,
    ``load``, ``n_servers``, ``checkpoint_dir``, ``keep_results``,
    ``tracer``, ``device``, default ``"cuda"``) and run its trace: the
    fleet summary dict plus the handoff config under ``"handoff"``."""
    fleet, trace, handoff = deploy_round_artifact(model, horizon_ms=horizon_ms, **deploy)
    out = fleet.run(trace, horizon_ms=horizon_ms)
    out["handoff"] = handoff
    return out
