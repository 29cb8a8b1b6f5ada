"""repro_torch.fleet — the multi-tenant, SLO-driven serve fleet.

Port of ``repro.fleet``: many tenants — one deployed one-shot artifact
each (distilled student, ``Ensemble``, or int8
``QuantizedStackedEnsemble``) — share a bounded pool of scoring servers
under per-tenant latency SLOs. The control plane is pure Python on
simulated milliseconds, a copy of the reference's, so a run's metrics
are the reference's bytes; the data plane below it is
``serve.EnsembleScorer``, one scorer launch on the card per scheduler
batch (``TenantRegistry`` and ``serve_round_artifact`` default to
``device="cuda"``).

Modules
-------
clock.py     ``SimClock``/``EventQueue``/``CostModel`` — simulated
             milliseconds, no wall-clock in the control plane.
registry.py  tenant -> model + ``ServeConfig`` + ``TenantSLO``; models
             load live or straight from wire blobs / ``save_payload``
             checkpoints (``register_wire``), packed on the registry's
             device.
fleet.py     ``ServeFleet`` — admission control, earliest-deadline-first
             batch assembly across tenants, per-shard
             ``MicroBatchScheduler`` scoring, deterministic service
             times.
metrics.py   per-tenant + global latency percentiles, goodput, shed
             accounting (submitted == completed + shed), batch
             occupancy, cache hit rate — one plain dict.
traffic.py   seeded open-loop Poisson arrival traces per tenant.
handoff.py   ``serve_round_artifact`` — deploy a finished round's model
             through encode -> checkpoint -> register_wire and measure
             it under load.

``tests/test_torch_fleet.py`` holds it to the reference on the CPU (its
summaries byte for byte, the committed load curve and trace baseline
included); ``python3 chip_smoke.py --phases build,fleet`` runs it on
the card.
"""
from repro_torch.fleet.clock import CostModel, EventQueue, SimClock
from repro_torch.fleet.fleet import FleetConfig, ServeFleet, nominal_capacity_qps
from repro_torch.fleet.handoff import deploy_round_artifact, serve_round_artifact
from repro_torch.fleet.metrics import FleetMetrics, nearest_rank
from repro_torch.fleet.registry import (
    FLEET_SERVE_CONFIG,
    Tenant,
    TenantRegistry,
    TenantSLO,
    shard_for,
)
from repro_torch.fleet.traffic import (
    Arrival,
    offered_qps,
    open_loop_trace,
    poisson_arrival_times,
    query_pool,
)

__all__ = [
    "Arrival",
    "CostModel",
    "EventQueue",
    "FLEET_SERVE_CONFIG",
    "FleetConfig",
    "FleetMetrics",
    "ServeFleet",
    "SimClock",
    "Tenant",
    "TenantRegistry",
    "TenantSLO",
    "deploy_round_artifact",
    "nearest_rank",
    "nominal_capacity_qps",
    "offered_qps",
    "open_loop_trace",
    "poisson_arrival_times",
    "query_pool",
    "serve_round_artifact",
    "shard_for",
]
