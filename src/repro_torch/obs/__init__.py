"""repro_torch.obs — host-side observability of the port: the span
tracer and the metrics registry.

  * ``trace``    span tracer -> Chrome trace-event JSON (Perfetto);
                 ``wall_clock`` for the rounds and engines, ``sim_clock``
                 for the fleet, whose traces are byte-reproducible
  * ``registry`` named counters/gauges/histograms + the schema-
                 versioned envelope the metric silos (``CommLedger``,
                 ``FleetMetrics``, ``SchedulerStats``) export through

``profile`` (kernel timing with achieved-vs-roofline attributes) comes
with the observability item (ROADMAP queue 1 item 12).
"""
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    current_tracer,
    sim_clock,
    stopwatch,
    traced,
    use_tracer,
    wall_clock,
)
from repro_torch.obs.registry import (
    MetricsRegistry,
    comm_section,
    default_registry,
    envelope,
    fleet_section,
    scheduler_section,
)

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "current_tracer",
    "sim_clock",
    "stopwatch",
    "traced",
    "use_tracer",
    "wall_clock",
    "MetricsRegistry",
    "comm_section",
    "default_registry",
    "envelope",
    "fleet_section",
    "scheduler_section",
]
