"""repro_torch.obs — observability of the port: the span tracer, the
metrics registry and the kernel profiling hooks.

  * ``trace``    span tracer -> Chrome trace-event JSON (Perfetto);
                 ``wall_clock`` for the rounds and engines, ``sim_clock``
                 for the fleet, whose traces are byte-reproducible
  * ``registry`` named counters/gauges/histograms + the schema-
                 versioned envelope the metric silos (``CommLedger``,
                 ``FleetMetrics``, ``SchedulerStats``) export through
  * ``profile``  kernel dispatch hooks: every ``kernels.ops`` call, with
                 a tracer installed, timed to completion (CUDA events on
                 the card) with achieved-vs-roofline FLOPs/bytes
                 attributes priced on the card's sheets

Everything is gated behind the null tracer: uninstrumented runs pay
one attribute check per site.
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
from repro_torch.obs.profile import kernel_cost, maybe_profile, set_hardware, timed_call

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
    "kernel_cost",
    "maybe_profile",
    "set_hardware",
    "timed_call",
]
