"""repro_torch.obs — host-side observability of the port: the span
tracer and the metrics registry.

  * ``trace``    span tracer -> Chrome trace-event JSON (Perfetto), on
                 the wall clock
  * ``registry`` named counters and histograms

The simulated clock, the ``traced`` decorator, the registry's exported
sections and ``profile`` come with the fleet and observability items
(ROADMAP queue 1 items 11-12).
"""
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    current_tracer,
    stopwatch,
    use_tracer,
    wall_clock,
)
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "current_tracer",
    "stopwatch",
    "use_tracer",
    "wall_clock",
    "MetricsRegistry",
    "default_registry",
]
