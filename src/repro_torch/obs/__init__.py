"""Host-side observability of the port: span tracer and metrics registry."""
