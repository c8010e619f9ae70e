"""Observability layer: tracing spans + metrics registry.

Dependency-free by design — ``repro_torch.obs`` imports nothing from the rest of
``repro_torch``, so every layer (service, core, benchmarks) can import it without
cycles. See :mod:`repro_torch.obs.trace` and :mod:`repro_torch.obs.metrics`.
"""
from .trace import (  # noqa: F401
    HOST_PID,
    HOST_PROCESS_NAME,
    TRACE_ENV,
    NullTracer,
    Tracer,
    chrome_trace_doc,
    enabled,
    get_tracer,
    set_tracer,
    span,
    trace_to,
    write_chrome_trace,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Info,
    MetricsRegistry,
    REGISTRY,
    default_registry,
)

__all__ = [
    "HOST_PID",
    "HOST_PROCESS_NAME",
    "TRACE_ENV",
    "NullTracer",
    "Tracer",
    "chrome_trace_doc",
    "enabled",
    "get_tracer",
    "set_tracer",
    "span",
    "trace_to",
    "write_chrome_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "Info",
    "MetricsRegistry",
    "REGISTRY",
    "default_registry",
]
