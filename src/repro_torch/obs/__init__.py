"""Observability layer: request tracing, per-site drift profiling, metrics.

Counterpart of ``repro/obs/__init__.py`` (without the benchmark ledger):

  * ``obs.trace``   ``Tracer``/``Span``: host-clock request spans with
    Chrome/Perfetto JSON export.  Standard library only, no device sync.
  * ``obs.profile`` opt-in per-site profiled execution reconciling
    measured device time (CUDA events on the card) against the analytic
    cycle model (``DriftReport``).  Never on by default.
  * ``obs.metrics`` ``MetricsRegistry``: Prometheus-text / JSON export
    over ``serving.telemetry`` plus standalone instruments.
"""
from repro_torch.obs.trace import (TRACE_SCHEMA, Span, Tracer,
                                   validate_chrome_trace, request_chains)

# the metrics names load lazily (PEP 562), as JAX's do, so
# `import repro_torch.obs` loads the tracer alone.
_METRICS_NAMES = ("MetricsRegistry", "MetricFamily", "Counter", "Gauge",
                  "Histogram", "escape_label")


def __getattr__(name):
    if name in _METRICS_NAMES:
        from repro_torch.obs import metrics
        return getattr(metrics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "TRACE_SCHEMA", "Span", "Tracer", "validate_chrome_trace",
    "request_chains",
    "MetricsRegistry", "MetricFamily", "Counter", "Gauge", "Histogram",
    "escape_label",
]
