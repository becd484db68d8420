"""Observability for the port's serving engine: tracing, metrics, exporters.

A copy of the JAX package's ``repro.obs`` (pure Python; only the imports
are the port's), so that traces and metrics of both engines read alike.

- ``trace``: ring-buffered monotonic-clock :class:`Tracer` (strictly
  no-op when disabled) and :class:`TraceConfig`.
- ``metrics``: :class:`MetricsRegistry` of counters/gauges/histograms
  with Prometheus text exposition.
- ``derive``: typed :class:`TrafficSnapshot` for the adaptive
  controller and trace-derived utilization views.
- ``export``: Chrome/Perfetto trace_event JSON writer + validator,
  Prometheus file writer.
"""
from repro_torch.obs.derive import TrafficSnapshot, fold_engine_metrics, utilization_from_trace
from repro_torch.obs.metrics import (
    TPOT_BUCKETS,
    TTFT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import TraceConfig, Tracer
from repro_torch.obs.export import to_perfetto, validate_perfetto, write_metrics, write_trace

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TPOT_BUCKETS",
    "TTFT_BUCKETS",
    "TraceConfig",
    "Tracer",
    "TrafficSnapshot",
    "fold_engine_metrics",
    "to_perfetto",
    "utilization_from_trace",
    "validate_perfetto",
    "write_metrics",
    "write_trace",
]
