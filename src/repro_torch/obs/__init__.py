"""`repro_torch.obs` — observability for the port: copies of the JAX
package's framework-free ``repro.obs`` modules.

* :mod:`~repro_torch.obs.trace` — nested span tracer, off by default;
* :mod:`~repro_torch.obs.metrics` — typed Counter/Gauge/Histogram
  registry with Prometheus-style exposition;
* :mod:`~repro_torch.obs.flight` — bounded flight recorder of the last N
  streaming tick reports (with their span trees when tracing is on).
"""
from repro_torch.obs import flight, metrics, trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    observe_stats,
)
from repro_torch.obs.trace import Tracer, get_tracer, is_enabled, span

__all__ = [
    "trace",
    "metrics",
    "flight",
    "Tracer",
    "get_tracer",
    "is_enabled",
    "span",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "observe_stats",
    "FlightRecorder",
]
