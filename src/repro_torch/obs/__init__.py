"""Observability for the port: tracing and metrics.

Counterpart of ``repro.obs`` without JAX:

* :mod:`repro_torch.obs.trace`   -- ``Tracer`` (nestable spans over a
  bounded ring buffer), the process-global current tracer
  (``set_tracer`` / ``tracer()``, off by default: ``NULL_TRACER``) and
  ``TraceHook`` for the program-dispatch seam;
* :mod:`repro_torch.obs.metrics` -- ``Counter`` / ``Gauge`` /
  ``Histogram`` in a ``MetricsRegistry`` (default ``REGISTRY``), JSON
  snapshots and Prometheus text;
* :mod:`repro_torch.obs.quality` -- ``QualityMonitor``: the sampled
  screening-recall probe, the concentration curve (k_t/N and the
  coarse stage's occupancy against t), the guard and degradation rates
  (imported lazily: it sits above the index layer).
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   TraceHook, install_dispatch_tracing,
                                   set_tracer, tracer,
                                   uninstall_dispatch_tracing)

__all__ = ["metrics", "trace", "REGISTRY", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "NULL_TRACER", "NullTracer", "Tracer",
           "TraceHook", "install_dispatch_tracing", "set_tracer", "tracer",
           "uninstall_dispatch_tracing", "QualityMonitor"]


def __getattr__(name):
    # lazy: quality reaches the index layer, which imports core, which
    # imports this package
    if name == "QualityMonitor":
        from repro_torch.obs.quality import QualityMonitor
        return QualityMonitor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
