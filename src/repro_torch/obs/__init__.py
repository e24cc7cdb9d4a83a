"""Observability for the port: tracing and metrics.

Counterpart of ``repro.obs`` without JAX:

* :mod:`repro_torch.obs.trace`   -- ``Tracer`` (nestable spans over a
  bounded ring buffer), the process-global current tracer
  (``set_tracer`` / ``tracer()``, off by default: ``NULL_TRACER``) and
  ``TraceHook`` for the program-dispatch seam;
* :mod:`repro_torch.obs.metrics` -- ``Counter`` / ``Gauge`` /
  ``Histogram`` in a ``MetricsRegistry`` (default ``REGISTRY``), JSON
  snapshots and Prometheus text.

The reference's ``QualityMonitor`` (``repro.obs.quality``) is not
ported yet (ROADMAP Queue 1 item 4).
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
           "uninstall_dispatch_tracing"]
