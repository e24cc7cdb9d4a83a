"""Tracing: nestable spans over a fixed-size ring buffer of events.

Counterpart of ``repro.obs.trace`` (the same classes, event schema and
span taxonomy; no JAX):

* **off** -- the current tracer defaults to :data:`NULL_TRACER`, whose
  ``enabled`` flag is False and whose ``span``/``event`` are no-ops.
  Every instrumented call site branches on ``tracer().enabled`` before
  computing any tag, so the disabled path is one global read and one
  attribute check: no events, no clock reads, no device
  synchronization, the same program keys and the same outputs.
* **on** -- events land in a preallocated ring buffer by a monotone
  sequence number; the buffer keeps the newest ``capacity`` events and
  ``dropped`` counts the rest.  A span that times device work
  (``engine.*``, ``plan.segment``) synchronizes the card before it
  closes, so its duration is the work's and not its enqueue time; only
  the enabled tracer does that.

Event schema (one dict per event; the fault injector,
``repro_torch.launch.faults``, emits onto the same stream):

  ``{"seq": int, "ts": float, "kind": "begin"|"end"|"point",
     "name": str, "span": int, "parent": int | None, "tags": dict}``

``span`` is the owning span's id for begin/end pairs (the enclosing
span for points; 0 = top level); ``parent`` the enclosing span's id;
``end`` events carry ``tags["dur"]`` (seconds).  The clock is
injectable (``Tracer(clock=...)``).

Span taxonomy:

  ``engine.denoise|select|full_scan|fused_step``  one per static engine
      entry call
  ``stage.screen|ivf_screen|rerank|aggregate|full_scan|fused_step``
      point events carrying analytic ``flops``/``bytes`` tags
      (``core.plan``)
  ``dispatch.<kind>``  one per program-cache dispatch (TraceHook)
  ``plan.segment``     one per trajectory-plan bucket execution
  ``wave.segment``     one per serving-runtime segment (+ ``wave.*`` /
      ``request.*`` / ``epoch.*`` lifecycle points)
  ``fault.<kind>``     injected faults, inline (launch.faults)
"""
from __future__ import annotations

import json
import time


class _NullSpan:
    """Shared no-op context manager (the disabled-tracer span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle: closes with an ``end`` event carrying ``dur``."""

    __slots__ = ("tracer", "name", "sid", "parent", "t0")

    def __init__(self, tracer, name, sid, parent, t0):
        self.tracer = tracer
        self.name = name
        self.sid = sid
        self.parent = parent
        self.t0 = t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer._end_span(self)
        return False


class Tracer:
    """Nestable spans + point events over a bounded ring buffer."""

    enabled = True

    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._buf: list = [None] * self.capacity
        self._seq = 0                     # next sequence number (monotone)
        self._next_span = 1               # span id 0 = top level
        self._stack: list[int] = []       # open span ids (nesting)

    # -- emission -------------------------------------------------------------
    def _emit(self, kind: str, name: str, span: int, parent, tags: dict):
        seq = self._seq
        self._seq = seq + 1
        self._buf[seq % self.capacity] = {
            "seq": seq, "ts": self.clock(), "kind": kind, "name": name,
            "span": span, "parent": parent, "tags": tags}

    def span(self, name: str, **tags):
        """Open a nested span; use as ``with tr.span("engine.denoise",
        t=400):``.  The matching ``end`` event records ``dur``."""
        parent = self._stack[-1] if self._stack else 0
        sid = self._next_span
        self._next_span += 1
        t0 = self.clock()
        self._emit("begin", name, sid, parent, tags)
        self._stack.append(sid)
        return _Span(self, name, sid, parent, t0)

    def _end_span(self, s: _Span):
        if self._stack and self._stack[-1] == s.sid:
            self._stack.pop()
        elif s.sid in self._stack:        # tolerate mis-nested exits
            self._stack.remove(s.sid)
        self._emit("end", s.name, s.sid, s.parent,
                   {"dur": self.clock() - s.t0})

    def event(self, name: str, **tags):
        """Point event inside the current span (0 = top level)."""
        span = self._stack[-1] if self._stack else 0
        self._emit("point", name, span,
                   self._stack[-2] if len(self._stack) > 1 else None, tags)

    # -- reading --------------------------------------------------------------
    def events(self) -> list[dict]:
        """Buffered events in sequence order (oldest surviving first)."""
        n = min(self._seq, self.capacity)
        start = self._seq - n
        return [self._buf[(start + i) % self.capacity] for i in range(n)]

    @property
    def dropped(self) -> int:
        """Events evicted by ring wrap (total emitted - buffered)."""
        return max(0, self._seq - self.capacity)

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._seq = 0
        self._next_span = 1
        self._stack = []

    def dump(self, path: str) -> int:
        """Write buffered events as JSON lines; returns the count."""
        evs = self.events()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e, default=str) + "\n")
        return len(evs)


class NullTracer(Tracer):
    """The disabled tracer: every operation is a no-op constant."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def span(self, name: str, **tags):
        return _NULL_SPAN

    def event(self, name: str, **tags):
        return None

    def _emit(self, *a, **kw):
        return None


NULL_TRACER = NullTracer()

_TRACER: Tracer = NULL_TRACER


def set_tracer(tr: Tracer | None) -> Tracer:
    """Install ``tr`` (or NULL_TRACER for ``None``) as the process-wide
    current tracer; returns the previous one so callers can restore."""
    global _TRACER
    prev = _TRACER
    _TRACER = NULL_TRACER if tr is None else tr
    return prev


def tracer() -> Tracer:
    """The current tracer (NULL_TRACER when tracing is off)."""
    return _TRACER


class TraceHook:
    """Dispatch-seam hook: spans every program dispatch.

    Installed at ``ops.set_dispatch_hook`` (the same seam the fault
    injector uses).  ``inner`` chains to a previously installed hook —
    typically the :class:`repro_torch.launch.faults.FaultInjector` — so
    tracing and fault injection compose; the injector's wrapped
    callable runs *inside* the trace span, so injected latency/errors
    are attributed to the dispatch that suffered them.

    Each dispatch emits a ``dispatch.<kind>`` span tagged with the full
    cache key and ``compile`` (True exactly when this lookup built the
    program — detected pre-lookup via ``key in engine._programs``).
    ``registry`` (optional, a ``repro_torch.obs.metrics.MetricsRegistry``)
    additionally counts dispatches and compiles per program kind.
    """

    def __init__(self, tr: Tracer, inner=None, registry=None):
        self.tracer = tr
        self.inner = inner
        self.registry = registry
        self._last_compile = False

    def on_program(self, engine, key) -> None:
        if self.inner is not None:
            self.inner.on_program(engine, key)   # may evict (recompile)
        # ``program()`` calls on_program then wrap back-to-back for the
        # same key, so one pending flag is enough (no interleaving)
        self._last_compile = key not in engine._programs

    def wrap(self, key, fn):
        if self.inner is not None:
            fn = self.inner.wrap(key, fn)
        tr = self.tracer
        if not tr.enabled and self.registry is None:
            return fn
        kind = key[0] if isinstance(key, tuple) and key else str(key)
        compiled = bool(self._last_compile)
        if self.registry is not None:
            self.registry.counter(f"golddiff_dispatch_total_{kind}").inc()
            if compiled:
                self.registry.counter("golddiff_compiles_total").inc()
        if not tr.enabled:
            return fn

        def traced(*args, **kw):
            with tr.span(f"dispatch.{kind}", key=repr(key),
                         compile=compiled):
                return fn(*args, **kw)

        return traced


def install_dispatch_tracing(tr: Tracer, registry=None) -> TraceHook:
    """Wrap the current dispatch hook (e.g. an installed fault
    injector) in a :class:`TraceHook` and install it.  Returns the hook
    so callers can pass it to :func:`uninstall_dispatch_tracing`."""
    from repro_torch.kernels import ops   # deferred: keep obs import-light
    hook = TraceHook(tr, inner=ops.dispatch_hook(), registry=registry)
    ops.set_dispatch_hook(hook)
    return hook


def uninstall_dispatch_tracing(hook: TraceHook | None = None) -> None:
    """Restore the hook that was active before tracing was installed."""
    from repro_torch.kernels import ops
    cur = ops.dispatch_hook()
    if isinstance(cur, TraceHook):
        ops.set_dispatch_hook(cur.inner)
    elif hook is not None and cur is hook:   # pragma: no cover - defensive
        ops.set_dispatch_hook(hook.inner)
