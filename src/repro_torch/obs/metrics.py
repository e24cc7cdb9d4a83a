"""Typed metrics: counters, gauges, bounded-quantile histograms.

Counterpart of ``repro.obs.metrics``.  :class:`Histogram` keeps a
fixed-size reservoir (Vitter's algorithm R on a counter-based
splitmix64 stream, no global RNG state): O(reservoir) memory, exact
quantiles while ``count <= reservoir`` and a uniform sample beyond it.
The serving runtime's p50/p99 read it.

All metrics live in a :class:`MetricsRegistry`; :data:`REGISTRY` is the
process-global default, and tests build private registries.  Two
exports: ``registry.snapshot()`` (a plain-JSON dict, name -> typed cell)
and ``registry.prometheus()`` (Prometheus text format 0.0.4: counters
and gauges as samples, histograms as summaries with ``quantile`` labels
and ``_sum``/``_count``).  The registry locks only when it creates a
metric.
"""
from __future__ import annotations

import math
import re
import threading

_M64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _unit(seed: int, n: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, counter)."""
    return _splitmix64((seed * 0xD1B54A32D192ED03
                        + n * 0x8CB92BA72F3D8DD7) & _M64) / 2.0 ** 64


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


class Counter:
    """Monotone counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def cell(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def cell(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Bounded-quantile histogram over a fixed-size reservoir.

    ``observe(v)`` is O(1); ``quantile(q)`` sorts the reservoir
    (O(R log R), an exporter-path cost).  While ``count <= reservoir``
    the sample IS the stream, so quantiles are exact; beyond it,
    algorithm R keeps each seen value with probability R/count —
    a uniform sample, so quantile error concentrates as O(1/sqrt(R)).
    """

    kind = "histogram"
    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", reservoir: int = 1024,
                 seed: int = 0):
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.name = name
        self.help = help
        self.reservoir = int(reservoir)
        self.seed = seed
        self._sample: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        n = self.count
        self.count = n + 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if n < self.reservoir:
            self._sample.append(v)
        else:
            j = int(_unit(self.seed, n) * (n + 1))
            if j < self.reservoir:
                self._sample[j] = v

    def quantile(self, q: float) -> float:
        if not self._sample:
            return 0.0
        s = sorted(self._sample)
        # linear interpolation between closest ranks (numpy default)
        pos = q * (len(s) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def cell(self) -> dict:
        c = {"type": "histogram", "count": self.count, "sum": self.sum,
             "min": self.min if self.count else 0.0,
             "max": self.max if self.count else 0.0}
        for q in self.QUANTILES:
            c[f"p{int(q * 100)}"] = self.quantile(q)
        return c


class MetricsRegistry:
    """Named metric store with idempotent typed constructors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, requested "
                                f"{cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", reservoir: int = 1024,
                  seed: int = 0) -> Histogram:
        return self._get(Histogram, name, help, reservoir=reservoir,
                         seed=seed)

    def register(self, metric) -> None:
        """Adopt an externally constructed metric (last-wins on name
        collisions — e.g. a fresh ``ServeRuntime`` re-registering its
        private latency histogram replaces a stale predecessor's)."""
        with self._lock:
            self._metrics[metric.name] = metric

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON dict of every metric (name -> typed cell)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.cell() for name, m in items}

    def prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines = []
        for name, m in items:
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} summary")
                for q in Histogram.QUANTILES:
                    lines.append(f'{pn}{{quantile="{q}"}} '
                                 f"{m.quantile(q):.9g}")
                lines.append(f"{pn}_sum {m.sum:.9g}")
                lines.append(f"{pn}_count {m.count}")
            else:
                lines.append(f"# TYPE {pn} {m.kind}")
                lines.append(f"{pn} {m.value:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = MetricsRegistry()
