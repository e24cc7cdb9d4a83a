"""Fault-tolerant serving runtime over :class:`ServeEngine`.

Counterpart of ``repro.launch.runtime``: the same admission, scheduling
and failure machinery around one warmed plan- or scan-mode engine, with
the same counters, breaker states and trace events.

* **admission control** -- requests are validated (``validate_request``)
  and enter a bounded queue; a full queue raises ``QueueFullError``.
* **plan-seam scheduling** -- a wave of co-batched requests advances one
  trajectory-plan segment at a time (``sampler.plan_segment``); between
  segments the scheduler admits, expires deadlined rows and repacks
  shrunken waves into smaller warmed batch buckets.  On the card every
  segment is a captured CUDA graph, and each seam moves the wave to the
  host and back, as the reference does.
* **continuous batching** -- each part (one request's rows) carries its
  own segment cursor; freed slots take queued requests at every seam,
  and a wave whose parts sit at different cursors runs the *mixed*
  segment (``sampler.plan_segment_mixed``), where only the rows at the
  segment's entry seam advance.
* **deadlines** -- per request (``Request.deadline_s``) or a default, on
  an injectable clock, checked at every seam and at delivery.
* **retries** -- ``faults.RETRYABLE_ERRORS`` (the injected errors,
  ``TransientExecutorError`` and ``torch.cuda.OutOfMemoryError``) retry
  with seeded exponential backoff.  Nothing else is retried: any other
  CUDA error (an illegal address, a launch failure) leaves the context
  unusable and propagates out of ``pump()``.
* **degradation ladder** -- four circuit breakers, every rung captured
  by ``warmup()``: ``screen`` (non-finite rows) -> exact-routing plan;
  ``compile`` (builds after warmup) -> scan mode; ``oom`` -> half the
  admission cap and half the steps, and the wave splits; ``exec`` ->
  retries, then the closed-form Gaussian (Wiener) segment, which only
  the retryable classes above can reach.
* **finite guard** -- rows that went non-finite in a segment are
  replaced with the Gaussian segment of the same rows.
* **hot swap** -- ``hot_swap(store, index)`` installs a grown store of
  the same shapes (``repro_torch.index.ingest``) as an engine epoch,
  copied into the warmed standby slot, probes it with a warmed segment,
  then flips the serving epoch.  In-flight waves finish on the epoch
  they were admitted under (``engine.at_epoch``); a failed probe
  quarantines the epoch (``EpochProbeError``).  No program is built or
  captured (``GoldDiffEngine`` module docstring).
* **observability** -- ``health()``, ``metrics_snapshot()`` and
  ``prometheus()`` through a ``MetricsRegistry``, and with a tracer
  enabled every request edge on the unified event schema;
  ``monitor=`` (a ``repro_torch.obs.quality.QualityMonitor``) records
  the concentration curve of every executed step, samples the
  screening-recall probe at the seams (its programs built by
  ``warmup()`` on every kept slot), counts finite-guard trips and
  degraded waves, and joins ``health()``.
* **sharded engines** -- a plan-mode engine over a ``LocalMesh`` is
  served the same way (one slot: a sharded engine does not hot-swap); an
  injected ``shard_drop`` on its dispatches retries like any executor
  error.
* **across ranks** -- over a ``ProcessMesh`` every rank runs a runtime
  over its engine and takes the same scheduler steps on the same state,
  so every rank delivers the same images and keeps the same counters,
  breakers and trace events.  The host channel's first rank (rank 0) is
  the front end: ``submit`` runs there only (another rank raises
  ``ValueError``), and each ``pump()`` opens with one
  ``mesh.host_broadcast`` of its record (the requests submitted since the
  last pump, with their clock readings, and whether to stop) and one
  ``host_max`` of whether any rank has a fault injector installed (then
  the ranks agree on every dispatch's outcome: ``faults.Agreement``).
  Inside ``pump()`` every clock reading is rank 0's, broadcast
  (``host_float``); after
  each segment one ``host_any`` joins the finite guard's row mask and
  the build counter's breaker input, so a row bad on any rank is
  replaced on all.  Only an agreed fault (one every rank raised at the
  same dispatch) is retried over ranks; any other error, retryable or
  not (say a ``TransientExecutorError`` or a real out-of-memory error
  raised inside a running segment on one rank), propagates out of that
  rank's ``pump()``, and the others' next collective fails within the
  groups' timeout, so their ``pump()`` raises too rather than hanging.  ``health()``,
  ``metrics_snapshot()`` and ``prometheus()`` stay rank-local and make
  no collective call (another rank reads the last agreed clock reading);
  ``start()``/``stop()`` run the loop on every rank, and rank 0's
  ``stop()`` ends every rank's loop at the same pump; ``hot_swap``
  raises, as for any sharded engine.

Single-threaded by design: ``pump()`` runs one scheduler step;
``run_until_idle()`` drains inline; ``start()``/``stop()`` run the loop
on a daemon thread.  A lock guards queue and wave state; segments run
outside it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import build_plan
from repro_torch.core.denoisers import WienerDenoiser
from repro_torch.core.engine import is_process_mesh
from repro_torch.core.sampler import (plan_segment, plan_segment_key,
                                      plan_segment_mixed,
                                      plan_segment_mixed_key, sample_plan)
from repro_torch.core.schedules import sampling_timesteps, take
from repro_torch.kernels import ops
from repro_torch.launch.faults import (RETRYABLE_ERRORS, Agreement,
                                       unit_uniform)
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_SALT_JITTER = 0xB0
# tickets a runtime keeps reachable by request id (``ticket``)
KEPT_TICKETS = 4096


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity."""


class EpochProbeError(RuntimeError):
    """A hot-swap candidate epoch failed its pre-flip probe (non-finite
    output or executor error) and was quarantined; the previous epoch
    keeps serving."""


def validate_request(req: Request, max_images: int) -> None:
    """Admission-time validation with actionable errors.

    ``bool`` is an ``int`` subclass, so it is rejected explicitly —
    ``Request(0, True, 0)`` is a bug, not one image.
    """
    ni = req.num_images
    if isinstance(ni, bool) or not isinstance(ni, (int, np.integer)):
        raise ValueError(f"request {req.request_id}: num_images must be "
                         f"an int, got {type(ni).__name__}")
    if ni < 1:
        raise ValueError(f"request {req.request_id}: num_images must be "
                         f">= 1, got {ni}")
    if ni > max_images:
        raise ValueError(f"request {req.request_id}: num_images={ni} "
                         f"exceeds the per-request cap {max_images}")
    sd = req.seed
    if isinstance(sd, bool) or not isinstance(sd, (int, np.integer)):
        raise ValueError(f"request {req.request_id}: seed must be an "
                         f"int, got {type(sd).__name__}")
    if sd < 0:
        raise ValueError(f"request {req.request_id}: seed must be "
                         f">= 0, got {sd}")
    if req.deadline_s is not None and not float(req.deadline_s) > 0.0:
        raise ValueError(f"request {req.request_id}: deadline_s must be "
                         f"positive, got {req.deadline_s}")


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs for the serving runtime (defaults are test-friendly).

    ``clock``/``sleep`` are injectable so deadline and backoff behavior
    is testable with a fake clock — production uses the monotonic
    clock.  ``seed`` drives the deterministic backoff jitter.
    """

    max_queue: int = 64
    max_images: int | None = None        # per-request cap; None -> max_batch
    default_deadline_s: float | None = None
    max_retries: int = 3
    backoff_base_s: float = 0.02
    backoff_max_s: float = 0.5
    jitter_frac: float = 0.25
    breaker_threshold: int = 3
    breaker_window_s: float = 30.0
    breaker_cooldown_s: float = 2.0
    max_inflight_waves: int = 2
    continuous: bool = True              # admit into in-flight waves at seams
    seed: int = 0
    idle_sleep_s: float = 0.005
    latency_reservoir: int = 1024        # bounded p50/p99 sample size
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep


@dataclasses.dataclass
class Ticket:
    """Handle returned by ``submit``; filled in as the request runs."""

    request: Request
    submitted_at: float
    expiry: float | None                 # absolute clock() time, or None
    status: str = "queued"               # queued|running|done|expired|failed
    images: np.ndarray | None = None
    latency_s: float | None = None
    degraded: bool = False               # any non-primary rung touched it


class CircuitBreaker:
    """Windowed failure counter with an open/half-open/closed state.

    ``threshold`` failures inside ``window_s`` open the breaker for
    ``cooldown_s``; after the cooldown it is half-open (the ladder
    resumes the primary rung as a probe) and one recorded success
    closes it.
    """

    def __init__(self, threshold: int, window_s: float, cooldown_s: float):
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.failures: list[float] = []
        self.open_until: float | None = None
        self._opened_at: float | None = None
        self._dwell_s = 0.0              # closed episodes' open+half-open time

    def record_failure(self, now: float) -> None:
        self.failures.append(now)
        self.failures = [t for t in self.failures
                         if t > now - self.window_s]
        if len(self.failures) >= self.threshold:
            if self._opened_at is None:
                self._opened_at = now
            self.open_until = now + self.cooldown_s

    def record_success(self, now: float) -> None:
        if self.open_until is not None and now >= self.open_until:
            self.open_until = None       # half-open probe succeeded
            self.failures = []
            if self._opened_at is not None:
                self._dwell_s += max(0.0, now - self._opened_at)
                self._opened_at = None

    def dwell_s(self, now: float) -> float:
        """Cumulative seconds spent not-closed (open or half-open): the
        degradation dwell time this breaker has imposed on the ladder."""
        d = self._dwell_s
        if self._opened_at is not None:
            d += max(0.0, now - self._opened_at)
        return d

    def state(self, now: float) -> str:
        if self.open_until is None:
            return "closed"
        return "open" if now < self.open_until else "half_open"

    def is_open(self, now: float) -> bool:
        return self.state(now) == "open"


class _ExactRouting:
    """Engine view with indexed screening forced off.

    ``build_plan`` duck-types its engine (sizes / use_index / schedule /
    store); presenting ``index = None`` and ``use_index() -> False``
    yields a plan whose every bucket routes the exact screen — the
    ``screen``-breaker rung.  On an engine without an index this
    produces the identical plan (and identical program keys), so the
    rung costs nothing to warm.
    """

    index = None

    def __init__(self, engine):
        object.__setattr__(self, "_eng", engine)

    def use_index(self, t) -> bool:
        return False

    def __getattr__(self, name):
        return getattr(self._eng, name)


@dataclasses.dataclass
class _Part:
    """One ticket's contiguous row block inside a wave.

    ``cursor`` is the index of the next plan segment this part will run
    (always a bucket seam: parts enter at 0 and only advance whole
    segments, so a part's rows are exactly at ``plan.buckets[cursor]
    .start`` on the timestep grid).  Under continuous admission parts at
    different cursors co-exist in one wave; a part whose cursor reaches
    ``num_segments`` is delivered and its rows compacted away, freeing
    slots for the queue."""

    ticket: Ticket
    n: int
    cursor: int = 0


@dataclasses.dataclass
class _Wave:
    """One co-batched row set advancing through segments.

    Not a lockstep cohort: each part carries its own segment cursor
    (see :class:`_Part`), ``ServeRuntime._pick_segment`` chooses which
    cursor group advances next, and rows whose part is frozen for a
    segment pass through the mixed program untouched.  ``x`` rows are
    prefix-packed in part order; rows past ``used`` are padding."""

    seq: int
    mode: str                            # "plan" | "scan"
    plan_name: str                       # primary|exact|short|short_exact|scan
    plan: object | None                  # TrajectoryPlan for mode == "plan"
    bucket: int                          # padded batch size (warmed)
    x: np.ndarray                        # [bucket, D] fp32 state
    parts: list[_Part]                   # prefix-packed row blocks
    epoch: int = 0                       # store epoch pinned for dispatches
    retries: int = 0
    degraded: bool = False
    degrade_reported: bool = False       # monitor.on_degrade fired once
    running: bool = False

    @property
    def used(self) -> int:
        return sum(p.n for p in self.parts)

    def num_segments(self) -> int:
        return self.plan.num_buckets if self.mode == "plan" else 1

    def cursors(self) -> list[int]:
        return sorted({p.cursor for p in self.parts})


class ServeRuntime:
    """Admission, deadlines, retries and the degradation ladder (see
    module docstring) around one warmed :class:`ServeEngine`."""

    def __init__(self, eng: ServeEngine, config: RuntimeConfig | None = None,
                 monitor=None,
                 registry: obs_metrics.MetricsRegistry | None = None):
        if eng.mode not in ("plan", "scan"):
            raise ValueError(f"ServeRuntime needs a plan- or scan-mode "
                             f"engine (got mode={eng.mode!r}); static "
                             f"mode has no shared segment seams")
        self.eng = eng
        self.engine = eng.engine         # core.GoldDiffEngine (prog cache)
        self.cfg = config or RuntimeConfig()
        self.max_images = (self.cfg.max_images if self.cfg.max_images
                           is not None else eng.max_batch)
        if self.max_images > eng.max_batch:
            raise ValueError(f"max_images={self.max_images} exceeds the "
                             f"engine's max_batch={eng.max_batch}; a "
                             f"runtime wave never chunks one request "
                             f"across waves")
        # -- degraded-plan variants (all warmed by ``warmup``)
        self.plans: dict[str, object] = {}
        if eng.mode == "plan":
            ns_short = max(2, eng.num_steps // 2)
            self.plans["primary"] = eng.plan
            if self.engine.index is not None:
                exact_view = _ExactRouting(self.engine)
                self.plans["exact"] = build_plan(exact_view, eng.num_steps)
                self.plans["short_exact"] = build_plan(exact_view, ns_short)
                self.plans["short"] = build_plan(self.engine, ns_short)
            else:
                self.plans["exact"] = eng.plan
                self.plans["short"] = build_plan(self.engine, ns_short)
                self.plans["short_exact"] = self.plans["short"]
        # -- breakers: one per failure class
        mk = lambda: CircuitBreaker(self.cfg.breaker_threshold,
                                    self.cfg.breaker_window_s,
                                    self.cfg.breaker_cooldown_s)
        self.br_exec = mk()
        self.br_screen = mk()
        self.br_oom = mk()
        self.br_compile = mk()
        # -- state
        self._lock = threading.RLock()
        self._queue: list[Ticket] = []
        self._waves: list[_Wave] = []
        self._seq = 0
        self._retry_seq = 0
        self._warm = False
        self._builds_warm = 0
        self._wiener: WienerDenoiser | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # -- over a ProcessMesh: rank 0 fronts, every rank replays
        self.ranks = is_process_mesh(self.engine.mesh)
        self.mesh = self.engine.mesh if self.ranks else None
        self.front = not self.ranks or self.mesh.host_rank == 0
        self._inbox: list[tuple] = []    # rank 0: (ticket, queue depth)
        self._tickets: collections.OrderedDict = collections.OrderedDict()
        self._now = 0.0                  # the last agreed clock reading
        self._halt = False               # rank 0's stop, agreed
        self._seam = Agreement(self.mesh) if self.ranks else None
        self.counters = {k: 0 for k in (
            "submitted", "completed", "expired", "failed", "retries",
            "finite_trips", "gauss_segments", "oom_splits", "repacks",
            "joins", "mixed_segments",
            "scan_waves", "exact_waves", "short_waves",
            "hot_swaps", "epoch_quarantined")}
        self.last_swap: dict = {}
        # -- observability: a bounded latency reservoir in the registry
        # (the monitor's, unless one is given) and the optional
        # QualityMonitor
        self.monitor = monitor
        if registry is not None:
            self.registry = registry
        elif monitor is not None:
            self.registry = monitor.registry
        else:
            self.registry = obs_metrics.REGISTRY
        self._lat_hist = obs_metrics.Histogram(
            "serve_latency_seconds", "end-to-end request latency (s)",
            reservoir=self.cfg.latency_reservoir)
        self.registry.register(self._lat_hist)

    # -- host <-> device at the seams --------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.eng.device)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32, copy=False)

    # -- Gaussian (Wiener) fallback programs ---------------------------------
    def _wiener_den(self) -> WienerDenoiser:
        """The Gaussian rung's statistics: over ranks from the slabs'
        sums, so no rank's device holds another rank's rows."""
        if self._wiener is None:
            kw = (dict(mesh=self.mesh, rows=self.engine.slab_ids())
                  if self.ranks else {})
            self._wiener = WienerDenoiser(self.eng.store, self.eng.schedule,
                                          device=self.eng.device, **kw)
        return self._wiener

    def _gauss_program(self, bucket: int, ts: tuple, start: int, stop: int):
        """The closed-form Gaussian DDIM segment ``fn(x)`` for one batch
        bucket: steps [start, stop) of the timestep grid ``ts`` with the
        Wiener posterior mean as the denoiser (rank-limited SVD form,
        finite for every finite input, no store read): the ladder's last
        rung.  One program a (bucket, span), since a captured graph has
        fixed loop bounds; it reads no store slot.  ``"gauss_seg"`` is
        not among the fault injector's default targets."""
        sched = self.eng.schedule
        clip = self.eng.clip_value
        dim = self.eng.store.dim
        key = ("gauss_seg", bucket, dim, tuple(ts), start, stop,
               None if clip is None else float(clip))

        def build():
            den = self._wiener_den()     # the host SVD: only on a build
            mu, V, lam = den.mu, den.V, den.lam
            a, b, _ = sched.tables(self.eng.device)

            def seg(x):
                for i in range(start, stop):
                    at, bt = take(a, ts[i]), take(b, ts[i])
                    coeff = (at * lam) / (at * at * lam + bt * bt)
                    x0 = mu + (((x - at * mu) @ V) * coeff) @ V.T
                    if clip is not None:
                        x0 = torch.clamp(x0, -clip, clip)
                    eps = (x - at * x0) / bt
                    x = take(a, ts[i + 1]) * x0 + take(b, ts[i + 1]) * eps
                return x

            return self.engine.jitter(seg, (bucket, dim), label=(
                f"Gaussian segment steps [{start}, {stop}) at batch "
                f"{bucket}"))

        return self.engine.program(key, build)

    def _mixed_program(self, batch: int, plan, pb):
        """The mixed-cursor segment ``fn(x, pos)`` for one (batch bucket,
        plan bucket): ``sampler.plan_segment_mixed`` with ``pos`` the
        per-row int32 grid cursors (rows at ``pb.start`` advance, the
        rest pass through).  Warmed for every plan variant."""
        shape = (batch, self.eng.store.dim)
        clip = self.eng.clip_value
        key = plan_segment_mixed_key(plan, pb, shape, "float32", clip)

        def build():
            seg = plan_segment_mixed(self.eng.denoiser.call_masked,
                                     self.eng.schedule, plan, pb, clip)
            return self.engine.jitter(
                seg, shape, ((batch,), torch.int32), label=(
                    f"mixed plan segment steps [{pb.start}, {pb.stop}) at "
                    f"shape {shape}"))

        return self.engine.program(key, build)

    def _plain_program(self, plan, pb, shape: tuple):
        """The plain segment of one plan bucket at a batch shape (the
        key ``sample_plan`` builds it under)."""
        clip = self.eng.clip_value
        key = plan_segment_key(plan, pb, shape, "float32", clip)
        return self.engine.program(key, lambda: self.engine.jitter(
            plan_segment(self.eng.denoiser.call_masked, self.eng.schedule,
                         plan, pb, clip), shape, label=(
                f"plan segment steps [{pb.start}, {pb.stop}) caps "
                f"{pb.caps.sig()} at shape {shape}")))

    def _segment_grid(self, wave: _Wave, seg: int) -> tuple[tuple, int, int]:
        """(ts, start, stop) of the wave's segment ``seg``."""
        if wave.mode == "plan":
            b = wave.plan.buckets[seg]
            return tuple(wave.plan.ts), b.start, b.stop
        ts = tuple(int(t) for t in
                   sampling_timesteps(self.eng.schedule, self.eng.num_steps))
        return ts, 0, len(ts) - 1

    def _run_gauss(self, wave: _Wave, seg: int, x: np.ndarray) -> np.ndarray:
        ts, start, stop = self._segment_grid(wave, seg)
        fn = self._gauss_program(wave.bucket, ts, start, stop)
        out = self._host(fn(self._dev(x)))
        self.counters["gauss_segments"] += 1
        return out

    def _spans(self) -> list[tuple]:
        """Every (ts, start, stop) a Gaussian segment can run: each
        bucket of each plan variant, and the scan grid."""
        scan_ts = tuple(int(t) for t in sampling_timesteps(
            self.eng.schedule, self.eng.num_steps))
        spans = {(scan_ts, 0, len(scan_ts) - 1)}
        for p in self.plans.values():
            for b in p.buckets:
                spans.add((tuple(int(t) for t in p.ts), b.start, b.stop))
        return sorted(spans)

    # -- warmup ---------------------------------------------------------------
    def warmup(self) -> dict:
        """Build every rung of the ladder for every batch bucket, on
        both kept operand slots (``engine.reserve_standby``): the
        engine's own segments, the degraded plan variants, the
        mixed-cursor segments, the scan-mode programs and the Gaussian
        segments (those read no slot).  On the card each is a captured
        CUDA graph.  After this no failure path and no hot swap into
        the standby slot builds anything (``health()`` reports
        ``compiles_post_warmup`` from the engine's build counter)."""
        t0 = time.perf_counter()
        c0 = self.engine._captures
        if self.ranks:
            self._agree_faults()
        epochs = self.engine.reserve_standby()
        slots = [self.engine._epochs[e] for e in epochs]
        stats: dict = {}
        for epoch in epochs:
            with self.engine.at_epoch(epoch):
                st = self.eng.warmup()
                stats = stats or st
                self._warm_rungs()
                if self.monitor is not None:
                    stats["probe_ts_warmed"] = self.monitor.warmup(
                        self._probe_ts())
        with self._lock:
            self._gc_epochs()        # the standby slot goes back to free
        for b in self.eng.batch_buckets():
            for ts, start, stop in self._spans():
                self._gauss_program(b, ts, start, stop)
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)
        self._warm = True
        self._builds_warm = self.engine._builds
        stats["runtime_warmup_s"] = time.perf_counter() - t0
        stats["programs_total"] = len(self.engine._programs)
        stats["graphs_captured"] = self.engine._captures - c0
        stats["slots"] = slots
        return stats

    def _probe_ts(self) -> list[int]:
        """Every timestep a recall probe can fire at: the executed steps
        of each plan variant and of the scan grid."""
        ts: set[int] = set()
        for p in self.plans.values():
            ts.update(int(t) for t in p.ts[:-1])
        ts.update(int(t) for t in sampling_timesteps(
            self.eng.schedule, self.eng.num_steps)[:-1])
        return sorted(ts)

    def _warm_rungs(self) -> None:
        """The scan rung, the plan variants and the mixed segments of
        every batch bucket, on the pinned slot."""
        dim = self.eng.store.dim
        for b in self.eng.batch_buckets():
            shape = (b, dim)
            self.eng._scan_program(shape)
            seen = {id(self.eng.plan)} if self.eng.mode == "plan" else set()
            for plan in self.plans.values():
                if id(plan) in seen:
                    continue
                seen.add(id(plan))
                sample_plan(self.eng.denoiser.call_masked, self.eng.schedule,
                            shape, plan, clip_value=self.eng.clip_value,
                            program_cache=self.engine.program,
                            compile_only=True, jitter=self.engine.jitter)
            seen_mix: set[int] = set()
            for plan in self.plans.values():
                if id(plan) in seen_mix:
                    continue
                seen_mix.add(id(plan))
                for pb in plan.buckets:
                    self._mixed_program(b, plan, pb)

    # -- store hot-swap -------------------------------------------------------
    def _probe_epoch(self, epoch: int) -> None:
        """Run one warmed program pinned at ``epoch`` on a zero input and
        require finite output: same shapes and a warmed slot, so nothing
        is built, and the new operands go through screen, re-rank and
        aggregate before any user row touches them."""
        b = self.eng.batch_buckets()[0]
        shape = (b, self.eng.store.dim)
        x = torch.zeros(shape, dtype=torch.float32, device=self.eng.device)
        with self.engine.at_epoch(epoch):
            if self.eng.mode == "plan":
                fn = self._plain_program(self.eng.plan,
                                         self.eng.plan.buckets[0], shape)
            else:
                fn = self.eng._scan_program(shape)
            out = self._host(fn(x))
        if not np.isfinite(out).all():
            raise EpochProbeError(
                f"epoch {epoch} probe produced non-finite output "
                f"({int((~np.isfinite(out)).sum())} bad values)")

    def hot_swap(self, store, index=None, epoch: int | None = None,
                 probe: bool = True) -> int:
        """Swap the serving golden store without downtime or builds.

        Installs ``(store, index)`` as a standby epoch in the warmed
        engine (copied into the free kept slot; same-shape contract
        enforced by ``engine.swap_compat``, which the appendable
        lifecycle's capacity-padded views satisfy by construction),
        probes it (:meth:`_probe_epoch`), then flips the serving epoch
        under the scheduler lock.  ``last_swap`` holds the install,
        probe and flip seconds (the card synchronized after the
        install).  Waves admitted before the flip finish on their own
        epoch (``_Wave.epoch``); waves admitted after see the new store.  A failed probe
        quarantines the epoch — it is retired, ``epoch_quarantined``
        increments, :class:`EpochProbeError` propagates, and the old
        epoch keeps serving untouched.

        Returns the installed epoch id (``epoch`` if given — e.g. the
        lifecycle's on-disk epoch number — else the next free int).
        Over a ``ProcessMesh`` it raises ``ValueError``: a sharded engine
        holds per-rank slabs and does not hot-swap.
        """
        if self.ranks:
            raise ValueError("ServeRuntime.hot_swap over a ProcessMesh: "
                             "sharded engines do not hot-swap (each rank "
                             "holds its slab; rebuild the engines)")
        tr = obs_trace.tracer()
        t0 = time.perf_counter()
        with self._lock:
            if epoch is None:
                epoch = max(self.engine._epochs) + 1
            epoch = int(epoch)
            if epoch == self.engine.serving_epoch:
                raise ValueError(f"epoch {epoch} is already serving")
            self.engine.install_epoch(epoch, store, index)
        self._sync()
        t1 = time.perf_counter()
        if probe:
            try:
                self._probe_epoch(epoch)
            except (EpochProbeError, *RETRYABLE_ERRORS) as e:
                with self._lock:
                    self.engine.retire_epoch(epoch)
                    self.counters["epoch_quarantined"] += 1
                if tr.enabled:
                    tr.event("epoch.quarantine", epoch=epoch,
                             error=type(e).__name__)
                if isinstance(e, EpochProbeError):
                    raise
                raise EpochProbeError(
                    f"epoch {epoch} probe failed: {e}") from e
        t2 = time.perf_counter()
        with self._lock:
            prev = self.engine.serving_epoch
            self.engine.set_serving_epoch(epoch)
            self.counters["hot_swaps"] += 1
            self._gc_epochs()
        self.last_swap = {"install_s": t1 - t0, "probe_s": t2 - t1,
                          "flip_s": time.perf_counter() - t2}
        if tr.enabled:
            tr.event("epoch.swap", epoch=epoch, prev=prev)
        return epoch

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)

    def _gc_epochs(self) -> None:
        """Retire standby epochs no in-flight wave references (caller
        holds the lock).  Serving and wave-pinned epochs survive; the
        rest give their slots back (``engine.retire_epoch``)."""
        live = {w.epoch for w in self._waves}
        live.add(self.engine.serving_epoch)
        for e in [e for e in self.engine._epochs if e not in live]:
            self.engine.retire_epoch(e)

    # -- the ranks' agreement ---------------------------------------------------
    def _clock(self) -> float:
        """A clock reading inside ``pump()``: over ranks rank 0's, one
        ``host_float`` (no other rank reads its own clock here)."""
        if not self.ranks:
            return self.cfg.clock()
        self._now = self.mesh.host_float(
            self.cfg.clock() if self.front else None)
        return self._now

    def _local_now(self) -> float:
        """The time ``health()`` and the metrics read: the clock, or on a
        rank other than 0 the last agreed reading (no collective)."""
        return self.cfg.clock() if self.front else self._now

    def _agree_faults(self) -> None:
        """One ``host_max``: whether any rank has a fault injector
        installed; if one has, every lookup and dispatch of this step
        agrees its outcome (``faults.Agreement``), else the seam adds no
        collective."""
        (any_hook,) = self.mesh.host_max(int(ops.dispatch_hook() is not None))
        self._seam.active = bool(any_hook)
        self.engine.seam = self._seam

    def _take_record(self) -> None:
        """Open a scheduler step over ranks: rank 0's record (the
        requests submitted since the last step and whether to stop), one
        ``host_broadcast``; every other rank queues the same tickets, as
        ``submit`` queued them on rank 0."""
        rec = None
        if self.front:
            with self._lock:
                new, self._inbox = self._inbox, []
                self._queue.extend(t for t, _ in new)
                rec = {"stop": self._stop.is_set(), "new": [
                    (t.request.request_id, int(t.request.num_images),
                     int(t.request.seed), t.request.deadline_s,
                     t.submitted_at, t.expiry, depth)
                    for t, depth in new]}
        rec = self.mesh.host_broadcast(rec)
        self._agree_faults()
        self._halt = rec["stop"]
        if self.front:
            return
        tr = obs_trace.tracer()
        with self._lock:
            for rid, n, seed, dl, at, expiry, depth in rec["new"]:
                t = Ticket(request=Request(rid, n, seed, deadline_s=dl),
                           submitted_at=at, expiry=expiry)
                self._queue.append(t)
                self._keep(t)
                self.counters["submitted"] += 1
                if tr.enabled:
                    tr.event("request.admit", request=rid, images=n,
                             queue_depth=depth)

    def _keep(self, t: Ticket) -> None:
        self._tickets[t.request.request_id] = t
        while len(self._tickets) > KEPT_TICKETS:
            self._tickets.popitem(last=False)

    def ticket(self, request_id) -> Ticket:
        """The latest ticket of ``request_id`` on this rank, of the last
        ``KEPT_TICKETS`` (``submit`` returned it; over ranks every rank
        but 0 made it from rank 0's record)."""
        return self._tickets[request_id]

    # -- admission ------------------------------------------------------------
    def submit(self, req: Request) -> Ticket:
        """Validate + enqueue; raises ``ValueError`` (bad request) or
        ``QueueFullError`` (admission control) instead of accepting
        work it cannot serve.  Over ranks rank 0 admits (any other rank
        raises ``ValueError``) and the request reaches the queue, every
        rank's, at the next ``pump()``."""
        if not self.front:
            raise ValueError(
                f"submit runs on rank 0 of the mesh's host channel, the "
                f"front end; this is rank {self.mesh.host_rank}, which "
                f"replays rank 0's requests")
        validate_request(req, self.max_images)
        with self._lock:
            if len(self._queue) + len(self._inbox) >= self.cfg.max_queue:
                raise QueueFullError(
                    f"queue at capacity ({self.cfg.max_queue}); retry "
                    f"after the backlog drains")
            now = self.cfg.clock()
            dl = req.deadline_s if req.deadline_s is not None \
                else self.cfg.default_deadline_s
            t = Ticket(request=req, submitted_at=now,
                       expiry=None if dl is None else now + float(dl))
            depth = len(self._queue) + len(self._inbox) + 1
            if self.ranks:
                self._inbox.append((t, depth))
            else:
                self._queue.append(t)
            self._keep(t)
            self.counters["submitted"] += 1
            tr = obs_trace.tracer()
            if tr.enabled:
                tr.event("request.admit", request=req.request_id,
                         images=int(req.num_images), queue_depth=depth)
            return t

    def _expire_queued(self, now: float) -> None:
        keep = []
        tr = obs_trace.tracer()
        for t in self._queue:
            if t.expiry is not None and now > t.expiry:
                t.status = "expired"
                self.counters["expired"] += 1
                if tr.enabled:
                    tr.event("request.expire", request=t.request.request_id,
                             phase="queued")
            else:
                keep.append(t)
        self._queue = keep

    def _pick_rung(self, now: float) -> tuple[str, str, object, int]:
        """(mode, plan_name, plan, admission cap) for a new wave, by
        breaker state.  Precedence: build storms force scan mode
        (fewest cache lookups); OOM halves admission and steps; a
        tripped screen guard forces exact routing."""
        cap = self.eng.max_batch
        if self.eng.mode == "scan" or self.br_compile.is_open(now):
            return "scan", "scan", None, cap
        oom = self.br_oom.is_open(now)
        if oom:
            cap = max(1, self.eng.max_batch // 2)
        base = "short" if oom else "primary"
        if self.br_screen.is_open(now):
            base = {"primary": "exact", "short": "short_exact"}[base]
        return "plan", base, self.plans[base], cap

    def _admit(self, now: float) -> None:
        """Seam admission: fill freed slots in in-flight waves first
        (continuous batching — joined parts start at cursor 0 while
        their wave-mates keep theirs), then open new waves while the
        in-flight cap allows.

        ``request.admit`` fires exactly once, at ``submit`` time: a
        request that waits across many seams is neither re-counted nor
        re-traced here — joins emit ``wave.join`` and new waves emit
        ``wave.admit``, so per-request admit metrics stay single-count
        no matter how many seams it sat through."""
        if not self._queue:
            return
        mode, name, plan, cap = self._pick_rung(now)
        if self.cfg.continuous and mode == "plan":
            for w in self._waves:
                if not self._queue:
                    return
                if w.running or w.mode != "plan" or w.plan_name != name:
                    continue             # never mix plan variants in a wave
                if w.epoch != self.engine.serving_epoch:
                    continue             # one epoch per wave: joiners must
                self._join_wave(w, cap, now)  # see the serving store
        while self._queue and len(self._waves) < self.cfg.max_inflight_waves:
            parts: list[_Part] = []
            used = 0
            while self._queue and \
                    used + self._queue[0].request.num_images <= cap:
                t = self._queue.pop(0)
                t.status = "running"
                parts.append(_Part(t, t.request.num_images))
                used += t.request.num_images
            if not parts:
                return                   # head request exceeds current cap
            bucket = self.eng._bucket_for(used)
            x = self.eng._noise_rows(
                [(p.ticket.request, 0, p.n) for p in parts], bucket).numpy()
            wave = _Wave(seq=self._seq, mode=mode, plan_name=name,
                         plan=plan, bucket=bucket, x=x, parts=parts,
                         epoch=self.engine.serving_epoch,
                         degraded=(name not in ("primary",)
                                   and self.eng.mode != "scan"))
            self._seq += 1
            if name == "scan" and self.eng.mode != "scan":
                self.counters["scan_waves"] += 1
            elif name in ("exact", "short_exact"):
                self.counters["exact_waves"] += 1
            if name in ("short", "short_exact"):
                self.counters["short_waves"] += 1
            self._waves.append(wave)
            tr = obs_trace.tracer()
            if tr.enabled:
                tr.event("wave.admit", wave=wave.seq, mode=mode, plan=name,
                         bucket=bucket, used=used,
                         requests=[p.ticket.request.request_id
                                   for p in parts])

    def _join_wave(self, wave: _Wave, cap: int, now: float) -> None:
        """Admit queued requests into a freed slot of an in-flight wave.

        The joining part starts its own trajectory at cursor 0; its
        terminal noise comes from the request's own ``row_seed(seed,
        row)`` generators, the rows the request would get in a fresh
        wave.  The wave's batch bucket
        grows to the smallest warmed bucket that fits (a repack — the
        mirror image of deadline compaction's shrink)."""
        joined: list[_Part] = []
        used = wave.used
        while self._queue and \
                used + self._queue[0].request.num_images <= cap:
            t = self._queue.pop(0)
            t.status = "running"
            joined.append(_Part(t, t.request.num_images))
            used += t.request.num_images
        if not joined:
            return
        tr = obs_trace.tracer()
        bucket = self.eng._bucket_for(used)
        if bucket > wave.bucket:
            x = np.zeros((bucket, wave.x.shape[1]), np.float32)
            x[: wave.used] = wave.x[: wave.used]
            self.counters["repacks"] += 1
            if tr.enabled:
                tr.event("wave.repack", wave=wave.seq, bucket=bucket,
                         prev_bucket=wave.bucket, used=wave.used)
            wave.x, wave.bucket = x, bucket
        ofs = wave.used
        for p in joined:
            rows = self.eng._noise_rows([(p.ticket.request, 0, p.n)],
                                        self.eng._bucket_for(p.n)).numpy()[: p.n]
            wave.x[ofs: ofs + p.n] = rows
            wave.parts.append(p)
            self.counters["joins"] += 1
            if tr.enabled:
                tr.event("wave.join", wave=wave.seq,
                         request=p.ticket.request.request_id,
                         rows=p.n, slot=ofs, cursor=0,
                         queue_wait_s=now - p.ticket.submitted_at)
            ofs += p.n

    def _pick_wave(self, now: float) -> _Wave | None:
        """Earliest-deadline-first over waves, FIFO on ties."""
        cands = [w for w in self._waves if not w.running]
        if not cands:
            return None

        def urgency(w: _Wave):
            exps = [p.ticket.expiry for p in w.parts
                    if p.ticket.expiry is not None]
            return (min(exps) if exps else float("inf"), w.seq)

        return min(cands, key=urgency)

    def _pick_segment(self, wave: _Wave) -> int:
        """Which cursor group advances next: earliest deadline first
        (deadline correctness dominates), ties to the SMALLEST cursor —
        catch-up-and-merge scheduling.  Freezing the front group while
        fresh joiners replay the early buckets lets trailing cursors
        *reach* leading ones; parts at equal cursors automatically run
        as one dispatch from then on (``_pos_rows`` activates every
        part at the picked seam), so converging trajectories coalesce
        and share all remaining segments.  That coalescing — more rows
        per dispatch, fewer dispatches per request — is where continuous
        batching beats wave-at-a-time under sustained load; draining
        the front group
        first would keep every join in its own private dispatch stream.
        No group starves: parts only enter at cursor 0, cursors only
        increase, and a trailing group either merges into the group
        ahead of it or leaves the wave within ``num_segments`` picks."""
        if wave.mode != "plan":
            return 0
        best, best_key = 0, None
        for c in wave.cursors():
            exps = [p.ticket.expiry for p in wave.parts
                    if p.cursor == c and p.ticket.expiry is not None]
            k = (min(exps) if exps else float("inf"), c)
            if best_key is None or k < best_key:
                best, best_key = c, k
        return best

    def _pos_rows(self, wave: _Wave, seg: int) -> tuple[np.ndarray,
                                                        np.ndarray]:
        """Per-row grid cursors + activity mask for segment ``seg``:
        ``pos[r]`` is the timestep-grid index row r sits at (its part's
        bucket seam); rows are active iff that seam is this segment's
        entry.  Padding rows get -1, which never matches a seam."""
        pos = np.full((wave.bucket,), -1, np.int32)
        ofs = 0
        for p in wave.parts:
            pos[ofs: ofs + p.n] = wave.plan.buckets[p.cursor].start
            ofs += p.n
        return pos, pos == wave.plan.buckets[seg].start

    # -- segment execution (outside the lock) ---------------------------------
    def _segment_fn(self, wave: _Wave, seg: int, mixed: bool):
        shape = (wave.bucket, self.eng.store.dim)
        if wave.mode == "scan":
            return self.eng._scan_program(shape)
        plan, b = wave.plan, wave.plan.buckets[seg]
        if mixed:
            return self._mixed_program(wave.bucket, plan, b)
        return self._plain_program(plan, b, shape)

    def _backoff(self, attempt: int) -> None:
        self._retry_seq += 1
        u = unit_uniform(self.cfg.seed, self._retry_seq, _SALT_JITTER)
        d = min(self.cfg.backoff_max_s,
                self.cfg.backoff_base_s * (2.0 ** (attempt - 1)))
        self.cfg.sleep(max(0.0, d * (1.0 + self.cfg.jitter_frac
                                     * (2.0 * u - 1.0))))

    @staticmethod
    def _is_oom(msg: str) -> bool:
        m = msg.lower()
        return "resource_exhausted" in m or "out of memory" in m \
            or "out-of-memory" in m

    def _run_segment(self, wave: _Wave, seg: int):
        """Run segment ``seg`` of the wave with retries, the OOM split
        escape hatch, and the Gaussian fallback.  Returns
        ``("ok", new_x)`` or ``("split", None)``.  With tracing enabled
        the whole attempt loop runs inside a ``wave.segment`` span whose
        ``cursor``/``active``/``frozen`` tags record which rows advanced
        (``scripts/trace_latency.py`` reconstructs per-request
        queue/compute timelines from them)."""
        tr = obs_trace.tracer()
        # every dispatch of this wave resolves operands from the epoch
        # it was admitted under — a hot_swap between its seams changes
        # nothing for it (the swap's whole zero-downtime contract)
        if not tr.enabled:
            with self.engine.at_epoch(wave.epoch):
                return self._run_segment_inner(wave, seg, tr)
        ts, start, stop = self._segment_grid(wave, seg)
        n_act = wave.used
        if wave.mode == "plan":
            _, act = self._pos_rows(wave, seg)
            n_act = int(act[: wave.used].sum())
        with tr.span("wave.segment", wave=wave.seq, cursor=seg,
                     mode=wave.mode, plan=wave.plan_name,
                     bucket=wave.bucket, used=wave.used,
                     active=n_act, frozen=wave.used - n_act,
                     start=start, stop=stop, epoch=wave.epoch):
            with self.engine.at_epoch(wave.epoch):
                return self._run_segment_inner(wave, seg, tr)

    def _run_segment_inner(self, wave: _Wave, seg: int, tr):
        x_prev = wave.x
        mixed = False
        act = np.ones(wave.bucket, bool)
        if wave.mode == "plan":
            pos, act = self._pos_rows(wave, seg)
            # an aligned wave (every part at this seam) runs the PLAIN
            # per-bucket program — bit-identical to wave-at-a-time and
            # to ServeEngine.serve; the mixed program only dispatches
            # when cursors actually diverge
            mixed = not bool(act[: wave.used].all())
        attempt = 0
        built = None
        while True:
            builds0 = self.engine._builds
            try:
                if mixed:
                    fn = self._segment_fn(wave, seg, True)
                    self.counters["mixed_segments"] += 1
                    out = fn(self._dev(x_prev), self._dev(pos))
                else:
                    fn = self._segment_fn(wave, seg, False)
                    out = fn(self._dev(x_prev))
                out = self._host(out)
                # evict-then-rebuild storms (and a third live epoch's
                # slot) build without changing the cache size; the build
                # counter sees them and arms the scan-mode rung (below)
                built = self.engine._builds > builds0 and self._warm
                break
            except RETRYABLE_ERRORS as e:
                if self.ranks and not getattr(e, "agreed", False):
                    # one rank's own error: retried alone, it would make
                    # collectives the other ranks do not make
                    raise
                now = self._clock()
                oom = self._is_oom(str(e))
                if tr.enabled:
                    tr.event("wave.retry", wave=wave.seq, attempt=attempt,
                             oom=oom, error=type(e).__name__)
                if oom:
                    self.br_oom.record_failure(now)
                    if wave.bucket > 1:
                        return "split", None
                else:
                    self.br_exec.record_failure(now)
                attempt += 1
                self.counters["retries"] += 1
                wave.retries += 1
                if attempt > self.cfg.max_retries:
                    if tr.enabled:
                        tr.event("wave.gauss_fallback", wave=wave.seq,
                                 cursor=seg)
                    out = self._run_gauss(wave, seg, x_prev)
                    if wave.mode == "plan":
                        # frozen rows stay frozen: the Gaussian segment
                        # ran THIS segment's grid span, which only the
                        # active rows are at
                        out = np.where(act[:, None], out, x_prev)
                    wave.degraded = True
                    break
                self._backoff(attempt)
        # per-row finite guard: never let NaN/inf cross a seam.  Frozen
        # rows are untouched copies of state that already passed this
        # guard, so only active rows can trip it (and only active rows
        # may take the Gaussian replacement — it ran this segment's
        # span, not theirs).
        used = wave.used
        row_ok = np.isfinite(out[:used]).all(axis=1) | ~act[:used]
        if self.ranks:
            # one OR over the ranks: a row bad on any rank is replaced on
            # every rank, and a build on any rank arms every rank's rung
            bad = self.mesh.host_any(np.append(~row_ok, bool(built)))
            row_ok = ~bad[:-1]
            built = None if built is None else bool(bad[-1])
        if built is not None:
            if built:
                self.br_compile.record_failure(self._clock())
            else:
                self.br_compile.record_success(self._clock())
        if not row_ok.all():
            nbad = int((~row_ok).sum())
            self.counters["finite_trips"] += nbad
            if self.monitor is not None:
                self.monitor.on_finite_trips(nbad)
            if tr.enabled:
                tr.event("wave.finite_trip", wave=wave.seq, rows=nbad)
            self.br_screen.record_failure(self._clock())
            gauss = self._run_gauss(wave, seg, x_prev)
            bad = np.flatnonzero(~row_ok)
            if not out.flags.writeable:
                out = np.array(out)
            out[bad] = gauss[bad]
            wave.degraded = True
        else:
            self.br_screen.record_success(self._clock())
            self.br_exec.record_success(self._clock())
        return "ok", out

    # -- post-segment bookkeeping (under the lock) ----------------------------
    def _split(self, wave: _Wave) -> None:
        """Halve an OOM-ing wave into two waves on warmed smaller
        buckets, preserving per-ticket row blocks and each part's own
        segment cursor (children of a mixed-cursor wave stay mixed)."""
        self.counters["oom_splits"] += 1
        half, first, second, acc = wave.used / 2.0, [], [], 0
        for p in wave.parts:
            (first if acc < half else second).append(p)
            acc += p.n
        if not second:                   # single ticket: move it wholesale
            second = [first.pop()]
        self._waves.remove(wave)
        ofs = 0
        for parts in (first, second):
            if not parts:
                continue
            used = sum(p.n for p in parts)
            bucket = self.eng._bucket_for(used)
            x = np.zeros((bucket, wave.x.shape[1]), np.float32)
            x[:used] = wave.x[ofs: ofs + used]
            ofs += used
            self._waves.append(_Wave(
                seq=self._seq, mode=wave.mode, plan_name=wave.plan_name,
                plan=wave.plan, bucket=bucket, x=x, parts=parts,
                epoch=wave.epoch, retries=wave.retries, degraded=True))
            tr = obs_trace.tracer()
            if tr.enabled:
                tr.event("wave.split", wave=wave.seq, child=self._seq,
                         bucket=bucket, used=used)
            self._seq += 1

    def _deliver_part(self, wave: _Wave, p: _Part, ofs: int,
                      now: float) -> None:
        """Deliver one completed part.  The delivery-time deadline check
        keeps the "completed implies within deadline" invariant; ``ofs``
        is the part's row slot in the wave (the ``slot`` trace tag)."""
        shape = self.eng.store.image_shape
        tr = obs_trace.tracer()
        t = p.ticket
        rows = wave.x[ofs: ofs + p.n]
        if t.expiry is not None and now > t.expiry:
            t.status = "expired"         # strict: late even at the end
            self.counters["expired"] += 1
            if tr.enabled:
                tr.event("request.expire",
                         request=t.request.request_id, phase="deliver")
            return
        if not np.isfinite(rows).all():         # unreachable by design;
            t.status = "failed"                 # belt over the suspenders
            self.counters["failed"] += 1
            if tr.enabled:
                tr.event("request.failed",
                         request=t.request.request_id)
            return
        t.images = rows.reshape((p.n,) + tuple(shape)).copy()
        t.latency_s = now - t.submitted_at
        t.degraded = t.degraded or wave.degraded
        t.status = "done"
        self.counters["completed"] += 1
        self._lat_hist.observe(t.latency_s)
        if tr.enabled:
            tr.event("request.deliver", request=t.request.request_id,
                     wave=wave.seq, slot=ofs, latency_s=t.latency_s,
                     degraded=t.degraded)

    def _drop_parts(self, wave: _Wave, drop: set, now: float) -> bool:
        """Remove parts (by ``id``) from a wave — delivered or expired —
        compact survivors' rows to the prefix, and repack to the
        smallest warmed bucket that still fits (slots freed here are
        what ``_join_wave`` refills at the next seam).  Returns True if
        the wave emptied and was removed."""
        alive = [p for p in wave.parts if id(p) not in drop]
        if not alive:
            self._waves.remove(wave)
            return True
        keep = np.zeros(wave.used, bool)
        ofs = 0
        for p in wave.parts:
            if id(p) not in drop:
                keep[ofs: ofs + p.n] = True
            ofs += p.n
        used = int(keep.sum())
        bucket = self.eng._bucket_for(used)
        x = np.zeros((bucket, wave.x.shape[1]), np.float32)
        x[:used] = wave.x[: len(keep)][keep]
        if bucket < wave.bucket:
            self.counters["repacks"] += 1
            tr = obs_trace.tracer()
            if tr.enabled:
                tr.event("wave.repack", wave=wave.seq,
                         bucket=bucket, prev_bucket=wave.bucket,
                         used=used)
        wave.x, wave.bucket, wave.parts = x, bucket, alive
        return False

    def _post_segment(self, wave: _Wave, seg: int, result) -> None:
        status, out = result
        now = self._clock()
        if status == "split":
            self._split(wave)
            return
        if self.monitor is not None:
            ts, start, stop = self._segment_grid(wave, seg)
            for i in range(start, stop):
                self.monitor.record_step(int(ts[i]))
            self.monitor.maybe_probe_recall(out[:wave.used],
                                            int(ts[stop - 1]))
        wave.x = out
        nseg = wave.num_segments()
        for p in wave.parts:
            if wave.mode != "plan":
                p.cursor = nseg          # scan: whole trajectory in one go
            elif p.cursor == seg:
                p.cursor = seg + 1
        done_ids, ofs = set(), 0
        for p in wave.parts:
            if p.cursor >= nseg:
                self._deliver_part(wave, p, ofs, now)
                done_ids.add(id(p))
            ofs += p.n
        if done_ids:
            if wave.degraded and not wave.degrade_reported \
                    and self.monitor is not None:
                wave.degrade_reported = True
                self.monitor.on_degrade()
            if self._drop_parts(wave, done_ids, now):
                return
        self._compact_expired(wave, now)

    def _compact_expired(self, wave: _Wave, now: float) -> bool:
        """Bucket-seam deadline enforcement: expire deadlined tickets,
        compact survivors to the prefix, repack to a smaller warmed
        bucket when possible.  Returns True if the whole wave died."""
        drop: set = set()
        tr = obs_trace.tracer()
        for p in wave.parts:
            if p.ticket.expiry is not None and now > p.ticket.expiry:
                p.ticket.status = "expired"
                self.counters["expired"] += 1
                drop.add(id(p))
                if tr.enabled:
                    tr.event("request.expire",
                             request=p.ticket.request.request_id,
                             phase="seam", wave=wave.seq)
        if not drop:
            return False
        return self._drop_parts(wave, drop, now)

    # -- scheduler loop -------------------------------------------------------
    def pump(self) -> bool:
        """One scheduler step.  Returns True if a segment ran.  Over
        ranks it opens with rank 0's record (``_take_record``)."""
        if self.ranks:
            self._take_record()
        with self._lock:
            now = self._clock()
            self._expire_queued(now)
            # pre-admission seam: rows already past their deadline are
            # dropped BEFORE admission, so the slots they free (and the
            # smaller repacked buckets) are joinable at this very seam
            for w in list(self._waves):
                if not w.running:
                    self._compact_expired(w, now)
            self._admit(now)
            wave = self._pick_wave(now)
            if wave is None:
                return False
            seg = self._pick_segment(wave)
            wave.running = True
        try:
            result = self._run_segment(wave, seg)
        finally:
            with self._lock:
                wave.running = False
        with self._lock:
            self._post_segment(wave, seg, result)
            self._gc_epochs()            # waves done on an old epoch may
        return True                      # have been its last reference

    def run_until_idle(self, max_iters: int = 100_000) -> None:
        """Drain the queue and all in-flight waves inline.

        Audited for continuous admission: a queue that refills at every
        seam cannot starve the idle condition, because ``pump`` returns
        True whenever ANY segment ran — the sleep branch below is
        reached only when nothing was runnable at all (the head request
        exceeds a degraded admission cap while no wave has work), never
        merely because admission kept finding fresh joins.  Each pump
        that admits also advances a cursor group, and every group is
        finitely many segments from delivery, so with a finite queue the
        loop strictly consumes work."""
        for _ in range(max_iters):
            if not self.pump():
                with self._lock:
                    if not self._queue and not self._waves:
                        return
                # stalled but not idle: the head request exceeds a
                # degraded admission cap — wait out the breaker cooldown
                # instead of spinning through the iteration budget
                self.cfg.sleep(self.cfg.idle_sleep_s)
        raise RuntimeError(f"runtime did not go idle in {max_iters} "
                           f"pump iterations")

    def start(self) -> None:
        """Run the scheduler loop on a daemon thread.  Over ranks every
        rank starts one, and the loops end together: at the pump whose
        record carries rank 0's ``stop()``."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._halt = False

        def loop():
            while not (self._halt if self.ranks else self._stop.is_set()):
                if not self.pump() and not self._halt:
                    self._stop.wait(self.cfg.idle_sleep_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-runtime")
        self._thread.start()

    def stop(self) -> None:
        """End the loop; over ranks rank 0's call ends every rank's, and
        another rank's call waits for that."""
        if self._thread is None:
            return
        if self.front:
            self._stop.set()
        self._thread.join()
        self._thread = None

    # -- observability --------------------------------------------------------
    def health(self) -> dict:
        with self._lock:
            now = self._local_now()
            finished = (self.counters["completed"]
                        + self.counters["expired"] + self.counters["failed"])
            h = {
                "queue_depth": len(self._queue),
                "inflight_waves": len(self._waves),
                "breaker_exec": self.br_exec.state(now),
                "breaker_screen": self.br_screen.state(now),
                "breaker_oom": self.br_oom.state(now),
                "breaker_compile": self.br_compile.state(now),
                "dwell_exec_s": self.br_exec.dwell_s(now),
                "dwell_screen_s": self.br_screen.dwell_s(now),
                "dwell_oom_s": self.br_oom.dwell_s(now),
                "dwell_compile_s": self.br_compile.dwell_s(now),
                "degraded_scan_mode": (self.eng.mode == "plan"
                                       and self.br_compile.is_open(now)),
                "degraded_exact_screen": self.br_screen.is_open(now),
                "degraded_reduced_batch": self.br_oom.is_open(now),
                "compiles_post_warmup": (self.engine._builds
                                         - self._builds_warm
                                         if self._warm else 0),
                "serving_epoch": self.engine.serving_epoch,
                "epochs_resident": len(self.engine._epochs),
                "p50_ms": self._lat_hist.quantile(0.5) * 1e3,
                "p95_ms": self._lat_hist.quantile(0.95) * 1e3,
                "p99_ms": self._lat_hist.quantile(0.99) * 1e3,
                "latency_samples": self._lat_hist.count,
                "deadline_miss_rate": (self.counters["expired"] / finished
                                       if finished else 0.0),
                **{f"n_{k}": v for k, v in self.counters.items()},
            }
            if self.monitor is not None:
                h.update(self.monitor.health())
            return h

    def _sync_registry(self, now: float) -> None:
        """Mirror runtime-local state (counters, breakers, queue) into
        ``self.registry`` so one export carries the whole stack's
        metrics (the latency histogram was registered at
        construction)."""
        reg = self.registry
        for k, v in self.counters.items():
            reg.gauge(f"serve_{k}_total").set(v)
        reg.gauge("serve_queue_depth").set(len(self._queue))
        reg.gauge("serve_inflight_waves").set(len(self._waves))
        reg.gauge("serve_compiles_post_warmup").set(
            self.engine._builds - self._builds_warm if self._warm else 0)
        reg.gauge("serve_serving_epoch").set(self.engine.serving_epoch)
        reg.gauge("serve_epochs_resident").set(len(self.engine._epochs))
        for name, br in (("exec", self.br_exec),
                         ("screen", self.br_screen),
                         ("oom", self.br_oom),
                         ("compile", self.br_compile)):
            reg.gauge(f"serve_breaker_{name}_open").set(
                1.0 if br.is_open(now) else 0.0)
            reg.gauge(f"serve_breaker_{name}_dwell_seconds").set(
                br.dwell_s(now))

    def metrics_snapshot(self) -> dict:
        """JSON-friendly dict of every metric in the registry."""
        with self._lock:
            self._sync_registry(self._local_now())
        return self.registry.snapshot()

    def prometheus(self) -> str:
        """Prometheus text exposition of the same registry."""
        with self._lock:
            self._sync_registry(self._local_now())
        return self.registry.prometheus()
