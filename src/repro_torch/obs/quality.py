"""Online quality monitors: screening recall, concentration, guards.

Counterpart of ``repro.obs.quality``.  The paper's speed/quality
contract is checked at serve time, at a sample rate that leaves the hot
path alone:

* **screening-recall probe** -- at a sampled subset of segment seams,
  the indexed coarse screen and the exact top-m screen run on the first
  ``probe_rows`` rows of the wave and their overlap is recorded
  (``repro_torch.index.store.screening_recall``, the metric the recall
  gates use): what degrades silently when ``ProbeSchedule`` narrows at
  high SNR.
* **concentration curve** -- per executed timestep, the golden-subset
  fraction k_t/N and the fraction of rows the coarse stage touches, as
  per-t gauges and histograms (Posterior Progressive Concentration,
  observable in production).
* **guard rates** -- finite-guard trips and degraded waves as counters,
  driven by the serving runtime.

Probe decisions draw from the counter-based splitmix stream of the
metrics module: a ``seed`` and a call order give the same probe points
whatever the clock.  The probe programs live in the engine's program
cache under ``"obs_screen_*"`` kinds, which the fault injector does not
target (a monitor that can be faulted measures the injector), and
:meth:`QualityMonitor.warmup` builds them (on the card: captures each
as a CUDA graph), so a monitor builds nothing after warmup.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import metrics as _metrics


class QualityMonitor:
    """Sampled online quality telemetry for one ``GoldDiffEngine``.

    ``sample_rate`` is the probability, at each opportunity, of running
    the recall probe (two extra dispatches); the concentration curve is
    host arithmetic and is recorded at every reported step."""

    def __init__(self, engine, registry: _metrics.MetricsRegistry | None
                 = None, sample_rate: float = 0.25, probe_rows: int = 2,
                 seed: int = 0):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got "
                             f"{sample_rate}")
        self.engine = engine
        self.registry = registry if registry is not None \
            else _metrics.REGISTRY
        self.sample_rate = float(sample_rate)
        self.probe_rows = int(probe_rows)
        self.seed = seed
        self._probe_n = 0                # sampling-decision counter
        r = self.registry
        self.recall_hist = r.histogram(
            "golddiff_screen_recall_proxy",
            "sampled indexed-vs-exact screening recall at segment seams")
        self.recall_last = r.gauge(
            "golddiff_screen_recall_last",
            "most recent screening-recall probe value")
        self.subset_hist = r.histogram(
            "golddiff_subset_frac",
            "golden-subset fraction k_t/N per executed step")
        self.occupancy_hist = r.histogram(
            "golddiff_probe_occupancy",
            "fraction of store rows touched by the coarse stage per step")
        self.steps = r.counter("golddiff_steps_total",
                               "executed denoise steps observed")
        self.probes = r.counter("golddiff_recall_probes_total",
                                "screening-recall probes executed")
        self.finite_trips = r.counter(
            "golddiff_finite_trips_total",
            "rows replaced by the Gaussian fallback after a finite-guard "
            "trip")
        self.degrades = r.counter("golddiff_degraded_waves_total",
                                  "waves served on a non-primary rung")

    # -- concentration (analytic, on the host) --------------------------------
    def _touched_frac(self, t: int) -> float:
        eng = self.engine
        if eng.use_index(t):
            return min(1.0, eng.nprobe(t) * eng.index.max_cluster
                       / eng.store.n)
        return 1.0                       # the exact screen reads every row

    def record_step(self, t: int) -> None:
        """Record the concentration curve for one executed timestep."""
        t = int(t)
        eng = self.engine
        n = eng.store.n
        _, k_t = eng.sizes(t)
        occ = self._touched_frac(t)
        self.steps.inc()
        self.subset_hist.observe(k_t / n)
        self.occupancy_hist.observe(occ)
        r = self.registry
        r.gauge(f"golddiff_k_frac_t{t}",
                "golden-subset fraction k_t/N at this timestep"
                ).set(k_t / n)
        r.gauge(f"golddiff_occupancy_t{t}",
                "coarse-stage touched fraction at this timestep").set(occ)
        if eng.use_index(t):
            r.gauge(f"golddiff_nprobe_t{t}",
                    "scheduled probe count at this timestep"
                    ).set(eng.nprobe(t))

    # -- guard / degradation hooks (driven by the runtime) ----------------------
    def on_finite_trips(self, n: int) -> None:
        self.finite_trips.inc(n)

    def on_degrade(self) -> None:
        self.degrades.inc()

    # -- recall probe -------------------------------------------------------------
    def _probe_programs(self, t: int, rows: int):
        """The (exact, indexed) probe screens for static ``t`` over a
        ``[rows, D]`` query, in the engine's program cache under the
        obs-only kinds (on the card each a CUDA graph): the exact top-m
        ids (``engine.coarse_ids``) and the probed candidates' ids and
        distances (``engine.probed_ids``).  Over a ``ProcessMesh`` both
        screen every shard and merge, so every rank gets the global
        recall; a ``LocalMesh`` engine's slot holds the whole store, so
        it screens that."""
        eng = self.engine
        m_t, _ = eng.sizes(t)
        mp, npb = eng.padded_m(t), eng.nprobe(t)
        shape = (rows, eng.store.dim)
        where = eng.device.type
        exact = eng.program(
            ("obs_screen_exact", t, shape, m_t, where),
            lambda: eng.jitter(lambda q: eng.coarse_ids(q, m_t), shape,
                               label=f"recall probe (exact) t={t}"))
        ivf = eng.program(
            ("obs_screen_ivf", t, shape, mp, npb, where),
            lambda: eng.jitter(lambda q: eng.probed_ids(q, mp, npb),
                               shape, label=f"recall probe (indexed) t={t}"))
        return exact, ivf

    def probe_recall(self, x, t: int) -> float | None:
        """Indexed-vs-exact screening recall on the first ``probe_rows``
        rows of ``x`` (the state at timestep ``t``; a numpy array or a
        tensor).  None when the step screens exactly.  Probes always run
        at ``probe_rows`` rows (short inputs are tiled), so the programs'
        shapes are static and :meth:`warmup` covers every later probe."""
        t = int(t)
        eng = self.engine
        if not eng.use_index(t) or x.shape[0] == 0:
            return None
        from repro_torch.index.store import screening_recall
        rows = max(1, self.probe_rows)
        a, _ = eng.constants(t)
        q = (x[:rows].detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x[:rows])).astype(np.float32)
        if q.shape[0] < rows:
            reps = -(-rows // q.shape[0])
            q = np.tile(q, (reps, 1))[:rows]
        q = torch.from_numpy(q / np.float32(a)).to(eng.device)
        exact_fn, ivf_fn = self._probe_programs(t, rows)
        exact_ids = exact_fn(q)
        ids, pd2 = ivf_fn(q)
        rec = screening_recall(ids, pd2, None, exact_ids)
        self.probes.inc()
        self.recall_hist.observe(rec)
        self.recall_last.set(rec)
        return rec

    def maybe_probe_recall(self, x, t: int) -> float | None:
        """Sampled :meth:`probe_recall` (deterministic decision stream)."""
        n = self._probe_n
        self._probe_n = n + 1
        if self.sample_rate <= 0.0 \
                or _metrics._unit(self.seed, n) >= self.sample_rate:
            return None
        return self.probe_recall(x, t)

    # -- summary ------------------------------------------------------------------
    def health(self) -> dict:
        """Flat summary for ``ServeRuntime.health()`` (JSON-friendly)."""
        return {
            "screen_recall_last": self.recall_last.value,
            "screen_recall_p50": self.recall_hist.quantile(0.5),
            "subset_frac_p50": self.subset_hist.quantile(0.5),
            "probe_occupancy_p50": self.occupancy_hist.quantile(0.5),
            "n_recall_probes": self.probes.value,
            "n_steps_observed": self.steps.value,
        }

    # -- warmup -------------------------------------------------------------------
    def warmup(self, ts, rows: int | None = None) -> int:
        """Build the probe programs of every indexed timestep in ``ts``
        and run each once, so monitoring builds nothing after warmup.
        Returns the number of timesteps warmed."""
        eng = self.engine
        rows = max(1, self.probe_rows if rows is None else int(rows))
        q = torch.zeros((rows, eng.store.dim), dtype=torch.float32,
                        device=eng.device)
        warmed = 0
        for t in sorted({int(t) for t in ts}):
            if not eng.use_index(t):
                continue
            exact_fn, ivf_fn = self._probe_programs(t, rows)
            exact_fn(q)
            ivf_fn(q)
            warmed += 1
        return warmed


__all__ = ["QualityMonitor"]
