"""GoldDiff execution engine: coarse screen -> exact re-rank -> aggregate.

Counterpart of ``repro.core.engine`` for one device.  A step runs one
of two bodies:

* staged (``_denoise_body``): the coarse screen, then the by-index
  re-rank distances and the by-index golden aggregate.  The coarse
  screen is exact, materialized (pdist + sort) or streamed (the
  ``screen_topm`` kernel) by ``use_stream``, or indexed (``index=``, a
  :class:`repro_torch.index.GoldenIndex`): kernel 7 (``ops.ivf_probe``)
  pools the query, picks the windows and writes the probed CSR windows'
  dataset ids and validity in one launch, every probed row going to the
  re-rank (``ivf_screen``'s capacity mode), with the probe count nprobe_t
  from a :class:`repro_torch.index.ProbeSchedule` and an occupancy
  floor.  ``index_mode="auto"`` screens a step exactly when its probed
  rows would pass the crossover fraction of N (``use_index``);
  "always" indexes every step;
* fused (``_fused_body``, when ``use_fused``; never on an indexed
  step): the ``fused_candidates`` kernel reads the store once and the
  epilogue aggregates the k golden rows.

The policies are the reference's rules (``screen=``, ``fused=``) with
the port's own per-platform constants below.  Every stage goes through
``repro_torch.kernels.ops``: the kernels on the card, their plain
versions on CPU.

Static steps (``denoise``) run eagerly at their own (m_t, k_t), the
paper's per-step FLOP saving.  The masked step (``denoise_masked``)
pads the shapes to a plan bucket's caps (or the worst case) and takes
the sizes as fp32 device values, so a run of its steps can be captured
as one CUDA graph (``jitter``); ``program`` caches what is built, one
entry per (plan bucket, batch shape) as the reference caches compiled
programs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.dataset import DatasetStore, downsample_proxy
from repro_torch.core.schedules import Schedule, take
from repro_torch.index.schedule import ProbeSchedule
from repro_torch.index.store import GoldenIndex
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device

NEG_INF = -1e30

# The m/N above which the fused single-pass step beats the staged step
# (by-index re-rank and aggregate).  ``fused="auto"`` fuses when the
# largest scheduled m_t / N exceeds it (the reference's "dense"
# strategy).  "cpu" is the reference's own value, kept so that the
# plain CPU path takes the reference's route.  "cuda" comes from
# chip_smoke.py's [crossover] sweep on an H100 at B=16, N=50000: the
# fused step won from m/N 0.0955 in one run and from at most 0.05 in
# another, and the two tie at 0.10; at the default schedule
# (m_max/N = 0.25) "auto" fuses (PERF.md).  Since the top-m select's
# redesign the fused step wins at every point of the sweep (fused/staged
# 0.964 at m/N 0.05, 0.835 at 0.10), so its crossover lies below 0.05.
# The value stays 0.10 all the same: ``use_index`` reads the same
# fraction, as the reference does (an indexed step's probed rows must
# stay under it), and at 0.05 the first step of the indexed cifar_like
# trajectory (2672 probed rows a query) would leave the index, which no
# line has measured.
GATHER_CROSSOVER_FRAC = {"cpu": 0.10, "cuda": 0.10}

# Bytes of the [B, N] fp32 distance matrix above which ``screen="auto"``
# streams the coarse screen instead of materializing it.  "cpu" is the
# reference's.  "cuda" comes from chip_smoke.py's [screen-memory] lines
# on an H100 (N=50000, m=12500): the streamed screen first took
# 1.02-1.11x the materialized time at B=16 and 256, then 1.76x at B=16;
# with the redesigned select it takes 0.78x (B=16) and 0.81x (B=256),
# while the materialized peak is 9x the matrix (the sort's values and
# int64 indices).  So materialize until that peak would pass about
# 4.5 GiB (5.6% of the 80 GB card) and stream above.  The budget is not
# lowered for the new ratios: they are measured at m=12500 only, while
# the steps that take this rule (those "auto" does not fuse, below m/N
# 0.10) have small m, where the materialized top-k is cheap.
SCREEN_MATERIALIZE_BYTES = {"cpu": 1 << 31, "cuda": 1 << 29}


@dataclasses.dataclass(frozen=True)
class GoldDiffConfig:
    """Subset-size schedules as fractions of N (paper defaults, Sec. 4.1)."""

    m_min_frac: float = 1 / 10   # = k_max (paper: random N/10 matches full)
    m_max_frac: float = 1 / 4
    k_min_frac: float = 1 / 20
    k_max_frac: float = 1 / 10
    proxy_factor: int = 4

    def sizes(self, n: int) -> tuple[int, int, int, int]:
        m_min = max(1, int(n * self.m_min_frac))
        m_max = max(m_min, int(n * self.m_max_frac))
        k_min = max(1, int(n * self.k_min_frac))
        k_max = max(k_min, int(n * self.k_max_frac))
        k_max = min(k_max, m_min)  # golden set always fits the candidate set
        return m_min, m_max, k_min, k_max


def schedule_sizes(cfg: GoldDiffConfig, schedule: Schedule, t: int,
                   n: int) -> tuple[int, int]:
    """(m_t, k_t) for integer timestep t (static mode; Eqs. 4/6)."""
    g = schedule.g_np(t)
    m_min, m_max, k_min, k_max = cfg.sizes(n)
    m_t = int(math.floor(m_min + (m_max - m_min) * (1.0 - g)))
    k_t = int(math.floor(k_min + (k_max - k_min) * g))
    return max(1, min(m_t, n)), max(1, min(k_t, m_t, n))


def masked_sizes(cfg: GoldDiffConfig, schedule: Schedule, t, n: int,
                 device=None) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(g, m_t, k_t)`` of the masked path for a Python int or an
    integer tensor ``t`` (any shape, on ``device``): g in fp32 from the
    schedule's table, the sizes by Eqs. 4/6 in fp32 then truncated to
    int32, as the reference computes them under ``jit``.  Uncapped;
    ``schedule_sizes`` is the static (float64) form."""
    m_min, m_max, k_min, k_max = cfg.sizes(n)
    g = schedule.g(t, device)
    m_t = torch.floor(m_min + (m_max - m_min) * (1.0 - g)).to(torch.int32)
    k_t = torch.floor(k_min + (k_max - k_min) * g).to(torch.int32)
    return g, m_t, k_t


class GoldDiffEngine:
    """Kernel routing for the GoldDiff pipeline on one device.

    The store (and the index) move to ``device`` (the CUDA card unless
    the caller passes another; raises when there is none).  ``screen``
    is "auto", "streamed" or "materialized"; ``screen_tile`` the plain
    carry loop's N-tile (None: its default); ``fused`` "auto", True or
    False; ``index`` a GoldenIndex of this store (or None), probed by
    ``probe_schedule`` (default ``ProbeSchedule()``) on the steps
    ``index_mode`` ("auto" or "always") routes to it."""

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 cfg: GoldDiffConfig | None = None, device=None,
                 screen: str = "auto", screen_tile: int | None = None,
                 fused: str | bool = "auto",
                 index: GoldenIndex | None = None,
                 probe_schedule: ProbeSchedule | None = None,
                 index_mode: str = "auto"):
        if screen not in ("auto", "streamed", "materialized"):
            raise ValueError(f"unknown screen mode {screen!r}")
        if index_mode not in ("auto", "always"):
            raise ValueError(f"unknown index_mode {index_mode!r}")
        if fused not in ("auto", True, False):
            raise ValueError(f"unknown fused mode {fused!r}; expected "
                             f"'auto', True or False")
        if index is not None and index.n != store.n:
            raise ValueError(f"index built for N={index.n}, store has "
                             f"N={store.n}")
        self.store = store.to(resolve_device(device))
        self.index = (None if index is None
                      else index.to(self.store.device))
        self.index_mode = index_mode
        self.probe_schedule = probe_schedule or ProbeSchedule()
        if index is not None:
            # ascending-occupancy cumsum: the fewest rows any P probed
            # windows hold (the nprobe occupancy floor); a host constant,
            # and an int32 device copy for the masked path's floor
            self._occ_cum = np.cumsum(np.sort(np.diff(
                index.offsets.cpu().numpy())))
            self._occ_cum_dev = torch.as_tensor(
                self._occ_cum.astype(np.int32), device=self.store.device)
        self._nprobe: dict[int, int] = {}
        self.schedule = schedule
        self.cfg = cfg or GoldDiffConfig()
        self.screen = screen
        self.screen_tile = None if screen_tile is None else int(screen_tile)
        self.fused = fused
        platform = self.store.device.type
        self._screen_budget = SCREEN_MATERIALIZE_BYTES[platform]
        self.crossover_frac = GATHER_CROSSOVER_FRAC[platform]
        # the reference's build-time strategy: past the crossover the
        # staged re-rank would touch too many rows by index
        m_max_frac = self.cfg.sizes(self.store.n)[1] / self.store.n
        self.strategy = ("gather" if m_max_frac <= self.crossover_frac
                         else "dense")
        self._consts: dict[int, tuple[float, float]] = {}
        self._sizes: dict[int, tuple[int, int]] = {}
        self._programs: dict = {}
        self._builds = 0          # programs built (graphs on the card)
        self._captures = 0        # CUDA graphs captured by ``jitter``
        self._graph_pool = None   # the memory pool every graph shares
        self._graph_stream = None  # ... and the stream that captures them
        self._masked_tables: dict = {}

    @property
    def X(self) -> torch.Tensor:
        return self.store.X

    @property
    def proxy(self) -> torch.Tensor:
        return self.store.proxy

    # -- programs: the cache and the CUDA graphs ------------------------------
    def program(self, key, build):
        """The program cache: ``build()`` once per key (the reference
        keys compiled programs the same way), counted in ``_builds``."""
        if key not in self._programs:
            self._programs[key] = build()
            self._builds += 1
        return self._programs[key]

    def jitter(self, fn, *specs, label: str | None = None):
        """The counterpart of the reference's ``jit`` + AOT compile: on
        the card, ``fn`` captured as one CUDA graph; on the CPU, ``fn``.

        ``specs`` give ``fn``'s inputs: a shape (an fp32 input) or a
        ``(shape, dtype)`` pair.  On the card this allocates one static
        input of each, runs ``fn`` once eagerly on a side stream (which
        builds the kernels, sets their shared-memory attributes and
        warms cub), captures it into the memory pool all of this
        engine's graphs share, and returns a callable that copies its
        arguments into the static inputs, replays and returns a clone of
        the static output.  Graphs in one pool must not be replayed
        concurrently (each may reuse another's temporaries): the
        serving loop replays them one at a time on one stream.  The
        store and the static buffers never move, so addresses baked into
        the graph stay valid (kernel 1's TMA tensor maps encode them).

        The kernels' ``launches`` counts move at capture, when nothing
        runs: the capture's counts are taken back and added at every
        replay.  A capture that fails raises, naming ``label``."""
        if self.store.device.type != "cuda":
            return fn
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.store.device)
        self._captures += 1
        return capture(fn, specs, self._graph_stream, self._graph_pool,
                       label or getattr(fn, "__qualname__", repr(fn)))

    # -- precomputed per-timestep constants ----------------------------------
    def sizes(self, t: int) -> tuple[int, int]:
        if t not in self._sizes:
            self._sizes[t] = schedule_sizes(self.cfg, self.schedule, t,
                                            self.store.n)
        return self._sizes[t]

    def constants(self, t: int) -> tuple[float, float]:
        """(a_t, sigma_t^2) as host floats."""
        if t not in self._consts:
            a = float(self.schedule.a[t])
            sig2 = float(self.schedule.sigma_np(t)) ** 2
            self._consts[t] = (a, sig2)
        return self._consts[t]

    def nprobe(self, t: int) -> int:
        """Scheduled probe count nprobe_t for a static timestep, with an
        occupancy floor: even the nprobe_t smallest windows hold k_t
        real rows, so ``select()`` never returns padding."""
        if t not in self._nprobe:
            m_t, k_t = self.sizes(t)
            p = self.probe_schedule.nprobe(
                self.schedule.g_np(t), m_t, self.store.n,
                self.index.num_clusters)
            need = int(np.searchsorted(self._occ_cum, k_t) + 1)
            self._nprobe[t] = min(max(p, need), self.index.num_clusters)
        return self._nprobe[t]

    def padded_m(self, t: int) -> int:
        """Indexed candidate count: the probed capacity nprobe_t * L
        (IVF-Flat: everything probed is re-ranked)."""
        return self.nprobe(t) * self.index.max_cluster

    # -- routing policies -----------------------------------------------------
    def use_index(self, t: int) -> bool:
        """Route this step's coarse screen through the index?  "auto"
        screens exactly whenever the probed rows would pass the
        crossover fraction of N: the index degrades to the exact
        screen, never to a slower step."""
        if self.index is None:
            return False
        if self.index_mode == "always":
            return True
        return self.padded_m(t) <= self.crossover_frac * self.store.n

    def strategy_for(self, t: int) -> str:
        """Per-step strategy: indexed steps gather (their candidate set
        is the probed capacity); exact steps keep the build-time one."""
        return "gather" if self.use_index(t) else self.strategy

    def use_fused(self, t: int) -> bool:
        """Route this step through the fused single-pass body?  Indexed
        steps never fuse (the fused pass reads every store row).  True
        fuses every other step; "auto" fuses where the reference's rule
        does on one host, when the build-time strategy is "dense"."""
        return self._fused_masked(self.use_index(t))

    def _fused_masked(self, use_ix: bool) -> bool:
        """The fused decision for a step indexed or not (``use_ix``): the
        masked path takes it once a bucket, ``use_fused`` once a step."""
        if self.fused is False or use_ix:
            return False
        if self.fused is True:
            return True
        return self.strategy == "dense"

    def use_stream(self, batch: int, n: int | None = None) -> bool:
        """Stream the coarse screen at this (batch, store) size?  "auto"
        streams once the materialized [B, N] fp32 matrix would cross the
        platform's budget (``SCREEN_MATERIALIZE_BYTES``)."""
        if self.screen != "auto":
            return self.screen == "streamed"
        n = self.store.n if n is None else n
        return 4 * int(batch) * int(n) > self._screen_budget

    # -- pipeline stages ------------------------------------------------------
    def _proxy_query(self, q: torch.Tensor) -> torch.Tensor:
        q_img = q.reshape(q.shape[:-1] + tuple(self.store.image_shape))
        return downsample_proxy(q_img, self.cfg.proxy_factor)

    def coarse(self, q: torch.Tensor, m: int) -> torch.Tensor:
        """Top-m candidates by exact proxy distance; [B, m], streamed or
        materialized by ``use_stream``."""
        return ops.screen_topm(self._proxy_query(q), self.store.proxy, m,
                               x_norms=self.store.proxy_norms,
                               tile=self.screen_tile,
                               stream=self.use_stream(q.shape[0]))[0]

    def coarse_indexed(self, q: torch.Tensor, m: int, nprobe_max: int,
                       nprobe=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Candidates via the Golden Index: ``(pos, d2)`` with positions
        in cluster-sorted row space, +inf ``d2`` on capacity padding
        (``ops.ivf_screen``; capacity mode when ``m = nprobe_max * L``)."""
        ix = self.index
        return ops.ivf_screen(self._proxy_query(q), ix.proxy_sorted,
                              ix.proxy_norms_sorted, ix.offsets,
                              ix.centroids, ix.centroid_norms, m,
                              nprobe_max, ix.max_cluster, nprobe=nprobe)

    def probe(self, q: torch.Tensor, nprobe_max: int, nprobe=None):
        """IVF level 1 of rescaled queries (``ops.ivf_probe``: on the card
        one launch from ``q`` to the probed candidates' dataset ids and
        validity, the proxy pooled inside it); ``nprobe`` (a 0-d device
        tensor on the masked path) masks the probes beyond it."""
        ix = self.index
        return ops.ivf_probe(q, self.store.image_shape, self.cfg.proxy_factor,
                             ix.centroids, ix.centroid_norms, ix.offsets,
                             ix.perm, ix.n, nprobe_max, ix.max_cluster,
                             nprobe=nprobe, fields=("ids", "valid"))

    def _select_body(self, q: torch.Tensor, t: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx, d2) of the golden support for a rescaled query; ``idx``
        are dataset row ids on both paths (indexed candidates come from
        ``probe`` as ids, with the validity of each capacity slot)."""
        m_t, k_t = self.sizes(t)
        if self.use_index(t):
            pr = self.probe(q, self.nprobe(t))
            return ops.golden_rerank(q, self.store.X, pr.ids,
                                     min(k_t, self.padded_m(t)),
                                     x_norms=self.store.x_norms,
                                     valid=pr.valid)
        cand = self.coarse(q, m_t)
        return ops.golden_rerank(q, self.store.X, cand, k_t,
                                 x_norms=self.store.x_norms)

    def _select_ids_body(self, q: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support as dataset row ids."""
        return self._select_body(q, t)[0]

    def _denoise_body(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Staged step: coarse -> rerank -> aggregate, distances computed
        exactly once."""
        a, sig2 = self.constants(t)
        q = x_t / a
        idx, d2 = self._select_body(q, t)
        lg = torch.clamp_min(-d2 / (2.0 * sig2), NEG_INF)
        out = ops.golden_support_aggregate(self.store.X, idx, lg)
        return out.to(x_t.dtype)

    def _fused_body(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Fused single-pass step (``ops.fused_step``): candidates with
        their exact distances from one read of the store, then the
        top-k and the aggregate of the k golden rows."""
        a, sig2 = self.constants(t)
        m_t, k_t = self.sizes(t)
        q = x_t / a
        out = ops.fused_step(q, self._proxy_query(q), self.store.X,
                             self.store.proxy, m_t, k_t, sig2,
                             x_norms=self.store.x_norms,
                             proxy_norms=self.store.proxy_norms,
                             stream=self.use_stream(x_t.shape[0]),
                             tile=self.screen_tile)
        return out.to(x_t.dtype)

    # -- public entry points --------------------------------------------------
    def select(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support S_t for each query; [B, k_t]."""
        t = int(t)
        a, _ = self.constants(t)
        return self._select_ids_body(x_t / a, t)

    def denoise(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Full GoldDiff step for the Optimal base (unbiased SS on S_t)."""
        t = int(t)
        if self.use_fused(t):
            return self._fused_body(x_t, t)
        return self._denoise_body(x_t, t)

    # -- masked (graph-capturable) path -----------------------------------------
    def _masked_nprobe_pad(self) -> int:
        """Worst-case nprobe_t over the whole t grid (the static pad of
        ``caps=None``)."""
        if not hasattr(self, "_nprobe_pad"):
            T = self.schedule.num_steps
            self._nprobe_pad = max(self.nprobe(t) for t in range(1, T + 1))
        return self._nprobe_pad

    def _use_index_masked(self) -> bool:
        """``caps=None`` is one body for every step, so the indexed/exact
        choice is global: index only when even the worst-case probe width
        stays under the crossover ("always" skips that guard and then
        pays worst-case probes at every step)."""
        if self.index is None:
            return False
        if self.index_mode == "always":
            return True
        touched = self._masked_nprobe_pad() * self.index.max_cluster
        return touched <= self.crossover_frac * self.store.n

    def _masked_caps(self, caps) -> tuple[int, int, int, bool]:
        """``(m_cap, k_cap, nprobe_cap, use_index)`` of a plan bucket's
        ``caps`` (a ``plan.BucketCaps``), or the worst case over the
        whole schedule for ``caps=None``."""
        n = self.store.n
        _, m_max, _, k_max = self.cfg.sizes(n)
        if caps is None:
            use_ix = self._use_index_masked()
            return (m_max, k_max,
                    self._masked_nprobe_pad() if use_ix else 0, use_ix)
        use_ix = bool(caps.indexed) and self.index is not None
        return (min(int(caps.m_cap), n), int(caps.k_cap),
                int(caps.nprobe_cap), use_ix)

    def _masked_nprobe_t(self, g: torch.Tensor, m_t: torch.Tensor,
                         k_t: torch.Tensor, p_cap: int) -> torch.Tensor:
        """The probe count as an int32 device tensor: ``nprobe``'s
        rule in fp32, its occupancy floor at this k_t (a
        ``searchsorted`` on the device copy of the cumsum), clipped to
        the bucket's pad."""
        c = self.index.num_clusters
        nprobe_t = self.probe_schedule.nprobe_tensor(g, m_t, self.store.n, c)
        need = torch.searchsorted(self._occ_cum_dev, k_t.reshape(-1),
                                  out_int32=True).reshape(k_t.shape) + 1
        nprobe_t = torch.maximum(nprobe_t, torch.clamp_max(need, c))
        return torch.clamp(nprobe_t, 1, p_cap)

    def _masked_table(self, m_cap: int, k_cap: int, p_cap: int,
                      use_ix: bool) -> tuple:
        """The masked step's per-timestep values over t = 0..T at one set
        of caps, as device tensors: ``(m_t, k_t, nprobe_t or None, a_t,
        sigma_t^2)``, the sizes by ``masked_sizes`` capped, nprobe_t by
        ``_masked_nprobe_t``, the schedule's in fp32; each element the
        same fp32 operations as for one t.  Built once, before any
        capture (a table first built inside one would live in the graph's
        memory, so it is then not kept), so a captured step reads views
        of it and launches nothing for them."""
        key = (m_cap, k_cap, p_cap, use_ix)
        if key in self._masked_tables:
            return self._masked_tables[key]
        dev = self.store.device
        t = torch.arange(self.schedule.num_steps + 1, device=dev)
        g, m_t, k_t = masked_sizes(self.cfg, self.schedule, t, self.store.n)
        m_t, k_t = torch.clamp_max(m_t, m_cap), torch.clamp_max(k_t, k_cap)
        sig = self.schedule.sigma(t)
        tab = (m_t, k_t,
               self._masked_nprobe_t(g, m_t, k_t, p_cap) if use_ix else None,
               self.schedule.tables(dev)[0], sig * sig)
        if not (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            self._masked_tables[key] = tab
        return tab

    def denoise_masked(self, x_t: torch.Tensor, t, caps=None) -> torch.Tensor:
        """The masked step: shapes padded to ``caps`` (a plan bucket's,
        or the worst case for None), the sizes m_t, k_t and nprobe_t
        entering only as masks.  ``t`` is a Python int or a 0-d integer
        tensor on the store's device; a_t, sigma_t, m_t, k_t and nprobe_t
        are fp32 device values, as the reference computes them under
        ``jit`` (``_masked_table``), so the step touches no host value and
        a CUDA graph can capture it.  Exact distances are computed once a
        step."""
        m_cap, k_cap, p_cap, use_ix = self._masked_caps(caps)
        m_t, k_t, nprobe_t, a, sig2 = (
            None if v is None else take(v, t)
            for v in self._masked_table(m_cap, k_cap, p_cap, use_ix))
        q = x_t / a
        if self._fused_masked(use_ix):
            out = ops.fused_step(q, self._proxy_query(q), self.X, self.proxy,
                                 m_cap, min(k_cap, m_cap), sig2,
                                 x_norms=self.store.x_norms,
                                 proxy_norms=self.store.proxy_norms,
                                 stream=self.use_stream(x_t.shape[0]),
                                 tile=self.screen_tile, m_t=m_t, k_t=k_t)
            return out.to(x_t.dtype)
        if use_ix:
            # every probed row is a candidate (IVF-Flat): the time-aware
            # budget is nprobe_t, padded to the bucket's probe width
            m_pad = p_cap * self.index.max_cluster
            pr = self.probe(q, p_cap, nprobe_t)
            cand, live = pr.ids, pr.valid
        else:
            m_pad = m_cap
            cand = self.coarse(q, m_pad)                    # top-m sorted
            live = torch.arange(m_pad, device=q.device) < m_t
        k_pad = min(k_cap, m_pad)
        idx, d2 = ops.golden_rerank(q, self.X, cand, k_pad,
                                    x_norms=self.store.x_norms, valid=live)
        lg = torch.clamp_min(-d2 / (2.0 * sig2), NEG_INF)
        lg = torch.where(torch.arange(k_pad, device=q.device) < k_t, lg,
                         NEG_INF)
        out = ops.golden_support_aggregate(self.X, idx, lg)
        return out.to(x_t.dtype)

    def full_scan(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Exact posterior mean over the whole store (Eq. 2)."""
        a, sig2 = self.constants(int(t))
        return ops.golden_aggregate(x_t / a, self.store.X, sig2,
                                    x_norms=self.store.x_norms
                                    ).to(x_t.dtype)


def capture(fn, specs, side: torch.cuda.Stream, pool, label: str):
    """``GoldDiffEngine.jitter``'s capture on the card (see there).  The
    warm run and the capture run on the engine's own stream ``side``:
    the pool's blocks are kept per stream, so one stream lets a capture
    reuse what the graphs before it freed, and a failed capture leaves
    no state on a stream anything else uses (the outer stream context
    restores the caller's stream even when the capture's own exit
    raises)."""
    device = side.device
    inputs = [torch.zeros(shape, dtype=dtype, device=device)
              for shape, dtype in map(_spec, specs)]
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*inputs)              # builds the kernels, sets their attributes
        before = [k.launches for k in ops.COUNTED]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side):
                out = fn(*inputs)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {label} failed: "
                               f"{e}") from e
        finally:
            delta = [k.launches - b for k, b in zip(ops.COUNTED, before)]
            for k, b in zip(ops.COUNTED, before):
                k.launches = b
    torch.cuda.current_stream(device).wait_stream(side)

    def replay(*args):
        for buf, arg in zip(inputs, args):
            buf.copy_(arg)
        graph.replay()
        for k, d in zip(ops.COUNTED, delta):
            k.launches += d
        return out.clone()

    return replay


def _spec(s) -> tuple[tuple, torch.dtype]:
    """``(shape, dtype)`` of a ``jitter`` input spec: a shape (fp32) or
    a ``(shape, dtype)`` pair."""
    if len(s) == 2 and isinstance(s[1], torch.dtype):
        return tuple(s[0]), s[1]
    return tuple(s), torch.float32
