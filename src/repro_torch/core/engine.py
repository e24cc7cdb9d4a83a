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

PyTorch runs eagerly, so there is no program cache: each step runs its
own static (m_t, k_t), which is the paper's per-step FLOP saving.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.dataset import DatasetStore, downsample_proxy
from repro_torch.core.schedules import Schedule
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
            # windows hold (the nprobe occupancy floor); a host constant
            self._occ_cum = np.cumsum(np.sort(np.diff(
                index.offsets.cpu().numpy())))
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

    def use_fused(self, t: int) -> bool:
        """Route this step through the fused single-pass body?  Indexed
        steps never fuse (the fused pass reads every store row).  True
        fuses every other step; "auto" fuses where the reference's rule
        does on one host, when the build-time strategy is "dense"."""
        if self.fused is False:
            return False
        if self.use_index(t):
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

    def probe(self, q: torch.Tensor, nprobe_max: int):
        """IVF level 1 of rescaled queries (``ops.ivf_probe``: on the card
        one launch from ``q`` to the probed candidates' dataset ids and
        validity, the proxy pooled inside it)."""
        ix = self.index
        return ops.ivf_probe(q, self.store.image_shape, self.cfg.proxy_factor,
                             ix.centroids, ix.centroid_norms, ix.offsets,
                             ix.perm, ix.n, nprobe_max, ix.max_cluster,
                             fields=("ids", "valid"))

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

    def full_scan(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Exact posterior mean over the whole store (Eq. 2)."""
        a, sig2 = self.constants(int(t))
        return ops.golden_aggregate(x_t / a, self.store.X, sig2,
                                    x_norms=self.store.x_norms
                                    ).to(x_t.dtype)
