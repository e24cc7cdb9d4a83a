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

``storage_dtype=torch.bfloat16`` keeps the engine's store operands (X,
the proxy and the index's cluster-sorted proxy) in bf16, half the
bytes, with the row norms fp32 from the store's fp32 master copy; the
proxy query is rounded to bf16 (the exact query stays fp32), and every
distance, softmax and sum is fp32, in the kernels' bf16-row instances
on the card.  ``strategy=`` ("auto", "measure", "gather", "dense")
picks the build-time gather-vs-dense strategy that ``fused="auto"``
reads, as the reference's does.

Static steps (``denoise``) run eagerly at their own (m_t, k_t), the
paper's per-step FLOP saving.  The masked step (``denoise_masked``)
pads the shapes to a plan bucket's caps (or the worst case) and takes
the sizes as fp32 device values, so a run of its steps can be captured
as one CUDA graph (``jitter``); ``program`` caches what is built, one
entry per (plan bucket, batch shape) as the reference caches compiled
programs.

Store epochs (``install_epoch`` / ``set_serving_epoch`` / ``at_epoch``
/ ``retire_epoch``) let a serving runtime swap in a grown golden store
of the same shapes (``repro_torch.index.ingest``) without building
anything.  The reference passes the operands as a jit argument; a
captured CUDA graph instead bakes their addresses.  So an epoch's
operands (:class:`StoreOperands`) live in a *slot*, engine-owned device
buffers at fixed addresses, and on the card the program keys carry the
slot: ``reserve_standby()`` adds a second slot, the runtime's warmup
captures every program for both, and ``install_epoch`` copies the new
epoch into a free slot in place, so its graphs (and kernel 1's tensor
maps) stay valid.  A third live epoch takes a new slot whose graphs are
captured on demand and counted in ``_builds``.

Sharded execution (``mesh=``, ``shard_axis=``, ``batch_axis=``): the
store, and when indexed the global index's cluster-sorted rows cut at
CSR window boundaries (``repro_torch.index.shard``), are split over the
shards of one axis of a :class:`repro_torch.distributed.LocalMesh`
(every shard in this process) or of a
:class:`repro_torch.distributed.ProcessMesh` (one shard a rank), and
every entry point (``denoise``, ``denoise_masked``, ``select``,
``full_scan``) runs as three shard-local stages separated by three
merges (``repro_torch.distributed.retrieval``): the shard-local screen
and the cross-shard m-th threshold, the shard-local re-rank and the
k-th threshold (the two-stage top-k), and the shard-local softmax
states (kernel 3's state entry; kernel 4's for the full scan) merged by
log-sum-exp.  The candidate partition equals the single-device one row
for row, so the sharded engine matches the unsharded one to fp32
reduction order.  ``batch_axis`` splits the query batch over a second
axis.  With every shard on one card, the masked step reads nothing back
to the host, and ``jitter`` captures a plan segment of S slices as one
CUDA graph whose kernels read the layout's fixed slabs; with shards on
several cards of one process it runs eagerly.  Program keys carry the
mesh signature, and a sharded engine does not hot-swap.

Over a ``ProcessMesh`` the program is SPMD: every rank makes the same
calls with the same inputs and returns the global result.  The engine
keeps the dataset on the host (``store`` is on the CPU; ``device`` is
the rank's: the mesh's, else the one given, else the card) and puts only
the rank's slab on that device; slot 0 holds views of that slab, never
the whole store.  On a ``batch_axis`` of ranks a rank
runs its chunk of the query batch and the chunks are gathered over that
axis.  ``jitter`` decides by the groups' backend: over NCCL it captures
a plan segment, collectives and all, as one CUDA graph (the eager run
before the capture makes the communicator); over gloo it runs eagerly.
``strategy="measure"`` measures on the mesh's first rank and broadcasts
the crossover, so that every rank takes the same route.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dataset import DatasetStore, downsample_proxy
from repro_torch.core.plan import (full_scan_costs, fused_step_costs,
                                   step_stage_costs)
from repro_torch.core.schedules import Schedule, take
from repro_torch.index.schedule import ProbeSchedule
from repro_torch.index.store import GoldenIndex
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
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

STRATEGIES = ("auto", "measure", "gather", "dense")

# program kinds that read no store operand (the serving runtime's
# Gaussian fallback): one program serves every slot
SLOTLESS_KINDS = ("gauss_seg",)
# the epoch id ``reserve_standby`` gives the standby slot until the first
# ``install_epoch`` takes it (the runtime's warmup pins it so)
STANDBY_EPOCH = -1


class StoreOperands(NamedTuple):
    """The engine's device operands for one store/index epoch: one
    *slot*.  Every body reads these (through the engine's properties),
    never the construction store.  Index fields are None on an engine
    without an index.  ``perm`` maps the empty slots of a
    capacity-padded window (+inf ``proxy_norms_sorted``) to a store row
    with a +inf norm, so an empty slot that a probe reaches ranks after
    every real row and weighs 0 (``_make_operands``)."""

    X: torch.Tensor                  # [N, D] rows (storage dtype)
    proxy: torch.Tensor              # [N, dp] proxy rows (storage dtype)
    x_norms: torch.Tensor            # [N] fp32
    proxy_norms: torch.Tensor        # [N] fp32
    proxy_sorted: torch.Tensor | None = None         # [N, dp] sorted
    proxy_norms_sorted: torch.Tensor | None = None   # [N] fp32, +inf pads
    perm: torch.Tensor | None = None                 # [N] int64
    offsets: torch.Tensor | None = None              # [C+1] int64
    centroids: torch.Tensor | None = None            # [C, dp] fp32
    centroid_norms: torch.Tensor | None = None       # [C] (+inf spares)
STORAGE_DTYPES = (None, torch.bfloat16)


def measure_crossover(x: torch.Tensor, x_norms: torch.Tensor,
                      batch: int = 8, rows: int = 2048,
                      repeats: int = 3) -> float:
    """Probe the store's device for the gather/dense crossover fraction.

    Times the dense form (``ops.pdist`` over all N rows, then a lookup of
    ``rows`` touched rows) against the gather form (``ops.support_distances``
    at those rows), best of ``repeats`` on host clocks with the card
    synchronized around each (the plain versions on the CPU), and
    extrapolates the touched fraction at which they break even (the
    gather's cost is about linear in rows, the dense one's constant): the
    reference's formula and clip.  A coarse estimate is enough: it only
    picks a strategy, both of which are exact."""
    n = x.shape[0]
    rows = min(rows, n)
    dev = x.device
    q = torch.zeros((batch, x.shape[1]), dtype=torch.float32, device=dev)
    idx = ((torch.arange(rows, device=dev) * 997) % n).repeat(batch, 1)

    def dense():
        return torch.take_along_dim(ops.pdist(q, x, x_norms=x_norms), idx,
                                    -1)

    def gather():
        return ops.support_distances(q, x, idx, x_norms)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        fn()
        sync()
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_dense, t_gather = best(dense), best(gather)
    return float(np.clip((t_dense / t_gather) * (rows / n), 1e-3, 1.0))


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
    the caller passes another; raises when there is none); over a
    ``ProcessMesh`` the device is the mesh's, and only the rank's slab
    moves there.  ``screen``
    is "auto", "streamed" or "materialized"; ``screen_tile`` the plain
    carry loop's N-tile (None: its default); ``fused`` "auto", True or
    False; ``index`` a GoldenIndex of this store (or None), probed by
    ``probe_schedule`` (default ``ProbeSchedule()``) on the steps
    ``index_mode`` ("auto" or "always") routes to it.  ``storage_dtype``
    is None (fp32 rows) or ``torch.bfloat16``; ``strategy`` "auto" (the
    platform's crossover fraction), "measure" (``measure_crossover`` on
    the store's device), "gather" or "dense"."""

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 cfg: GoldDiffConfig | None = None, device=None,
                 screen: str = "auto", screen_tile: int | None = None,
                 fused: str | bool = "auto",
                 index: GoldenIndex | None = None,
                 probe_schedule: ProbeSchedule | None = None,
                 index_mode: str = "auto", storage_dtype=None,
                 strategy: str = "auto", mesh=None, shard_axis: str = "data",
                 batch_axis: str | None = None):
        if mesh is not None and shard_axis not in mesh.axis_names:
            raise ValueError(f"shard_axis {shard_axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
        if batch_axis is not None:
            if mesh is None:
                raise ValueError("batch_axis requires a mesh")
            if batch_axis not in mesh.axis_names:
                raise ValueError(f"batch_axis {batch_axis!r} not in mesh "
                                 f"axes {mesh.axis_names}")
            if batch_axis == shard_axis:
                raise ValueError("batch_axis must differ from shard_axis "
                                 f"({shard_axis!r})")
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; expected one "
                             f"of {STRATEGIES}")
        if storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"unknown storage_dtype {storage_dtype!r}; "
                             f"expected None or torch.bfloat16")
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
        self.ranks = is_process_mesh(mesh)
        if self.ranks:
            # SPMD over ranks: the rows stay on the host, the rank's slab
            # goes to the rank's device (below)
            mesh = mesh.on(device).along(shard_axis)
            self.device = mesh.device
            self.store = store.to("cpu")
            self.index = None if index is None else index.to("cpu")
        else:
            self.device = resolve_device(device)
            self.store = store.to(self.device)
            self.index = (None if index is None
                          else index.to(self.device))
        self.storage_dtype = storage_dtype
        self._tls = threading.local()
        self._lock = threading.RLock()   # graph replay, install, capture
        # sharded execution: the per-shard layout over one mesh axis
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.batch_axis = batch_axis
        if mesh is not None:
            from repro_torch.index.shard import shard_layout
            self.n_shards = int(mesh.shape[shard_axis])
            self.batch_shards = (1 if batch_axis is None
                                 else int(mesh.shape[batch_axis]))
            self._layout = shard_layout(self.store, mesh, shard_axis,
                                        index=self.index,
                                        storage_dtype=storage_dtype,
                                        device=self.device)
        else:
            self.n_shards = self.batch_shards = 1
            self._layout = None
        # the engine's store operands: epoch 0 in slot 0 (see the module
        # docstring); the construction store stays, for the base denoiser.
        # A rank of a ProcessMesh holds views of its slab there instead.
        if self.ranks:
            sl = self._layout.slabs[0]
            ops0 = StoreOperands(X=sl.X, proxy=sl.proxy, x_norms=sl.x_norms,
                                 proxy_norms=sl.proxy_norms)
        else:
            ops0 = self._make_operands(self.store, self.index)
        self._slots: dict[int, StoreOperands] = {0: ops0}
        self._epochs: dict[int, int] = {0: 0}     # epoch -> slot
        self._kept_slots = [0]   # slots recycled when free, never freed
        self._free_slots: list[int] = []
        self._serving_epoch = 0
        self.index_mode = index_mode
        self.probe_schedule = probe_schedule or ProbeSchedule()
        if index is not None:
            # ascending-occupancy cumsum: the fewest rows any P probed
            # windows hold (the nprobe occupancy floor); a host constant,
            # and an int32 device copy for the masked path's floor
            self._occ_cum = np.cumsum(np.sort(np.diff(
                index.offsets.cpu().numpy())))
            self._occ_cum_dev = torch.as_tensor(
                self._occ_cum.astype(np.int32), device=self.device)
        self._nprobe: dict[int, int] = {}
        self.schedule = schedule
        self.cfg = cfg or GoldDiffConfig()
        self.screen = screen
        self.screen_tile = None if screen_tile is None else int(screen_tile)
        self.fused = fused
        platform = self.device.type
        self._screen_budget = SCREEN_MATERIALIZE_BYTES[platform]
        if strategy == "measure":
            # over ranks one measures (its slab) and every rank takes its
            # value: ranks that took different routes would hang
            frac = (measure_crossover(self.X, self.x_norms)
                    if not self.ranks or mesh.first else 0.0)
            self.crossover_frac = mesh.broadcast(frac) if self.ranks else frac
        else:
            self.crossover_frac = GATHER_CROSSOVER_FRAC[platform]
        if strategy in ("gather", "dense"):
            self.strategy = strategy
        else:
            # the reference's build-time rule: past the crossover the
            # staged re-rank would touch too many rows by index
            m_max_frac = self.cfg.sizes(self.store.n)[1] / self.store.n
            self.strategy = ("gather" if m_max_frac <= self.crossover_frac
                             else "dense")
        self._consts: dict[int, tuple[float, float]] = {}
        self._sizes: dict[int, tuple[int, int]] = {}
        self._stage_costs: dict = {}
        self._programs: dict = {}
        self._builds = 0          # programs built (graphs on the card)
        self._captures = 0        # CUDA graphs captured by ``jitter``
        self._graph_pool = None   # the memory pool every graph shares
        self._graph_stream = None  # ... and the stream that captures them
        self._masked_tables: dict = {}
        self.seam = None          # the ranks' fault agreement (``program``)

    # -- store epochs on operand slots ------------------------------------------
    def _make_operands(self, store: DatasetStore,
                       index: GoldenIndex | None) -> StoreOperands:
        """One epoch's operands on the engine's device: the rows in the
        storage dtype, the norms fp32 from the store's fp32 master copy,
        as the reference's StoreOperands.  An empty slot of a
        capacity-padded window (``proxy_norms_sorted`` +inf while
        ``perm`` names a real row, row 0 by the layout's convention) is
        pointed at a padding row (+inf ``x_norms``), so that a probe
        which reaches it re-ranks +inf there and gives it no weight; the
        reference's capacity-mode screen re-ranks row 0 there instead."""
        dev, sd = self.device, self.storage_dtype or torch.float32
        kw = {}
        if index is not None:
            xn = store.x_norms.to(dev, torch.float32)
            perm = index.perm.to(dev)
            pns = index.proxy_norms_sorted.to(dev, torch.float32)
            alias = ~torch.isfinite(pns) & torch.isfinite(xn[perm])
            pad = torch.nonzero(~torch.isfinite(xn))
            if bool(alias.any()) and pad.numel():
                perm = torch.where(alias, pad[0, 0], perm)
            kw = dict(proxy_sorted=index.proxy_sorted.to(dev, sd),
                      proxy_norms_sorted=pns, perm=perm,
                      offsets=index.offsets.to(dev),
                      centroids=index.centroids.to(dev, torch.float32),
                      centroid_norms=index.centroid_norms.to(
                          dev, torch.float32))
        return StoreOperands(X=store.X.to(dev, sd),
                             proxy=store.proxy.to(dev, sd),
                             x_norms=store.x_norms.to(dev, torch.float32),
                             proxy_norms=store.proxy_norms.to(
                                 dev, torch.float32), **kw)

    def _slot(self) -> int:
        """The slot of ``call_epoch``: the one this thread's next
        dispatch reads."""
        return self._epochs[self.call_epoch]

    def current_operands(self) -> StoreOperands:
        return self._slots[self._slot()]

    @property
    def call_epoch(self) -> int:
        """The epoch the next dispatch in this thread reads: the one
        pinned by an enclosing ``at_epoch`` (in-flight waves finish on
        the epoch they were admitted under), else the serving epoch."""
        pinned = getattr(self._tls, "pinned", None)
        return self._serving_epoch if pinned is None else pinned

    @property
    def serving_epoch(self) -> int:
        return self._serving_epoch

    @property
    def X(self) -> torch.Tensor:
        return self.current_operands().X

    @property
    def proxy(self) -> torch.Tensor:
        return self.current_operands().proxy

    @property
    def x_norms(self) -> torch.Tensor:
        return self.current_operands().x_norms

    @property
    def proxy_norms(self) -> torch.Tensor:
        return self.current_operands().proxy_norms

    @property
    def proxy_sorted(self) -> torch.Tensor | None:
        return self.current_operands().proxy_sorted

    @property
    def proxy_norms_sorted(self) -> torch.Tensor | None:
        return self.current_operands().proxy_norms_sorted

    @property
    def index_perm(self) -> torch.Tensor | None:
        return self.current_operands().perm

    def swap_compat(self, store: DatasetStore,
                    index: GoldenIndex | None) -> str | None:
        """None when ``(store, index)`` can hot-swap into this engine's
        programs, else the reason: every static ingredient of a program
        and of the host per-timestep constants must be unchanged (array
        shapes, indexed-ness, cluster count, padded probe width, and the
        CSR offsets, which feed the nprobe occupancy floor).  The
        appendable store lifecycle keeps all of them across appends; a
        capacity rebuild needs a fresh engine."""
        if self.mesh is not None:
            return ("sharded engines do not hot-swap (the mesh layout "
                    "holds per-shard slabs; rebuild the engine)")
        if (store.n, store.dim) != (self.store.n, self.store.dim):
            return (f"store shape ({store.n}, {store.dim}) != engine's "
                    f"({self.store.n}, {self.store.dim})")
        if (index is None) != (self.index is None):
            return "indexed-ness differs from the engine's"
        if index is not None:
            if index.num_clusters != self.index.num_clusters:
                return (f"num_clusters {index.num_clusters} != "
                        f"{self.index.num_clusters}")
            if index.max_cluster != self.index.max_cluster:
                return (f"max_cluster {index.max_cluster} != "
                        f"{self.index.max_cluster}")
            if not torch.equal(index.offsets.cpu(), self.index.offsets.cpu()):
                return ("CSR offsets differ (the static nprobe "
                        "occupancy floor depends on them)")
        return None

    def _drop_slot_programs(self, slot: int) -> None:
        """Forget the graphs captured on ``slot`` (card only: on the CPU
        programs read their operands when called and carry no slot)."""
        tag = ("slot", slot)
        self._programs = {k: v for k, v in self._programs.items()
                          if not (isinstance(k, tuple) and k[-1:] == (tag,))}

    def _own_slot(self, slot: int) -> None:
        """Give ``slot`` buffers of its own where it shares storage with
        the construction store or index (an fp32 slot 0 does), so that
        recycling it never writes into a caller's tensors; its graphs
        baked the old addresses and are dropped."""
        ops_ = self._slots[slot]
        outside = {t.data_ptr() for obj in (self.store, self.index)
                   if obj is not None
                   for t in (getattr(obj, f.name)
                             for f in dataclasses.fields(obj))
                   if isinstance(t, torch.Tensor)}
        if any(t is not None and t.data_ptr() in outside for t in ops_):
            self._slots[slot] = StoreOperands(
                *(None if t is None else t.clone() for t in ops_))
            self._drop_slot_programs(slot)

    def reserve_standby(self) -> list[int]:
        """Keep two slots warm: the serving slot (given buffers of its
        own) and one standby, a copy of it, that ``install_epoch`` fills
        in place.  A free kept slot is held by ``STANDBY_EPOCH`` so that
        ``at_epoch`` can pin it; retiring that epoch frees the slot for
        the first install.  Idempotent; returns an epoch for each kept
        slot, which the runtime's warmup captures every program on."""
        if self.mesh is not None:        # no hot swap: one slot
            return [self._serving_epoch]
        with self._lock:
            serving = self._epochs[self._serving_epoch]
            self._own_slot(serving)
            if serving not in self._kept_slots:
                self._kept_slots.append(serving)
            if len(self._kept_slots) < 2:
                s = max(self._slots) + 1
                self._slots[s] = StoreOperands(
                    *(None if t is None else t.clone()
                      for t in self._slots[serving]))
                self._kept_slots.append(s)
                self._free_slots.append(s)
            if self._free_slots and STANDBY_EPOCH not in self._epochs:
                self._epochs[STANDBY_EPOCH] = self._free_slots.pop(0)
            return [e for e, s in self._epochs.items()
                    if s in self._kept_slots]

    def install_epoch(self, epoch: int, store: DatasetStore,
                      index: GoldenIndex | None = None) -> None:
        """Install ``(store, index)`` as a standby epoch: copied in place
        into a free kept slot (no allocation; the slot's graphs stay
        valid, so nothing is built or captured), else into a new slot,
        whose programs are then built on demand and counted in
        ``_builds``.  Shapes must match (``swap_compat``).  The serving
        epoch is unchanged until ``set_serving_epoch``."""
        reason = self.swap_compat(store, index)
        if reason is not None:
            raise ValueError(f"epoch {epoch} cannot hot-swap: {reason}")
        epoch = int(epoch)
        new = self._make_operands(store, index)
        with self._lock:
            if epoch in self._epochs:
                self.retire_epoch(epoch)
            if self._free_slots:
                slot = self._free_slots.pop(0)
                for dst, src in zip(self._slots[slot], new):
                    if dst is not None:
                        dst.copy_(src)
            else:
                slot = max(self._slots) + 1
                self._slots[slot] = StoreOperands(
                    *(None if t is None else t.clone() for t in new))
            self._epochs[epoch] = slot

    def set_serving_epoch(self, epoch: int) -> None:
        if int(epoch) not in self._epochs:
            raise KeyError(f"epoch {epoch} is not installed "
                           f"(have {sorted(self._epochs)})")
        self._serving_epoch = int(epoch)

    def retire_epoch(self, epoch: int) -> None:
        """Drop a standby epoch.  Its slot, once no epoch reads it, goes
        back to the free list when it is one of the two kept slots (its
        memory stays held, its graphs stay valid), and is freed with its
        graphs otherwise.  (The reference frees the epoch's memory.)"""
        epoch = int(epoch)
        if epoch == self._serving_epoch:
            raise ValueError(f"cannot retire the serving epoch {epoch}")
        with self._lock:
            slot = self._epochs.pop(epoch, None)
            if slot is None or slot in self._epochs.values():
                return
            if slot in self._kept_slots:
                self._free_slots.append(slot)
            else:
                del self._slots[slot]
                self._drop_slot_programs(slot)

    @contextlib.contextmanager
    def at_epoch(self, epoch: int):
        """Pin this thread's dispatches to ``epoch``'s operands (the
        serving runtime runs each wave's segments so)."""
        prev = getattr(self._tls, "pinned", None)
        self._tls.pinned = int(epoch)
        try:
            yield
        finally:
            self._tls.pinned = prev

    # -- programs: the cache and the CUDA graphs ------------------------------
    def program_key(self, key):
        """The cache key of ``key`` as this thread would dispatch it: on
        the card a graph bakes its slot's addresses, so the key carries
        the slot (except ``SLOTLESS_KINDS``); on the CPU a program reads
        its operands when called."""
        key = tuple(key) + self.mesh_sig()
        if self.device.type != "cuda" or key[0] in SLOTLESS_KINDS:
            return key
        return key + (("slot", self._slot()),)

    def mesh_sig(self) -> tuple:
        """``(("mesh", shard_axis, shards, batch_axis, batch_shards),)``
        on a sharded engine, else ``()``: part of every program key."""
        if self.mesh is None:
            return ()
        return (("mesh", self.shard_axis, self.n_shards, self.batch_axis,
                 self.batch_shards),)

    def program(self, key, build):
        """The program cache: ``build()`` once per key (the reference
        keys compiled programs the same way), counted in ``_builds``.

        This lookup is the dispatch seam: an installed hook
        (``ops.set_dispatch_hook``) sees the key before the hit/miss
        check (it may evict) and may wrap the returned callable; with
        none the cached object itself is returned.  Over a
        ``ProcessMesh`` a serving runtime may set ``seam`` (a
        ``repro_torch.launch.faults.Agreement``): while it is active the
        ranks agree on every lookup's and dispatch's outcome, so that a
        fault drawn on one rank is every rank's."""
        key = self.program_key(key)
        hook = ops.dispatch_hook()
        seam = self.seam if self.seam is not None and self.seam.active \
            else None
        if seam is not None:
            seam.on_program(self, key, hook)
        elif hook is not None:
            hook.on_program(self, key)
        if key not in self._programs:
            self._programs[key] = build()
            self._builds += 1
        fn = self._programs[key]
        if seam is not None:
            return seam.wrap(key, fn, hook)
        if hook is not None:
            return hook.wrap(key, fn)
        return fn

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
        serving loop replays them one at a time on one stream, and the
        engine's lock keeps replays, captures and ``install_epoch``'s
        copies apart.  The slots and the static buffers never move, so
        addresses baked into the graph stay valid (kernel 1's TMA tensor
        maps encode them).

        The kernels' ``launches`` counts move at capture, when nothing
        runs: the capture's counts are taken back and added at every
        replay.  A capture that fails raises, naming ``label``.

        A sharded engine captures where its mesh says a graph can hold
        the merges (``capturable``): every shard on this card, or a
        ``ProcessMesh`` over NCCL, whose collectives the graph then
        holds; the eager run makes the communicator, and the capture
        is thread-local, so that the process group's watchdog thread may
        query its events meanwhile.  Otherwise (shards on several cards
        of one process, gloo) ``fn`` runs eagerly."""
        if self.device.type != "cuda" or (
                self.mesh is not None
                and not self.mesh.capturable(self.shard_axis, self.device)):
            return fn
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_stream = torch.cuda.Stream(self.device)
        with self._lock:
            self._captures += 1
            replay = capture(fn, specs, self._graph_stream, self._graph_pool,
                             label or getattr(fn, "__qualname__", repr(fn)),
                             "thread_local" if self.ranks else "global")

        def locked(*args):
            with self._lock:
                return replay(*args)
        return locked

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
        does: on one host when the build-time strategy is "dense", and on
        every exact sharded step (``retrieval.fused_local_step``)."""
        return self._fused_masked(self.use_index(t))

    def _fused_masked(self, use_ix: bool) -> bool:
        """The fused decision for a step indexed or not (``use_ix``): the
        masked path takes it once a bucket, ``use_fused`` once a step."""
        if self.fused is False or use_ix:
            return False
        if self.fused is True or self.mesh is not None:
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
        """The pooled proxy query, rounded to the storage dtype (and held
        in fp32) as the reference rounds it."""
        q_img = q.reshape(q.shape[:-1] + tuple(self.store.image_shape))
        qp = downsample_proxy(q_img, self.cfg.proxy_factor)
        if self.storage_dtype is not None:
            qp = qp.to(self.storage_dtype).float()
        return qp

    def coarse(self, q: torch.Tensor, m: int) -> torch.Tensor:
        """Top-m candidates by exact proxy distance; [B, m], streamed or
        materialized by ``use_stream``."""
        return ops.screen_topm(self._proxy_query(q), self.proxy, m,
                               x_norms=self.proxy_norms,
                               tile=self.screen_tile,
                               stream=self.use_stream(q.shape[0]))[0]

    def coarse_indexed(self, q: torch.Tensor, m: int, nprobe_max: int,
                       nprobe=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Candidates via the Golden Index: ``(pos, d2)`` with positions
        in cluster-sorted row space, +inf ``d2`` on capacity padding
        (``ops.ivf_screen``; capacity mode when ``m = nprobe_max * L``)."""
        o = self.current_operands()
        return ops.ivf_screen(self._proxy_query(q), o.proxy_sorted,
                              o.proxy_norms_sorted, o.offsets,
                              o.centroids, o.centroid_norms, m,
                              nprobe_max, self.index.max_cluster,
                              nprobe=nprobe)

    def probe(self, q: torch.Tensor, nprobe_max: int, nprobe=None):
        """IVF level 1 of rescaled queries (``ops.ivf_probe``: on the card
        one launch from ``q`` to the probed candidates' dataset ids and
        validity, the proxy pooled inside it, rounded as ``_proxy_query``
        rounds it); ``nprobe`` (a 0-d device tensor on the masked path)
        masks the probes beyond it."""
        o, ix = self.current_operands(), self.index
        return ops.ivf_probe(q, self.store.image_shape, self.cfg.proxy_factor,
                             o.centroids, o.centroid_norms, o.offsets,
                             o.perm, ix.n, nprobe_max, ix.max_cluster,
                             nprobe=nprobe, fields=("ids", "valid"),
                             round_bf16=self.storage_dtype is not None)

    def _select_body(self, q: torch.Tensor, t: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx, d2) of the golden support for a rescaled query; ``idx``
        are dataset row ids on both paths (indexed candidates come from
        ``probe`` as ids, with the validity of each capacity slot)."""
        m_t, k_t = self.sizes(t)
        if self.use_index(t):
            pr = self.probe(q, self.nprobe(t))
            return ops.golden_rerank(q, self.X, pr.ids,
                                     min(k_t, self.padded_m(t)),
                                     x_norms=self.x_norms, valid=pr.valid)
        cand = self.coarse(q, m_t)
        return ops.golden_rerank(q, self.X, cand, k_t, x_norms=self.x_norms)

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
        out = ops.golden_support_aggregate(self.X, idx, lg)
        return out.to(x_t.dtype)

    def _fused_body(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Fused single-pass step (``ops.fused_step``): candidates with
        their exact distances from one read of the store, then the
        top-k and the aggregate of the k golden rows."""
        a, sig2 = self.constants(t)
        m_t, k_t = self.sizes(t)
        q = x_t / a
        out = ops.fused_step(q, self._proxy_query(q), self.X, self.proxy,
                             m_t, k_t, sig2, x_norms=self.x_norms,
                             proxy_norms=self.proxy_norms,
                             stream=self.use_stream(x_t.shape[0]),
                             tile=self.screen_tile)
        return out.to(x_t.dtype)

    # -- sharded (mesh) pipeline ------------------------------------------------
    def _by_batch(self, body, x_t: torch.Tensor) -> torch.Tensor:
        """``body(x)`` on each group of the query batch split over
        ``batch_axis`` (the store stays sharded over ``shard_axis`` in
        every group), the groups' outputs concatenated.  A rank of a
        ``ProcessMesh`` runs its own group and gathers the others over
        ``batch_axis``."""
        g = self.batch_shards
        if g == 1:
            return body(x_t)
        if x_t.shape[0] % g:
            raise ValueError(f"batch {x_t.shape[0]} does not divide over "
                             f"batch_axis {self.batch_axis!r} (size {g})")
        if self.ranks:
            mine = x_t.chunk(g)[self.mesh.coordinate(self.batch_axis)]
            return self.mesh.all_gather([body(mine)], 0,
                                        axis=self.batch_axis)
        return torch.cat([body(x) for x in x_t.chunk(g)])

    def _shard_rows(self):
        """The held shards' slabs as lists: (X, x_norms, proxy,
        proxy_norms)."""
        sl = self._layout.slabs
        return ([s.X for s in sl], [s.x_norms for s in sl],
                [s.proxy for s in sl], [s.proxy_norms for s in sl])

    def _ivf_local(self, qp: torch.Tensor, p: int, w_cap: int, nprobe=None):
        """Each shard's lanes of the globally probed index
        (``ops.ivf_screen_local``): ``(cand, valid)`` a shard."""
        L = self._layout
        cands, valids = [], []
        for s in L.slabs:
            pos, pd2 = ops.ivf_screen_local(
                qp.to(s.X.device), s.offsets, s.centroids, s.centroid_norms,
                s.w_lo, s.w_hi, p, L.max_cluster, w_cap, L.n_loc,
                nprobe=nprobe)
            cands.append(pos)
            valids.append(torch.isfinite(pd2))
        return cands, valids

    def _sharded_static(self, kind: str, x_t: torch.Tensor, t: int):
        """A static step over the mesh: the shard-local screen (exact or
        indexed) and the m-th cut, the shard-local re-rank and the k-th
        cut, then (``select``) the gathered global top-k ids or the
        log-sum-exp-merged golden mean.  ``kind`` "fused" runs the same
        operations in the fused order (bitwise the staged result)."""
        from repro_torch.distributed.retrieval import (
            fused_local_step, golden_local_topk, local_coarse_exact,
            merged_golden_mean)
        from repro_torch.distributed.sharding import gather_global_topk
        L, mesh = self._layout, self.mesh
        a, sig2 = self.constants(t)
        m_t, k_t = self.sizes(t)
        m_cap = min(m_t, L.n_loc)
        use_ix = self.use_index(t)
        if use_ix:
            p_t = self.nprobe(t)
            w_cap = min(p_t, L.w_max)
            k_cap = max(1, min(k_t, w_cap * L.max_cluster))
            strategy = "gather"
        else:
            k_cap = max(1, min(k_t, m_cap))
            strategy = self.strategy
        Xs, xns, prs, pns = self._shard_rows()

        def body(x):
            q = x / a
            qp = self._proxy_query(q)
            stream = self.use_stream(x.shape[0], L.n_loc)
            if kind == "fused":
                return fused_local_step(
                    Xs, xns, q, qp, prs, pns, m_cap, m_t, m_t, k_cap, k_t,
                    k_t, sig2, mesh, strategy, stream,
                    self.screen_tile).to(x.dtype)
            if use_ix:
                cands, valids = self._ivf_local(qp, p_t, w_cap)
            else:
                cands, valids = local_coarse_exact(
                    qp, prs, pns, m_cap, m_t, m_t, mesh, stream=stream,
                    tile=self.screen_tile)
            idx, neg, kth = golden_local_topk(Xs, xns, q, cands, valids,
                                              k_cap, k_t, k_t, mesh)
            if kind == "select":
                ids = [s.ids[i] for s, i in zip(L.slabs, idx)]
                return gather_global_topk(ids, neg, k_t, mesh)
            return merged_golden_mean(Xs, idx, neg, kth, sig2, mesh,
                                      strategy).to(x.dtype)
        return self._by_batch(body, x_t)

    def _sharded_masked_body(self, x_t: torch.Tensor, t, caps=None):
        """The masked step over the mesh: ``denoise_masked``'s caps,
        masks, probe schedule and occupancy floor, with the k_t cut
        applied by the cross-shard threshold instead of a positional
        mask (the same set up to distance ties at the k-th value, where
        the threshold keeps every tied row, as the reference's sharded
        body does).  Reads nothing back to the host: with the shards on
        one card a CUDA graph captures it."""
        from repro_torch.distributed.retrieval import (
            fused_local_step, golden_local_topk, local_coarse_exact,
            merged_golden_mean)
        L, mesh = self._layout, self.mesh
        m_cap, k_cap, p_cap, use_ix = self._masked_caps(caps)
        fused = self._fused_masked(use_ix)
        m_loc = min(m_cap, L.n_loc)
        if use_ix:
            w_cap = min(p_cap, L.w_max)
            k_loc = max(1, min(k_cap, w_cap * L.max_cluster))
            strategy = "gather"
        else:
            k_loc = max(1, min(k_cap, m_loc))
            strategy = self.strategy
        m_t, k_t, nprobe_t, a, sig2 = (
            None if v is None else take(v, t)
            for v in self._masked_table(m_cap, k_cap, p_cap, use_ix))
        Xs, xns, prs, pns = self._shard_rows()

        def body(x):
            q = x / a
            qp = self._proxy_query(q)
            stream = self.use_stream(x.shape[0], L.n_loc)
            if fused:
                return fused_local_step(
                    Xs, xns, q, qp, prs, pns, m_loc, m_cap, m_t, k_loc,
                    k_cap, k_t, sig2, mesh, strategy, stream,
                    self.screen_tile).to(x.dtype)
            if use_ix:
                cands, valids = self._ivf_local(qp, p_cap, w_cap, nprobe_t)
            else:
                cands, valids = local_coarse_exact(
                    qp, prs, pns, m_loc, m_cap, m_t, mesh, stream=stream,
                    tile=self.screen_tile)
            idx, neg, kth = golden_local_topk(Xs, xns, q, cands, valids,
                                              k_loc, k_cap, k_t, mesh)
            return merged_golden_mean(Xs, idx, neg, kth, sig2, mesh,
                                      strategy).to(x.dtype)
        return self._by_batch(body, x_t)

    def _sharded_full_scan(self, x_t: torch.Tensor, t: int):
        """The exact posterior mean over the sharded store: each shard's
        softmax state of all its rows (kernel 4's state entry on the
        card), one log-sum-exp merge."""
        from repro_torch.distributed.sharding import lse_merge_mean
        L = self._layout
        a, sig2 = self.constants(t)
        Xs, xns, _, _ = self._shard_rows()

        def body(x):
            q = x / a
            stream = self.use_stream(x.shape[0], L.n_loc)
            states = [ops.golden_full_partial(q.to(X.device), X, sig2,
                                              x_norms=xn, stream=stream,
                                              tile=self.screen_tile)
                      for X, xn in zip(Xs, xns)]
            return lse_merge_mean(*zip(*states), self.mesh).to(x.dtype)
        return self._by_batch(body, x_t)

    def slab_ids(self) -> np.ndarray:
        """The dataset ids of this rank's slab rows (a ``ProcessMesh``
        rank's one slab), int64 on the host: the rows a reader of this
        rank's part of the store takes.  Rows of +inf norm hold no data
        row (the empty slots of a capacity-padded index's windows, which
        name row 0) and are left out."""
        return self.slab_rows()[1]

    def slab_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """``(at, ids)``: the positions in this rank's slab of the rows
        that hold a data row (finite norm), and their dataset ids."""
        sl = self._layout.slabs[0]
        at = torch.nonzero(torch.isfinite(sl.x_norms[: sl.n_rows]))[:, 0]
        return at.cpu().numpy(), sl.ids[at].cpu().numpy()

    def coarse_ids(self, q: torch.Tensor, m: int) -> torch.Tensor:
        """Top-m dataset ids by exact proxy distance, [B, m], for the
        recall probe: ``coarse`` on one device; over a ``ProcessMesh``
        each shard's top-m of its slab and the gathered global top-m
        (``gather_global_topk``), the same on every rank."""
        if not self.ranks:
            return self.coarse(q, m)
        from repro_torch.distributed.sharding import gather_global_topk
        L = self._layout
        qp = self._proxy_query(q)
        stream = self.use_stream(q.shape[0], L.n_loc)
        ids, neg = [], []
        for s in L.slabs:
            c, d2 = ops.screen_topm(qp, s.proxy, min(m, L.n_loc),
                                    x_norms=s.proxy_norms,
                                    tile=self.screen_tile, stream=stream)
            ids.append(s.ids[c])
            neg.append(-d2)
        return gather_global_topk(ids, neg, m, self.mesh)

    def probed_ids(self, q: torch.Tensor, m: int, nprobe: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The indexed screen's candidates as dataset ids and their
        proxy distances (+inf on capacity padding), for the recall
        probe: ``coarse_indexed`` mapped through the index's order on
        one device; over a ``ProcessMesh`` every shard's lanes of the
        globally probed windows (``ops.ivf_screen_local``), gathered, the
        same on every rank."""
        if not self.ranks:
            pos, d2 = self.coarse_indexed(q, m, nprobe)
            return self.index_perm[pos], d2
        L = self._layout
        qp = self._proxy_query(q)
        w_cap = min(nprobe, L.w_max)
        (s,) = L.slabs
        pos, d2 = ops.ivf_screen_local(qp, s.offsets, s.centroids,
                                       s.centroid_norms, s.w_lo, s.w_hi,
                                       nprobe, L.max_cluster, w_cap, L.n_loc)
        return (self.mesh.all_gather([s.ids[pos]], 1),
                self.mesh.all_gather([d2], 1))

    # -- observability: spans around the static entry points -----------------
    def stage_costs(self, kind: str, t: int, batch: int) -> dict:
        """Cached analytic per-stage FLOPs/bytes (``core.plan``) of one
        entry call; ``select`` drops the aggregate stage."""
        key = (kind, int(t), int(batch))
        if key not in self._stage_costs:
            if kind == "full_scan":
                costs = full_scan_costs(self, batch)
            elif kind == "fused_step":
                costs = fused_step_costs(self, t, batch)
            else:
                costs = step_stage_costs(self, t, batch)
                if kind == "select":
                    costs = {s: c for s, c in costs.items()
                             if s != "aggregate"}
            self._stage_costs[key] = costs
        return self._stage_costs[key]

    def _traced(self, kind: str, t: int, x_t: torch.Tensor, fn):
        """``fn(x_t)`` inside an ``engine.<kind>`` span with one
        ``stage.*`` point event a stage.  Only reached with the tracer
        enabled; the card is synchronized inside the span, so its
        duration is the device work's.  The port runs static steps
        eagerly, so ``compile`` is always False."""
        tr = obs_trace.tracer()
        with tr.span(f"engine.{kind}", t=int(t), backend=self.device.type,
                     shape=tuple(x_t.shape), compile=False,
                     indexed=bool(self.use_index(t))):
            for stage, c in self.stage_costs(kind, t, x_t.shape[0]).items():
                tr.event(f"stage.{stage}", t=int(t), flops=c["flops"],
                         bytes=c["bytes"])
            out = fn(x_t)
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
        return out

    # -- public entry points --------------------------------------------------
    def select(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support S_t for each query; [B, k_t]."""
        t = int(t)
        a, _ = self.constants(t)
        if self.mesh is not None:
            fn = lambda x: self._sharded_static("select", x, t)
        else:
            fn = lambda x: self._select_ids_body(x / a, t)
        if not obs_trace.tracer().enabled:
            return fn(x_t)
        return self._traced("select", t, x_t, fn)

    def denoise(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Full GoldDiff step for the Optimal base (unbiased SS on S_t)."""
        t = int(t)
        fused = self.use_fused(t)
        if self.mesh is not None:
            kind = "fused" if fused else "denoise"
            body = lambda x, t: self._sharded_static(kind, x, t)
        else:
            body = self._fused_body if fused else self._denoise_body
        if not obs_trace.tracer().enabled:
            return body(x_t, t)
        return self._traced("fused_step" if fused else "denoise", t, x_t,
                            lambda x: body(x, t))

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
        dev = self.device
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
        step.  Over a mesh: ``_sharded_masked_body``."""
        if self.mesh is not None:
            return self._sharded_masked_body(x_t, t, caps)
        m_cap, k_cap, p_cap, use_ix = self._masked_caps(caps)
        m_t, k_t, nprobe_t, a, sig2 = (
            None if v is None else take(v, t)
            for v in self._masked_table(m_cap, k_cap, p_cap, use_ix))
        q = x_t / a
        if self._fused_masked(use_ix):
            out = ops.fused_step(q, self._proxy_query(q), self.X, self.proxy,
                                 m_cap, min(k_cap, m_cap), sig2,
                                 x_norms=self.x_norms,
                                 proxy_norms=self.proxy_norms,
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
                                    x_norms=self.x_norms, valid=live)
        lg = torch.clamp_min(-d2 / (2.0 * sig2), NEG_INF)
        lg = torch.where(torch.arange(k_pad, device=q.device) < k_t, lg,
                         NEG_INF)
        out = ops.golden_support_aggregate(self.X, idx, lg)
        return out.to(x_t.dtype)

    def full_scan(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Exact posterior mean over the whole store (Eq. 2); rows with
        a +inf norm (capacity padding) weigh 0."""
        t = int(t)
        a, sig2 = self.constants(t)

        def fn(x):
            if self.mesh is not None:
                return self._sharded_full_scan(x, t)
            return ops.golden_aggregate(x / a, self.X, sig2,
                                        x_norms=self.x_norms).to(x.dtype)
        if not obs_trace.tracer().enabled:
            return fn(x_t)
        return self._traced("full_scan", t, x_t, fn)


def is_process_mesh(mesh) -> bool:
    """Whether ``mesh`` shards over ranks (a ``ProcessMesh``)."""
    from repro_torch.distributed.sharding import ProcessMesh
    return isinstance(mesh, ProcessMesh)


def capture(fn, specs, side: torch.cuda.Stream, pool, label: str,
            mode: str = "global"):
    """``GoldDiffEngine.jitter``'s capture on the card (see there).  The
    warm run and the capture run on the engine's own stream ``side``:
    the pool's blocks are kept per stream, so one stream lets a capture
    reuse what the graphs before it freed, and a failed capture leaves
    no state on a stream anything else uses (the outer stream context
    restores the caller's stream even when the capture's own exit
    raises).  ``mode`` is the capture's error mode (``torch.cuda.graph``'s
    ``capture_error_mode``)."""
    device = side.device
    inputs = [torch.zeros(shape, dtype=dtype, device=device)
              for shape, dtype in map(_spec, specs)]
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*inputs)              # builds the kernels, sets their attributes
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected graph
        # (a retired slot's, a finished caller's) resets as it is freed,
        # which the capture mode forbids, and the capture is invalidated
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode=mode):
                out = fn(*inputs)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of {label} failed: "
                               f"{e}") from e
        finally:
            if collect:
                gc.enable()
            delta = [a - b for a, b in zip(ops.launch_counts(), before)]
            ops.add_launch_counts([-d for d in delta])
    torch.cuda.current_stream(device).wait_stream(side)

    def replay(*args):
        for buf, arg in zip(inputs, args):
            buf.copy_(arg)
        graph.replay()
        ops.add_launch_counts(delta)
        if isinstance(out, tuple):
            return tuple(o.clone() for o in out)
        return out.clone()

    return replay


def _spec(s) -> tuple[tuple, torch.dtype]:
    """``(shape, dtype)`` of a ``jitter`` input spec: a shape (fp32) or
    a ``(shape, dtype)`` pair."""
    if len(s) == 2 and isinstance(s[1], torch.dtype):
        return tuple(s[0]), s[1]
    return tuple(s), torch.float32
