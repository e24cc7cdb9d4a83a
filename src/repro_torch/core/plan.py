"""Trajectory plans: bucketed shapes for the DDIM grid.

Counterpart of ``repro.core.plan`` (host Python; the buckets and the
numbers equal the reference's).  The paper's Posterior Progressive
Concentration makes per-step budgets shrink and grow along the
trajectory: k_t halves and m_t grows as noise falls (Eqs. 4/6), and
the probe width nprobe_t tracks g(sigma_t) the same way.

* **static mode** runs each step at its own (m_t, k_t, nprobe_t): the
  paper's FLOP savings exactly, one launch sequence per step;
* **masked mode** (``caps=None``) pads every step to the worst case
  (m_max, k_max, nprobe_pad): one body for the whole trajectory.

A :class:`TrajectoryPlan` sits between the two: the step grid is split
into a few contiguous **shape buckets** by a greedy merge, adjacent
steps coalescing while the bucket's padded-FLOP overhead (every member
step run at the bucket's caps instead of its own shape) stays under
``threshold`` (default 15%).  Each bucket carries static caps
``(m_cap, k_cap, nprobe_cap)``; ``GoldDiffEngine.denoise_masked(x, t,
caps=...)`` pads to them, and ``sampler.sample_plan`` chains the
buckets as segments.  In the reference each segment is one compiled
program; in the port, on the card, each is one captured CUDA graph
(``GoldDiffEngine.jitter``).

Buckets never straddle an indexed/exact boundary: a step the engine
routes through the Golden Index (``engine.use_index(t)``) runs another
coarse stage than an exact step.  Within a bucket the masks reproduce
the static per-step shapes exactly (the top-m_cap list masked to m_t
equals the static top-m_t list, and likewise for k and nprobe), so plan
and static outputs differ only in fp32 reduction order.

FLOP accounting is the candidate/support work the caps pad: per query
and step ``(candidate_rows + k) * D`` with ``candidate_rows = m``
(exact) or ``nprobe * L`` (indexed), the exact re-rank plus the
aggregate.  The coarse proxy pass is left out: it does not depend on
the caps.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.schedules import sampling_timesteps

__all__ = ["BucketCaps", "PlanBucket", "TrajectoryPlan", "build_plan",
           "step_shapes", "step_stage_costs", "fused_step_costs",
           "full_scan_costs"]


@dataclasses.dataclass(frozen=True)
class BucketCaps:
    """Static pad shapes for one bucket's masked body.

    Hashable (frozen) so it can extend program-cache keys.
    ``nprobe_cap``/``indexed`` route the coarse stage: an indexed
    bucket pads the probe gather to ``nprobe_cap`` windows, an exact
    bucket pads the candidate list to ``m_cap`` rows.
    """

    m_cap: int
    k_cap: int
    nprobe_cap: int = 0
    indexed: bool = False

    def sig(self) -> tuple:
        """Cache-key signature."""
        return (self.m_cap, self.k_cap, self.nprobe_cap, self.indexed)


@dataclasses.dataclass(frozen=True)
class StepShape:
    """Exact per-step shapes (the static-mode program for step ``t``)."""

    t: int            # schedule timestep this DDIM step denoises at
    m_t: int
    k_t: int
    nprobe_t: int     # 0 when the step screens exactly
    indexed: bool

    def flops(self, dim: int, max_cluster: int) -> float:
        """Candidate/support FLOPs per query at these exact shapes."""
        cand = self.nprobe_t * max_cluster if self.indexed else self.m_t
        return float((cand + self.k_t) * dim)

    def flops_at(self, caps: BucketCaps, dim: int, max_cluster: int) -> float:
        """Candidate/support FLOPs per query when run padded to ``caps``."""
        cand = caps.nprobe_cap * max_cluster if caps.indexed else caps.m_cap
        return float((cand + caps.k_cap) * dim)


@dataclasses.dataclass(frozen=True)
class PlanBucket:
    """A contiguous run of DDIM steps sharing one program (one CUDA
    graph a batch shape on the card).

    ``start``/``stop`` index the *step* grid (position i denoises at
    ``plan.ts[i]`` and lands on ``plan.ts[i + 1]``), stop exclusive.
    """

    start: int
    stop: int
    caps: BucketCaps
    padded_flops: float   # per query, summed over member steps, at caps
    exact_flops: float    # per query, summed over member steps, exact

    @property
    def num_steps(self) -> int:
        return self.stop - self.start

    @property
    def overhead(self) -> float:
        """Padded-over-exact FLOP overhead (0.0 == no padding waste)."""
        return self.padded_flops / self.exact_flops - 1.0


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """A bucketed partition of one DDIM trajectory.

    ``ts`` is the full sampling grid (descending, ``num_steps + 1``
    points, as ``sampling_timesteps`` returns it); ``steps[i]`` holds
    the exact shapes of the step denoising at ``ts[i]``.
    """

    ts: tuple
    steps: tuple
    buckets: tuple
    threshold: float

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def padded_flops(self) -> float:
        """Per-query candidate/support FLOPs the plan actually pays."""
        return sum(b.padded_flops for b in self.buckets)

    @property
    def exact_flops(self) -> float:
        """Per-query candidate/support FLOPs of per-step static mode."""
        return sum(b.exact_flops for b in self.buckets)

    @property
    def overhead(self) -> float:
        """Whole-trajectory padded-FLOP overhead vs static mode."""
        return self.padded_flops / self.exact_flops - 1.0

    def describe(self) -> str:
        """Human-readable bucket table (one line per bucket)."""
        lines = [f"TrajectoryPlan: {self.num_steps} steps -> "
                 f"{self.num_buckets} buckets, "
                 f"padded-FLOP overhead {100 * self.overhead:.1f}% "
                 f"(threshold {100 * self.threshold:.0f}%/bucket)"]
        for b in self.buckets:
            t_hi = int(self.ts[b.start])
            t_lo = int(self.ts[b.stop - 1])
            cap = (f"nprobe<={b.caps.nprobe_cap}" if b.caps.indexed
                   else f"m<={b.caps.m_cap}")
            lines.append(
                f"  steps [{b.start}, {b.stop}) t {t_hi}..{t_lo}: "
                f"{cap} k<={b.caps.k_cap} "
                f"overhead {100 * b.overhead:.1f}%")
        return "\n".join(lines)


def _elem_size(engine) -> int:
    """Bytes per stored element (bf16 storage halves operand traffic)."""
    try:
        return int(engine.X.dtype.itemsize)
    except AttributeError:               # pragma: no cover - duck-typed
        return 4


def step_stage_costs(engine, t: int, batch: int = 1) -> dict:
    """Analytic per-stage FLOPs/bytes of one GoldDiff step at static ``t``.

    Returns ``{stage: {"flops": float, "bytes": float}}`` with stages
    ``screen`` *or* ``ivf_screen`` (by ``engine.use_index(t)``), then
    ``rerank`` and ``aggregate`` — the reference's operand-traffic /
    arithmetic model (its roofline benchmark reads it).  The
    conventions (documented so cells stay comparable across PRs):

    * matmul-form distances count 2*rows*dim FLOPs per query (one
      multiply-add per element);
    * bytes are *analytic operand traffic*: stored rows at the storage
      dtype width, norms/logits/outputs at fp32 — an optimistic
      read-each-operand-once model, so ``achieved <= peak`` holds with
      slack on cached re-reads;
    * the dense (scatter+GEMM) strategy reads the full store per stage,
      the gather strategy reads only the touched rows (exactly the
      crossover the engine picks strategies by).
    """
    b = float(batch)
    n = float(engine.store.n)
    dim = float(engine.store.dim)
    dp = float(engine.proxy.shape[1])
    esz = float(_elem_size(engine))
    m_t, k_t = engine.sizes(t)
    costs = {}
    if engine.use_index(t):
        ix = engine.index
        c = float(ix.num_clusters)
        cand = float(engine.nprobe(t) * ix.max_cluster)
        costs["ivf_screen"] = {
            # centroid scan GEMM + probed-window proxy distances; like
            # the exact screen, shared operands (centroids, probed
            # proxy rows) count ONCE per batch — the read-each-operand-
            # once convention — while per-query outputs scale with b
            "flops": 2.0 * b * c * dp + 2.0 * b * cand * dp,
            "bytes": c * dp * 4.0 + min(n, cand) * dp * esz
            + b * cand * 8.0 + b * dp * 4.0}
    else:
        cand = float(m_t)
        out_b = (b * n * 4.0
                 if not engine.use_stream(int(batch)) else b * m_t * 8.0)
        costs["screen"] = {"flops": 2.0 * b * n * dp,
                           "bytes": n * dp * esz + b * dp * 4.0 + out_b}
    if engine.strategy_for(t) == "dense":
        costs["rerank"] = {"flops": 2.0 * b * n * dim,
                           "bytes": n * dim * esz + b * n * 4.0}
        costs["aggregate"] = {"flops": 2.0 * b * n * dim,
                              "bytes": n * dim * esz + b * n * 4.0}
    else:
        costs["rerank"] = {"flops": 2.0 * b * cand * dim,
                           "bytes": b * cand * (dim * esz + 8.0)}
        costs["aggregate"] = {"flops": 2.0 * b * k_t * dim,
                              "bytes": b * k_t * (dim * esz + 4.0)}
    return costs


def fused_step_costs(engine, t: int, batch: int = 1) -> dict:
    """Analytic FLOPs/bytes of the fused single-pass step kind.

    One stage (``fused_step``): the fused program streams the proxy and
    dataset stores exactly once — coarse screen, exact re-rank, and the
    top-k epilogue in one pass — so the byte model reads each operand
    ONCE (n rows of proxy + X at storage width, queries/outputs at
    fp32, plus the [B, m] carry and the k golden rows the epilogue
    gathers).  FLOPs are the two per-tile GEMMs over all N rows plus
    the gather-form aggregate over k.  Deliberately an undercount of
    any real schedule (re-reads, spills), keeping ``achieved <= peak``
    meaningful in the roofline cell.
    """
    b = float(batch)
    n = float(engine.store.n)
    dim = float(engine.store.dim)
    dp = float(engine.proxy.shape[1])
    esz = float(_elem_size(engine))
    m_t, k_t = engine.sizes(t)
    flops = 2.0 * b * n * dp + 2.0 * b * n * dim + 2.0 * b * k_t * dim
    byts = (n * (dp + dim) * esz            # one streaming store pass
            + 2.0 * n * 4.0                 # fp32 row norms (both sides)
            + b * (dp + dim) * 4.0          # queries
            + b * m_t * 12.0                # [B, m] carry (neg, idx, d2)
            + b * k_t * (dim * esz + 8.0)   # epilogue golden-row gather
            + b * dim * 4.0)                # output
    return {"fused_step": {"flops": flops, "bytes": byts}}


def full_scan_costs(engine, batch: int = 1) -> dict:
    """Analytic FLOPs/bytes of the exact posterior mean (Eq. 2)."""
    b = float(batch)
    n = float(engine.store.n)
    dim = float(engine.store.dim)
    esz = float(_elem_size(engine))
    # distance GEMM + softmax-weighted aggregation GEMM over all N rows
    return {"full_scan": {"flops": 4.0 * b * n * dim,
                          "bytes": 2.0 * n * dim * esz + b * n * 8.0
                          + 2.0 * b * dim * 4.0}}


def step_shapes(engine, num_steps: int = 10) -> tuple:
    """Exact static-mode shapes for every step of the DDIM grid.

    ``engine`` is a ``GoldDiffEngine`` (duck-typed: ``sizes``,
    ``use_index``, ``nprobe`` and the schedule are all that is read).
    """
    ts = sampling_timesteps(engine.schedule, num_steps)
    steps = []
    for t in ts[:-1]:
        t = int(t)
        m_t, k_t = engine.sizes(t)
        indexed = bool(engine.use_index(t))
        nprobe_t = engine.nprobe(t) if indexed else 0
        steps.append(StepShape(t, m_t, k_t, nprobe_t, indexed))
    return tuple(ts.tolist()), tuple(steps)


def _caps_of(steps, lo: int, hi: int) -> BucketCaps:
    """Elementwise-max caps over steps[lo:hi] (all same ``indexed``)."""
    seg = steps[lo:hi]
    return BucketCaps(m_cap=max(s.m_t for s in seg),
                      k_cap=max(s.k_t for s in seg),
                      nprobe_cap=max(s.nprobe_t for s in seg),
                      indexed=seg[0].indexed)


def _bucket(steps, lo: int, hi: int, dim: int, max_cluster: int
            ) -> PlanBucket:
    caps = _caps_of(steps, lo, hi)
    padded = sum(s.flops_at(caps, dim, max_cluster) for s in steps[lo:hi])
    exact = sum(s.flops(dim, max_cluster) for s in steps[lo:hi])
    return PlanBucket(lo, hi, caps, padded, exact)


def build_plan(engine, num_steps: int = 10, threshold: float = 0.15,
               max_buckets: int | None = None) -> TrajectoryPlan:
    """Partition the DDIM grid into shape buckets by greedy merging.

    Every step starts as its own bucket (zero overhead == static mode);
    adjacent buckets with the same indexed/exact routing then merge
    greedily — always the pair whose merged bucket has the lowest
    padded-FLOP overhead — while that overhead stays ``<= threshold``.
    ``threshold=0`` therefore reproduces static mode (one bucket per
    distinct shape), ``threshold=inf`` reproduces masked mode (one
    bucket per routing region).  ``max_buckets`` keeps merging past the
    threshold (still lowest-overhead-first) until the bucket count
    fits, which is how ``--buckets N`` on the serving CLIs forces a
    program budget — except that indexed/exact routing edges always
    split buckets, so the floor is the number of routing regions (one
    region when the whole grid routes the same way).
    """
    ts, steps = step_shapes(engine, num_steps)
    if not steps:
        raise ValueError("empty sampling grid")
    dim = int(engine.store.dim)
    mc = int(engine.index.max_cluster) if engine.index is not None else 0
    buckets = [_bucket(steps, i, i + 1, dim, mc) for i in range(len(steps))]

    def merged(i: int) -> PlanBucket | None:
        a, b = buckets[i], buckets[i + 1]
        if a.caps.indexed != b.caps.indexed:
            return None                    # never straddle a routing edge
        return _bucket(steps, a.start, b.stop, dim, mc)

    def best_merge():
        cands = [(m.overhead, i, m) for i in range(len(buckets) - 1)
                 if (m := merged(i)) is not None]
        return min(cands, default=None)

    while len(buckets) > 1:
        cand = best_merge()
        if cand is None:
            break
        ov, i, m = cand
        if ov > threshold and (max_buckets is None
                               or len(buckets) <= max_buckets):
            break
        buckets[i: i + 2] = [m]
    return TrajectoryPlan(ts=ts, steps=steps, buckets=tuple(buckets),
                          threshold=float(threshold))
