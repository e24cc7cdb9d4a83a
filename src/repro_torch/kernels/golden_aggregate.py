"""Hand-written CUDA kernel: full-scan posterior mean (Eq. 2), one pass.

Replaces ``repro/kernels/golden_aggregate.py:93`` (``golden_aggregate`` /
``_agg_kernel``).  The kernel (``csrc/golden_aggregate.cu``) copies each
store row from device memory into shared memory once per call for a
group of up to 16 queries; the logits and the weighted sum both read it
there.  D is split across a thread block cluster (:func:`plan`), the
CTAs add their partial logits in rank order through distributed shared
memory, N is split across the clusters the card keeps resident, and a
second small kernel merges the clusters' (max, l, acc) states by
log-sum-exp in split order.  Its bf16-row instance (the engine's
``storage_dtype``) stages the rows in bf16 and widens them, two MMAs a
product (``csrc/dist_tile.cuh``).  Its plain version is
``ref.golden_aggregate_ref``.  The state entry
(:func:`golden_aggregate_state`) runs the same cluster pass and writes
the merged softmax state undivided, for the sharded full scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.golden_rerank import H100_SMS

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
         + [ctypes.c_float] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
         + [ctypes.c_void_p])
# the state entry's: acc, m and l in place of out and dbg
_STATE_ARGS = _ARGS[:10] + [ctypes.c_void_p] * 2 + _ARGS[11:]
# shared memory a block may opt in to on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024
THREADS = 256          # a CTA's threads
QUERY_GROUP = 16       # queries a cluster serves
TILE_ROWS = 16         # store rows a tile
WEIGHT_STRIDE = 20     # a query's row of weights in shared memory
SLICES = (64, 128, 256, 448, 768)   # columns a CTA: 8 warps x 8 KW
CLUSTERS = (1, 2, 4, 8, 16)   # CTAs a cluster (16: non-portable, H100)
STAGES = (8, 7, 6, 5, 4, 3)   # ring depths, deepest first
BARS = 32              # floats: the stages' and the sums' mbarriers


def dt_stride(cols: int) -> int:
    """``dt_stride`` of ``csrc/dist_tile.cuh``: a staged row's stride in
    floats (a multiple of 32, plus 8)."""
    return -(-cols // 32) * 32 + 8


def smem_bytes(ds: int, stages: int, c: int, itemsize: int = 4) -> int:
    """``agg_smem`` of the source: the ring of store rows of ``itemsize``
    bytes an element (4 fp32, 2 bf16), the mbarriers, the warps' partial
    dots, the C ranks' partial dots (x2), the weights (x2) and the
    rescale factors (x2)."""
    q, r = QUERY_GROUP, TILE_ROWS
    return (itemsize * stages * r * dt_stride(ds)
            + 4 * (BARS + (THREADS // 32) * q * r + 2 * c * q * r
                   + 2 * q * WEIGHT_STRIDE + 2 * q))


def pad4(t: torch.Tensor) -> torch.Tensor:
    """t [.., d] with its rows 16-byte aligned and a positive multiple of
    16 bytes (4 fp32 values, 8 bf16): t itself when it is, else a copy
    padded with zero columns (the copies' rows; zero columns add nothing
    to a dot or to a mean)."""
    e = 16 // t.element_size()
    d = t.shape[-1]
    if d and d % e == 0 and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, -d % e or e)).contiguous()


def rows16(name: str, x: torch.Tensor) -> torch.Tensor:
    """Store rows x [n, d] as kernels 1 and 4 stage them (16-byte rows,
    16-byte aligned): fp32 rows through ``pad4``; bf16 rows only as they
    are, since padding them would copy the whole store on every call."""
    if x.dtype == torch.bfloat16 and (x.shape[-1] % 8
                                      or x.data_ptr() % 16):
        raise ValueError(
            f"{name}: bf16 store rows need d a multiple of 8 and a 16-byte "
            f"aligned start (d={x.shape[-1]})")
    return pad4(x)


def cluster_shape(d: int, itemsize: int = 4) -> dict:
    """The smallest cluster whose CTAs each take at most SLICES[-1]
    columns: ``cluster`` (C), ``slice`` (ds, the least of SLICES that
    covers ceil(D / C)), ``stages`` (the deepest ring of store rows of
    ``itemsize`` bytes an element that fits) and ``smem`` (bytes a
    CTA)."""
    c = next((c for c in CLUSTERS if -(-d // c) <= SLICES[-1]), None)
    if c is None:
        raise ValueError(f"golden_aggregate: D={d} needs more than "
                         f"{CLUSTERS[-1]} CTAs of {SLICES[-1]} columns")
    ds = next(s for s in SLICES if s >= -(-d // c))
    stages = next(s for s in STAGES
                  if smem_bytes(ds, s, c, itemsize) <= MAX_SMEM)
    return dict(cluster=c, slice=ds, stages=stages,
                smem=smem_bytes(ds, stages, c, itemsize))


def plan(b: int, n: int, d: int, clusters: int | None = None,
         sms: int = H100_SMS, itemsize: int = 4) -> dict:
    """:func:`cluster_shape` plus the grid: ``groups`` of 16 queries side
    by side, ``splits`` of N (the resident ``clusters`` shared among the
    groups, every split at least one tile), ``rows`` a split (a multiple
    of TILE_ROWS), and the scratch's element counts (``part_acc`` fp32
    [splits, B, D]; ``part_ml`` fp32, m and l [splits, B] each).
    ``clusters`` defaults to sms // C, one CTA an SM; on the card it is
    what ``cudaOccupancyMaxActiveClusters`` reports."""
    p = cluster_shape(d, itemsize)
    if clusters is None:
        clusters = max(1, sms // p["cluster"])
    groups = -(-b // QUERY_GROUP)
    tiles = -(-n // TILE_ROWS)
    want = max(1, min(clusters // max(1, groups), tiles))
    rows = -(-tiles // want) * TILE_ROWS
    splits = -(-n // rows)
    p.update(groups=groups, splits=splits, rows=rows,
             part_acc=splits * b * d, part_ml=2 * splits * b)
    return p


_ACTIVE: dict = {}


def active_clusters(shape: dict, device: torch.device,
                    bf16: bool = False) -> int:
    """Clusters of this shape (of the bf16-row instance when ``bf16``)
    the card keeps resident at once; raises if the card refuses the
    cluster shape."""
    key = (device.index, shape["cluster"], shape["slice"], shape["stages"],
           bf16)
    if key not in _ACTIVE:
        fn = _build.load("golden_aggregate", "golden_aggregate_active_"
                         "clusters", [ctypes.c_int] * 4)
        with torch.cuda.device(device):
            got = fn(shape["cluster"], shape["slice"], shape["stages"],
                     int(bf16))
        if got < 0:
            _build.check("golden_aggregate", -got)
        if got == 0:
            raise RuntimeError(
                f"golden_aggregate: the card keeps no cluster of "
                f"{shape['cluster']} CTAs with {shape['smem']} bytes of "
                f"shared memory each resident")
        _ACTIVE[key] = got
    return _ACTIVE[key]


def _launch(q: torch.Tensor, x: torch.Tensor, sigma2: float,
            x_norms: torch.Tensor, debug: bool, state: bool = False):
    name = "golden_aggregate_state" if state else "golden_aggregate"
    _build.require(name, q.device, q=q, x=x, x_norms=x_norms)
    bf16 = _build.require_rows(name, x=x)
    _build.require_dtype(name, torch.float32, x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    if n == 0:
        raise ValueError(f"{name}: the store is empty")
    q32 = q.float().contiguous()
    qn = (q32 * q32).sum(-1)
    x = rows16(name, x)
    dp = x.shape[1]
    if q32.shape[1] != dp:
        q32 = torch.nn.functional.pad(q32, (0, dp - q32.shape[1]))
    q32 = pad4(q32)
    size = x.element_size()
    p = plan(b, n, dp, active_clusters(cluster_shape(dp, size), q.device,
                                       bf16), itemsize=size)
    dev = q.device
    part_acc = torch.empty(p["part_acc"], dtype=torch.float32, device=dev)
    part_ml = torch.empty(p["part_ml"], dtype=torch.float32, device=dev)
    out = torch.empty((b, dp), dtype=torch.float32, device=dev)
    dbg = (torch.full((p["splits"], p["cluster"], p["groups"] * QUERY_GROUP,
                       2 + TILE_ROWS), float("nan"), device=dev)
           if debug else None)
    head = (_build.ptr(q32), _build.ptr(x), int(bf16), _build.ptr(qn),
            _build.ptr(x_norms), ref.finite_inv_two_sigma2(sigma2),
            _build.ptr(part_acc), _build.ptr(part_ml),
            ctypes.c_void_p(part_ml.data_ptr() + 4 * p["splits"] * b),
            _build.ptr(out))
    tail = (b, n, dp, p["cluster"], p["slice"], p["stages"], p["splits"],
            p["rows"], _build.stream(dev))
    if state:
        ml = torch.empty((2, b), dtype=torch.float32, device=dev)
        fn = _build.load("golden_aggregate", "golden_aggregate_state_launch",
                         _STATE_ARGS)
        err = fn(*head, _build.ptr(ml[0]), _build.ptr(ml[1]), *tail)
    else:
        fn = _build.load(name, "golden_aggregate_launch", _ARGS)
        err = fn(*head, None if dbg is None else _build.ptr(dbg), *tail)
    _build.check("golden_aggregate", err)
    if state:
        _build.count(golden_aggregate_state, bf16)
        return out[:, :d], ml[0], ml[1]
    _build.count(golden_aggregate, bf16)
    return out[:, :d].to(q.dtype), dbg


def golden_aggregate(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                     x_norms: torch.Tensor) -> torch.Tensor:
    """Full-scan posterior mean: q [B, D] (the rescaled query), x [N, D]
    (fp32 or bf16 rows) and x_norms [N] fp32 -> [B, D] in q's dtype (fp32
    accumulation)."""
    return _launch(q, x, sigma2, x_norms, debug=False)[0]


golden_aggregate.launches = 0
golden_aggregate.launches_bf16 = 0


def golden_aggregate_state(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                           x_norms: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The state entry: the same kernel's softmax state of the whole
    store x, ``(acc [B, D], m [B], l [B])`` fp32 undivided (logits
    clamped at NEG_INF, so a store shard of +inf-norm padding alone gives
    m = NEG_INF and l = its row count), which shards merge by log-sum-exp
    (``distributed.sharding.lse_merge_mean``).  Its plain version is
    ``ref.full_partial_ref``."""
    return _launch(q, x, sigma2, x_norms, debug=False, state=True)


golden_aggregate_state.launches = 0
golden_aggregate_state.launches_bf16 = 0


def cluster_states(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                   x_norms: torch.Tensor):
    """:func:`golden_aggregate` plus what each CTA of every cluster holds:
    [splits, C, groups * 16, 2 + 16] fp32, each rank's final (max, l) and
    its first tile's 16 weights a query slot.  The ranks of a cluster
    must agree bit for bit (the test of the rank-order logit sum)."""
    return _launch(q, x, sigma2, x_norms, debug=True)
