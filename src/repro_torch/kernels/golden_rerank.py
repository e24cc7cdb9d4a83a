"""Hand-written CUDA kernel: exact re-rank distances to candidates by index.

Replaces ``repro/kernels/golden_rerank.py:66`` (``support_sqdist`` /
``_sqdist_kernel``).  The JAX op gathers ``x[idx]`` into a [B, m, D]
tensor first (2.46 GB at B=16, m=12500, D=3072).  The kernel
(``csrc/support_sqdist.cu``) never does, and reads each row that the
batch names once per group of ``QUERY_GROUP`` queries, however many of
them name it: a row map (``csrc/row_union.cuh``) lists the group's rows,
one pass over that list computes every row's dot products with the
group's queries, and a gather writes each slot's distance.  It is bound
by the bytes of the distinct rows.  Its bf16-row instance (the
engine's ``storage_dtype``) stages the rows in bf16, half the bytes,
and widens them for the same fp32 sums.  Its plain version is
``ref.support_sqdist_ref``.

The host plan (:func:`union_plan`, :func:`sqdist_plan`,
:func:`sqdist_scratch_sizes`) sizes every buffer from the shapes alone,
so a call reads nothing back from the card; ``golden_support_aggregate``
shares the row map's plan.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# csrc/row_union.cuh and csrc/support_sqdist.cu, which take their plan
# from the functions below
QUERY_GROUP = 16     # queries whose marks one 16-byte map word holds (QG)
UNION_CHUNK = 512    # rows one counting / compacting CTA takes (CHUNK)
DOT_ROWS = 128       # list rows one tile of the dot pass takes (BN)
DOT_SPLIT_MAX = 8    # D shares a tile of the dot pass at most (KS_MAX)
DOT_CTAS_PER_SM = 3  # dot-pass CTAs an SM holds (61 KB of stages each)
CTAS_PER_SM = 4      # resident row-pass CTAs an SM is planned for
H100_SMS = 132

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3)


def union_plan(b: int, n: int, s: int) -> dict:
    """The row map's plan for B queries of s slots each over N rows:
    ``groups`` of at most QUERY_GROUP queries, ``ucap`` (the most rows a
    group can name: min(N, min(B, QUERY_GROUP) * s), the size of its
    list) and ``chunks`` (the compaction's CTAs a group)."""
    return dict(groups=-(-b // QUERY_GROUP),
                ucap=min(n, min(b, QUERY_GROUP) * s),
                chunks=max(1, -(-n // UNION_CHUNK)))


def sqdist_plan(b: int, n: int, m: int, sms: int = H100_SMS) -> dict:
    """:func:`union_plan` plus ``dot_ctas``: the dot pass's CTAs a group,
    as many as the card keeps resident but no more than a full list's
    tiles times DOT_SPLIT_MAX.  On the card each CTA takes work items (a
    tile of DOT_ROWS list rows and one of ks shares of D) from a counter
    until the group's list is done; the card computes ks from the list's
    count (``dot_split`` in ``csrc/support_sqdist.cu``)."""
    p = union_plan(b, n, m)
    tiles = max(1, -(-p["ucap"] // DOT_ROWS))
    p["dot_ctas"] = max(1, min(tiles * DOT_SPLIT_MAX,
                               DOT_CTAS_PER_SM * sms // max(1, p["groups"])))
    return p


def sqdist_scratch_sizes(b: int, n: int, m: int) -> dict:
    """Element counts of the kernel's scratch: ``work`` int32 (the map's
    16-byte words [G, N], the dot pass's item counters [G], the chunk
    counts [G, chunks], the list counts [G], the query norms [B] as
    fp32, the lists [G, ucap]) and ``dots`` fp32 [DOT_SPLIT_MAX, G,
    ucap, QUERY_GROUP]."""
    p = union_plan(b, n, m)
    g, ucap = p["groups"], p["ucap"]
    return dict(work=4 * g * n + g + g * p["chunks"] + g + b + g * ucap,
                dots=DOT_SPLIT_MAX * g * ucap * QUERY_GROUP)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def carve(device: torch.device, *nbytes: int):
    """One scratch allocation for a call: ``(buffer, pointers)``, each
    part at a 256-byte aligned offset.  The buffer must outlive the
    launch (the caller keeps it until the call returns)."""
    offs, total = [], 0
    for n in nbytes:
        offs.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return buf, [ctypes.c_void_p(buf.data_ptr() + o) for o in offs]


def support_sqdist(q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Distances from q_b to rows x[idx[b]]: q [B, D] and x_norms [N]
    fp32, x [N, D] fp32 or bf16, idx [B, M] int64 in [0, N) -> [B, M]
    fp32."""
    name = "support_sqdist"
    _build.require(name, q.device, q=q, x=x, x_norms=x_norms, idx=idx)
    bf16 = _build.require_rows(name, x=x)
    _build.require_dtype(name, torch.float32, q=q, x_norms=x_norms)
    _build.require_dtype(name, torch.int64, idx=idx)
    b, d = q.shape
    n = x.shape[0]
    m = idx.shape[1]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    _build.require_shape(name, "idx", idx, (b, m))
    dev = q.device
    p = sqdist_plan(b, n, m, sm_count(dev))
    z = sqdist_scratch_sizes(b, n, m)
    scratch, (work, dots) = carve(dev, 4 * z["work"], 4 * z["dots"])
    out = torch.empty((b, m), dtype=torch.float32, device=dev)
    vec = int(_build.vec4(q) and _build.vec4(x))
    fn = _build.load(name, "support_sqdist_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), int(bf16), _build.ptr(x_norms),
             _build.ptr(idx), _build.ptr(out), b, m, n, d, vec, p["groups"],
             p["ucap"], p["chunks"], p["dot_ctas"], work, dots,
             _build.stream(dev))
    _build.check(name, err)
    _build.count(support_sqdist, bf16)
    return out


support_sqdist.launches = 0
support_sqdist.launches_bf16 = 0
