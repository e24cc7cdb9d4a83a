"""Hand-written CUDA kernel: pairwise squared distances (coarse screen).

Replaces ``repro/kernels/pdist.py:61`` (``pdist`` / ``_pdist_kernel``).
The kernel (``csrc/pdist.cu``) is bound by bytes: persistent CTAs, one
an SM, walk 64-row tiles of the proxy store through a ring of TMA bulk
copies, with a group of 16 queries resident in shared memory, and write
the [B, N] output with 16-byte stores; the dots are the tensor-core
distance stage it shares with kernel 4 (``csrc/dist_tile.cuh``).  Its
bf16-row instance (the engine's ``storage_dtype``) reads the proxy
store through a bf16 tensor map, half the bytes.  :func:`plan` sizes
the grid.  Its plain version is ``ref.pdist_ref``;
``ops.pdist`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.golden_aggregate import (MAX_SMEM, dt_stride, pad4,
                                                  rows16)
from repro_torch.kernels.golden_rerank import H100_SMS, sm_count

_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
QUERY_GROUP = 16     # queries a CTA
TILE = 64            # store rows a tile
BOX = 32             # columns a TMA box (128 bytes)
SLAB = 8 * BOX       # columns a staged slab at most
STAGES = (3, 2)      # ring depths, deepest first (a fourth was no faster at d=192)


def smem_bytes(d: int, stages: int, itemsize: int = 4) -> int:
    """``pdist_smem`` of the source for store rows of ``itemsize`` bytes
    an element (4 fp32, 2 bf16): 1024 bytes of alignment slack, the
    resident queries' boxes (d <= SLAB), ``stages`` stages of the store's
    boxes (and of the queries' slab, d > SLAB), the finished tile's two
    halves and the mbarriers.  A box row is 128 bytes: 32 fp32 columns,
    64 bf16 (the queries are fp32)."""
    one = d <= SLAB
    xcols = 128 // itemsize
    nq = -(-d // BOX) if one else SLAB // BOX
    nx = -(-d // xcols) if one else SLAB // xcols
    xbox, qbox = TILE * 128, QUERY_GROUP * 128
    return (1024 + (nq * qbox if one else 0)
            + stages * (nx * xbox + (0 if one else nq * qbox))
            + 4 * (2 * QUERY_GROUP * (TILE + 4) + 16))


def plan(b: int, n: int, d: int, sms: int = H100_SMS,
         itemsize: int = 4) -> dict:
    """The persistent grid: ``groups`` of 16 queries, ``ctas`` a group
    (the SMs shared among the groups, at most one a tile), ``tiles`` of
    the store, ``slabs`` of d, ``stages`` (the deepest ring that fits)
    and ``smem`` (bytes a CTA) for store rows of ``itemsize`` bytes."""
    groups = -(-b // QUERY_GROUP)
    tiles = -(-n // TILE)
    stages = next(s for s in STAGES
                  if smem_bytes(d, s, itemsize) <= MAX_SMEM)
    return dict(groups=groups, tiles=tiles,
                ctas=max(1, min(tiles, sms // max(1, groups))),
                slabs=max(1, -(-d // SLAB)), stages=stages,
                smem=smem_bytes(d, stages, itemsize))


def pdist(q: torch.Tensor, x: torch.Tensor, q_norms: torch.Tensor,
          x_norms: torch.Tensor) -> torch.Tensor:
    """||q_i - x_j||^2 for q: [B, d], x: [N, d] with norms [B], [N] (CUDA,
    contiguous; x fp32 or bf16, the rest fp32) -> [B, N] fp32."""
    name = "pdist"
    _build.require(name, q.device, q=q, x=x, q_norms=q_norms, x_norms=x_norms)
    bf16 = _build.require_rows(name, x=x)
    _build.require_dtype(name, torch.float32, q=q, q_norms=q_norms,
                         x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "q_norms", q_norms, (b,))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    x = rows16(name, x)
    d = x.shape[1]
    if q.shape[1] != d:
        q = torch.nn.functional.pad(q, (0, d - q.shape[1]))
    q = pad4(q)
    p = plan(b, n, d, sm_count(q.device), x.element_size())
    vec_out = int(n % 4 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.load(name, "pdist_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), int(bf16), _build.ptr(q_norms),
             _build.ptr(x_norms), _build.ptr(out), b, n, d, p["ctas"],
             p["stages"], vec_out, _build.stream(q.device))
    _build.check(name, err)
    _build.count(pdist, bf16)
    return out


pdist.launches = 0
pdist.launches_bf16 = 0
