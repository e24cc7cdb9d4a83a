"""Hand-written CUDA kernel: pairwise squared distances (coarse screen).

Replaces ``repro/kernels/pdist.py:61`` (``pdist`` / ``_pdist_kernel``).
The kernel (``csrc/pdist.cu``) is bound by bytes: persistent CTAs, one
an SM, walk 64-row tiles of the proxy store through a ring of TMA bulk
copies, with a group of 16 queries resident in shared memory, and write
the [B, N] output with 16-byte stores; the dots are the tensor-core
distance stage it shares with kernel 4 (``csrc/dist_tile.cuh``).
:func:`plan` sizes the grid.  Its plain version is ``ref.pdist_ref``;
``ops.pdist`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.golden_aggregate import MAX_SMEM, dt_stride, pad4
from repro_torch.kernels.golden_rerank import H100_SMS, sm_count

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
QUERY_GROUP = 16     # queries a CTA
TILE = 64            # store rows a tile
BOX = 32             # columns a TMA box (128 bytes)
SLAB = 8 * BOX       # columns a staged slab at most
STAGES = (3, 2)      # ring depths, deepest first (a fourth was no faster at d=192)


def smem_bytes(d: int, stages: int) -> int:
    """``pdist_smem`` of the source: 1024 bytes of alignment slack, the
    resident queries' boxes (d <= SLAB), ``stages`` stages of the store's
    boxes (and of the queries' slab, d > SLAB), the finished tile's two
    halves and the mbarriers."""
    one = d <= SLAB
    nbox = -(-d // BOX) if one else SLAB // BOX
    xbox, qbox = TILE * BOX, QUERY_GROUP * BOX
    return 4 * (256 + (nbox * qbox if one else 0)
                + stages * nbox * (xbox + (0 if one else qbox))
                + 2 * QUERY_GROUP * (TILE + 4) + 16)


def plan(b: int, n: int, d: int, sms: int = H100_SMS) -> dict:
    """The persistent grid: ``groups`` of 16 queries, ``ctas`` a group
    (the SMs shared among the groups, at most one a tile), ``tiles`` of
    the store, ``slabs`` of d, ``stages`` (the deepest ring that fits)
    and ``smem`` (bytes a CTA)."""
    groups = -(-b // QUERY_GROUP)
    tiles = -(-n // TILE)
    stages = next(s for s in STAGES if smem_bytes(d, s) <= MAX_SMEM)
    return dict(groups=groups, tiles=tiles,
                ctas=max(1, min(tiles, sms // max(1, groups))),
                slabs=max(1, -(-d // SLAB)), stages=stages,
                smem=smem_bytes(d, stages))


def pdist(q: torch.Tensor, x: torch.Tensor, q_norms: torch.Tensor,
          x_norms: torch.Tensor) -> torch.Tensor:
    """||q_i - x_j||^2 for q: [B, d], x: [N, d] with norms [B], [N] (fp32,
    CUDA, contiguous) -> [B, N] fp32."""
    name = "pdist"
    _build.require(name, q.device, q=q, x=x, q_norms=q_norms, x_norms=x_norms)
    _build.require_dtype(name, torch.float32, q=q, x=x, q_norms=q_norms,
                         x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "q_norms", q_norms, (b,))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    q, x = pad4(q), pad4(x)
    d = x.shape[1]
    p = plan(b, n, d, sm_count(q.device))
    vec_out = int(n % 4 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.load(name, "pdist_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), _build.ptr(q_norms),
             _build.ptr(x_norms), _build.ptr(out), b, n, d, p["ctas"],
             p["stages"], vec_out, _build.stream(q.device))
    _build.check(name, err)
    pdist.launches += 1
    return out


pdist.launches = 0
