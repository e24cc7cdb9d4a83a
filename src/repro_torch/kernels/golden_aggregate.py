"""Hand-written CUDA kernel: full-scan posterior mean (Eq. 2), split over N.

Replaces ``repro/kernels/golden_aggregate.py:93`` (``golden_aggregate`` /
``_agg_kernel``).  Hopper blocks run in no order, so instead of the
TPU's sequential online-softmax carry the kernel
(``csrc/golden_aggregate.cu``) splits N across blocks, each keeping a
partial (max, l, acc[BQ, D]) in shared memory for a group of up to 8
queries, and a second small kernel merges the partials by log-sum-exp.
All queries of a group share each tile of the store; the groups of one
row range sit side by side in the grid so that the store can cross HBM
about once per call (the intent; the DRAM bytes are not measured).
Its plain version is ``ref.golden_aggregate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 4
         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
# shared memory a block may opt in to on Hopper (232,448 bytes)
MAX_SMEM = 227 * 1024
GROUPS = (8, 4, 2, 1)      # queries per block the kernel is compiled for


def _plan(b: int, n: int, d: int, device: torch.device) -> tuple[int, int, int]:
    """(queries per block, splits of N, rows per split)."""
    smem = _build.load("golden_aggregate", "golden_aggregate_smem_bytes",
                       [ctypes.c_int, ctypes.c_int], ctypes.c_size_t)
    fits = [g for g in GROUPS if smem(g, d) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"golden_aggregate: D={d} needs "
                         f"{smem(1, d)} bytes of shared memory per block, "
                         f"more than the {MAX_SMEM} a block can hold")
    want = 1 << max(0, (b - 1).bit_length())      # next power of two >= B
    bq = next((g for g in fits if g <= want), fits[-1])
    groups = -(-b // bq)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(n, sms // groups))
    rows = -(-n // splits)
    return bq, -(-n // rows), rows


def golden_aggregate(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                     x_norms: torch.Tensor) -> torch.Tensor:
    """Full-scan posterior mean: q [B, D] (the rescaled query), x [N, D]
    and x_norms [N] fp32 -> [B, D] in q's dtype (fp32 accumulation)."""
    name = "golden_aggregate"
    _build.require(name, q.device, q=q, x=x, x_norms=x_norms)
    _build.require_dtype(name, torch.float32, x=x, x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    if n == 0:
        raise ValueError(f"{name}: the store is empty")
    q32 = q.float().contiguous()
    qn = (q32 * q32).sum(-1)
    bq, splits, rows = _plan(b, n, d, q.device)
    part_acc = torch.empty((splits, b, d), dtype=torch.float32,
                           device=q.device)
    part_m = torch.empty((splits, b), dtype=torch.float32, device=q.device)
    part_l = torch.empty((splits, b), dtype=torch.float32, device=q.device)
    out = torch.empty((b, d), dtype=torch.float32, device=q.device)
    vec = int(d % 4 == 0 and q32.data_ptr() % 16 == 0
              and x.data_ptr() % 16 == 0)
    fn = _build.load(name, "golden_aggregate_launch", _ARGS)
    err = fn(_build.ptr(q32), _build.ptr(x), _build.ptr(qn),
             _build.ptr(x_norms), ref.finite_inv_two_sigma2(sigma2),
             _build.ptr(part_acc), _build.ptr(part_m), _build.ptr(part_l),
             _build.ptr(out), b, n, d, bq, splits, rows, vec,
             _build.stream(q.device))
    _build.check(name, err)
    golden_aggregate.launches += 1
    return out.to(q.dtype)


golden_aggregate.launches = 0
