"""Hand-written CUDA kernel: softmax aggregation over golden rows by index.

Replaces ``repro/kernels/golden_support_aggregate.py:78``
(``golden_support_aggregate`` / ``_sagg_kernel``).  The TPU kernel's
online softmax carry across grid steps has no counterpart on Hopper;
the kernel (``csrc/golden_support_aggregate.cu``) reduces each query's
logits to (max, l) first and then accumulates the weighted rows,
loaded by index, in registers per 128-column slice: no atomics,
deterministic, bound by the bytes of the rows it reads.  Its plain
version is ``ref.golden_support_aggregate_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def golden_support_aggregate(x: torch.Tensor, idx: torch.Tensor,
                             logits: torch.Tensor) -> torch.Tensor:
    """softmax(logits)-weighted mean of x[idx] per query: x [N, D] fp32,
    idx [B, K] int64 in [0, N), logits [B, K] fp32 (NEG_INF entries get
    zero weight) -> [B, D] fp32, ``acc / max(l, 1e-30)``."""
    name = "golden_support_aggregate"
    _build.require(name, x.device, x=x, idx=idx, logits=logits)
    _build.require_dtype(name, torch.float32, x=x, logits=logits)
    _build.require_dtype(name, torch.int64, idx=idx)
    n, d = x.shape
    b, k = idx.shape
    _build.require_shape(name, "logits", logits, (b, k))
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    fn = _build.load(name, "golden_support_aggregate_launch", _ARGS)
    err = fn(_build.ptr(x), _build.ptr(idx), _build.ptr(logits),
             _build.ptr(out), b, k, d, vec, _build.stream(x.device))
    _build.check(name, err)
    golden_support_aggregate.launches += 1
    return out


golden_support_aggregate.launches = 0
