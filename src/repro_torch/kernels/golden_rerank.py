"""Hand-written CUDA kernel: exact re-rank distances to candidates by index.

Replaces ``repro/kernels/golden_rerank.py:66`` (``support_sqdist`` /
``_sqdist_kernel``).  The JAX op gathers ``x[idx]`` into a [B, m, D]
tensor first (2.46 GB at B=16, m=12500, D=3072); the kernel
(``csrc/support_sqdist.cu``) loads each candidate row by index instead,
one warp per row with 16-byte loads, and is bound by the bytes of the
rows it reads.  Its plain version is ``ref.support_sqdist_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def support_sqdist(q: torch.Tensor, x: torch.Tensor, x_norms: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Distances from q_b to rows x[idx[b]]: q [B, D], x [N, D],
    x_norms [N] (fp32), idx [B, M] int64 in [0, N) -> [B, M] fp32."""
    name = "support_sqdist"
    _build.require(name, q.device, q=q, x=x, x_norms=x_norms, idx=idx)
    _build.require_dtype(name, torch.float32, q=q, x=x, x_norms=x_norms)
    _build.require_dtype(name, torch.int64, idx=idx)
    b, d = q.shape
    n = x.shape[0]
    m = idx.shape[1]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    _build.require_shape(name, "idx", idx, (b, m))
    qn = (q * q).sum(-1)
    out = torch.empty((b, m), dtype=torch.float32, device=q.device)
    vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0
              and x.data_ptr() % 16 == 0)
    fn = _build.load(name, "support_sqdist_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), _build.ptr(x_norms),
             _build.ptr(idx), _build.ptr(qn), _build.ptr(out), b, m, d, vec,
             _build.stream(q.device))
    _build.check(name, err)
    support_sqdist.launches += 1
    return out


support_sqdist.launches = 0
