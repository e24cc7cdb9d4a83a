"""Hand-written CUDA kernel: tiled pairwise squared distances (coarse screen).

Replaces ``repro/kernels/pdist.py:61`` (``pdist`` / ``_pdist_kernel``).
The kernel (``csrc/pdist.cu``) is bound by bytes: it reads each proxy
row once for up to 16 queries, staging query and row tiles in shared
memory, and masks the ragged edges itself.  Its plain version is
``ref.pdist_ref``; ``ops.pdist`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    fn = _build.load(name, "pdist_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), _build.ptr(q_norms),
             _build.ptr(x_norms), _build.ptr(out), b, n, d,
             _build.stream(q.device))
    _build.check(name, err)
    pdist.launches += 1
    return out


pdist.launches = 0
