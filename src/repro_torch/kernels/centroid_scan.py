"""Hand-written CUDA kernel: query -> centroid distances (IVF level 1).

Replaces ``repro/kernels/centroid_scan.py:65`` (``centroid_scan`` /
``_centroid_kernel``).  The first stage of the indexed coarse screen:
distances from each proxy query to the Golden Index's C window
centroids.  The work is tiny (B=16 queries against a few hundred
centroids), so the kernel (``csrc/centroid_scan.cu``) is bound by its
launch, not by bytes or FLOPs: one wave of blocks, each a 16 x 16
output tile with its rows staged in shared memory.  Padded windows
carry +inf norms and get +inf distances.  Its plain version is
``ref.centroid_scan_ref``; ``ops.centroid_scan`` picks between them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def centroid_scan(q: torch.Tensor, centroids: torch.Tensor,
                  q_norms: torch.Tensor, c_norms: torch.Tensor
                  ) -> torch.Tensor:
    """||q_i - c_j||^2 for q: [B, d], centroids: [C, d] with norms [B],
    [C] (fp32, CUDA, contiguous) -> [B, C] fp32."""
    name = "centroid_scan"
    _build.require(name, q.device, q=q, centroids=centroids, q_norms=q_norms,
                   c_norms=c_norms)
    _build.require_dtype(name, torch.float32, q=q, centroids=centroids,
                         q_norms=q_norms, c_norms=c_norms)
    b, d = q.shape
    c = centroids.shape[0]
    _build.require_shape(name, "centroids", centroids, (c, d))
    _build.require_shape(name, "q_norms", q_norms, (b,))
    _build.require_shape(name, "c_norms", c_norms, (c,))
    out = torch.empty((b, c), dtype=torch.float32, device=q.device)
    fn = _build.load(name, "centroid_scan_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(centroids), _build.ptr(q_norms),
             _build.ptr(c_norms), _build.ptr(out), b, c, d,
             _build.stream(q.device))
    _build.check(name, err)
    centroid_scan.launches += 1
    return out


centroid_scan.launches = 0
