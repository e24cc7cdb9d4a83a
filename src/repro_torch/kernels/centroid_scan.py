"""Hand-written CUDA kernel 7: IVF level 1 in one launch.

Replaces ``repro/kernels/centroid_scan.py:65`` (``centroid_scan`` /
``_centroid_kernel``) and what runs around it on the indexed step: the
proxy pooling, the centroid distances, the stable top-nprobe windows
(``lax.top_k``'s order) and the CSR window expansion of ``ivf_screen``'s
capacity mode, with ``index.perm[pos]`` and the validity of each slot.
Kernel 7 was bound by its launch (a few hundred centroids at B=16), and
the chain around it was some 33 launches; ``csrc/centroid_scan.cu``
does it all in one, one thread block cluster of ``CLUSTER`` CTAs a
query, its intermediates in shared memory.

Two wrappers launch the one kernel, and both count into
``centroid_scan.launches``: ``ivf_probe`` (the indexed step) and
``centroid_scan`` (the distance stage alone, ``ops.centroid_scan``).
An engine with bf16 store rows (``storage_dtype``) probes with the
pooled query rounded to bf16 inside the launch (``round_bf16``), its
bf16 instance, counted in ``centroid_scan.launches_bf16``; the
centroids stay fp32 and capacity mode reads no proxy row.
The host plan is here: ``pool_geometry`` (how the query is pooled) and
``plan`` (windows a rank, threads a key, slots a rank, shared memory;
the window cap).  Their plain versions are
``ref.centroid_scan_ref`` and ``ref.ivf_probe_ref``; ``ops`` picks by
device.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import PROBE_FIELDS, Probe

CLUSTER = 8              # CTAs a query (csrc kCluster)
THREADS = 512            # threads a CTA (csrc kThreads)
MAX_WINDOWS = 16384      # every key in one CTA's shared memory
SMEM_BYTES = 232448      # what an H100 CTA may take (227 KB)

_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
         + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong]
         + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
         + [ctypes.c_void_p] * 7)


class Plan(NamedTuple):
    rows: int     # windows a rank owns (distances and places)
    group: int    # threads that count one key's place
    chunk: int    # candidate slots a rank writes
    smem: int     # dynamic shared memory a CTA, bytes


def pool_geometry(image_shape, factor: int) -> tuple[int, int, int, int]:
    """``(W, Ch, f, dp)`` of ``downsample_proxy`` on a query of this
    store: ``f = 0`` for the identity (non-image stores).  Raises
    ``ValueError`` where that proxy is not a [B, dp] row per query: image
    shapes other than (H, W, C), or spatial dims below the factor."""
    shape = tuple(int(s) for s in image_shape)
    if len(shape) == 1:
        return 1, 1, 0, shape[0]
    if len(shape) != 3:
        raise ValueError(f"ivf_probe: image shape {shape} is neither (D,) "
                         f"nor (H, W, C)")
    h, w, c = shape
    if factor < 1 or h < factor or w < factor:
        raise ValueError(f"ivf_probe: image shape {shape} does not pool by "
                         f"{factor} into a flat proxy")
    return w, c, factor, (h // factor) * (w // factor) * c


def plan(c: int, dp: int, p: int, l: int) -> Plan:
    """The launch's host plan for C windows of width dp, P probes of L
    rows (P = 0: the distance stage alone).  Raises ``ValueError`` above
    ``MAX_WINDOWS`` windows (P > 0), for P > C, or when the query and
    the keys pass a CTA's shared memory."""
    if p > 0 and c > MAX_WINDOWS:
        raise ValueError(f"ivf_probe: {c} windows > the cap of "
                         f"{MAX_WINDOWS} (every key in one CTA's shared "
                         f"memory)")
    if p > c:
        raise ValueError(f"ivf_probe: nprobe_max {p} > {c} windows")
    rows = -(-c // CLUSTER)
    group = 1 << int(math.log2(max(1, min(32, THREADS // rows))))
    smem = 4 * (dp + (dp & 1)) + (8 * c + 4 * p if p else 0)
    if smem > SMEM_BYTES:
        raise ValueError(f"ivf_probe: {smem} bytes of shared memory a CTA "
                         f"(d={dp}, C={c}, P={p}) > {SMEM_BYTES}")
    return Plan(rows, group, -(-p * l // CLUSTER), smem)


def _nprobe_arg(nprobe, p: int, device: torch.device):
    """(pointer, value): a 0-d integer tensor on the card is read by the
    kernel (no host sync); an int or None is passed by value."""
    if nprobe is None:
        return None, p
    if isinstance(nprobe, torch.Tensor):
        if nprobe.dtype.is_floating_point or nprobe.dtype == torch.bool:
            raise ValueError(f"ivf_probe: nprobe must be an integer, got "
                             f"{nprobe.dtype}")
        if nprobe.numel() != 1 or nprobe.device != device:
            raise ValueError(f"ivf_probe: nprobe must be one integer on "
                             f"{device}, got {tuple(nprobe.shape)} on "
                             f"{nprobe.device}")
        return nprobe.reshape(()).to(torch.int64), 0
    return None, int(nprobe)


def _launch(q, geometry, centroids, c_norms, plan_, p: int, l: int,
            offsets=None, perm=None, n: int = 0, nprobe=None,
            out=None, round_bf16: bool = False) -> None:
    w, ch, f, dp = geometry
    b, d = q.shape
    c = centroids.shape[0]
    out = out or {}
    nptr, nval = _nprobe_arg(nprobe, p, q.device)
    fn = _build.load("centroid_scan", "ivf_probe_launch", _ARGS)

    def ptr(t):
        return None if t is None else _build.ptr(t)

    err = fn(_build.ptr(q), b, d, w, ch, f, dp, _build.ptr(centroids),
             _build.ptr(c_norms), c, ptr(offsets), ptr(perm),
             n, p, l, ptr(nptr), nval, int(round_bf16),
             plan_.rows, plan_.group, plan_.chunk, plan_.smem,
             ptr(out.get("d2")), ptr(out.get("probe")), ptr(out.get("pos")),
             ptr(out.get("ids")), ptr(out.get("valid")),
             ptr(out.get("marker")), _build.stream(q.device))
    _build.check("centroid_scan", err)
    _build.count(centroid_scan, round_bf16)


def centroid_scan(q: torch.Tensor, centroids: torch.Tensor,
                  c_norms: torch.Tensor) -> torch.Tensor:
    """||q_i - c_j||^2 for q: [B, d], centroids: [C, d], norms [C] (fp32,
    CUDA, contiguous) -> [B, C] fp32; the query norms are summed in the
    kernel."""
    name = "centroid_scan"
    _build.require(name, q.device, q=q, centroids=centroids, c_norms=c_norms)
    _build.require_dtype(name, torch.float32, q=q, centroids=centroids,
                         c_norms=c_norms)
    b, d = q.shape
    c = centroids.shape[0]
    _build.require_shape(name, "centroids", centroids, (c, d))
    _build.require_shape(name, "c_norms", c_norms, (c,))
    out = torch.empty((b, c), dtype=torch.float32, device=q.device)
    _launch(q, (1, 1, 0, d), centroids, c_norms, plan(c, d, 0, 0), 0, 0,
            out={"d2": out})
    return out


centroid_scan.launches = 0
centroid_scan.launches_bf16 = 0


def ivf_probe(q: torch.Tensor, image_shape, factor: int,
              centroids: torch.Tensor, c_norms: torch.Tensor,
              offsets: torch.Tensor, perm: torch.Tensor | None, n: int,
              nprobe_max: int, max_cluster: int, nprobe=None,
              fields=PROBE_FIELDS, round_bf16: bool = False) -> Probe:
    """IVF level 1 of rescaled queries q [B, D] (fp32, CUDA): pooled by
    ``pool_geometry(image_shape, factor)`` (and rounded to bf16 when
    ``round_bf16``, its norm from the rounded values), the ``nprobe_max``
    nearest windows, and their ``max_cluster`` slots each over an index
    of ``n`` rows.  Writes only ``fields`` (of ``PROBE_FIELDS``; the others come
    back None); ``perm`` is needed for "ids" only.  ``nprobe`` (int or
    0-d integer tensor on the card) masks the probes beyond it."""
    name = "centroid_scan"
    geometry = pool_geometry(image_shape, factor)
    c, dp = centroids.shape
    p, l = int(nprobe_max), int(max_cluster)
    if p < 1 or l < 1:
        raise ValueError(f"ivf_probe: nprobe_max {p} and max_cluster {l} "
                         f"must be positive")
    plan_ = plan(c, dp, p, l)
    unknown = set(fields) - set(PROBE_FIELDS)
    if unknown:
        raise ValueError(f"ivf_probe: unknown fields {sorted(unknown)}")
    if "ids" in fields and perm is None:
        raise ValueError("ivf_probe: 'ids' needs perm")
    tensors = dict(q=q, centroids=centroids, c_norms=c_norms, offsets=offsets)
    if perm is not None:
        tensors["perm"] = perm
    _build.require(name, q.device, **tensors)
    _build.require_dtype(name, torch.float32, q=q, centroids=centroids,
                         c_norms=c_norms)
    _build.require_dtype(name, torch.int64, offsets=offsets,
                         **({} if perm is None else {"perm": perm}))
    b, d = q.shape
    if d != math.prod(image_shape) or geometry[3] != dp:
        raise ValueError(f"ivf_probe: queries [{b}, {d}] of image shape "
                         f"{tuple(image_shape)} do not pool to the "
                         f"centroids' width {dp}")
    _build.require_shape(name, "c_norms", c_norms, (c,))
    _build.require_shape(name, "offsets", offsets, (c + 1,))
    dev = q.device
    shapes = {"probe": ((b, p), torch.int64),
              "pos": ((b, p * l), torch.int64),
              "ids": ((b, p * l), torch.int64),
              "valid": ((b, p * l), torch.bool),
              "marker": ((b, p * l), torch.float32)}
    out = {k: torch.empty(s, dtype=t, device=dev)
           for k, (s, t) in shapes.items() if k in fields}
    _launch(q, geometry, centroids, c_norms, plan_, p, l, offsets, perm, n,
            nprobe, out, round_bf16)
    return Probe(**{k: out.get(k) for k in PROBE_FIELDS})
