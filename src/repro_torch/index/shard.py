"""Per-shard layout of the golden store (and its index) over a mesh axis.

Counterpart of ``repro.index.shard``.  The sharded engine partitions one
dataset (and, when indexed, one global ``GoldenIndex``) across the
shards of a mesh axis, so sharded screening is an equality-preserving
re-layout of the single-device pipeline:

* exact mode (no index): rows are chunked contiguously in dataset
  order; the padded tail rows carry +inf norms and id 0, so they are
  never screened in;
* indexed mode: the index's cluster-sorted rows are cut at CSR window
  boundaries (:func:`partition_windows`), balanced by row count.  Shard
  s holds the window ids ``wrange = [w_lo, w_hi)``, those windows' rows
  (proxy and store rows, cluster-sorted) and the window offsets rebased
  to its own rows; the centroid table is replicated, so every shard runs
  the same global probe selection and a probed window belongs to one
  shard.

The layout is built on the host with numpy, as the reference builds it
(every array equal to the reference's for the same store, index and
S), for the shards this process holds (``mesh.local_shards``: every
shard of a ``LocalMesh``, the rank's own of a ``ProcessMesh``), stacked
on a leading axis of those shards, then moved: to the held shards' one
device as one stacked tensor each, whose slices ``slabs[i]`` are views
at fixed addresses (a captured CUDA graph can bake them); or, with
shards on several devices, a copy of each slab on its own device.  So a
rank of a ``ProcessMesh`` builds and moves only its slab, N / S rows;
the centroid table is replicated.
``ids`` maps shard-local rows back to dataset ids, which is how
``select()`` keeps returning dataset rows.  The way back is
:func:`slab_slots` (a dataset id's row in a slab, -1 where the slab
does not hold it), and :func:`gather_support` assembles per-query
support rows [b, k, ...] that the shards hold between them, each rank
writing the slots it owns, with one sum over the shard axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ShardSlab(NamedTuple):
    """One shard's arrays on its device (index fields None when exact):
    ``w_lo`` / ``w_hi`` are 0-d tensors, so a captured step reads them
    on the device."""
    X: torch.Tensor
    x_norms: torch.Tensor
    proxy: torch.Tensor
    proxy_norms: torch.Tensor
    ids: torch.Tensor
    offsets: torch.Tensor | None
    w_lo: torch.Tensor | None
    w_hi: torch.Tensor | None
    centroids: torch.Tensor | None
    centroid_norms: torch.Tensor | None
    n_rows: int = 0               # real rows (the rest is padding)


class ShardedLayout(NamedTuple):
    """The stacked per-shard golden store (+ optional index routing)."""

    # stacked over the shards held (S of a LocalMesh, a rank's 1)
    X: torch.Tensor               # [S, n_loc, D] rows (sorted if indexed)
    x_norms: torch.Tensor         # [S, n_loc] fp32 (+inf on padding)
    proxy: torch.Tensor           # [S, n_loc, dp]
    proxy_norms: torch.Tensor     # [S, n_loc] fp32 (+inf on padding)
    ids: torch.Tensor             # [S, n_loc] int64 dataset ids (0 on pad)
    offsets: torch.Tensor | None  # [S, W + 1] int64 local window offsets
    wrange: torch.Tensor | None   # [S, 2] int64 owned windows [w_lo, w_hi)
    centroids: torch.Tensor | None        # [C, dp] replicated
    centroid_norms: torch.Tensor | None   # [C] replicated
    n_loc: int                    # rows a shard (padded)
    w_max: int                    # most windows any shard owns
    max_cluster: int              # L: padded rows a window
    n_shards: int
    slabs: tuple                  # ShardSlab per shard this process holds

    @property
    def indexed(self) -> bool:
        return self.offsets is not None


def partition_windows(offsets: np.ndarray, n_shards: int) -> np.ndarray:
    """Cut points (window ids, length S + 1) balancing rows per shard:
    shard s takes the windows up to the first boundary at or past
    ``(s + 1) / S`` of the rows.  Monotone; shards past the last window
    come out empty when there are fewer windows than shards."""
    offsets = np.asarray(offsets)
    n = int(offsets[-1])
    cuts = [0]
    for s in range(1, n_shards):
        target = round(n * s / n_shards)
        w = int(np.searchsorted(offsets, target, side="left"))
        cuts.append(int(np.clip(w, cuts[-1], len(offsets) - 1)))
    cuts.append(len(offsets) - 1)
    return np.asarray(cuts, np.int64)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# the attribute naming the epoch-file array a host tensor maps
_STORED = "_stored_array"


def file_backed(stored) -> torch.Tensor:
    """A host tensor over a copy-on-write mapping of ``stored`` (a
    ``utils.atomic.StoredArray``: an array of an epoch file, in place)
    that remembers where it lies, so that :func:`host_rows` reads the
    rows it is asked for with positioned reads and leaves the mapping
    untouched.  Any other reader sees an ordinary tensor whose pages
    are read when touched."""
    t = torch.from_numpy(stored.map())
    setattr(t, _STORED, stored)
    return t


def host_rows(a, rows, out: np.ndarray | None = None, dst=None
              ) -> np.ndarray:
    """Rows ``rows`` of ``a`` (a tensor on any device, or an array) as
    numpy, or into ``out`` (at ``dst`` when given, as
    ``StoredArray.read_rows``).  A :func:`file_backed` tensor's rows are
    read from its file by positioned reads (sorted, coalesced into runs
    of consecutive ids), not through its mapping: a kernel's fault-around
    maps up to 64 KiB of cached neighbours for each page a scattered
    gather through the mapping touches, and those pages stay resident
    while the mapping lives, so the reader would hold several times the
    rows it read (and ``RssFile`` would say so).  Resident bytes then
    grow by ``out`` alone."""
    stored = getattr(a, _STORED, None)
    rows = np.asarray(rows, np.int64).reshape(-1)
    if stored is not None:
        return stored.read_rows(rows, out, dst)
    if isinstance(a, torch.Tensor):
        got = a[torch.as_tensor(rows, device=a.device)].cpu().numpy()
    else:
        got = np.asarray(a)[rows]
    if out is None:
        return got
    out[np.arange(rows.size) if dst is None else dst] = got
    return out


def _layout_arrays(store, n_shards: int, index=None, held=None) -> dict:
    """The layout's stacked arrays as numpy for the shards ``held`` (all
    by default), each built as the reference's ``shard_layout`` builds
    it, and the layout's sizes.  Only the held shards' rows are read
    (:func:`host_rows`: from the epoch file where the store maps one).
    An empty slot of a capacity-padded index's window (+inf
    ``proxy_norms_sorted`` where ``perm`` names a real row, row 0 by
    the layout's convention) is laid out as padding: zero rows, +inf
    norms, id 0, so that it is never screened in and its row is not
    read (the reference's layout copies row 0 there, which a probe of
    that window then ranks as a second copy of row 0)."""
    held = list(range(n_shards)) if held is None else list(held)
    n = store.n
    xn = _host(store.x_norms).astype(np.float32)
    pn = _host(store.proxy_norms).astype(np.float32)
    if index is None:
        order = np.arange(n)
        n_loc = -(-n // n_shards)
        row_cuts = np.minimum(np.arange(n_shards + 1) * n_loc, n)
        w_max = 0
        offs = wrange = None
        empty = None
    else:
        if index.n != n:
            raise ValueError(f"index built for N={index.n}, store N={n}")
        order = _host(index.perm).astype(np.int64)
        offsets = _host(index.offsets).astype(np.int64)
        cuts = partition_windows(offsets, n_shards)
        row_cuts = offsets[cuts]
        w_max = int(np.max(np.diff(cuts)))
        n_loc = int(np.max(np.diff(row_cuts)))
        parts = []
        for s in held:
            o = offsets[cuts[s]: cuts[s + 1] + 1] - offsets[cuts[s]]
            parts.append(np.pad(o, (0, w_max + 1 - len(o)),
                                mode="edge" if len(o) else "constant"))
        offs = np.stack(parts).astype(np.int64)
        wrange = np.stack([cuts[:-1], cuts[1:]],
                          axis=1)[held].astype(np.int64)
        empty = (~np.isfinite(_host(index.proxy_norms_sorted))
                 & np.isfinite(pn[order]))
    ids = np.zeros((len(held), n_loc), np.int64)
    keep = []
    for i, s in enumerate(held):
        span = np.arange(row_cuts[s], row_cuts[s + 1])
        at = (np.arange(span.size) if empty is None
              else np.flatnonzero(~empty[span]))
        ids[i, at] = order[span[at]]
        keep.append(at)

    def stack_rows(a, fill=0.0):
        width = tuple(a.shape[1:])
        out = np.full((len(held), n_loc) + width, fill,
                      a.dtype if isinstance(a, np.ndarray)
                      else _host(a[:0]).dtype)
        for i, at in enumerate(keep):
            host_rows(a, ids[i, at], out[i], at)
        return out

    return dict(X=stack_rows(store.X), x_norms=stack_rows(xn, fill=np.inf),
                proxy=stack_rows(store.proxy),
                proxy_norms=stack_rows(pn, fill=np.inf), ids=ids,
                offsets=offs, wrange=wrange, n_loc=int(n_loc), w_max=w_max,
                n_rows=[int(row_cuts[s + 1] - row_cuts[s]) for s in held])


def shard_layout(store, mesh, axis: str = "data", index=None,
                 storage_dtype=None, device=None) -> ShardedLayout:
    """Build the per-shard layout of ``store`` (and ``index``) over
    ``axis`` of ``mesh`` (a ``LocalMesh`` or ``ProcessMesh``) for the
    shards this process holds, on the host.  ``device`` is the shards'
    default device (the store's unless given); ``storage_dtype`` (None
    or ``torch.bfloat16``) is the rows' dtype, the norms staying fp32."""
    n_sh = int(mesh.shape[axis])
    held = mesh.local_shards(axis)
    arr = _layout_arrays(store, n_sh, index, held)
    devs = mesh.shard_devices(axis, store.device if device is None
                              else device)
    one = len({devs[s] for s in held}) == 1
    home = devs[held[0]] if one else torch.device("cpu")
    rows_dt = storage_dtype or torch.float32

    def put(a, dtype=None):
        return None if a is None else torch.as_tensor(a).to(home, dtype)

    L = dict(X=put(arr["X"], rows_dt), x_norms=put(arr["x_norms"]),
             proxy=put(arr["proxy"], rows_dt),
             proxy_norms=put(arr["proxy_norms"]), ids=put(arr["ids"]),
             offsets=put(arr["offsets"]), wrange=put(arr["wrange"]),
             centroids=None if index is None
             else index.centroids.to(home, torch.float32),
             centroid_norms=None if index is None
             else index.centroid_norms.to(home, torch.float32))
    slabs = []
    for i, s in enumerate(held):
        dev = devs[s]
        take = (lambda t: None if t is None else
                (t[i] if one else t[i].to(dev).contiguous()))
        rep = (lambda t: None if t is None else
               (t if one else t.to(dev)))
        wr = take(L["wrange"])
        slabs.append(ShardSlab(
            X=take(L["X"]), x_norms=take(L["x_norms"]),
            proxy=take(L["proxy"]), proxy_norms=take(L["proxy_norms"]),
            ids=take(L["ids"]), offsets=take(L["offsets"]),
            w_lo=None if wr is None else wr[0],
            w_hi=None if wr is None else wr[1],
            centroids=rep(L["centroids"]),
            centroid_norms=rep(L["centroid_norms"]),
            n_rows=arr["n_rows"][i]))
    return ShardedLayout(**L, n_loc=arr["n_loc"], w_max=arr["w_max"],
                         max_cluster=0 if index is None
                         else int(index.max_cluster),
                         n_shards=n_sh, slabs=tuple(slabs))


def slab_slots(slab: ShardSlab, n: int) -> torch.Tensor:
    """[n] int32 on the slab's device: the slab row holding each
    dataset id, -1 for the ids the slab does not hold (its padding rows,
    and any row of +inf norm, map nothing: an empty slot of a
    capacity-padded window holds no row)."""
    dev = slab.ids.device
    slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
    at = torch.nonzero(torch.isfinite(slab.x_norms[: slab.n_rows]))[:, 0]
    slots[slab.ids[at]] = at.to(torch.int32)
    return slots


def gather_support(values, idx: torch.Tensor, slots: torch.Tensor, mesh
                   ) -> list[torch.Tensor]:
    """The rows of dataset ids ``idx`` [b, k] of each of ``values``
    (tensors [n_loc, ...] of this rank's slab rows, one leading row a
    slab row), assembled over the shard axis: every rank writes the
    slots whose rows it holds (``slots`` from :func:`slab_slots`) into a
    zero [b, k, ...] buffer and one ``mesh.psum`` (a ``ProcessMesh``)
    sums them, which is exact, since every slot has one owner and the
    other ranks add zeros.  The values share one buffer, so one
    collective serves them all; returns their [b, k, ...] rows, in the
    order given."""
    s = slots[idx]                                       # [b, k]
    own = (s >= 0)[..., None]
    rows = s.clamp_min(0).long()
    flat = [v[rows].reshape(idx.shape + (-1,)) for v in values]
    widths = [f.shape[-1] for f in flat]
    buf = torch.where(own, torch.cat(flat, -1), 0.0)
    buf = mesh.psum([buf])
    return [p.reshape(idx.shape + tuple(v.shape[1:]))
            for p, v in zip(buf.split(widths, -1), values)]


__all__ = ["ShardedLayout", "ShardSlab", "partition_windows",
           "shard_layout", "slab_slots", "gather_support", "file_backed",
           "host_rows"]
