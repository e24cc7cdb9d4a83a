"""The immutable GoldenIndex store (IVF layout over the proxy space).

Counterpart of ``repro.index.store``.  Dataset rows are permuted into
cluster-sorted order so every cluster's rows are contiguous: a probed
window in ``ops.ivf_screen`` is then ``offsets[c] + arange(L)``.  Only
the proxy arrays are kept in sorted order; the engine maps candidate
positions through ``perm`` back to dataset ids before the exact
re-rank, so the [N, D] store is never duplicated.

``perm`` and ``offsets`` are int64 tensors (the by-index kernels take
int64 indices; the reference keeps int32).  They are converted once,
when an index is built, loaded or carried across, never per step, and
saved as int32 so that the file is the reference's.  ``max_cluster``
(the padded per-probe row count L) is a host ``int``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.index.build import kmeans
from repro_torch.utils import atomic, resolve_device

if TYPE_CHECKING:  # annotation only: repro_torch.core imports this package
    from repro_torch.core.dataset import DatasetStore


@dataclasses.dataclass(frozen=True)
class GoldenIndex:
    centroids: torch.Tensor           # [C, dp] fp32 window centers (proxy space)
    centroid_norms: torch.Tensor      # [C] ||c||^2 (fp32)
    perm: torch.Tensor                # [N] int64: sorted row r is dataset row perm[r]
    offsets: torch.Tensor             # [C+1] int64 CSR window boundaries
    proxy_sorted: torch.Tensor        # [N, dp] proxy rows in cluster-sorted order
    proxy_norms_sorted: torch.Tensor  # [N] ||proxy||^2, sorted (keeps +inf pads)
    max_cluster: int                  # L: largest window size (static pad width)

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def n(self) -> int:
        return self.perm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def to(self, device) -> "GoldenIndex":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(GoldenIndex)
                     if f.name != "max_cluster")


def default_num_clusters(n: int) -> int:
    """sqrt-N rule: C ~ sqrt(N) balances the centroid scan (O(C d)) with
    the probed-row term (O(nprobe * N/C * d))."""
    return int(np.clip(round(np.sqrt(n)), 4, n))


def build_index(store: "DatasetStore", num_clusters: int | None = None,
                generator: torch.Generator | None = None, iters: int = 25,
                balance: float = 1.5) -> GoldenIndex:
    """Cluster the proxy embedding and lay out the CSR index, on the
    store's device.

    Deterministic under a fixed ``generator`` (a ``torch.Generator`` of
    the store's device; default: one seeded 0).  ``balance`` caps the
    padded probe width: a cluster larger than ``ceil(balance * N / C)``
    is split into consecutive CSR windows that share its centroid, so
    probing pays ``nprobe * L`` for L near the mean cluster size.
    Windows of a split cluster tie on centroid distance."""
    n = store.n
    c = int(np.clip(num_clusters or default_num_clusters(n), 1, n))
    if generator is None:
        generator = torch.Generator(device=store.device).manual_seed(0)
    cents, assign = kmeans(generator, store.proxy, c, iters=iters)
    assign_np = assign.cpu().numpy()
    perm = np.argsort(assign_np, kind="stable")
    counts = np.bincount(assign_np, minlength=c)
    cents_np = cents.cpu().numpy()
    cap = max(1, int(np.ceil(balance * n / c)))
    # split oversized clusters into <= cap windows (duplicated centroids)
    win_cents, win_sizes = [], []
    for ci in range(c):
        size = int(counts[ci])
        pieces = max(1, -(-size // cap))
        base = size // pieces
        rem = size - base * pieces
        for p in range(pieces):
            win_cents.append(cents_np[ci])
            win_sizes.append(base + (1 if p < rem else 0))
    offsets = np.concatenate([[0], np.cumsum(win_sizes)])
    dev = store.device
    w_cents = torch.from_numpy(np.stack(win_cents)).to(dev)
    perm_t = torch.from_numpy(perm.astype(np.int64)).to(dev)
    return GoldenIndex(
        centroids=w_cents,
        centroid_norms=(w_cents * w_cents).sum(-1),
        perm=perm_t,
        offsets=torch.from_numpy(offsets.astype(np.int64)).to(dev),
        proxy_sorted=store.proxy[perm_t],
        # gathered, not recomputed: +inf markers on padded rows survive
        proxy_norms_sorted=store.proxy_norms[perm_t].float(),
        max_cluster=int(max(win_sizes)))


def index_from_numpy(centroids, centroid_norms, perm, offsets, proxy_sorted,
                     proxy_norms_sorted, max_cluster: int,
                     device=None) -> GoldenIndex:
    """An index from arrays computed elsewhere (e.g. a ``repro``
    ``GoldenIndex`` converted with ``np.asarray``), taken as they are;
    ``perm`` and ``offsets`` become int64 with their values unchanged.
    The index's counterpart of ``store_from_numpy``."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return GoldenIndex(
        centroids=t(centroids, np.float32),
        centroid_norms=t(centroid_norms, np.float32),
        perm=t(perm, np.int64), offsets=t(offsets, np.int64),
        proxy_sorted=t(proxy_sorted, np.float32),
        proxy_norms_sorted=t(proxy_norms_sorted, np.float32),
        max_cluster=int(max_cluster))


def screening_recall(pos, d2, perm, exact_ids) -> float:
    """recall@m of indexed screening vs exact screening (host-side).

    Fraction of the exact top-m candidate ids (``exact_ids`` [B, m])
    present among the selectable indexed candidates (positions ``pos``
    whose ``d2`` is finite; capacity padding must not count), mapped
    through ``perm`` to dataset ids (None: ``pos`` are dataset ids),
    averaged over the batch.  Takes
    tensors on any device or numpy arrays."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    pos, exact = host(pos), host(exact_ids)
    ids = pos if perm is None else host(perm)[pos]
    fin = np.isfinite(host(d2))
    m = exact.shape[1]
    return float(np.mean([
        len(set(ids[b][fin[b]]) & set(exact[b])) / m
        for b in range(exact.shape[0])]))


# -- persistence (atomic, versioned, checksummed) ----------------------------

INDEX_FORMAT = "golden-index"
INDEX_FORMAT_VERSION = 1


class StoreError(Exception):
    """Base class for golden-store persistence/lifecycle failures."""


class StoreCorruptionError(StoreError):
    """On-disk store bytes are damaged or internally inconsistent
    (truncation, bit-flip, torn write, broken CSR invariants)."""


class StoreVersionError(StoreError):
    """On-disk store was written by an incompatible format version."""


class StoreCapacityError(StoreError):
    """An append exceeded the capacity-padded layout (no free slot /
    no spare window left); a full rebuild is required to grow."""


def validate_index(fields: dict[str, np.ndarray], max_cluster: int) -> None:
    """Validate GoldenIndex array invariants; raise StoreCorruptionError.

    The semantic layer, after the manifest's checks: ranks, integer
    ``perm``/``offsets``, CSR well-formedness (offsets sorted, spanning
    exactly the sorted rows, no window wider than ``max_cluster``), and
    ``perm`` a bijection over the selectable (finite proxy-norm) rows."""
    cents = fields["centroids"]
    cnorm = fields["centroid_norms"]
    perm = fields["perm"]
    offsets = fields["offsets"]
    ps = fields["proxy_sorted"]
    pns = fields["proxy_norms_sorted"]

    def bad(msg: str):
        raise StoreCorruptionError(f"golden index invalid: {msg}")

    for name, arr, nd in (("centroids", cents, 2), ("centroid_norms",
                          cnorm, 1), ("perm", perm, 1), ("offsets",
                          offsets, 1), ("proxy_sorted", ps, 2),
                          ("proxy_norms_sorted", pns, 1)):
        if arr.ndim != nd:
            bad(f"{name} must be {nd}-D, got shape {arr.shape}")
    for name, arr in (("perm", perm), ("offsets", offsets)):
        if not np.issubdtype(arr.dtype, np.integer):
            bad(f"{name} must be an integer array, got {arr.dtype}")
    n = perm.shape[0]
    c = cents.shape[0]
    if cnorm.shape[0] != c:
        bad(f"centroid_norms has {cnorm.shape[0]} entries for "
            f"{c} centroids")
    if ps.shape != (n, cents.shape[1]):
        bad(f"proxy_sorted shape {ps.shape} != ({n}, {cents.shape[1]})")
    if pns.shape[0] != n:
        bad(f"proxy_norms_sorted has {pns.shape[0]} entries for {n} rows")
    if offsets.shape[0] != c + 1:
        bad(f"offsets has {offsets.shape[0]} entries for {c} windows "
            f"(want C+1 = {c + 1})")
    if n and (offsets[0] != 0 or offsets[-1] != n):
        bad(f"offsets must span [0, {n}], got "
            f"[{int(offsets[0])}, {int(offsets[-1])}]")
    sizes = np.diff(offsets.astype(np.int64))
    if (sizes < 0).any():
        w = int(np.argmax(sizes < 0))
        bad(f"offsets not sorted (window {w} has negative size "
            f"{int(sizes[w])})")
    if int(max_cluster) < (int(sizes.max()) if sizes.size else 0):
        bad(f"max_cluster {int(max_cluster)} < widest window "
            f"{int(sizes.max())}")
    if n and ((perm < 0).any() or (perm >= n).any()):
        bad(f"perm has out-of-range entries (valid range [0, {n}))")
    if np.isnan(cnorm).any() or np.isnan(pns).any():
        bad("NaN in centroid_norms / proxy_norms_sorted (norms must be "
            "finite, or +inf on padding slots)")
    real_ids = perm[np.isfinite(pns)]
    if real_ids.size != np.unique(real_ids).size:
        bad("perm is not a bijection: duplicate dataset ids among "
            "selectable rows")


def save_index(index: GoldenIndex, path: str) -> None:
    """Atomic, checksummed save: ``<path>`` (npz) + a JSON manifest
    sidecar ``<path>.manifest.json``, the reference's format (``perm``
    and ``offsets`` as int32)."""
    if index.n >= 2 ** 31:
        raise ValueError(f"index of {index.n} rows does not fit the int32 "
                         f"on-disk format")
    arrays = {f: getattr(index, f).cpu().numpy() for f in ARRAY_FIELDS}
    for f in ("perm", "offsets"):
        arrays[f] = arrays[f].astype(np.int32)
    atomic.save_arrays(path, arrays, fmt=INDEX_FORMAT,
                       version=INDEX_FORMAT_VERSION,
                       meta={"max_cluster": int(index.max_cluster)})


def load_index(path: str, device=None) -> GoldenIndex:
    """Validated load onto ``device`` (the CUDA card unless the caller
    passes another): manifest, version and checksum checks, then the
    CSR and permutation invariants, all before construction, so damage
    surfaces as :class:`StoreCorruptionError` /
    :class:`StoreVersionError`."""
    arrays, meta = atomic.load_arrays(
        path, fmt=INDEX_FORMAT, version=INDEX_FORMAT_VERSION,
        corruption_exc=StoreCorruptionError,
        version_exc=StoreVersionError)
    missing = sorted(set(ARRAY_FIELDS) - set(arrays))
    if missing:
        raise StoreCorruptionError(
            f"{path}: manifest is missing required index array(s): "
            f"{missing}")
    if "max_cluster" not in meta:
        raise StoreCorruptionError(f"{path}: manifest meta is missing "
                                   f"'max_cluster'")
    max_cluster = int(meta["max_cluster"])
    validate_index(arrays, max_cluster)
    return index_from_numpy(max_cluster=max_cluster, device=device,
                            **{f: arrays[f] for f in ARRAY_FIELDS})
