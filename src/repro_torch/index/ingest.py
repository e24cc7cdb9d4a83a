"""Durable, appendable golden-store lifecycle (epochs + journal).

Counterpart of ``repro.index.ingest``; the on-disk format is the
reference's byte for byte (epoch directories, the ``CURRENT`` pointer,
the framed CRC'd journal, the ``utils.atomic`` manifests), so a store
written by either package opens in the other.

Capacity-padded layout
    Every CSR window gets a uniform capacity ``L_cap = ceil(slack *
    max_cluster)`` and a pool of *spare* windows is added; ``offsets``
    is the constant ``arange(W+1) * L_cap``.  Empty slots carry ``+inf``
    proxy/row norms (+inf distance: never screened in, zero weight) and
    spare windows ``+inf`` centroid norms, so probes rank them last.
    Appends fill slots in place: shapes, ``n``, ``max_cluster`` and
    ``num_clusters`` never change, so a running engine's programs (on
    the card its captured graphs) serve every later epoch.

Occupancy-triggered local re-clustering
    A row landing in a full window re-clusters that window alone: a
    deterministic 2-means splits its rows between it and one spare.
    With no spare left the row goes to the nearest window with a free
    slot; the layout is exhausted only when every slot is full
    (:class:`~repro_torch.index.store.StoreCapacityError`).

Durability: epoch directories + an append journal
    ``append()`` journals the raw rows (base epoch, sequence number,
    CRC) with an fsync before it touches memory; ``commit()`` writes a
    new epoch directory, flips ``CURRENT`` atomically (the commit
    point), then truncates the journal.  ``open()`` loads the CURRENT
    epoch (validated) and replays the journal's valid prefix, skipping
    frames of other epochs or out of sequence, so recovery is idempotent
    across every crash window.  Replay is numpy only, with no RNG and no
    device, so a recovered store is bit-identical to the state before
    the crash.

All mutable state is host numpy.  ``view(device)`` copies it to a device
as an ordinary ``(DatasetStore, GoldenIndex)`` pair (never a zero-copy
alias of the live buffers, which a later append would mutate); the
serving runtime installs views as engine epochs
(``ServeRuntime.hot_swap``).

Over ranks (``open_slab``) a committed epoch is opened in place: its
small arrays are read, its row arrays stay in the file (uncompressed npz
members, mapped and read by position), and each rank of a
``ProcessMesh`` reads its slab's rows alone.  The reference cuts one
host copy in its one process; one process a card would otherwise hold
the store once a rank.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.index.store import (GoldenIndex, StoreCapacityError,
                                     StoreCorruptionError, StoreError,
                                     StoreVersionError, index_from_numpy,
                                     validate_index)
from repro_torch.utils import atomic, resolve_device

if TYPE_CHECKING:  # annotation only: repro_torch.core imports this package
    from repro_torch.core.dataset import DatasetStore

EPOCH_FORMAT = "golden-store-epoch"
EPOCH_FORMAT_VERSION = 1

CURRENT_FILE = "CURRENT"
JOURNAL_FILE = "journal.bin"
JOURNAL_MAGIC = b"GJRNL001"
FRAME_MAGIC = b"FRME"
# frame header: magic, base_epoch, seq, n_rows, dim, payload crc32
_FRAME_HDR = struct.Struct("<4sQQIII")

_ARRAYS = ("X", "proxy", "x_norms", "proxy_norms", "proxy_sorted",
           "proxy_norms_sorted", "perm", "offsets", "centroids",
           "centroid_norms", "sizes")


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Capacity-padding knobs (fixed at ``create`` time, persisted)."""

    slack: float = 1.5       # window capacity = ceil(slack * max_cluster)
    spare_frac: float = 0.125  # spare windows as a fraction of base windows
    recluster_iters: int = 8   # Lloyd iterations of the local 2-means


def _epoch_name(epoch: int) -> str:
    return f"epoch_{int(epoch):08d}"


def downsample_proxy_np(x_img: np.ndarray, factor: int = 4) -> np.ndarray:
    """The paper's proxy in numpy: the spatially average-pooled image,
    flattened (``core.dataset.downsample_proxy``'s rule: the identity
    for non-image data, ndim < 3 trailing dims, or tiny spatial dims).
    It agrees with the torch pooling to fp32 rounding (the mean's
    summation order may differ)."""
    if x_img.ndim < 3 or x_img.shape[-2] < factor or x_img.shape[-3] < factor:
        return (x_img.reshape(x_img.shape[: x_img.ndim - 1] + (-1,))
                if x_img.ndim >= 2 else x_img)
    h, w, c = x_img.shape[-3:]
    hh, ww = h // factor, w // factor
    lead = x_img.shape[:-3]
    v = x_img[..., : hh * factor, : ww * factor, :]
    v = v.reshape(lead + (hh, factor, ww, factor, c)).mean(axis=(-4, -2))
    return v.reshape(lead + (hh * ww * c,))


def _proxy_rows(rows: np.ndarray, image_shape: tuple,
                proxy_factor: int) -> np.ndarray:
    """Numpy proxy embedding of flattened rows (``downsample_proxy_np``;
    numpy only, so journal replay never depends on device state)."""
    img = rows.reshape((rows.shape[0],) + tuple(image_shape))
    return np.asarray(downsample_proxy_np(img, proxy_factor),
                      np.float32).reshape(rows.shape[0], -1)


class StoreLifecycle:
    """Appendable, crash-safe golden store rooted at a directory.

    Construct with :meth:`create` (from an immutable store + index) or
    :meth:`open` (recover from disk).  All mutable state is host numpy;
    :meth:`view` copies it to a device for the engine.
    """

    def __init__(self, root: str, arrays: dict[str, np.ndarray],
                 meta: dict, epoch: int,
                 quarantined: list[tuple[str, str]] | None = None):
        self.root = os.fspath(root)
        self._X = arrays["X"]
        self._proxy = arrays["proxy"]
        self._xn = arrays["x_norms"]
        self._pn = arrays["proxy_norms"]
        self._ps = arrays["proxy_sorted"]
        self._pns = arrays["proxy_norms_sorted"]
        self._perm = arrays["perm"]
        self._offsets = arrays["offsets"]
        self._cent = arrays["centroids"]
        self._cnorm = arrays["centroid_norms"]
        self._sizes = arrays["sizes"]
        self.image_shape = tuple(meta["image_shape"])
        self.proxy_factor = int(meta["proxy_factor"])
        self.capacity = int(meta["capacity"])          # L_cap per window
        self.recluster_iters = int(meta.get("recluster_iters", 8))
        self._n_rows = int(meta["n_rows"])
        self._seq = int(meta["seq"])                   # next frame seq
        self._epoch = int(epoch)                       # durable epoch id
        self._epoch_seq = self._seq
        self._epoch_n_rows = self._n_rows
        self.quarantined = list(quarantined or [])
        self.replayed_frames = 0

    # -- derived geometry ----------------------------------------------------
    @property
    def num_windows(self) -> int:
        return self._cent.shape[0]

    @property
    def n_capacity(self) -> int:
        return self._perm.shape[0]

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def epoch(self) -> int:
        """Last *durable* epoch id (what a crash recovers to, modulo
        the journal)."""
        return self._epoch

    @property
    def pending_rows(self) -> int:
        """Rows appended (journaled) since the last durable epoch."""
        return self._n_rows - self._epoch_n_rows

    @property
    def dim(self) -> int:
        return self._X.shape[1]

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, root: str, store: "DatasetStore", index: GoldenIndex,
               config: IngestConfig | None = None,
               proxy_factor: int = 4) -> "StoreLifecycle":
        """Lay out a capacity-padded copy of ``(store, index)`` (tensors
        on any device, or numpy arrays) under ``root`` and commit it as
        epoch 0."""
        cfg = config or IngestConfig()
        if store.labels is not None:
            raise ValueError("StoreLifecycle does not carry labels yet "
                             "(conditional stores are a follow-on)")
        if index.n != store.n:
            raise ValueError(f"index built for N={index.n}, store has "
                             f"N={store.n}")
        n, d = store.n, store.dim
        dp = index.centroids.shape[1]
        w_base = index.num_clusters
        l_cap = max(2, int(np.ceil(cfg.slack * index.max_cluster)))
        w_spare = max(1, int(np.ceil(cfg.spare_frac * w_base)))
        w = w_base + w_spare
        n_cap = w * l_cap
        if n > n_cap:                    # cannot happen with slack >= 1
            raise StoreCapacityError(f"capacity {n_cap} < existing rows "
                                     f"{n}")
        arr = {
            "X": np.zeros((n_cap, d), np.float32),
            "proxy": np.zeros((n_cap, dp), np.float32),
            "x_norms": np.full(n_cap, np.inf, np.float32),
            "proxy_norms": np.full(n_cap, np.inf, np.float32),
            "proxy_sorted": np.zeros((n_cap, dp), np.float32),
            "proxy_norms_sorted": np.full(n_cap, np.inf, np.float32),
            "perm": np.zeros(n_cap, np.int32),
            "offsets": (np.arange(w + 1, dtype=np.int64)
                        * l_cap).astype(np.int32),
            "centroids": np.zeros((w, dp), np.float32),
            "centroid_norms": np.full(w, np.inf, np.float32),
            "sizes": np.zeros(w, np.int32),
        }
        arr["X"][:n] = _host(store.X, np.float32)
        arr["proxy"][:n] = _host(store.proxy, np.float32)
        arr["x_norms"][:n] = _host(store.x_norms, np.float32)
        arr["proxy_norms"][:n] = _host(store.proxy_norms, np.float32)
        arr["centroids"][:w_base] = _host(index.centroids, np.float32)
        arr["centroid_norms"][:w_base] = _host(index.centroid_norms,
                                               np.float32)
        off = _host(index.offsets, np.int64)
        perm = _host(index.perm, np.int32)
        ps = _host(index.proxy_sorted, np.float32)
        pns = _host(index.proxy_norms_sorted, np.float32)
        for wi in range(w_base):
            size = int(off[wi + 1] - off[wi])
            dst = wi * l_cap
            arr["proxy_sorted"][dst:dst + size] = ps[off[wi]:off[wi + 1]]
            arr["proxy_norms_sorted"][dst:dst + size] = \
                pns[off[wi]:off[wi + 1]]
            arr["perm"][dst:dst + size] = perm[off[wi]:off[wi + 1]]
            arr["sizes"][wi] = size
        meta = {"image_shape": list(store.image_shape),
                "proxy_factor": int(proxy_factor),
                "capacity": l_cap,
                "recluster_iters": int(cfg.recluster_iters),
                "n_rows": n, "seq": 0}
        os.makedirs(root, exist_ok=True)
        lc = cls(root, arr, meta, epoch=0)
        lc._write_epoch(0)
        atomic.atomic_write_text(os.path.join(root, CURRENT_FILE),
                                 _epoch_name(0) + "\n")
        lc._reset_journal()
        return lc

    @classmethod
    def open(cls, root: str, fallback: bool = True) -> "StoreLifecycle":
        """Recover from disk: load the CURRENT epoch (validated), then
        replay the journal's valid prefix.

        ``fallback=True`` quarantines a damaged CURRENT epoch and walks
        back to the newest loadable one (recorded in ``quarantined``);
        with no survivor — or with ``fallback=False`` — the typed
        load error propagates.
        """
        root = os.fspath(root)
        candidates = _candidates(root, fallback)
        quarantined: list[tuple[str, str]] = []
        last_err: StoreError | None = None
        for name in candidates:
            try:
                lc = cls._load_epoch(root, name, quarantined)
                lc._replay_journal()
                return lc
            except (StoreCorruptionError, StoreVersionError) as e:
                quarantined.append((name, str(e)))
                last_err = e
        raise last_err if last_err is not None else \
            StoreError(f"{root}: no loadable epoch")

    @classmethod
    def _load_epoch(cls, root: str, name: str,
                    quarantined: list) -> "StoreLifecycle":
        npz, epoch = _epoch_npz(root, name)
        arrays, meta = atomic.load_arrays(
            npz, fmt=EPOCH_FORMAT, version=EPOCH_FORMAT_VERSION,
            corruption_exc=StoreCorruptionError,
            version_exc=StoreVersionError)
        _validate_epoch(npz, arrays, meta)
        return cls(root, arrays, meta, epoch=epoch,
                   quarantined=list(quarantined))

    @classmethod
    def open_slab(cls, root: str, mesh, fallback: bool = True
                  ) -> "SlabEpoch":
        """The epoch :meth:`open` would choose, opened on every rank of
        ``mesh`` (a ``ProcessMesh``) without reading its rows: a host
        ``(DatasetStore, GoldenIndex)`` whose small arrays (norms,
        ``perm``, ``offsets``, centroids, ``sizes``) are read whole and
        whose row arrays (``X``, ``proxy``, ``proxy_sorted``; ``[n_cap,
        .]``, so ``store.n``, ``store.dim`` and ``index.max_cluster`` are
        the epoch's) are tensors over the epoch file
        (``index.shard.file_backed``).  Given to ``GoldDiffEngine``,
        ``GoldDiff`` or ``ServeEngine`` with ``mesh=``, the rank reads
        its slab's rows alone (the slab of the engine's shard axis), by
        positioned reads, so that it holds its slab (on its device), the small
        arrays and nothing else of the rows.

        Every rank validates the small arrays as :meth:`open` does; the
        host channel's first rank also streams the row arrays' sha256
        (one fixed buffer) and reads the journal.  Its verdict, or the
        typed error's message, goes to every rank over
        ``mesh.host_broadcast``, so every rank returns the same epoch
        (``fallback`` walks back past damaged ones, listed in the
        result's ``quarantined``), or raises the same
        ``StoreCorruptionError`` / ``StoreVersionError``.  Journaled
        appends that :meth:`open` would replay raise ``StoreError`` on
        every rank: fold them into an epoch with :meth:`commit` first
        (a journal is replayed on the whole store, never by slab).
        Nothing is written: a torn journal tail stays for :meth:`open`
        to truncate."""
        from repro_torch.core.dataset import DatasetStore
        from repro_torch.index.shard import file_backed
        root = os.fspath(root)
        first = mesh.host_rank == 0
        listing = None
        if first:
            try:
                listing = ("ok", _candidates(root, fallback))
            except StoreError as e:
                listing = (type(e).__name__, str(e))
        kind, got = mesh.host_broadcast(listing)
        if kind != "ok":
            raise _ERRORS[kind](got)
        quarantined: list[tuple[str, str]] = []
        last = None
        for name in got:
            mine = None
            try:
                npz, epoch = _epoch_npz(root, name)
                arrays, meta = atomic.load_arrays(
                    npz, fmt=EPOCH_FORMAT, version=EPOCH_FORMAT_VERSION,
                    in_place=_ROW_ARRAYS, verify=first,
                    corruption_exc=StoreCorruptionError,
                    version_exc=StoreVersionError)
                _validate_epoch(npz, arrays, meta)
                if first:
                    pending = _pending_frames(root, epoch, int(meta["seq"]),
                                              arrays["X"].shape[1])
                    if pending:
                        raise StoreError(
                            f"{root}: the journal holds {pending} frame(s) "
                            f"of appends to {name} that open() would "
                            f"replay; open_slab reads committed epochs "
                            f"only: commit() them first")
            except (StoreCorruptionError, StoreVersionError,
                    StoreError) as e:
                mine = (type(e).__name__, str(e))
            verdict = mesh.host_broadcast(mine)
            # a rank that fails where the first rank passed (the same
            # bytes read apart) fails every rank alike
            if mesh.host_max([int(verdict is None and mine is not None)])[0]:
                raise StoreError(f"{root}: the ranks disagree on {name} "
                                 f"(a rank's own reading failed where the "
                                 f"first rank's passed)")
            if verdict is None:
                store = DatasetStore(
                    X=file_backed(arrays["X"]),
                    proxy=file_backed(arrays["proxy"]),
                    x_norms=torch.from_numpy(arrays["x_norms"]),
                    proxy_norms=torch.from_numpy(arrays["proxy_norms"]),
                    image_shape=tuple(meta["image_shape"]), labels=None)
                index = GoldenIndex(
                    centroids=torch.from_numpy(arrays["centroids"]),
                    centroid_norms=torch.from_numpy(
                        arrays["centroid_norms"]),
                    perm=torch.from_numpy(arrays["perm"].astype(np.int64)),
                    offsets=torch.from_numpy(
                        arrays["offsets"].astype(np.int64)),
                    proxy_sorted=file_backed(arrays["proxy_sorted"]),
                    proxy_norms_sorted=torch.from_numpy(
                        arrays["proxy_norms_sorted"]),
                    max_cluster=int(meta["capacity"]))
                return SlabEpoch(store, index, epoch, quarantined)
            kind, msg = verdict
            if kind == "StoreError":
                raise StoreError(msg)
            quarantined.append((name, msg))
            last = _ERRORS[kind](msg)
        raise last if last is not None else \
            StoreError(f"{root}: no loadable epoch")

    # -- journal -------------------------------------------------------------
    def _journal_path(self) -> str:
        return os.path.join(self.root, JOURNAL_FILE)

    def _reset_journal(self) -> None:
        atomic.atomic_write_bytes(self._journal_path(), JOURNAL_MAGIC)

    def _read_journal(self):
        """``(frames, end)``: ``(epoch, seq, rows)`` of the journal's
        valid prefix and the byte offset where validity ends."""
        return _journal_frames(self._journal_path(), self.dim)

    def _replay_journal(self) -> None:
        """Apply the journal's valid prefix on top of the loaded epoch
        (idempotent: frames from other epochs or out-of-sequence are
        skipped), then truncate any invalid tail."""
        frames, end = self._read_journal()
        for epoch, seq, rows in frames:
            if epoch != self._epoch or seq != self._seq:
                continue                          # stale or gapped frame
            self._apply_rows(rows)
            self._seq += 1
            self.replayed_frames += 1
        path = self._journal_path()
        if not os.path.exists(path) or end == 0:
            self._reset_journal()
        else:
            size = os.path.getsize(path)
            if size > end:                        # torn tail: drop it
                with open(path, "r+b") as f:
                    f.truncate(end)
                    f.flush()
                    os.fsync(f.fileno())

    def _journal_append(self, rows: np.ndarray) -> None:
        payload = np.ascontiguousarray(rows, np.float32).tobytes()
        hdr = _FRAME_HDR.pack(FRAME_MAGIC, self._epoch, self._seq,
                              rows.shape[0], rows.shape[1],
                              zlib.crc32(payload) & 0xFFFFFFFF)
        with open(self._journal_path(), "ab") as f:
            f.write(hdr + payload)
            f.flush()
            os.fsync(f.fileno())

    # -- append --------------------------------------------------------------
    def append(self, rows: np.ndarray) -> int:
        """Durably append flattened rows ``[b, D]``; returns the frame's
        sequence number.

        The journal write (fsync'd) happens before any in-memory
        mutation, so a crash at any later point replays this append
        bit-identically on restart.  Raises
        :class:`~repro_torch.index.store.StoreCapacityError` — *before*
        journaling — when the rows don't fit the capacity-padded
        layout.
        """
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"append rows must be [b, {self.dim}], got "
                             f"{rows.shape}")
        if self._n_rows + rows.shape[0] > self.n_capacity:
            raise StoreCapacityError(
                f"append of {rows.shape[0]} rows exceeds capacity "
                f"{self.n_capacity} (have {self._n_rows}); rebuild with "
                f"more slack/spares to grow further")
        seq = self._seq
        self._journal_append(rows)
        self._apply_rows(rows)
        self._seq += 1
        return seq

    def _apply_rows(self, rows: np.ndarray) -> None:
        """Pure-numpy, RNG-free application of one append frame (the
        same code path at append time and journal replay)."""
        prox = _proxy_rows(rows, self.image_shape, self.proxy_factor)
        l_cap = self.capacity
        for i in range(rows.shape[0]):
            p = prox[i]
            nid = self._n_rows
            d2 = (self._cnorm - 2.0 * (self._cent @ p)
                  + float(p @ p))
            w = int(np.argmin(d2))
            if self._sizes[w] >= l_cap:
                spare = np.flatnonzero(~np.isfinite(self._cnorm)
                                       & (self._sizes == 0))
                if spare.size:
                    self._recluster(w, int(spare[0]))
                    d2w = ((self._cnorm[[w, int(spare[0])]]
                            - 2.0 * (self._cent[[w, int(spare[0])]] @ p))
                           + float(p @ p))
                    pair = [w, int(spare[0])]
                    order = np.argsort(d2w, kind="stable")
                    w = next(pair[int(j)] for j in order
                             if self._sizes[pair[int(j)]] < l_cap)
                else:
                    # no spare windows left: nearest window with a free
                    # slot (graceful recall degradation, never a crash)
                    free = self._sizes < l_cap
                    d2 = np.where(free & np.isfinite(self._cnorm), d2,
                                  np.inf)
                    if not np.isfinite(d2).any():
                        d2 = np.where(free, 0.0, np.inf)
                    w = int(np.argmin(d2))
            slot = w * l_cap + int(self._sizes[w])
            self._perm[slot] = nid
            self._ps[slot] = p
            self._pns[slot] = float(p @ p)
            self._sizes[w] += 1
            self._X[nid] = rows[i]
            self._xn[nid] = float(rows[i] @ rows[i])
            self._proxy[nid] = p
            self._pn[nid] = float(p @ p)
            self._n_rows += 1

    def _recluster(self, w: int, s: int) -> None:
        """Deterministic local 2-means: split window ``w``'s rows
        between ``w`` and the spare ``s`` (centroids updated, all other
        windows untouched)."""
        l_cap = self.capacity
        lo = w * l_cap
        size = int(self._sizes[w])
        pts = self._ps[lo:lo + size].copy()
        perm = self._perm[lo:lo + size].copy()
        pns = self._pns[lo:lo + size].copy()
        c1 = pts.mean(0)
        d1 = ((pts - c1) ** 2).sum(-1)
        c2 = pts[int(np.argmax(d1))].copy()
        side = None
        for _ in range(max(1, self.recluster_iters)):
            d1 = ((pts - c1) ** 2).sum(-1)
            d2 = ((pts - c2) ** 2).sum(-1)
            new_side = d2 < d1                    # ties stay with c1
            if side is not None and (new_side == side).all():
                break
            side = new_side
            if side.any():
                c2 = pts[side].mean(0)
            if (~side).any():
                c1 = pts[~side].mean(0)
        # degenerate split (all identical points): halve by position so
        # the overflowing window actually frees slots
        if side is None or not side.any() or not (~side).any():
            side = np.zeros(size, bool)
            side[size // 2:] = True
            c1 = pts[~side].mean(0)
            c2 = pts[side].mean(0)
        for win, mask, c in ((w, ~side, c1), (s, side, c2)):
            base = win * l_cap
            cnt = int(mask.sum())
            self._ps[base:base + cnt] = pts[mask]
            self._perm[base:base + cnt] = perm[mask]
            self._pns[base:base + cnt] = pns[mask]
            # cleared tail slots: deterministic padding (bit-identical
            # replay depends on it)
            self._ps[base + cnt:base + l_cap] = 0.0
            self._perm[base + cnt:base + l_cap] = 0
            self._pns[base + cnt:base + l_cap] = np.inf
            self._sizes[win] = cnt
            self._cent[win] = c
            self._cnorm[win] = float(c @ c)

    # -- commit (durable epoch) ----------------------------------------------
    def _arrays(self) -> dict[str, np.ndarray]:
        return {"X": self._X, "proxy": self._proxy, "x_norms": self._xn,
                "proxy_norms": self._pn, "proxy_sorted": self._ps,
                "proxy_norms_sorted": self._pns, "perm": self._perm,
                "offsets": self._offsets, "centroids": self._cent,
                "centroid_norms": self._cnorm, "sizes": self._sizes}

    def _write_epoch(self, epoch: int) -> None:
        d = os.path.join(self.root, _epoch_name(epoch))
        os.makedirs(d, exist_ok=True)
        atomic.save_arrays(
            os.path.join(d, "arrays.npz"), self._arrays(),
            fmt=EPOCH_FORMAT, version=EPOCH_FORMAT_VERSION,
            meta={"image_shape": list(self.image_shape),
                  "proxy_factor": self.proxy_factor,
                  "capacity": self.capacity,
                  "recluster_iters": self.recluster_iters,
                  "n_rows": self._n_rows, "seq": self._seq,
                  "epoch": int(epoch)})

    def commit(self, kill=None) -> int:
        """Fold journaled appends into a new durable epoch.

        Stages (``kill`` is a test hook called with the stage name
        after each one — raising from it simulates a crash exactly
        there):

        1. ``"epoch_written"`` — the new epoch directory is durable,
           ``CURRENT`` still points at the old epoch.  Recovery loads
           the OLD epoch and replays the journal: state preserved.
        2. ``"current_flipped"`` — ``CURRENT`` atomically points at the
           new epoch; the journal still holds the old frames.  Recovery
           loads the NEW epoch and *skips* the stale frames (epoch tag
           mismatch): state preserved.
        3. ``"journal_truncated"`` — old frames garbage-collected.
        """
        if self.pending_rows == 0 and self._seq == self._epoch_seq:
            return self._epoch
        new = self._epoch + 1
        self._write_epoch(new)
        if kill is not None:
            kill("epoch_written")
        atomic.atomic_write_text(os.path.join(self.root, CURRENT_FILE),
                                 _epoch_name(new) + "\n")
        if kill is not None:
            kill("current_flipped")
        self._epoch = new
        self._epoch_seq = self._seq
        self._epoch_n_rows = self._n_rows
        self._reset_journal()
        if kill is not None:
            kill("journal_truncated")
        return new

    # -- engine-facing views -------------------------------------------------
    def view(self, device=None):
        """The current state as an ordinary ``(DatasetStore,
        GoldenIndex)`` pair on ``device`` (the CUDA card unless the
        caller names another).  Always copies, on the CPU too: a
        zero-copy alias of these live buffers would let a later
        ``append`` change an installed engine epoch behind its back."""
        from repro_torch.core.dataset import DatasetStore
        device = resolve_device(device)

        def t(a):
            return torch.from_numpy(a).to(device, copy=True)

        store = DatasetStore(
            X=t(self._X), proxy=t(self._proxy), x_norms=t(self._xn),
            proxy_norms=t(self._pn), image_shape=self.image_shape,
            labels=None)
        index = index_from_numpy(
            self._cent, self._cnorm, self._perm, self._offsets, self._ps,
            self._pns, max_cluster=self.capacity, device=device)
        return store, index


_ROW_ARRAYS = ("X", "proxy", "proxy_sorted")   # [n_cap, .]: by slab
_ERRORS = {"StoreError": StoreError,
           "StoreCorruptionError": StoreCorruptionError,
           "StoreVersionError": StoreVersionError}


class SlabEpoch(tuple):
    """``(store, index)`` of an epoch opened by
    :meth:`StoreLifecycle.open_slab` (it unpacks as the pair), with the
    ``epoch`` id, the epochs ``quarantined`` on the way to it, as
    :meth:`StoreLifecycle.open` lists them, and ``small_bytes``: the host
    bytes of the arrays read whole, as the pair holds them."""

    def __new__(cls, store, index, epoch: int, quarantined: list):
        self = super().__new__(cls, (store, index))
        self.store, self.index = store, index
        self.epoch, self.quarantined = int(epoch), list(quarantined)
        self.small_bytes = sum(
            t.numel() * t.element_size() for t in (
                store.x_norms, store.proxy_norms, index.centroids,
                index.centroid_norms, index.perm, index.offsets,
                index.proxy_norms_sorted))
        return self


def _candidates(root: str, fallback: bool) -> list[str]:
    """The epochs :meth:`StoreLifecycle.open` tries, in order: CURRENT's,
    then (``fallback``) every other epoch directory, newest first."""
    cur_path = os.path.join(root, CURRENT_FILE)
    if not os.path.exists(cur_path):
        raise StoreError(f"{root}: not a store-lifecycle root "
                         f"(no {CURRENT_FILE})")
    current = open(cur_path).read().strip()
    candidates = [current]
    if fallback:
        candidates += sorted((p for p in os.listdir(root)
                              if p.startswith("epoch_") and p != current),
                             reverse=True)
    return candidates


def _epoch_npz(root: str, name: str) -> tuple[str, int]:
    """An epoch directory's npz path and epoch id (checked to exist)."""
    try:
        epoch = int(name.split("_", 1)[1])
    except (IndexError, ValueError):
        raise StoreCorruptionError(f"{root}: malformed epoch name "
                                   f"{name!r} in {CURRENT_FILE}")
    npz = os.path.join(root, name, "arrays.npz")
    if not os.path.exists(npz):
        raise StoreCorruptionError(f"{npz}: epoch directory missing "
                                   f"or incomplete")
    return npz, epoch


def _validate_epoch(npz: str, arrays: dict, meta: dict) -> None:
    """An epoch's semantic checks, after the manifest's: the array set,
    the meta keys, the index's invariants and the row count (reads only
    the small arrays and the row arrays' shapes)."""
    missing = sorted(set(_ARRAYS) - set(arrays))
    if missing:
        raise StoreCorruptionError(f"{npz}: missing epoch array(s): "
                                   f"{missing}")
    for key in ("image_shape", "proxy_factor", "capacity", "n_rows", "seq"):
        if key not in meta:
            raise StoreCorruptionError(f"{npz}: manifest meta is missing "
                                       f"{key!r}")
    validate_index({f: arrays[f] for f in
                    ("centroids", "centroid_norms", "perm", "offsets",
                     "proxy_sorted", "proxy_norms_sorted")},
                   int(meta["capacity"]))
    n_rows = int(meta["n_rows"])
    n_cap = arrays["perm"].shape[0]
    if not 0 <= n_rows <= n_cap:
        raise StoreCorruptionError(f"{npz}: n_rows {n_rows} outside "
                                   f"[0, {n_cap}]")
    if np.isfinite(arrays["x_norms"][n_rows:]).any():
        raise StoreCorruptionError(f"{npz}: finite x_norms beyond "
                                   f"n_rows={n_rows} (row-count mismatch)")
    sizes = arrays["sizes"]
    if int(sizes.sum()) != n_rows:
        raise StoreCorruptionError(
            f"{npz}: window occupancy {int(sizes.sum())} != n_rows "
            f"{n_rows}")


def _journal_frames(path: str, dim: int):
    """``(frames, end)``: ``(epoch, seq, rows)`` for the journal's valid
    prefix (frames of ``dim``-wide rows), and the byte offset where
    validity ends (0: no journal, or a foreign file)."""
    frames = []
    end = len(JOURNAL_MAGIC)
    if not os.path.exists(path):
        return frames, 0
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        return frames, 0                          # foreign file: rewrite
    pos = len(JOURNAL_MAGIC)
    while pos + _FRAME_HDR.size <= len(data):
        magic, epoch, seq, n, d, crc = _FRAME_HDR.unpack_from(data, pos)
        if magic != FRAME_MAGIC or d != dim:
            break
        payload = data[pos + _FRAME_HDR.size:
                       pos + _FRAME_HDR.size + n * d * 4]
        if len(payload) != n * d * 4:
            break                                 # torn tail
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                                 # corrupt tail
        rows = np.frombuffer(payload, np.float32).reshape(n, d)
        frames.append((epoch, seq, rows))
        pos += _FRAME_HDR.size + len(payload)
        end = pos
    return frames, end


def _pending_frames(root: str, epoch: int, seq: int, dim: int) -> int:
    """How many of the journal's frames ``open`` would replay on top of
    ``epoch`` (whose next frame is ``seq``)."""
    frames, _ = _journal_frames(os.path.join(root, JOURNAL_FILE), dim)
    n = 0
    for e, s, _ in frames:
        if e == epoch and s == seq + n:
            n += 1
    return n


def _host(a, dtype) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)
