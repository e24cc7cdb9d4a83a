"""Crash-safe artifact persistence: atomic writes + checksummed manifests.

The port's own copy of ``repro.utils.atomic`` (numpy only).  The npz
and manifest format is the reference's byte for byte, so an artifact
written by either package loads in the other; ``repro_torch.index.store``
persists the Golden Index through it, and ``repro_torch.training.
checkpoint`` the training state.

bf16 arrays (no numpy dtype without ml_dtypes, which the port does not
use) travel as 2-byte voids holding the bf16 bits: ``save_arrays(...,
bfloat16=names)`` writes them as the reference's ml_dtypes arrays land in
an npz (header descr ``'<V2'``, manifest dtype ``"bfloat16"``), and
``load_arrays`` accepts the ``|V2`` array numpy reads back under a
``"bfloat16"`` manifest entry.  The reference's own check refuses that
pair (``src/repro/utils/atomic.py:179``), so it cannot restore a bf16
leaf; every other dtype mismatch raises here as there.

Write protocol (per file): write to ``<name>.tmp.<pid>`` in the SAME
directory, flush + ``os.fsync``, then ``os.replace`` over the final
name and fsync the directory.  A crash at any point leaves either the
old file or the new file — never a torn one — and stray ``.tmp.*``
files are ignored by every reader.

Array artifacts are an ``.npz`` plus a JSON *manifest* recording the
format name, an integer ``format_version``, and per-array
shape/dtype/sha256.  ``load_arrays`` validates all of it BEFORE any
caller constructs objects from the data, raising the caller's typed
error classes (so ``repro_torch.index.store`` surfaces
``StoreCorruptionError``/``StoreVersionError``) instead of an obscure
downstream failure or — worse — silently wrong numerics.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zipfile
from typing import NamedTuple

import numpy as np


class ArtifactError(Exception):
    """Base class for persistence failures (missing / unreadable)."""


class ArtifactCorruptionError(ArtifactError):
    """Artifact bytes disagree with their manifest (torn write,
    truncation, bit-flip, checksum mismatch, schema mismatch)."""


class ArtifactVersionError(ArtifactError):
    """Artifact was written by an incompatible format version."""


def sha256_hex(data: bytes | np.ndarray) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + replace)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1,
                                        sort_keys=True).encode("utf-8"))


def _manifest_path(npz_path: str) -> str:
    return os.fspath(npz_path) + ".manifest.json"


BF16_BITS = np.dtype("V2")     # a bf16 array's numpy form: its 2-byte bits


def _savez(buf, arrays: dict[str, np.ndarray], bfloat16) -> None:
    """``np.savez(buf, **arrays)``, except that the arrays named in
    ``bfloat16`` (2-byte voids) get the header ml_dtypes' bfloat16 gets
    (descr ``'<V2'``), so the bytes equal the reference's."""
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if key in bfloat16:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": val.shape})
                    fid.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(fid, val)


def save_arrays(npz_path: str, arrays: dict[str, np.ndarray],
                fmt: str, version: int, meta: dict | None = None,
                manifest_path: str | None = None,
                bfloat16=()) -> str:
    """Atomically write ``arrays`` as npz + a checksummed manifest.

    The npz lands first, the manifest second — the manifest is the
    per-artifact commit marker, so a crash between the two writes is
    *detected* at load (checksum mismatch), never silently served.
    ``bfloat16`` names the arrays that are bf16 bits (``BF16_BITS``).
    Returns the manifest path.
    """
    npz_path = os.fspath(npz_path)
    manifest_path = manifest_path or _manifest_path(npz_path)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    for k in bfloat16:
        if arrays[k].dtype != BF16_BITS:
            raise ValueError(f"save_arrays: bf16 array {k!r} must hold its "
                             f"bits as {BF16_BITS}, got {arrays[k].dtype}")
    buf = io.BytesIO()
    _savez(buf, arrays, set(bfloat16))
    atomic_write_bytes(npz_path, buf.getvalue())
    manifest = {
        "format": fmt,
        "format_version": int(version),
        "arrays": {k: {"shape": list(v.shape),
                       "dtype": "bfloat16" if k in bfloat16 else str(v.dtype),
                       "sha256": sha256_hex(v)}
                   for k, v in sorted(arrays.items())},
        "meta": dict(meta or {}),
    }
    atomic_write_json(manifest_path, manifest)
    return manifest_path


def _read_manifest(npz_path: str, manifest_path: str, fmt: str,
                   version: int, corruption_exc, version_exc) -> dict:
    """The manifest of ``npz_path``, checked for presence, form, format
    name and version."""
    if not os.path.exists(manifest_path):
        raise corruption_exc(f"{npz_path}: missing manifest "
                             f"{os.path.basename(manifest_path)} (not "
                             f"written by save_arrays, or a torn write)")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise corruption_exc(f"{manifest_path}: unreadable manifest "
                             f"({e})") from e
    if not isinstance(manifest, dict) or \
            not isinstance(manifest.get("arrays"), dict):
        raise corruption_exc(f"{manifest_path}: malformed manifest "
                             f"(expected an object with an 'arrays' map)")
    if manifest.get("format") != fmt:
        raise corruption_exc(
            f"{manifest_path}: format {manifest.get('format')!r} != "
            f"expected {fmt!r}")
    got_ver = manifest.get("format_version")
    if got_ver != int(version):
        raise version_exc(
            f"{manifest_path}: format_version {got_ver!r} is not the "
            f"supported version {version} — refusing to load")
    return manifest


def _check_set(npz_path: str, spec: dict, names, corruption_exc) -> None:
    missing = sorted(set(spec) - set(names))
    extra = sorted(set(names) - set(spec))
    if missing or extra:
        raise corruption_exc(
            f"{npz_path}: array set mismatch vs manifest "
            f"(missing: {missing or '-'}, unexpected: {extra or '-'})")


def _check_entry(npz_path: str, manifest_path: str, name: str, want,
                 shape, dtype, corruption_exc) -> None:
    """An array's shape and dtype against its manifest entry."""
    if not isinstance(want, dict):
        raise corruption_exc(f"{manifest_path}: malformed entry for "
                             f"array {name!r}")
    if list(shape) != list(want.get("shape", [])):
        raise corruption_exc(
            f"{npz_path}: array {name!r} shape {list(shape)} != "
            f"manifest {want.get('shape')}")
    bf16 = want.get("dtype") == "bfloat16" and dtype == BF16_BITS
    if str(dtype) != want.get("dtype") and not bf16:
        raise corruption_exc(
            f"{npz_path}: array {name!r} dtype {dtype} != "
            f"manifest {want.get('dtype')}")


def _check_digest(npz_path: str, name: str, want: dict, digest: str,
                  corruption_exc) -> None:
    if digest != want.get("sha256"):
        raise corruption_exc(
            f"{npz_path}: array {name!r} checksum mismatch "
            f"(sha256 {digest[:12]}… != manifest "
            f"{str(want.get('sha256'))[:12]}… — torn write or "
            f"bit-rot)")


# -- arrays read in place ------------------------------------------------------

_LOCAL_HEADER = 30           # a zip local file header's fixed part
_IOV_MAX = 1024              # buffers one preadv call takes (POSIX minimum)
_HASH_CHUNK = 4 << 20        # the one buffer a streamed checksum reads into


def _preadv_all(fd: int, bufs: list, pos: int, path: str) -> int:
    """Fill ``bufs`` from ``fd`` at byte ``pos`` by ``os.preadv``, calling
    again after a short count (Linux returns at most about 2 GiB a call,
    and a signal may cut a read short); only a call that reads nothing
    means the file ends early.  Returns the byte after the last read."""
    bufs = [b for b in bufs if len(b)]
    while bufs:
        got = os.preadv(fd, bufs, pos)
        if got <= 0:
            raise EOFError(f"{path}: short read at byte {pos} (truncated "
                           f"file)")
        pos += got
        while bufs and got >= len(bufs[0]):
            got -= len(bufs[0])
            bufs = bufs[1:]
        if bufs and got:
            bufs = [bufs[0][got:]] + bufs[1:]
    return pos


class StoredArray(NamedTuple):
    """An array stored uncompressed in an npz, where it lies in the file:
    the byte ``offset`` of its first element in ``path``, its ``shape``
    and ``dtype`` (C order).  Nothing of it is read until asked:
    :meth:`map` maps it (pages are read when touched), :meth:`read_rows`
    reads chosen rows with positioned reads into a buffer (the file's
    pages stay in the page cache and are never mapped, so the reader's
    resident bytes grow by the buffer alone), :meth:`sha256` streams it."""
    path: str
    offset: int
    shape: tuple
    dtype: np.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    @property
    def row_bytes(self) -> int:
        return self.nbytes // max(self.shape[0], 1) if self.shape else 0

    def map(self) -> np.ndarray:
        """A copy-on-write mapping of the array (``np.memmap`` mode "c":
        writable, and a write never reaches the file)."""
        if self.nbytes == 0:
            return np.empty(self.shape, self.dtype)
        return np.memmap(self.path, dtype=self.dtype, mode="c",
                         offset=self.offset, shape=self.shape)

    def sha256(self) -> str:
        """The sha256 of the array's bytes (``sha256_hex`` of it), read
        through one fixed buffer."""
        h = hashlib.sha256()
        buf = bytearray(min(_HASH_CHUNK, max(self.nbytes, 1)))
        view = memoryview(buf)
        left = self.nbytes
        with open(self.path, "rb", buffering=0) as f:
            f.seek(self.offset)
            while left:
                got = f.readinto(view[:min(left, len(buf))])
                if not got:
                    raise EOFError(f"{self.path}: {left} bytes of the "
                                   f"array missing (truncated file)")
                h.update(view[:got])
                left -= got
        return h.hexdigest()

    def read_rows(self, rows, out: np.ndarray | None = None,
                  dst=None) -> np.ndarray:
        """Rows ``rows`` (ids along the first axis) into ``out`` at
        ``dst`` (default: ``out[j]`` gets ``rows[j]``; ``out`` is made
        when not given), by positioned reads: the rows sorted by id and
        coalesced into runs of consecutive ids, one ``preadv`` a run
        scattering them to their places in ``out``."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if out is None:
            out = np.empty((rows.size,) + tuple(self.shape[1:]), self.dtype)
        dst = (np.arange(rows.size) if dst is None
               else np.asarray(dst, np.int64).reshape(-1))
        if rows.size == 0:
            return out
        if rows.min() < 0 or rows.max() >= self.shape[0]:
            raise IndexError(f"{self.path}: row ids outside [0, "
                             f"{self.shape[0]})")
        if out.dtype != self.dtype or not out.flags.c_contiguous:
            raise ValueError("read_rows writes into a C-contiguous buffer "
                             f"of {self.dtype}")
        rb = self.row_bytes
        mem = memoryview(out.reshape(-1).view(np.uint8))
        order = np.argsort(rows, kind="stable")
        src, to = rows[order], dst[order]
        # pieces: consecutive ids landing in consecutive rows of ``out``;
        # runs: consecutive ids (one positioned read)
        cut = np.flatnonzero((np.diff(src) != 1) | (np.diff(to) != 1)) + 1
        p0 = np.concatenate([[0], cut])
        p1 = np.concatenate([cut, [src.size]])
        new_run = np.ones(p0.size, bool)
        new_run[1:] = src[p0[1:]] != src[p1[:-1] - 1] + 1
        runs = np.flatnonzero(new_run).tolist() + [p0.size]
        with open(self.path, "rb", buffering=0) as f:
            fd = f.fileno()
            for r0, r1 in zip(runs[:-1], runs[1:]):
                pos = self.offset + int(src[p0[r0]]) * rb
                for c in range(r0, r1, _IOV_MAX):
                    bufs = [mem[int(to[p0[i]]) * rb: int(to[p1[i] - 1] + 1)
                                * rb] for i in range(c, min(c + _IOV_MAX,
                                                            r1))]
                    pos = _preadv_all(fd, bufs, pos, self.path)
        return out


def stored_members(npz_path: str, corruption_exc=ArtifactCorruptionError,
                   names=None) -> dict[str, StoredArray]:
    """Where each member array of an npz lies (``StoredArray`` by name;
    those in ``names`` when given).  A member's data starts after its
    *local* header (30 bytes, then the name and the local extra field,
    whose length differs from the central directory's under
    ``force_zip64``) and the npy header.  A compressed or
    Fortran-ordered member raises ``corruption_exc``."""
    npz_path = os.fspath(npz_path)
    out = {}
    try:
        with zipfile.ZipFile(npz_path) as zf, open(npz_path, "rb") as f:
            for info in zf.infolist():
                name = info.filename
                if not name.endswith(".npy") or (
                        names is not None and name[:-4] not in names):
                    continue
                if info.compress_type != zipfile.ZIP_STORED:
                    raise corruption_exc(f"{npz_path}: member {name!r} is "
                                         f"compressed; it cannot be read "
                                         f"in place")
                f.seek(info.header_offset)
                head = f.read(_LOCAL_HEADER)
                if len(head) != _LOCAL_HEADER or head[:4] != b"PK\x03\x04":
                    raise corruption_exc(f"{npz_path}: bad local header for "
                                         f"member {name!r}")
                n_name, n_extra = struct.unpack("<HH", head[26:30])
                start = info.header_offset + _LOCAL_HEADER + n_name + n_extra
                f.seek(start)
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                if fortran:
                    raise corruption_exc(f"{npz_path}: member {name!r} is "
                                         f"Fortran-ordered")
                arr = StoredArray(npz_path, f.tell(), tuple(shape),
                                  np.dtype(dtype))
                if f.tell() - start + arr.nbytes != info.file_size:
                    raise corruption_exc(
                        f"{npz_path}: member {name!r} holds "
                        f"{info.file_size} bytes, its header says "
                        f"{f.tell() - start + arr.nbytes}")
                out[name[:-len(".npy")]] = arr
    except (OSError, ValueError, zipfile.BadZipFile, EOFError,
            struct.error) as e:
        raise corruption_exc(f"{npz_path}: unreadable npz ({e})") from e
    return out


def load_arrays(npz_path: str, fmt: str, version: int,
                manifest_path: str | None = None,
                corruption_exc: type[Exception] = ArtifactCorruptionError,
                version_exc: type[Exception] = ArtifactVersionError,
                in_place=(), verify: bool = True) -> tuple[dict, dict]:
    """Load + validate an npz/manifest pair written by ``save_arrays``.

    Validates, in order: manifest presence and well-formedness, format
    name, format version, npz readability, array presence (both
    directions), per-array shape/dtype, and per-array sha256.  Raises
    ``version_exc`` for version mismatches and ``corruption_exc`` for
    everything else, always with a message naming the offending piece.
    Returns ``(arrays, meta)``.

    The arrays named in ``in_place`` are not read: they come back as
    ``StoredArray`` (where they lie in the file; such a member must be
    stored uncompressed, in C order, its size its header's), their
    shape and dtype checked against the manifest and their sha256
    streamed from the file through one fixed buffer (``verify``), so
    the check costs no resident bytes."""
    npz_path = os.fspath(npz_path)
    manifest_path = manifest_path or _manifest_path(npz_path)
    manifest = _read_manifest(npz_path, manifest_path, fmt, version,
                              corruption_exc, version_exc)
    spec = manifest["arrays"]
    in_place = set(in_place)
    arrays = {}
    try:
        with zipfile.ZipFile(npz_path) as zf:
            # the member names as ``np.load`` gives them
            _check_set(npz_path, spec, [n[:-4] if n.endswith(".npy") else n
                                        for n in zf.namelist()],
                       corruption_exc)
            members = (stored_members(npz_path, corruption_exc, in_place)
                       if in_place else {})
            for name in sorted(spec):
                if name in in_place:
                    arrays[name] = members[name]
                else:
                    with zf.open(name + ".npy") as fid:
                        arrays[name] = np.lib.format.read_array(fid)
    except (OSError, ValueError, zipfile.BadZipFile, KeyError,
            EOFError) as e:
        raise corruption_exc(f"{npz_path}: unreadable npz ({e})") from e
    for name in sorted(spec):
        have = arrays[name]
        _check_entry(npz_path, manifest_path, name, spec[name], have.shape,
                     have.dtype, corruption_exc)
        if name not in in_place:
            _check_digest(npz_path, name, spec[name], sha256_hex(have),
                          corruption_exc)
        elif verify:
            try:
                digest = have.sha256()
            except (OSError, EOFError) as e:
                raise corruption_exc(f"{npz_path}: array {name!r} "
                                     f"unreadable ({e})") from e
            _check_digest(npz_path, name, spec[name], digest,
                          corruption_exc)
    meta = manifest.get("meta")
    return arrays, dict(meta) if isinstance(meta, dict) else {}
