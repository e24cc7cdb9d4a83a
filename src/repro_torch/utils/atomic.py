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
import zipfile

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


def load_arrays(npz_path: str, fmt: str, version: int,
                manifest_path: str | None = None,
                corruption_exc: type[Exception] = ArtifactCorruptionError,
                version_exc: type[Exception] = ArtifactVersionError,
                ) -> tuple[dict[str, np.ndarray], dict]:
    """Load + validate an npz/manifest pair written by ``save_arrays``.

    Validates, in order: manifest presence and well-formedness, format
    name, format version, npz readability, array presence (both
    directions), per-array shape/dtype, and per-array sha256.  Raises
    ``version_exc`` for version mismatches and ``corruption_exc`` for
    everything else, always with a message naming the offending piece.
    Returns ``(arrays, meta)``.
    """
    npz_path = os.fspath(npz_path)
    manifest_path = manifest_path or _manifest_path(npz_path)
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
    try:
        with np.load(npz_path) as z:
            arrays = {k: np.array(z[k]) for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile, KeyError,
            EOFError) as e:
        raise corruption_exc(f"{npz_path}: unreadable npz ({e})") from e
    spec = manifest["arrays"]
    missing = sorted(set(spec) - set(arrays))
    extra = sorted(set(arrays) - set(spec))
    if missing or extra:
        raise corruption_exc(
            f"{npz_path}: array set mismatch vs manifest "
            f"(missing: {missing or '-'}, unexpected: {extra or '-'})")
    for name in sorted(spec):
        want, have = spec[name], arrays[name]
        if not isinstance(want, dict):
            raise corruption_exc(f"{manifest_path}: malformed entry for "
                                 f"array {name!r}")
        if list(have.shape) != list(want.get("shape", [])):
            raise corruption_exc(
                f"{npz_path}: array {name!r} shape {list(have.shape)} != "
                f"manifest {want.get('shape')}")
        bf16 = want.get("dtype") == "bfloat16" and have.dtype == BF16_BITS
        if str(have.dtype) != want.get("dtype") and not bf16:
            raise corruption_exc(
                f"{npz_path}: array {name!r} dtype {have.dtype} != "
                f"manifest {want.get('dtype')}")
        digest = sha256_hex(have)
        if digest != want.get("sha256"):
            raise corruption_exc(
                f"{npz_path}: array {name!r} checksum mismatch "
                f"(sha256 {digest[:12]}… != manifest "
                f"{str(want.get('sha256'))[:12]}… — torn write or "
                f"bit-rot)")
    meta = manifest.get("meta")
    return arrays, dict(meta) if isinstance(meta, dict) else {}
