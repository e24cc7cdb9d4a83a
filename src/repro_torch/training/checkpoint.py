"""Flat-file checkpoints of parameter and optimizer trees (counterpart of
``repro.training.checkpoint``), in the reference's layout.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` holding the
flattened key paths ("/"-joined: dict keys in sorted order, a NamedTuple
field as ``.<name>``, as ``jax.tree_util`` names them), dtypes and per-array
sha256 checksums, written through ``repro_torch.utils.atomic`` (tmp +
fsync + rename, manifest last).  A checkpoint written by either package
restores in the port.  bf16 leaves are written as the reference writes
them (2-byte voids, manifest dtype ``"bfloat16"``) and read back as bf16
bits, with no ml_dtypes; the reference itself cannot read a bf16 leaf
back (ROADMAP Queue 3).  Leaves come back on the device and in the dtype
of the tree given to ``restore``.

A tree of DTensors (a mesh's parameters) is saved as its full tensors,
as the reference saves global arrays: every rank gathers each leaf (a
collective: all ranks call ``save``), rank 0 writes, and the ranks meet
at a barrier.  ``restore`` into DTensor leaves puts each full tensor back
on its leaf's placements (each rank keeps its chunk).
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.utils import atomic

CKPT_FORMAT = "training-checkpoint"
CKPT_FORMAT_VERSION = 1


class CheckpointCorruptionError(atomic.ArtifactCorruptionError):
    """Checkpoint bytes disagree with their manifest."""


class CheckpointVersionError(atomic.ArtifactVersionError):
    """Checkpoint written by an incompatible format version."""


def _items(node):
    """(path segment, child) pairs of a dict or NamedTuple node, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for key, child in items:
        out.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    items = _items(like)
    if items is None:
        return leaves[prefix]
    kids = {key: _unflatten(child, leaves, f"{prefix}/{key}" if prefix
                            else key) for key, child in items}
    if isinstance(like, dict):
        return {k: kids[str(k)] for k in like}
    return type(like)(*(kids[f".{f}"] for f in like._fields))


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(atomic.BF16_BITS)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == atomic.BF16_BITS:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if is_dtensor(like):
        from repro_torch.distributed.sharding import place
        return place(t.to(device=like.to_local().device, dtype=like.dtype),
                     like.device_mesh, like.placements)
    return t.to(device=like.device, dtype=like.dtype)


def save(directory: str | pathlib.Path, step: int, tree) -> pathlib.Path:
    """Write ``tree`` (nested dicts / NamedTuples of tensors) as step
    ``step`` under ``directory``; returns the step's directory."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    flat = _flatten(tree)
    bf16 = [k for k, t in flat.items()
            if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16]
    arrays = {k: _to_numpy(t) for k, t in flat.items()}
    sharded = any(is_dtensor(t) for t in flat.values())
    if sharded:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    else:
        writer = True
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        atomic.save_arrays(str(d / "arrays.npz"), arrays,
                           fmt=CKPT_FORMAT, version=CKPT_FORMAT_VERSION,
                           meta={"step": int(step)},
                           manifest_path=str(d / "manifest.json"),
                           bfloat16=bf16)
    if sharded:
        dist.barrier()
    return d


def latest_step(directory: str | pathlib.Path) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore(directory: str | pathlib.Path, step: int, like_tree):
    """The tree saved as ``step``, shaped like ``like_tree``: each leaf on
    its ``like_tree`` leaf's device, in its dtype.  A torn, altered or
    mismatched checkpoint raises ``CheckpointCorruptionError``, another
    format version ``CheckpointVersionError``."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    data, _ = atomic.load_arrays(
        str(d / "arrays.npz"), fmt=CKPT_FORMAT,
        version=CKPT_FORMAT_VERSION,
        manifest_path=str(d / "manifest.json"),
        corruption_exc=CheckpointCorruptionError,
        version_exc=CheckpointVersionError)
    flat_like = _flatten(like_tree)
    if set(data) != set(flat_like):
        raise CheckpointCorruptionError(
            f"{d}: checkpoint/tree key mismatch "
            f"(missing: {sorted(set(flat_like) - set(data)) or '-'}, "
            f"unexpected: {sorted(set(data) - set(flat_like)) or '-'})")
    return _unflatten(like_tree, {k: _from_numpy(data[k], like)
                                  for k, like in flat_like.items()})
