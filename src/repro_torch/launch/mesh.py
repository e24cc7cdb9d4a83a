"""Mesh construction (counterpart of ``repro.launch.mesh``) and the H100's
roofline constants.

* ``make_debug_mesh`` -- the sharded store's ``LocalMesh`` (every shard
  in this process), which the engine takes;
* ``make_production_mesh`` -- the reference's pod mesh for the LLM, a
  ``torch.distributed`` ``DeviceMesh`` of (16, 16) ("data", "model") or
  (2, 16, 16) ("pod", "data", "model") over the current world;
* ``make_debug_device_mesh`` -- the reference's ``make_debug_mesh`` for
  the LLM: a small ("data", "model") ``DeviceMesh`` over the current
  world (the CPU tests' (2, 2) gloo mesh, the card's (1, 1) NCCL mesh);
* ``make_process_mesh`` -- the sharded engine's ``ProcessMesh`` over the
  current world, one shard a rank: the counterpart of the reference's
  ``jax.make_mesh((S,), ("data",))`` / ``((4, 2), ("data", "model"))``
  for ``GoldDiffEngine(mesh=...)``.

Functions, never module-level meshes: importing this module touches no
process group.  The default process group is the caller's to create
(``init_process_group`` with an explicit address, world size and rank;
the dry run's is a fake group of 256 or 512 ranks).
"""
from __future__ import annotations

import os

import torch

from repro_torch.distributed.sharding import LocalMesh, ProcessMesh
from repro_torch.utils import resolve_device


def make_debug_mesh(n_data: int = 1, n_model: int = 1, devices=None
                    ) -> LocalMesh:
    """A ``LocalMesh`` with axes ("data", "model") of sizes (n_data,
    n_model): every shard in this process, on the engine's device unless
    ``devices`` lists one device per "data" position."""
    return LocalMesh((n_data, n_model), ("data", "model"), devices=devices)


def _world_for(shape) -> int:
    """The current world's size, which must be the product of ``shape``."""
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world "
                         f"has {world}")
    return world


def _device_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    _world_for(shape)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def _group_timeout():
    """The collective timeout the default group was made with, or None
    where its backend does not expose it."""
    import torch.distributed as dist
    pg = dist.distributed_c10d._get_default_group()
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (AttributeError, RuntimeError):
            continue
    return None


def make_process_mesh(shape=None, axes=("data",), device=None
                      ) -> ProcessMesh:
    """The sharded engine's mesh over the current world: one shard a
    rank, the first axis the shard axis.  ``shape`` is ``(S,)`` (the
    default: the whole world) or ``(S, G)`` for axes such as ("data",
    "model"), whose second axis can split the query batch.

    The backend is the default group's, which the caller created
    (``init_process_group`` with an explicit address, world size, rank
    and timeout; one call per rank, e.g. under ``torchrun``).  Each rank
    runs on its card (``LOCAL_RANK``, else the rank, modulo the cards),
    under NCCL and gloo alike, unless ``device`` names another; with no
    card ``device=None`` raises (``resolve_device``), and the CPU is
    taken only where ``device="cpu"`` asks for it (gloo).  Under NCCL the
    engine captures its plan segments, collectives and all, as CUDA
    graphs; under gloo it runs them eagerly.  A world whose size is not
    the product of ``shape`` raises ``ValueError`` naming it.

    The mesh's host channel (``ProcessMesh.host_broadcast`` and
    ``host_max``, the serving runtime's decisions) runs over gloo on the
    CPU: the default group itself under gloo; under NCCL a gloo group of
    the whole world made here, with the timeout the default group was
    made with (a backend that does not expose it raises), so that a rank
    that stops answering fails every other rank's decision within it.
    Every rank must call this at the same point (``new_group``)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up")
    _world_for(shape)
    nccl = dist.get_backend() == "nccl"
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    host = None
    if nccl:
        timeout = _group_timeout()
        if timeout is None:
            raise RuntimeError("the default group's timeout is not "
                               "readable; the host channel takes it")
        host = dist.new_group(backend="gloo", timeout=timeout)
    if len(shape) == 1:
        return ProcessMesh(axes[0], device=device, host_group=host)
    return ProcessMesh(device_mesh=_device_mesh(
        shape, axes, "cuda" if nccl else "cpu"), device=device,
        host_group=host)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 cards a pod ("data", "model"); 2 x 16 x 16 = 512
    across two pods ("pod", "data", "model").  Built over the current
    default process group on ``device_type`` ("cuda" unless asked for
    "cpu"); a world of another size raises ``ValueError`` naming it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_debug_device_mesh(n_data: int = 1, n_model: int = 1,
                           device_type: str = "cuda"):
    """The reference's ``make_debug_mesh`` for the LLM: a (n_data,
    n_model) ("data", "model") ``DeviceMesh`` over the current world of
    n_data x n_model ranks."""
    return _device_mesh((n_data, n_model), ("data", "model"), device_type)


# NVIDIA H100 SXM5 80GB (roofline denominators).  The reference's TPU v5e
# constants have no counterpart here; every number below is the card's.
# Dense bf16 tensor-core peak, FLOP/s per card (H100 SXM5 data sheet:
# 1979 TFLOP/s with 2:4 sparsity, half of it dense).
PEAK_FLOPS_BF16 = 989.4e12
# HBM3 bandwidth, bytes/s per card (data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
# HBM per card (data sheet: 80 GB).
HBM_PER_CHIP = 80e9
# NVLink 4, bytes/s per card and direction (data sheet: 900 GB/s
# bidirectional, so 450e9 a direction).  An 8-card HGX node joins its
# cards all to all over NVLink; a 16-wide mesh axis spans two such nodes,
# whose traffic crosses the inter-node network (ConnectX-7 at 400 Gb/s a
# card, 50e9 B/s), so a collective over a 16-wide axis runs at
# ``INTERNODE_BW``, the slower link of its ring.
NVLINK_BW = 450e9
INTERNODE_BW = 50e9
# the collective term's rate: every collective of the 16 x 16 mesh spans
# an axis of 16 cards, two nodes
ICI_BW = INTERNODE_BW


__all__ = ["make_debug_mesh", "make_production_mesh",
           "make_debug_device_mesh", "make_process_mesh", "PEAK_FLOPS_BF16", "HBM_BW",
           "HBM_PER_CHIP", "NVLINK_BW", "INTERNODE_BW", "ICI_BW"]
