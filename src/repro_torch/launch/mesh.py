"""Mesh construction (counterpart of ``repro.launch.mesh``) and the H100's
roofline constants.

* ``make_debug_mesh`` -- the sharded store's ``LocalMesh`` (every shard
  in this process), which the engine takes;
* ``make_production_mesh`` -- the reference's pod mesh for the LLM, a
  ``torch.distributed`` ``DeviceMesh`` of (16, 16) ("data", "model") or
  (2, 16, 16) ("pod", "data", "model") over the current world;
* ``make_debug_device_mesh`` -- the reference's ``make_debug_mesh`` for
  the LLM: a small ("data", "model") ``DeviceMesh`` over the current
  world (the CPU tests' (2, 2) gloo mesh, the card's (1, 1) NCCL mesh).

Functions, never module-level meshes: importing this module touches no
process group.  The default process group is the caller's to create
(``init_process_group`` with an explicit address, world size and rank;
the dry run's is a fake group of 256 or 512 ranks).
"""
from __future__ import annotations

from repro_torch.distributed.sharding import LocalMesh


def make_debug_mesh(n_data: int = 1, n_model: int = 1, devices=None
                    ) -> LocalMesh:
    """A ``LocalMesh`` with axes ("data", "model") of sizes (n_data,
    n_model): every shard in this process, on the engine's device unless
    ``devices`` lists one device per "data" position."""
    return LocalMesh((n_data, n_model), ("data", "model"), devices=devices)


def _device_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


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
           "make_debug_device_mesh", "PEAK_FLOPS_BF16", "HBM_BW",
           "HBM_PER_CHIP", "NVLINK_BW", "INTERNODE_BW", "ICI_BW"]
