"""Mesh construction for the sharded engine.

Counterpart of ``repro.launch.mesh``'s ``make_debug_mesh`` only: the
reference's pod meshes and TPU constants have no counterpart on one
card.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import LocalMesh


def make_debug_mesh(n_data: int = 1, n_model: int = 1, devices=None
                    ) -> LocalMesh:
    """A ``LocalMesh`` with axes ("data", "model") of sizes (n_data,
    n_model): every shard in this process, on the engine's device unless
    ``devices`` lists one device per "data" position."""
    return LocalMesh((n_data, n_model), ("data", "model"), devices=devices)


__all__ = ["make_debug_mesh"]
