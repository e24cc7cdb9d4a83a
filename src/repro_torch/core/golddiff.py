"""GoldDiff: Dynamic Time-Aware Golden Subset selection (paper Sec. 3.4).

Counterpart of ``repro.core.golddiff``: each timestep screens a
candidate set C_t of size m_t by proxy distance (Eq. 4), re-ranks it
exactly to the golden support S_t of size k_t (Eq. 6), and evaluates
the base denoiser with ``support=S_t`` and the unbiased softmax.
``__call__`` runs a static step: over the Optimal base the engine's
whole step (the selection distances reused by the aggregate); over a
patch base (Kamb, PCA) the engine's selection, then the base's own
feature-space posterior on the support.  ``call_masked`` is the masked
step that plans and scans chain, for the Optimal base only.
Execution is delegated to :class:`repro_torch.core.engine.GoldDiffEngine`,
on the base denoiser's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.dataset import DatasetStore, downsample_proxy
from repro_torch.core.denoisers import OptimalDenoiser
from repro_torch.core.engine import (GoldDiffConfig, GoldDiffEngine,
                                     is_process_mesh, schedule_sizes)
from repro_torch.core.schedules import Schedule
from repro_torch.kernels import ops
from repro_torch.kernels.ref import materialized_topm

__all__ = ["GoldDiff", "GoldDiffConfig", "GoldDiffEngine", "schedule_sizes",
           "coarse_screen", "golden_select"]


def coarse_screen(store: DatasetStore, q: torch.Tensor, m: int,
                  proxy_factor: int) -> torch.Tensor:
    """Top-m candidate indices by proxy distance, ties to the lowest
    index.  q: [B, D] -> [B, m]."""
    q_img = q.reshape(q.shape[:-1] + tuple(store.image_shape))
    qp = downsample_proxy(q_img, proxy_factor)
    d2 = ops.pdist(qp, store.proxy, x_norms=store.proxy_norms)
    return materialized_topm(d2, m)[0]


def golden_select(store: DatasetStore, q: torch.Tensor, cand: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Exact re-ranking inside the candidate set (Eq. 5). Returns [B, k]."""
    return ops.golden_rerank(q, store.X, cand, k, x_norms=store.x_norms)[0]


class GoldDiff:
    """Plug-and-play wrapper: GoldDiff(base_denoiser) (paper Tab. 5).

    GoldDiff always aggregates with the unbiased softmax: a base built
    with ``weighting="wss"`` is switched to "ss" (the base object
    itself, as in the reference).  ``screen=``/``screen_tile=`` pick the
    streamed or materialized coarse screen, ``fused=`` the single-pass
    fused step (Optimal base), and
    ``index=repro_torch.index.build_index(store)`` routes the coarse
    screen through the Golden Index (probe width by
    ``probe_schedule=``, steps by ``index_mode=``);
    ``storage_dtype=torch.bfloat16`` keeps the engine's store rows in
    bf16 (a patch base still reads its own fp32 store on the support),
    and ``strategy=`` picks the gather-vs-dense strategy; ``mesh=`` (a
    ``repro_torch.distributed.LocalMesh`` or ``ProcessMesh``) shards the
    store over ``shard_axis`` and the query batch over ``batch_axis``;
    all as in :class:`GoldDiffEngine`.  Over a mesh and a patch base the
    sharded selection runs over the mesh and the base then runs on the
    support (the reference's order).  Over a ``ProcessMesh`` the engine
    runs on the mesh's device (the card unless the mesh names another),
    ``store`` is the engine's copy on the host, and the rank's card holds
    only its slab: the Optimal base's steps are the engine's, and a patch
    base is bound to the rank (``PatchDenoiser.on_ranks``), so that it
    gathers each support's rows (and the PCA base's features, cached for
    the slab alone) from the ranks' slabs.  ``device`` is where queries
    and outputs live (the engine's)."""

    def __init__(self, base, cfg: GoldDiffConfig | None = None,
                 screen: str = "auto", screen_tile: int | None = None,
                 fused: str | bool = "auto", index=None,
                 probe_schedule=None, index_mode: str = "auto",
                 storage_dtype=None, strategy: str = "auto", mesh=None,
                 shard_axis: str = "data", batch_axis: str | None = None):
        self.store: DatasetStore = base.store
        ranks = is_process_mesh(mesh)
        self.base = base
        self.cfg = cfg or GoldDiffConfig()
        self.schedule: Schedule = base.schedule
        if getattr(base, "weighting", "ss") == "wss":
            base.weighting = "ss"
        self.name = f"golddiff+{base.name}"
        self.engine = GoldDiffEngine(self.store, self.schedule, self.cfg,
                                     device=None if ranks
                                     else self.store.device, screen=screen,
                                     screen_tile=screen_tile, fused=fused,
                                     index=index,
                                     probe_schedule=probe_schedule,
                                     index_mode=index_mode,
                                     storage_dtype=storage_dtype,
                                     strategy=strategy, mesh=mesh,
                                     shard_axis=shard_axis,
                                     batch_axis=batch_axis)
        self.device = self.engine.device
        if ranks:                 # the rows on the host, the slab on the card
            self.store = self.engine.store
            if not isinstance(base, OptimalDenoiser):
                base.on_ranks(self.engine)

    def select(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support S_t for each query; [B, k_t]."""
        return self.engine.select(x_t, int(t))

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None) -> torch.Tensor:
        if support is not None:
            return self.base(x_t, t, support=support)
        t = int(t)
        if isinstance(self.base, OptimalDenoiser):
            return self.engine.denoise(x_t, t)
        # a patch base computes its own logits on S_t (a PCA base builds
        # its feature cache for the step's patch size on first use)
        return self.base(x_t, t, support=self.select(x_t, t))

    def call_masked(self, x_t: torch.Tensor, t, caps=None) -> torch.Tensor:
        """The masked step (``GoldDiffEngine.denoise_masked``): shapes
        padded to ``caps`` (a ``plan.BucketCaps``; None pads to the worst
        case), m_t and k_t entering as masks; ``t`` a Python int or a
        0-d integer tensor on the store's device.  Optimal base only: a
        patch base needs the static patch size of each step."""
        if not isinstance(self.base, OptimalDenoiser):
            raise ValueError(
                f"the masked step needs the Optimal base; {self.name} "
                f"serves in static mode only (GoldDiff.__call__)")
        return self.engine.denoise_masked(x_t, t, caps)


class FullScan:
    """The engine's full scan (``GoldDiffEngine.full_scan``) over its own
    store rows, bf16 ones under ``storage_dtype``, as a denoiser: the
    exact posterior mean GoldDiff is held against on the same rows."""

    def __init__(self, engine: GoldDiffEngine):
        self.engine, self.store = engine, engine.store
        self.device = engine.device

    def __call__(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        return self.engine.full_scan(x_t, t)
