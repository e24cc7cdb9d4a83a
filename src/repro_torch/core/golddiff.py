"""GoldDiff: Dynamic Time-Aware Golden Subset selection (paper Sec. 3.4).

Counterpart of ``repro.core.golddiff``: each timestep screens a
candidate set C_t of size m_t by proxy distance (Eq. 4), re-ranks it
exactly to the golden support S_t of size k_t (Eq. 6), and evaluates
the Optimal base's unbiased softmax on S_t.  ``__call__`` runs a static
step; ``call_masked`` the masked step that plans and scans chain.
Execution is delegated to :class:`repro_torch.core.engine.GoldDiffEngine`,
on the base denoiser's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.dataset import DatasetStore
from repro_torch.core.denoisers import OptimalDenoiser
from repro_torch.core.engine import (GoldDiffConfig, GoldDiffEngine,
                                     schedule_sizes)
from repro_torch.core.schedules import Schedule

__all__ = ["GoldDiff", "GoldDiffConfig", "GoldDiffEngine", "schedule_sizes"]


class GoldDiff:
    """Plug-and-play wrapper: GoldDiff(base_denoiser) (paper Tab. 5).

    ``screen=``/``screen_tile=`` pick the streamed or materialized
    coarse screen, ``fused=`` the single-pass fused step, and
    ``index=repro_torch.index.build_index(store)`` routes the coarse
    screen through the Golden Index (probe width by
    ``probe_schedule=``, steps by ``index_mode=``); all as in
    :class:`GoldDiffEngine`."""

    def __init__(self, base, cfg: GoldDiffConfig | None = None,
                 screen: str = "auto", screen_tile: int | None = None,
                 fused: str | bool = "auto", index=None,
                 probe_schedule=None, index_mode: str = "auto"):
        if not isinstance(base, OptimalDenoiser):
            raise NotImplementedError(
                "GoldDiff over a patch-family base is not ported yet "
                "(ROADMAP Queue 1: the rest of core/); the port wraps "
                "OptimalDenoiser")
        self.base = base
        self.cfg = cfg or GoldDiffConfig()
        self.store: DatasetStore = base.store
        self.schedule: Schedule = base.schedule
        self.name = f"golddiff+{base.name}"
        self.engine = GoldDiffEngine(self.store, self.schedule, self.cfg,
                                     device=self.store.device, screen=screen,
                                     screen_tile=screen_tile, fused=fused,
                                     index=index,
                                     probe_schedule=probe_schedule,
                                     index_mode=index_mode)

    def select(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support S_t for each query; [B, k_t]."""
        return self.engine.select(x_t, int(t))

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None) -> torch.Tensor:
        if support is not None:
            return self.base(x_t, t, support=support)
        return self.engine.denoise(x_t, int(t))

    def call_masked(self, x_t: torch.Tensor, t, caps=None) -> torch.Tensor:
        """The masked step (``GoldDiffEngine.denoise_masked``): shapes
        padded to ``caps`` (a ``plan.BucketCaps``; None pads to the worst
        case), m_t and k_t entering as masks; ``t`` a Python int or a
        0-d integer tensor on the store's device."""
        return self.engine.denoise_masked(x_t, t, caps)
