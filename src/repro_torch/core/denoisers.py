"""Analytical denoisers: map ``x_t: [B, D]`` at timestep ``t`` to the
posterior-mean estimate ``x0_hat: [B, D]``.

Counterpart of ``repro.core.denoisers``; the port has the
``OptimalDenoiser`` (exact empirical-Bayes posterior mean, Eq. 2) with
its full scan and its golden ``support=`` path, both through
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.core.dataset import DatasetStore
from repro_torch.core.schedules import Schedule
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device


class OptimalDenoiser:
    """Exact posterior mean over the training set (or a golden support).

    The store moves to ``device`` (the CUDA card unless the caller
    passes another; raises when there is none)."""

    name = "optimal"

    def __init__(self, store: DatasetStore, schedule: Schedule, device=None):
        self.store = store.to(resolve_device(device))
        self.schedule = schedule

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None) -> torch.Tensor:
        a = float(self.schedule.a[t])
        sig2 = float(self.schedule.sigma_np(t)) ** 2
        if support is not None:
            return self._on_support(x_t, a, sig2, support)
        return ops.golden_aggregate(x_t / a, self.store.X, sig2,
                                    x_norms=self.store.x_norms).to(x_t.dtype)

    def _on_support(self, x_t, a: float, sig2: float, idx) -> torch.Tensor:
        q = x_t / a                                # [B, D]
        d2 = ops.support_distances(q, self.store.X, idx,
                                   x_norms=self.store.x_norms)
        lg = -d2 / (2.0 * sig2)
        return ops.golden_support_aggregate(self.store.X, idx,
                                            lg).to(x_t.dtype)


DENOISERS = {"optimal": OptimalDenoiser}


def make_denoiser(name: str, store: DatasetStore, schedule: Schedule, **kw):
    if name not in DENOISERS:
        raise NotImplementedError(
            f"denoiser {name!r} is not ported yet (ROADMAP Queue 1: the "
            f"rest of core/); the port has {sorted(DENOISERS)}")
    return DENOISERS[name](store, schedule, **kw)
