"""GoldDiff execution engine: coarse screen -> exact re-rank -> aggregate.

Counterpart of ``repro.core.engine`` for one device, exact (non-indexed)
screening, staged steps.  That is the path the JAX engine itself takes
with its kernel backend at batch 16 on a GPU-sized store: the [B, N]
screen stays materialized (``use_stream``), the re-rank and aggregate
gather (the build-time strategy, since m_max / N = 0.25 <= 0.35), so
``use_fused`` leaves the step staged.  Every stage goes through
``repro_torch.kernels.ops``: the pdist screen, the by-index re-rank
distances and the by-index golden aggregate on the card, their plain
versions on CPU.

PyTorch runs eagerly, so there is no program cache: each step runs its
own static (m_t, k_t), which is the paper's per-step FLOP saving.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.dataset import DatasetStore, downsample_proxy
from repro_torch.core.schedules import Schedule
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GoldDiffConfig:
    """Subset-size schedules as fractions of N (paper defaults, Sec. 4.1)."""

    m_min_frac: float = 1 / 10   # = k_max (paper: random N/10 matches full)
    m_max_frac: float = 1 / 4
    k_min_frac: float = 1 / 20
    k_max_frac: float = 1 / 10
    proxy_factor: int = 4

    def sizes(self, n: int) -> tuple[int, int, int, int]:
        m_min = max(1, int(n * self.m_min_frac))
        m_max = max(m_min, int(n * self.m_max_frac))
        k_min = max(1, int(n * self.k_min_frac))
        k_max = max(k_min, int(n * self.k_max_frac))
        k_max = min(k_max, m_min)  # golden set always fits the candidate set
        return m_min, m_max, k_min, k_max


def schedule_sizes(cfg: GoldDiffConfig, schedule: Schedule, t: int,
                   n: int) -> tuple[int, int]:
    """(m_t, k_t) for integer timestep t (static mode; Eqs. 4/6)."""
    g = schedule.g_np(t)
    m_min, m_max, k_min, k_max = cfg.sizes(n)
    m_t = int(math.floor(m_min + (m_max - m_min) * (1.0 - g)))
    k_t = int(math.floor(k_min + (k_max - k_min) * g))
    return max(1, min(m_t, n)), max(1, min(k_t, m_t, n))


class GoldDiffEngine:
    """Kernel routing for the GoldDiff pipeline on one device.

    The store moves to ``device`` (the CUDA card unless the caller
    passes another; raises when there is none)."""

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 cfg: GoldDiffConfig | None = None, device=None):
        self.store = store.to(resolve_device(device))
        self.schedule = schedule
        self.cfg = cfg or GoldDiffConfig()
        self._consts: dict[int, tuple[float, float]] = {}
        self._sizes: dict[int, tuple[int, int]] = {}

    # -- precomputed per-timestep constants ----------------------------------
    def sizes(self, t: int) -> tuple[int, int]:
        if t not in self._sizes:
            self._sizes[t] = schedule_sizes(self.cfg, self.schedule, t,
                                            self.store.n)
        return self._sizes[t]

    def constants(self, t: int) -> tuple[float, float]:
        """(a_t, sigma_t^2) as host floats."""
        if t not in self._consts:
            a = float(self.schedule.a[t])
            sig2 = float(self.schedule.sigma_np(t)) ** 2
            self._consts[t] = (a, sig2)
        return self._consts[t]

    # -- pipeline stages ------------------------------------------------------
    def _proxy_query(self, q: torch.Tensor) -> torch.Tensor:
        q_img = q.reshape(q.shape[:-1] + tuple(self.store.image_shape))
        return downsample_proxy(q_img, self.cfg.proxy_factor)

    def coarse(self, q: torch.Tensor, m: int) -> torch.Tensor:
        """Top-m candidates by exact proxy distance; [B, m]."""
        return ops.screen_topm(self._proxy_query(q), self.store.proxy, m,
                               x_norms=self.store.proxy_norms)[0]

    def _select_body(self, q: torch.Tensor, t: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(idx, d2) of the golden support for a rescaled query."""
        m_t, k_t = self.sizes(t)
        cand = self.coarse(q, m_t)
        return ops.golden_rerank(q, self.store.X, cand, k_t,
                                 x_norms=self.store.x_norms)

    def _select_ids_body(self, q: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support as dataset row ids."""
        return self._select_body(q, t)[0]

    def _denoise_body(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Staged step: coarse -> rerank -> aggregate, distances computed
        exactly once."""
        a, sig2 = self.constants(t)
        q = x_t / a
        idx, d2 = self._select_body(q, t)
        lg = torch.clamp_min(-d2 / (2.0 * sig2), NEG_INF)
        out = ops.golden_support_aggregate(self.store.X, idx, lg)
        return out.to(x_t.dtype)

    # -- public entry points --------------------------------------------------
    def select(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Golden support S_t for each query; [B, k_t]."""
        t = int(t)
        a, _ = self.constants(t)
        return self._select_ids_body(x_t / a, t)

    def denoise(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Full GoldDiff step for the Optimal base (unbiased SS on S_t)."""
        return self._denoise_body(x_t, int(t))

    def full_scan(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Exact posterior mean over the whole store (Eq. 2)."""
        a, sig2 = self.constants(int(t))
        return ops.golden_aggregate(x_t / a, self.store.X, sig2,
                                    x_norms=self.store.x_norms
                                    ).to(x_t.dtype)
