"""Time-aware probe schedule: how many clusters to visit at noise sigma_t.

Counterpart of ``repro.index.schedule`` (the host-side rule).  The
normalized noise level g(sigma_t) in [0, 1] interpolates between two
probed fractions of the C clusters,

    nprobe_t = ceil(C * (f_lo + (f_hi - f_lo) * g(sigma_t)))

wide at low SNR (g -> 1, a diffuse posterior) and a handful of clusters
at high SNR (g -> 0, the golden support has collapsed onto a local
neighborhood).  Two safety terms keep recall honest: a capacity floor
``ceil(safety * m_t * C / N)`` (the probed clusters must plausibly hold
the candidate budget m_t) and an absolute ``min_probes``.  When the
floor pushes nprobe_t past the platform's crossover the engine screens
that step exactly (``GoldDiffEngine.use_index``).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ProbeSchedule:
    """nprobe_t = clip(max(snr_term, capacity_floor, min_probes), 1, C)."""

    f_lo: float = 1 / 16     # probed fraction of clusters at g = 0 (high SNR)
    f_hi: float = 1.0        # probed fraction at g = 1 (low SNR)
    safety: float = 2.0      # capacity floor: probed rows >= safety * m_t
    min_probes: int = 4

    def nprobe(self, g: float, m_t: int, n: int, num_clusters: int) -> int:
        """Host-side probe count for a static timestep."""
        c = num_clusters
        snr = math.ceil(c * (self.f_lo + (self.f_hi - self.f_lo) * g))
        cap = math.ceil(self.safety * m_t * c / n)
        return int(min(max(snr, cap, self.min_probes, 1), c))


__all__ = ["ProbeSchedule"]
