"""Paper-side presets: dataset x denoiser x GoldDiff hyperparameters.

Counterpart of ``repro.configs.golddiff``.  Paper defaults (Sec. 4.1):
m_min = k_max = N/10, m_max = N/4, k_min = N/20, 10 DDIM steps, proxy =
4x spatial downsample; every preset but ``moons`` runs the PCA base.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.golddiff import GoldDiffConfig


@dataclasses.dataclass(frozen=True)
class ExperimentPreset:
    dataset: str
    dataset_kw: dict
    schedule: str = "ddpm_linear"
    num_steps: int = 10            # sampling steps (paper default)
    base_denoiser: str = "pca"
    golddiff: GoldDiffConfig = GoldDiffConfig()


PRESETS = {
    "moons": ExperimentPreset("moons", {"n": 2000}, base_denoiser="optimal"),
    "mnist": ExperimentPreset("mnist_like", {"n": 4096}),
    "fashion": ExperimentPreset("mnist_like", {"n": 4096, "seed": 7}),
    "cifar10": ExperimentPreset("cifar_like", {"n": 8192}),
    "celeba": ExperimentPreset("celeba_like", {"n": 4096}),
    "afhq": ExperimentPreset("afhq_like", {"n": 4096}),
    "imagenet": ExperimentPreset("imagenet_like",
                                 {"n": 20000, "num_classes": 1000}),
}
