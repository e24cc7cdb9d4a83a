"""Core analytical-diffusion library, PyTorch port of ``repro.core``."""
from repro_torch.core.dataset import (DatasetStore, downsample_proxy,
                                      make_store, store_from_numpy)
from repro_torch.core.denoisers import (DENOISERS, OptimalDenoiser,
                                        make_denoiser)
from repro_torch.core.engine import GoldDiffEngine
from repro_torch.core.golddiff import GoldDiff, GoldDiffConfig, schedule_sizes
from repro_torch.core.sampler import sample
from repro_torch.core.schedules import (Schedule, make_schedule,
                                        sampling_timesteps)

__all__ = [
    "DatasetStore", "downsample_proxy", "make_store", "store_from_numpy",
    "DENOISERS", "OptimalDenoiser", "make_denoiser",
    "GoldDiff", "GoldDiffConfig", "GoldDiffEngine", "schedule_sizes",
    "sample",
    "Schedule", "make_schedule", "sampling_timesteps",
]
