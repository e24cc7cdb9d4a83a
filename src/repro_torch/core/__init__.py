"""Core analytical-diffusion library, PyTorch port of ``repro.core``."""
from repro_torch.core.dataset import (DatasetStore, downsample_proxy,
                                      make_store, store_from_numpy)
from repro_torch.core.denoisers import (DENOISERS, OptimalDenoiser,
                                        make_denoiser)
from repro_torch.core.engine import GoldDiffEngine
from repro_torch.core.golddiff import GoldDiff, GoldDiffConfig, schedule_sizes
from repro_torch.core.plan import (BucketCaps, PlanBucket, StepShape,
                                   TrajectoryPlan, build_plan,
                                   full_scan_costs, fused_step_costs,
                                   step_shapes, step_stage_costs)
from repro_torch.core.sampler import (plan_segment, plan_segment_key,
                                      plan_segment_mixed, sample,
                                      sample_plan, sample_scan)
from repro_torch.core.schedules import (Schedule, make_schedule,
                                        sampling_timesteps)

__all__ = [
    "DatasetStore", "downsample_proxy", "make_store", "store_from_numpy",
    "DENOISERS", "OptimalDenoiser", "make_denoiser",
    "GoldDiff", "GoldDiffConfig", "GoldDiffEngine", "schedule_sizes",
    "BucketCaps", "PlanBucket", "StepShape", "TrajectoryPlan", "build_plan",
    "full_scan_costs", "fused_step_costs", "step_shapes", "step_stage_costs",
    "plan_segment", "plan_segment_key", "plan_segment_mixed",
    "sample", "sample_plan", "sample_scan",
    "Schedule", "make_schedule", "sampling_timesteps",
]
