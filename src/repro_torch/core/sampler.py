"""Reverse-process sampler driving an analytical denoiser.

Counterpart of ``repro.core.sampler.sample``: per-step DDIM (Song et
al., 2020a) over an evenly spaced sub-grid of the schedule, 10 steps by
default, with x0-prediction clipping.  ``x_init`` replaces the internal
terminal-noise draw with a caller-supplied x_T; for ``eta > 0`` the
caller may pass the per-step noise, which is how the tests share noise
with the JAX package (its ``jax.random`` stream cannot be reproduced).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.schedules import Schedule, sampling_timesteps


def _clip(x0: torch.Tensor, clip_value: float | None) -> torch.Tensor:
    return x0 if clip_value is None else torch.clamp(x0, -clip_value,
                                                     clip_value)


def _normal(shape: tuple, generator: torch.Generator | None,
            device: torch.device) -> torch.Tensor:
    # drawn on the CPU so a seed gives the same numbers on every device
    return torch.randn(shape, generator=generator).to(device)


def sample(denoiser: Callable, schedule: Schedule, shape: tuple,
           generator: torch.Generator | None = None, num_steps: int = 10,
           eta: float = 0.0, clip_value: float | None = 3.0,
           x_init: torch.Tensor | None = None,
           noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """Per-step DDIM sampling on the denoiser's store device; returns x0.

    ``generator`` (a CPU ``torch.Generator``) draws x_T when ``x_init``
    is None and, for ``eta > 0``, the per-step noise when ``noise``
    (one tensor of ``shape`` per step) is None."""
    device = denoiser.store.device
    ts = sampling_timesteps(schedule, num_steps)
    if x_init is not None:
        x = torch.as_tensor(x_init).to(device)
    else:
        x = float(schedule.b[int(ts[0])]) * _normal(shape, generator, device)
    for i, (t, t_prev) in enumerate(zip(ts[:-1], ts[1:])):
        x0_hat = _clip(denoiser(x, int(t)), clip_value)
        step_noise = None
        if eta > 0:
            step_noise = (torch.as_tensor(noise[i]).to(device)
                          if noise is not None
                          else _normal(shape, generator, device))
        x = schedule.ddim_step(x, x0_hat, int(t), int(t_prev), eta,
                               step_noise)
    return x
