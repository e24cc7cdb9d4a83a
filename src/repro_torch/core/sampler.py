"""Reverse-process samplers driving an analytical denoiser.

Counterpart of ``repro.core.sampler``, DDIM (Song et al., 2020a) over an
evenly spaced sub-grid of the schedule, 10 steps by default, with
x0-prediction clipping:

* ``sample``      -- per-step loop of static steps (each at its own
  (m_t, k_t));
* ``sample_scan`` -- one masked body for every step (``caps=None``: the
  worst-case shapes), deterministic DDIM only;
* ``sample_plan`` -- one segment per bucket of a
  ``repro_torch.core.plan.TrajectoryPlan``, each padded only to its
  bucket's caps.  With ``program_cache`` and ``jitter`` (the engine's)
  each segment is built once per batch shape: on the card one captured
  CUDA graph, where the reference compiles one program;
* ``sample_conditional`` -- class-conditional generation through a
  denoiser over one class's sub-store (paper Tab. 3);
* ``denoise_trajectory`` -- deterministic DDIM from a given x_T, every
  step's state returned (paired comparisons: all methods from the same
  initial noise, Fig. 4).

``x_init`` replaces the internal terminal-noise draw with a
caller-supplied x_T (the serving engine's per-row noise, and how the
tests share noise with the JAX package: its ``jax.random`` stream
cannot be reproduced); for ``eta > 0`` the caller may pass ``sample``
the per-step noise.  The masked samplers pass each step's timestep as
a Python int and take a_t, b_t from the schedule's fp32 device tables
(``Schedule.tables``), as the reference's scan body indexes its fp32
arrays, so a segment touches no host value.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.schedules import Schedule, sampling_timesteps, take
from repro_torch.obs import trace as obs_trace


def _clip(x0: torch.Tensor, clip_value: float | None) -> torch.Tensor:
    return x0 if clip_value is None else torch.clamp(x0, -clip_value,
                                                     clip_value)


def _normal(shape: tuple, generator: torch.Generator | None,
            device: torch.device) -> torch.Tensor:
    # drawn on the CPU so a seed gives the same numbers on every device
    return torch.randn(shape, generator=generator).to(device)


def _init_noise(schedule: Schedule, t0: int, shape: tuple,
                generator: torch.Generator | None, device: torch.device,
                x_init: torch.Tensor | None) -> torch.Tensor:
    if x_init is not None:
        return torch.as_tensor(x_init).to(device)
    return float(schedule.b[t0]) * _normal(shape, generator, device)


def sample(denoiser: Callable, schedule: Schedule, shape: tuple,
           generator: torch.Generator | None = None, num_steps: int = 10,
           eta: float = 0.0, clip_value: float | None = 3.0,
           x_init: torch.Tensor | None = None,
           noise: Sequence[torch.Tensor] | None = None,
           trace: bool = False):
    """Per-step DDIM sampling on the denoiser's device; returns x0,
    and with ``trace=True`` also the stacked clipped x0 predictions of
    every step, [steps, *shape].

    ``generator`` (a CPU ``torch.Generator``) draws x_T when ``x_init``
    is None and, for ``eta > 0``, the per-step noise when ``noise``
    (one tensor of ``shape`` per step) is None."""
    device = denoiser.device
    ts = sampling_timesteps(schedule, num_steps)
    x = _init_noise(schedule, int(ts[0]), shape, generator, device, x_init)
    traj = []
    for i, (t, t_prev) in enumerate(zip(ts[:-1], ts[1:])):
        x0_hat = _clip(denoiser(x, int(t)), clip_value)
        step_noise = None
        if eta > 0:
            step_noise = (torch.as_tensor(noise[i]).to(device)
                          if noise is not None
                          else _normal(shape, generator, device))
        x = schedule.ddim_step(x, x0_hat, int(t), int(t_prev), eta,
                               step_noise)
        if trace:
            traj.append(x0_hat)
    if trace:
        return x, torch.stack(traj)
    return x


def sample_conditional(make_denoiser_for_class: Callable[[int], Callable],
                       schedule: Schedule, shape: tuple, class_id: int,
                       **kw):
    """``sample`` with the denoiser ``make_denoiser_for_class(class_id)``
    (e.g. one over ``dataset.restrict(store, rows of the class)``)."""
    return sample(make_denoiser_for_class(class_id), schedule, shape, **kw)


def denoise_trajectory(denoiser: Callable, schedule: Schedule,
                       x_T: torch.Tensor, num_steps: int = 10,
                       clip_value: float | None = 3.0
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Deterministic DDIM from a given terminal noise ``x_T`` (moved to
    the denoiser's device): ``(x_0, [x_T, ..., x_0])``."""
    ts = sampling_timesteps(schedule, num_steps)
    x = torch.as_tensor(x_T).to(denoiser.device)
    xs = [x]
    for t, t_prev in zip(ts[:-1], ts[1:]):
        x0_hat = _clip(denoiser(x, int(t)), clip_value)
        x = schedule.ddim_step(x, x0_hat, int(t), int(t_prev))
        xs.append(x)
    return x, xs


def _masked_step(denoise_masked: Callable, schedule: Schedule,
                 x: torch.Tensor, t: int, t_prev: int, caps,
                 clip_value: float | None) -> torch.Tensor:
    """One deterministic DDIM step of a masked body, with the fp32
    a_t, b_t of the schedule's device tables."""
    a, b, _ = schedule.tables(x.device)
    x0_hat = _clip(denoise_masked(x, t, caps), clip_value)
    eps_hat = (x - take(a, t) * x0_hat) / take(b, t)
    return take(a, t_prev) * x0_hat + take(b, t_prev) * eps_hat


def _device_of(denoise_masked: Callable) -> torch.device:
    """The device of a masked body's owner (``GoldDiff.call_masked`` or
    ``GoldDiffEngine.denoise_masked``)."""
    return denoise_masked.__self__.device


def sample_scan(denoise_masked: Callable, schedule: Schedule, shape: tuple,
                generator: torch.Generator | None = None,
                num_steps: int = 10, clip_value: float | None = 3.0,
                x_init: torch.Tensor | None = None) -> torch.Tensor:
    """DDIM with one masked body (``caps=None``) at every step.
    Deterministic only: there is no ``eta``, and passing one is a
    ``TypeError``."""
    ts = [int(t) for t in sampling_timesteps(schedule, num_steps)]
    x = _init_noise(schedule, ts[0], shape, generator,
                    _device_of(denoise_masked), x_init)
    for t, t_prev in zip(ts[:-1], ts[1:]):
        x = _masked_step(denoise_masked, schedule, x, t, t_prev, None,
                         clip_value)
    return x


def plan_segment(denoise_masked: Callable, schedule: Schedule, plan, bucket,
                 clip_value: float | None = 3.0) -> Callable:
    """One plan bucket's steps as a standalone ``x -> x`` function, so
    the serving runtime can run and re-enter single segments;
    ``sample_plan`` chains the same functions."""
    ts = [int(t) for t in plan.ts]

    def segment(x):
        for i in range(bucket.start, bucket.stop):
            x = _masked_step(denoise_masked, schedule, x, ts[i], ts[i + 1],
                             bucket.caps, clip_value)
        return x
    return segment


def _clip_key(clip_value: float | None):
    return None if clip_value is None else float(clip_value)


def plan_segment_key(plan, bucket, shape: tuple, dtype_str: str,
                     clip_value: float | None) -> tuple:
    """The program-cache key of one plan segment (shared by
    ``sample_plan``'s build and run paths, so what warmup built is
    always a hit)."""
    return ("plan_seg", bucket.start, bucket.stop, bucket.caps.sig(),
            tuple(plan.ts), tuple(shape), dtype_str, _clip_key(clip_value))


def plan_segment_mixed(denoise_masked: Callable, schedule: Schedule, plan,
                       bucket, clip_value: float | None = 3.0) -> Callable:
    """A plan segment that advances only some of its rows.

    ``segment(x, pos)`` runs :func:`plan_segment`'s steps, but row ``r``
    carries a grid cursor ``pos[r]`` (integer) and only rows at this
    bucket's entry seam (``pos[r] == bucket.start``) take the DDIM
    update; the others pass through unchanged (``torch.where`` on the
    carry).  Every op is row-independent, so the active rows equal the
    same rows run through :func:`plan_segment`.  The frozen rows still
    flow through the denoiser and are discarded, which keeps one
    program per (plan bucket x batch bucket)."""
    ts = [int(t) for t in plan.ts]

    def segment(x, pos):
        active = (pos == bucket.start)[:, None]
        for i in range(bucket.start, bucket.stop):
            x_next = _masked_step(denoise_masked, schedule, x, ts[i],
                                  ts[i + 1], bucket.caps, clip_value)
            x = torch.where(active, x_next, x)
        return x
    return segment


def plan_segment_mixed_key(plan, bucket, shape: tuple, dtype_str: str,
                           clip_value: float | None) -> tuple:
    """The program-cache key of a mixed-cursor segment: the anatomy of
    :func:`plan_segment_key` under its own kind, so the plain and the
    mixed program of one bucket live side by side and both get warmed."""
    return ("plan_seg_mix",) + plan_segment_key(plan, bucket, shape,
                                                 dtype_str, clip_value)[1:]


def _dtype_str(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def sample_plan(denoise_masked: Callable, schedule: Schedule, shape: tuple,
                plan, generator: torch.Generator | None = None,
                clip_value: float | None = 3.0,
                x_init: torch.Tensor | None = None,
                program_cache: Callable | None = None,
                compile_only: bool = False,
                jitter: Callable | None = None) -> torch.Tensor | None:
    """Bucketed DDIM: one segment per bucket of ``plan`` (built for this
    schedule), ``denoise_masked`` taking ``(x, t, caps)`` (e.g.
    ``GoldDiff.call_masked``).  The DDIM update equals
    :func:`sample_scan`'s; only the partition differs, and each
    bucket's masks reproduce the static per-step shapes, so plan, scan
    and static outputs agree to fp32 reduction order.  Deterministic
    DDIM only.

    ``program_cache(key, build)`` (e.g. ``GoldDiffEngine.program``)
    keeps each segment per batch shape: ``plan.num_buckets`` builds the
    first time, none afterwards.  ``jitter`` (e.g.
    ``GoldDiffEngine.jitter``) builds each cached segment: on the card
    one captured CUDA graph.  With the tracer enabled each segment runs
    in a ``plan.segment`` span (the card synchronized inside it).
    ``compile_only=True`` fills the cache for
    an fp32 input of ``shape`` without sampling a trajectory (the
    serving warmup; each capture runs its segment once on zeros) and
    returns None."""
    def build(bucket, shp):
        seg = plan_segment(denoise_masked, schedule, plan, bucket,
                           clip_value)
        if jitter is None:
            return lambda: seg
        return lambda: jitter(seg, shp, label=(
            f"plan segment steps [{bucket.start}, {bucket.stop}) caps "
            f"{bucket.caps.sig()} at shape {shp}"))

    if compile_only:
        if program_cache is None:
            raise ValueError("compile_only needs a program_cache to hold "
                             "the built segments")
        for bucket in plan.buckets:
            program_cache(plan_segment_key(plan, bucket, shape, "float32",
                                           clip_value),
                          build(bucket, tuple(shape)))
        return None

    x = _init_noise(schedule, int(plan.ts[0]), shape, generator,
                    _device_of(denoise_masked), x_init)
    tr = obs_trace.tracer()
    for bi, bucket in enumerate(plan.buckets):
        shp = tuple(x.shape)
        if program_cache is None:
            fn = plan_segment(denoise_masked, schedule, plan, bucket,
                              clip_value)
        else:
            fn = program_cache(plan_segment_key(plan, bucket, shp,
                                                _dtype_str(x.dtype),
                                                clip_value),
                               build(bucket, shp))
        if not tr.enabled:
            x = fn(x)
            continue
        with tr.span("plan.segment", bucket=bi, start=bucket.start,
                     stop=bucket.stop, caps=bucket.caps.sig(),
                     shape=tuple(x.shape)):
            x = fn(x)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
    return x
