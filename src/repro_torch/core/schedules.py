"""Diffusion forward-process schedules.

Counterpart of ``repro.core.schedules``: every schedule is the affine
form ``x_t = a_t * x_0 + b_t * eps`` with host-side numpy ``a``/``b``
(built by the same numpy code, so the grids are equal), and the DDIM
update acts on tensors.  ``sigma(t)`` / ``g(t)`` are the traced forms
of the masked path: fp32, as the reference computes them under default
(non-x64) JAX, read from tables built once per schedule and device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A discretized forward process with ``num_steps + 1`` grid points;
    t = 0 is (almost) clean data, t = num_steps is (almost) pure noise."""

    name: str
    a: np.ndarray  # signal coefficient, shape [T+1]
    b: np.ndarray  # noise coefficient, shape [T+1]
    # fp32 (a, b, g) tables per device, filled by ``tables``
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def num_steps(self) -> int:
        return len(self.a) - 1

    def sigma_np(self, t) -> np.ndarray:
        """Noise-to-signal ratio sigma_t = b_t / a_t (paper's sigma_t)."""
        return self.b[t] / self.a[t]

    def g_np(self, t) -> float:
        """Normalized noise level g(sigma_t) in [0, 1] (paper Eq. 4/6):
        log-linear between the smallest and largest sigma on the grid."""
        sig = np.log(self.b[1:] / self.a[1:])
        lo, hi = sig.min(), sig.max()
        t = int(np.clip(t, 1, self.num_steps))
        return float(np.clip((np.log(self.sigma_np(t)) - lo) / (hi - lo),
                             0.0, 1.0))

    def tables(self, device) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """fp32 ``(a, b, g)`` tables [T+1] on ``device``, built once.

        ``g`` is computed on the CPU in fp32 (``torch.log``) and moved,
        so every device reads the same values, and a CUDA graph that
        indexes them captures no host-to-device copy."""
        device = torch.device(device)
        if device not in self._tables:
            a = torch.tensor(self.a, dtype=torch.float32)
            b = torch.tensor(self.b, dtype=torch.float32)
            sig = torch.log(b[1:] / a[1:])
            lo, hi = sig.min(), sig.max()
            t = torch.arange(self.num_steps + 1).clamp(1, self.num_steps)
            g = torch.clamp((torch.log(b[t] / a[t]) - lo) / (hi - lo),
                            0.0, 1.0)
            self._tables[device] = tuple(v.to(device) for v in (a, b, g))
        return self._tables[device]

    def sigma(self, t, device=None) -> torch.Tensor:
        """fp32 sigma_t = b_t / a_t for an integer tensor ``t`` (or a
        Python int, read on ``device``)."""
        a, b, _ = self.tables(t.device if isinstance(t, torch.Tensor)
                              else device)
        return take(b, t) / take(a, t)

    def g(self, t, device=None) -> torch.Tensor:
        """fp32 g(sigma_t) for an integer tensor ``t`` (or a Python int,
        read on ``device``); t is clipped to [1, T], as in ``g_np``."""
        return take(self.tables(t.device if isinstance(t, torch.Tensor)
                                else device)[2], t)

    def ddim_step(self, x_t: torch.Tensor, x0_hat: torch.Tensor, t: int,
                  t_prev: int, eta: float = 0.0,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
        """Deterministic (eta=0) or stochastic DDIM update t -> t_prev."""
        a_t = float(self.a[t]); b_t = float(self.b[t])
        a_p = float(self.a[t_prev]); b_p = float(self.b[t_prev])
        eps_hat = (x_t - a_t * x0_hat) / b_t
        if eta == 0.0 or noise is None:
            return a_p * x0_hat + b_p * eps_hat
        # VP-style stochastic interpolation; the coefficients round to
        # fp32 where the reference computes them in fp32
        f32 = np.float32
        root = np.sqrt(f32(max(b_t**2 - (a_t * b_p / a_p) ** 2, 0.0)))
        sig = f32(eta * b_p / b_t) * root / f32(b_t)
        dir_coeff = np.sqrt(np.maximum(f32(b_p**2) - sig * sig, f32(0.0)))
        return a_p * x0_hat + float(dir_coeff) * eps_hat + float(sig) * noise


def take(table: torch.Tensor, t) -> torch.Tensor:
    """``table[t]`` for a Python int or an integer tensor of any shape on
    the table's device, without a host round trip (an int gives a view;
    a tensor an ``index_select``, which a CUDA graph can capture)."""
    if not isinstance(t, torch.Tensor):
        return table[int(t)]
    return torch.index_select(table, 0, t.reshape(-1)).reshape(t.shape)


def ddpm_linear(num_steps: int = 1000, beta_start: float = 1e-4,
                beta_end: float = 2e-2) -> Schedule:
    betas = np.linspace(beta_start, beta_end, num_steps)
    alpha_bar = np.cumprod(1.0 - betas)
    a = np.concatenate([[1.0], np.sqrt(alpha_bar)])
    b = np.concatenate([[0.0 + 1e-4], np.sqrt(1.0 - alpha_bar)])
    return Schedule("ddpm_linear", a, b)


SCHEDULES = {"ddpm_linear": ddpm_linear}


def make_schedule(name: str, num_steps: int = 1000, **kw) -> Schedule:
    if name not in SCHEDULES:
        raise NotImplementedError(
            f"schedule {name!r} is not ported yet; the port has "
            f"{sorted(SCHEDULES)}")
    return SCHEDULES[name](num_steps=num_steps, **kw)


def sampling_timesteps(schedule: Schedule, num_sampling_steps: int) -> np.ndarray:
    """Evenly spaced (in index space) decreasing grid incl. endpoints."""
    T = schedule.num_steps
    ts = np.unique(np.linspace(0, T, num_sampling_steps + 1).round().astype(int))
    return ts[::-1]  # T ... 0
