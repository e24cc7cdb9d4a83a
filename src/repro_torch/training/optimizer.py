"""AdamW + cosine schedule + global-norm clipping on tensors (counterpart
of ``repro.training.optimizer``).

The state is fp32 whatever the parameters' dtype: the moments m, v and a
master copy of the parameters, so bf16 parameters are the master rounded
once a step.  ``step`` is a 0-d int tensor on the parameters' device and
every quantity derived from it (the learning rate, the bias corrections,
the clip scale) stays there: a step reads nothing back to the host.

Each operation is the reference's, in its order, so an update agrees
with the reference's to the last bit or two of fp32.  ``apply_updates``
works in place: it overwrites the parameters, m, v and master it is
given (the reference returns new trees; the port keeps one copy of the
38 GB of state a full-width model holds).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict
    master: dict       # fp32 master copy of the params


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor): linear warmup over
    ``warmup_steps``, then a cosine from ``lr`` down to ``min_lr_frac`` of
    it at ``total_steps``; fp32."""
    step = torch.as_tensor(step)
    warm = cfg.lr * torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1),
                                    1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(params: dict) -> AdamWState:
    """Zero moments and an fp32 master copy (a copy even of fp32
    leaves: the update overwrites the master in place)."""
    leaf = next(t for _, t in tree_leaves(params))
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                  device=t.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      tree_map(zeros, params), tree_map(zeros, params),
                      tree_map(lambda t: t.detach().float().clone(), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 sums of squares, the leaves in
    ``tree_leaves`` order (the reference's)."""
    total = 0
    for _, x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: AdamWState):
    """One AdamW step in place.  Returns ``(params, state, metrics)``:
    the same parameter dict (each leaf the new master in its dtype), the
    state with m, v and master updated and ``step + 1``, and
    ``{"grad_norm", "lr"}`` as 0-d device tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    m_of, v_of = dict(tree_leaves(state.m)), dict(tree_leaves(state.v))
    ma_of, p_of = dict(tree_leaves(state.master)), dict(tree_leaves(params))
    with torch.no_grad():
        for path, g in tree_leaves(grads):
            m, v, master = m_of[path], v_of[path], ma_of[path]
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            upd += cfg.weight_decay * master
            master -= lr * upd
            p_of[path].copy_(master)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
