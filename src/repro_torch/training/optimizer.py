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

On DTensor leaves (a mesh) the same update runs in place on each rank's
shards: a gradient is first put on its moment's placements (the
parameters' own, or ZeRO-1's when ``init_state`` was given other
placements), and a parameter takes its new value from the master on
its own placements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.module import tree_leaves


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


def _on(t: torch.Tensor, placements) -> torch.Tensor:
    """A DTensor on ``placements`` (a no-op for a plain tensor or the
    same placements)."""
    if placements is None or not is_dtensor(t) or \
            tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over two trees of one shape (``other``
    None: ``fn(leaf, None)``)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, None if other is None else other[k])
                for k, v in tree.items()}
    return fn(tree, other)


def init_state(params: dict, placements: dict | None = None) -> AdamWState:
    """Zero moments and an fp32 master copy (a copy even of fp32
    leaves: the update overwrites the master in place).  ``placements``
    (a tree like ``params``, DTensor leaves only) puts the three on
    other placements than the parameters' (ZeRO-1)."""
    leaf = next(t for _, t in tree_leaves(params))

    def zeros(t, pl):
        return _on(torch.zeros_like(t, dtype=torch.float32), pl)
    master = _map2(lambda t, pl: _on(t.detach().float().clone(), pl),
                   params, placements)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      _map2(zeros, params, placements),
                      _map2(zeros, params, placements), master)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 sums of squares, the leaves in
    ``tree_leaves`` order (the reference's)."""
    return _norm(x for _, x in tree_leaves(tree))


def _norm(leaves) -> torch.Tensor:
    total = 0
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: AdamWState):
    """One AdamW step in place.  Returns ``(params, state, metrics)``:
    the same parameter dict (each leaf the new master in its dtype), the
    state with m, v and master updated and ``step + 1``, and
    ``{"grad_norm", "lr"}`` as 0-d device tensors."""
    m_of, v_of = dict(tree_leaves(state.m)), dict(tree_leaves(state.v))
    ma_of, p_of = dict(tree_leaves(state.master)), dict(tree_leaves(params))
    grads = [(path, _on(g, m_of[path].placements if is_dtensor(m_of[path])
                        else None)) for path, g in tree_leaves(grads)]
    mesh = contextlib.nullcontext()
    if any(is_dtensor(g) for _, g in grads):
        from torch.distributed.tensor.experimental import implicit_replication
        mesh = implicit_replication()
    with mesh:
        return _apply(cfg, params, grads, state, m_of, v_of, ma_of, p_of)


def _apply(cfg, params, grads, state, m_of, v_of, ma_of, p_of):
    gnorm = _norm(g for _, g in grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    with torch.no_grad():
        for path, g in grads:
            m, v, master = m_of[path], v_of[path], ma_of[path]
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            upd += cfg.weight_decay * master
            master -= lr * upd
            p = p_of[path]
            p.copy_(_on(master, p.placements if is_dtensor(p) else None))
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
