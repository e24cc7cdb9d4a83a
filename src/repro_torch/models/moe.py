"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): grouped
GShard-style top-k dispatch.

Tokens are routed in groups of ``group_size``; each expert takes at most
``cap = max(1, ceil(group * k / E * capacity_factor))`` tokens of a
group.  The reference's rules, kept exactly because they decide which
tokens an expert drops:

  * the router runs in fp32; the top-k over its softmax breaks ties to
    the lowest expert (``lax.top_k``'s order: a stable descending sort);
  * the gates are renormalised over the chosen support (floor 1e-9);
  * queue positions are a fp32 cumsum in choice-major order: every
    token's first choice queues before any token's second choice;
  * a slot at or past ``cap`` is dropped;
  * dispatch and combine are dense one-hot tensors [G, T, E, C] in the
    activation dtype (the gates are rounded to it in combine), so no
    shape depends on the data and a decode step stays one CUDA graph;
  * the auxiliary load-balance loss is ``E * sum(mean prob * top-1
    share)``.

The products are plain einsums, as in the reference (no TPU kernel).

Under a mesh the routing runs under ``local_map`` on each rank's groups
(the groups split over the batch's mesh axes where their count allows,
the router gathered whole), so every group's decisions are the
one-process port's bit for bit: the sort, the cumsum and the one-hot
never see a DTensor.  The dispatch, combine and expert tensors are then
constrained as the reference constrains them (groups over the batch's
axes, experts over "model").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (current_rules, is_dtensor,
                                              shard, shard_map_compat)
from repro_torch.models.module import ParamSpec


def moe_specs(d_model: int, d_ff: int, num_experts: int,
              dtype: torch.dtype) -> dict:
    e = num_experts
    return {"router": ParamSpec((d_model, e), ("embed", None), torch.float32,
                                scale=0.02),
            "w_gate": ParamSpec((e, d_model, d_ff),
                                ("experts", "embed", "mlp"), dtype),
            "w_up": ParamSpec((e, d_model, d_ff),
                              ("experts", "embed", "mlp"), dtype),
            "w_down": ParamSpec((e, d_ff, d_model),
                                ("experts", "mlp", "embed"), dtype)}


def capacity(group: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    return max(1, int(math.ceil(group * top_k / num_experts
                                * capacity_factor)))


def _one_hot(x: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: 1 where x equals 0..n-1 (a float x at -1 or
    past n gives a row of zeros)."""
    return (x[..., None] == torch.arange(n, dtype=x.dtype,
                                         device=x.device)).to(dtype)


def route(p: dict, xg: torch.Tensor, num_experts: int, top_k: int,
          cap: int):
    """The routing of token groups xg [G, T, d]: ``(probs [G, T, E] fp32,
    expert_idx [G, T, k], dispatch, combine [G, T, E, cap] in xg's
    dtype)``."""
    ng, g_sz, _ = xg.shape
    e, k = num_experts, top_k
    probs = torch.softmax(xg.float() @ p["router"], -1)          # [g,t,E]
    expert_idx = torch.sort(probs, dim=-1, descending=True,
                            stable=True)[1][..., :k]             # [g,t,k]
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)

    mask = _one_hot(expert_idx, e, torch.float32)                 # [g,t,k,E]
    prio = mask.transpose(1, 2).reshape(ng, k * g_sz, e)
    pos = (torch.cumsum(prio, 1) - 1.0).reshape(ng, k, g_sz, e).transpose(
        1, 2)                                                     # [g,t,k,E]
    dispatch = torch.zeros((ng, g_sz, e, cap), dtype=xg.dtype,
                           device=xg.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        keep_j = (pos[:, :, j] < cap) & (mask[:, :, j] > 0)       # [g,t,E]
        d_j = _one_hot(pos[:, :, j], cap, xg.dtype) * keep_j[..., None].to(
            xg.dtype)                                             # [g,t,E,C]
        dispatch = dispatch + d_j
        combine = combine + d_j * gate_vals[:, :, j, None, None].to(xg.dtype)
    return probs, expert_idx, dispatch, combine


def _mesh_route(p: dict, xg, num_experts: int, top_k: int, cap: int):
    """``route`` of DTensors: each rank routes its own groups."""
    from torch.distributed.tensor import Replicate
    rules = current_rules()
    xg = shard(xg, "batch", None, None)
    gpl = tuple(xg.placements)
    rep = (Replicate(),) * len(gpl)
    fn = shard_map_compat(lambda router, x: route({"router": router}, x,
                                                  num_experts, top_k, cap),
                          rules.mesh, (rep, gpl), (gpl, gpl, gpl, gpl))
    return fn(p["router"], xg)


def _mesh_experts(p: dict, dispatch, combine, xg):
    """Dispatch, the experts and combine of DTensors under ``local_map``,
    on the reference's layout: the groups over the batch's axes and the
    experts over "model" (dispatch, combine, every expert tensor), the
    expert weights gathered on their other dimensions (ZeRO-3's gather);
    y [G, T, d] is a partial sum over the experts' axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = current_rules().mesh
    dpl = tuple(dispatch.placements)
    xpl = tuple(p_ if p_ == Shard(0) else Replicate() for p_ in dpl)
    wpl = tuple(Shard(0) if p_ == Shard(2) else Replicate() for p_ in dpl)
    opl = tuple(Partial() if p_ == Shard(2) else q for p_, q in zip(dpl, xpl))

    def body(d_l, c_l, x_l, wg, wu, wd):
        xe = dispatch_tokens(d_l, x_l)
        ye = expert_mlp({"w_gate": wg, "w_up": wu, "w_down": wd}, xe)
        return combine_tokens(c_l, ye)
    fn = shard_map_compat(body, mesh, (dpl, dpl, xpl, wpl, wpl, wpl), opl)
    return fn(dispatch, combine, xg, p["w_gate"], p["w_up"], p["w_down"])


def dispatch_tokens(dispatch: torch.Tensor, xg: torch.Tensor
                    ) -> torch.Tensor:
    """[G, T, E, C] x [G, T, d] -> each expert's slots [G, E, C, d]."""
    return torch.einsum("gtec,gtd->gecd", dispatch, xg)


def expert_mlp(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its slots [G, E, C, d]."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def combine_tokens(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """[G, T, E, C] x [G, E, C, d] -> the gated sum a token [G, T, d]."""
    return torch.einsum("gtec,gecd->gtd", combine, ye)


def moe_apply(p: dict, x: torch.Tensor, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 512
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, aux loss: 0-d fp32)."""
    b, s, d = x.shape
    t = b * s
    g_sz = min(group_size, t)
    ng = t // g_sz
    if ng * g_sz != t:
        raise ValueError(f"moe_apply: {t} tokens are not a multiple of "
                         f"the group of {g_sz}")
    e = num_experts
    xg = x.reshape(ng, g_sz, d)
    cap = capacity(g_sz, e, top_k, capacity_factor)
    if not is_dtensor(xg):
        probs, expert_idx, dispatch, combine = route(p, xg, e, top_k, cap)
        y = combine_tokens(combine, expert_mlp(p, dispatch_tokens(dispatch,
                                                                  xg)))
    else:
        probs, expert_idx, dispatch, combine = _mesh_route(p, xg, e, top_k,
                                                           cap)
        dispatch = shard(dispatch, "batch", None, "act_experts", None)
        combine = shard(combine, "batch", None, "act_experts", None)
        y = _mesh_experts(p, dispatch, combine, xg)

    # load-balance auxiliary loss (Switch / GShard form); on DTensors as
    # sums over the count (a mean over a split dimension is a
    # Partial("avg"), which torch 2.11's DTensor cannot mix with sums)
    top1 = _one_hot(expert_idx[..., 0], e, torch.float32)
    if is_dtensor(probs):
        me, ce = probs.sum((0, 1)) / t, top1.sum((0, 1)) / t
    else:
        me, ce = probs.mean((0, 1)), top1.mean((0, 1))            # [E]
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d), aux
