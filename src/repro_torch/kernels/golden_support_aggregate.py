"""Hand-written CUDA kernel: softmax aggregation over golden rows by index.

Replaces ``repro/kernels/golden_support_aggregate.py:78``
(``golden_support_aggregate`` / ``_sagg_kernel``).  The TPU kernel's
online softmax carry across grid steps has no counterpart on Hopper.
The kernel (``csrc/golden_support_aggregate.cu``) reduces each query's
logits to (max, l) first and turns each slot into its weight once; the
batch's row map (``csrc/row_union.cuh``, planned by
``golden_rerank.union_plan``) lists the rows a group of queries names,
and one pass over that list reads each row once for the group and
accumulates its weighted columns for all of the group's queries in
registers.  The CTAs' partial sums merge in a fixed order:
deterministic, bound by the bytes of the distinct rows.  Its bf16-row
instance (the engine's ``storage_dtype``) loads the rows in bf16, half
the bytes, and widens them for the same fp32 sums.  Its plain version
is ``ref.golden_support_aggregate_ref``.  The state entry
(:func:`golden_support_aggregate_state`) is the same kernel writing the
softmax state undivided, for the sharded engine's log-sum-exp merge.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.golden_rerank import (CTAS_PER_SM, H100_SMS,
                                               QUERY_GROUP, carve, sm_count,
                                               union_plan)

SLICE = 512          # columns one row-pass CTA takes (a float4 a thread)
MIN_TILE_ROWS = 64   # fewest list rows a row-pass CTA is planned for

_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 4)
# ... and the state entry's: acc, m and l in place of out
_STATE_ARGS = _ARGS[:5] + [ctypes.c_void_p] * 2 + _ARGS[5:]


def aggregate_plan(b: int, n: int, k: int, d: int,
                   sms: int = H100_SMS) -> dict:
    """:func:`golden_rerank.union_plan` plus the row pass's grid:
    ``slices`` of SLICE columns and ``tiles`` per group, each tile
    taking an equal share of the group's list (computed on the card from
    its count), so that about CTAS_PER_SM CTAs an SM run, but a tile has
    at least MIN_TILE_ROWS rows of a full list."""
    p = union_plan(b, n, k)
    p["slices"] = max(1, -(-d // SLICE))
    want = -(-CTAS_PER_SM * sms // (p["slices"] * max(1, p["groups"])))
    p["tiles"] = max(1, min(want, p["ucap"] // MIN_TILE_ROWS))
    return p


def scratch_sizes(b: int, n: int, k: int, d: int,
                  sms: int = H100_SMS) -> dict:
    """Sizes of the kernel's scratch: ``zero`` bytes, zeroed by the call
    (the tally u64 and the weights fp32, each [G, ucap, QUERY_GROUP],
    then the map's 16-byte words [G, N]); ``work`` int32 (the (max, l)
    pairs [B] as fp32, the chunk counts [G, chunks], the list counts
    [G], the lists [G, ucap]); ``part`` fp32 (the tiles' partial sums
    [tiles, B, D])."""
    p = aggregate_plan(b, n, k, d, sms)
    g, ucap = p["groups"], p["ucap"]
    cells = g * ucap * QUERY_GROUP
    return dict(zero=12 * cells + 16 * g * n,
                work=2 * b + g * p["chunks"] + g + g * ucap,
                part=p["tiles"] * b * d)


def _launch(x: torch.Tensor, idx: torch.Tensor, logits: torch.Tensor,
            state: bool):
    name = ("golden_support_aggregate_state" if state
            else "golden_support_aggregate")
    _build.require(name, x.device, x=x, idx=idx, logits=logits)
    bf16 = _build.require_rows(name, x=x)
    _build.require_dtype(name, torch.float32, logits=logits)
    _build.require_dtype(name, torch.int64, idx=idx)
    n, d = x.shape
    b, k = idx.shape
    _build.require_shape(name, "logits", logits, (b, k))
    if state and k < 1:
        raise ValueError(f"{name}: a softmax state needs k >= 1")
    dev = x.device
    sms = sm_count(dev)
    p = aggregate_plan(b, n, k, d, sms)
    z = scratch_sizes(b, n, k, d, sms)
    scratch, (zero, work, part) = carve(dev, z["zero"], 4 * z["work"],
                                        4 * z["part"])
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    plan = (b, k, n, d, _build.vec4(x), p["groups"], p["ucap"], p["chunks"],
            p["tiles"], zero, work, part, _build.stream(dev))
    if state:
        ml = torch.empty((2, b), dtype=torch.float32, device=dev)
        fn = _build.load("golden_support_aggregate",
                         "golden_support_aggregate_state_launch", _STATE_ARGS)
        err = fn(_build.ptr(x), int(bf16), _build.ptr(idx),
                 _build.ptr(logits), _build.ptr(out), _build.ptr(ml[0]),
                 _build.ptr(ml[1]), *plan)
    else:
        fn = _build.load(name, "golden_support_aggregate_launch", _ARGS)
        err = fn(_build.ptr(x), int(bf16), _build.ptr(idx),
                 _build.ptr(logits), _build.ptr(out), *plan)
    _build.check("golden_support_aggregate", err)
    if state:
        _build.count(golden_support_aggregate_state, bf16)
        return out, ml[0], ml[1]
    _build.count(golden_support_aggregate, bf16)
    return out


def golden_support_aggregate(x: torch.Tensor, idx: torch.Tensor,
                             logits: torch.Tensor) -> torch.Tensor:
    """softmax(logits)-weighted mean of x[idx] per query: x [N, D] fp32
    or bf16, idx [B, K] int64 in [0, N), logits [B, K] fp32 (NEG_INF
    entries get zero weight) -> [B, D] fp32, ``acc / max(l, 1e-30)``."""
    return _launch(x, idx, logits, state=False)


golden_support_aggregate.launches = 0
golden_support_aggregate.launches_bf16 = 0


def golden_support_aggregate_state(x: torch.Tensor, idx: torch.Tensor,
                                   logits: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The state entry: the same kernel's softmax state of x[idx] per
    query, ``(acc [B, D], m [B], l [B])`` fp32 undivided (m the max
    logit from NEG_INF, l the denominator), which store shards merge by
    log-sum-exp (``distributed.sharding.lse_merge_mean``).  K >= 1.  Its
    plain version is ``ref.partial_aggregate_ref``."""
    return _launch(x, idx, logits, state=True)


golden_support_aggregate_state.launches = 0
golden_support_aggregate_state.launches_bf16 = 0
