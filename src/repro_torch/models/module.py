"""Parameter trees from specs (counterpart of ``repro.models.module``).

A model definition is a nested dict of ``ParamSpec`` leaves;
``init_params`` materializes it on one device from an explicit
``torch.Generator`` with the reference's init law: normal with std
1/sqrt(fan_in) (fan_in the second-to-last axis), ``scale`` overriding
it, ``embed`` leaves at their scale, norms ones, ``arange`` (Mamba's
``a_log``) log(1..n) over the last axis.  A leaf stacked over the
layer repeats is drawn one repeat at a time in fp32 and written into a
leaf of the spec's dtype, so no fp32 copy of the whole stack is ever
held (qwen2.5-32b's ``w_gate`` alone would be 36.2 GB).  The draws
cannot equal ``jax.random``'s, so parity tests carry the reference's
parameters across (``models.convert``).  No sharding yet: the logical
axes wait for the sharding slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed | arange
    scale: float | None = None    # stddev override for "normal"
    stacked: bool = False         # leading axis = the layer repeats


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, keys in sorted order
    (``jax.tree``'s order); paths joined by "/"."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from tree_leaves(tree[key], f"{prefix}/{key}" if prefix
                               else key)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "arange":             # the Mamba A_log init: log(1..n)
        n = spec.shape[-1]
        v = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        return v.expand(spec.shape).to(spec.dtype).clone()
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"init {spec.init!r} is none of normal, embed, "
                         f"zeros, ones, arange")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for part in (out.unbind(0) if spec.stacked else (out,)):
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device, dtype=torch.float32).mul_(std))
    return out


def init_params(spec_tree, generator: torch.Generator, device=None) -> dict:
    """Materialize every leaf on ``device`` (the generator's device by
    default), drawing in ``tree_leaves`` order from ``generator`` (a
    stacked leaf repeat by repeat)."""
    device = torch.device(generator.device if device is None else device)
    out: dict = {}
    for path, spec in tree_leaves(spec_tree):
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _init_leaf(spec, generator, device)
    return out


def param_count(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(spec_tree)))


def stack_specs(spec_tree, repeats: int):
    """Add a leading 'layers' axis to every leaf (the stacked
    ``[repeats, ...]`` layout of the reference's scan over layers)."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(repeats,) + s.shape, stacked=True), spec_tree)
