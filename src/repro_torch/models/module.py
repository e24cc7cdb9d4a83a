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
parameters across (``models.convert``).

Every leaf carries the reference's logical axes (``stack_specs``
prepends "layers").  ``param_shardings`` gives each leaf's DTensor
placements under a ``Rules`` table, and ``abstract_params`` the leaves
as DTensors on the rules' mesh that allocate nothing (fake tensors under
an active ``FakeTensorMode``, else meta tensors): the dry run's
parameters.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed | arange
    scale: float | None = None    # stddev override for "normal"
    stacked: bool = False         # leading axis = the layer repeats

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"{self.shape} vs {self.logical_axes}")


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
               device: torch.device, rules=None) -> torch.Tensor:
    """One leaf drawn on ``device``.  Under ``rules`` with a mesh only
    this rank's shard is kept, as a DTensor on the leaf's placements: a
    stacked leaf's repeats are drawn whole one at a time and each gives
    up all but its chunk, so no rank holds more than one repeat of a
    leaf whole."""
    pl = None if rules is None else rules.sharding(spec.logical_axes,
                                                   spec.shape)
    if pl is None:
        return _draw_leaf(spec, generator, device, spec.shape, None, None)
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed.sharding import local_chunk, local_shape
    if spec.stacked and any(isinstance(p, Shard) and p.dim == 0 for p in pl):
        raise ValueError(f"a stacked leaf {spec.shape} is sharded over its "
                         f"repeats ({pl})")
    mesh = rules.mesh
    part_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for p in pl)
    out = _draw_leaf(spec, generator, device,
                     local_shape(mesh, pl, spec.shape),
                     lambda t: local_chunk(t, mesh, pl),
                     lambda t: local_chunk(t, mesh, part_pl))
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(spec.shape),
                              stride=_contiguous_strides(spec.shape))


def _draw_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device, shape, chunk, part_chunk
               ) -> torch.Tensor:
    """The leaf's values of local ``shape``: ``chunk`` (``part_chunk``
    for one repeat of a stacked leaf) takes a rank's chunk of a whole
    draw, None keeps it whole."""
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    if spec.init == "arange":             # the Mamba A_log init: log(1..n)
        n = spec.shape[-1]
        v = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        v = v.expand(spec.shape).to(spec.dtype).clone()
        return v if chunk is None else chunk(v)
    if spec.init not in ("normal", "embed"):
        raise ValueError(f"init {spec.init!r} is none of normal, embed, "
                         f"zeros, ones, arange")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    parts = ([(p, spec.shape[1:], part_chunk) for p in out.unbind(0)]
             if spec.stacked else [(out, spec.shape, chunk)])
    for dst, whole, take in parts:
        draw = torch.randn(whole, generator=generator, device=device,
                           dtype=torch.float32).mul_(std)
        dst.copy_(draw if take is None else take(draw))
    return out


def init_params(spec_tree, generator: torch.Generator, device=None,
                rules=None) -> dict:
    """Materialize every leaf on ``device`` (the generator's device by
    default), drawing in ``tree_leaves`` order from ``generator`` (a
    stacked leaf repeat by repeat).  Under ``rules`` with a mesh every
    rank draws the same values and keeps its shards (``_init_leaf``):
    the leaves ``place_params`` would give, without the whole tree on
    any card."""
    device = torch.device(generator.device if device is None else device)
    out: dict = {}
    for path, spec in tree_leaves(spec_tree):
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _init_leaf(spec, generator, device, rules)
    return out


def param_shardings(spec_tree, rules) -> dict:
    """Each leaf's DTensor placements under ``rules`` (None without a
    mesh), as a tree like ``spec_tree``."""
    return tree_map(lambda s: rules.sharding(s.logical_axes, s.shape),
                    spec_tree)


def sharded_tensor(shape, logical_axes, dtype, rules, device,
                   fill=torch.empty):
    """A DTensor of ``shape`` on ``rules.mesh`` with the placements of
    ``logical_axes``, each rank's shard ``fill(local shape)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import local_shape
    mesh = rules.mesh
    pl = rules.sharding(tuple(logical_axes), tuple(shape))
    local = fill(local_shape(mesh, pl, shape), dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def abstract_tensor(shape, logical_axes, dtype, rules, device=None):
    """``sharded_tensor`` allocating nothing: a fake tensor on ``device``
    (the mesh's device type by default) under an active
    ``FakeTensorMode``, else a meta tensor."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        device = "meta"
    elif device is None:
        device = rules.mesh.device_type
    return sharded_tensor(shape, logical_axes, dtype, rules, device)


def place_tree(tree: dict, axes: dict, rules, prefix: str = "") -> dict:
    """Each leaf of ``tree`` (held whole by every rank) as a DTensor on
    the placements of its logical axes (``axes``: path -> axes), each
    rank keeping its chunk; ``tree`` unchanged without a mesh."""
    from repro_torch.distributed.sharding import place
    if rules.mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: place_tree(v, axes, rules,
                              f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return place(tree, rules.mesh,
                 rules.sharding(axes[prefix], tuple(tree.shape)))


def place_params(params: dict, spec_tree, rules) -> dict:
    """``params`` (held whole) on ``param_shardings(spec_tree, rules)``."""
    return place_tree(params, {p: s.logical_axes for p, s in
                               tree_leaves(spec_tree)}, rules)


def abstract_params(spec_tree, rules, device=None) -> dict:
    """The leaves as DTensors on ``rules.mesh`` with their placements,
    allocating nothing (``abstract_tensor``): the dry run's
    parameters."""
    return tree_map(lambda s: abstract_tensor(s.shape, s.logical_axes,
                                              s.dtype, rules, device),
                    spec_tree)


def _contiguous_strides(shape) -> tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def param_count(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(spec_tree)))


def stack_specs(spec_tree, repeats: int):
    """Add a leading 'layers' axis to every leaf (the stacked
    ``[repeats, ...]`` layout of the reference's scan over layers)."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(repeats,) + s.shape,
        logical_axes=("layers",) + s.logical_axes, stacked=True), spec_tree)
