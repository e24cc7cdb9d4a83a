"""Logical-axis sharding of the LLM, the store's mesh interface, and the
cross-shard merge primitives (counterpart of
``repro.distributed.sharding``).

**The LLM's logical sharding.**  Every parameter and activation carries
*logical* axis names; a :class:`Rules` table maps them to the axes of a
``torch.distributed`` ``DeviceMesh`` per execution mode (train, prefill,
decode, decode_long, none).  ``Rules.spec`` is the reference's
resolution, per dimension a mesh-axis name, a tuple of them or None
(the ``PartitionSpec`` counterpart): with a shape it drops mesh axes
whose cumulative size does not divide the dimension, and it never uses
one mesh axis twice.  ``Rules.sharding`` turns a spec into DTensor
placements (one ``Shard`` / ``Replicate`` per mesh dimension, in mesh
order); a dimension sharded over a tuple of mesh axes is split in mesh
order, which is the reference's major-to-minor order when the tuple
follows the mesh's axis order (every table entry does; another order
raises).  ``shard(x, *axes)`` is a no-op without a mesh and a
``redistribute`` with one (the ``with_sharding_constraint``
counterpart); ``shard_map_compat`` is ``local_map`` on explicit
placements (the ``shard_map`` counterpart).  A thread-local context
(``use_rules`` / ``current_rules``) carries the rules into the model
code, so a program without a mesh runs no sharding machinery at all.

**The store's mesh interface** (the sharded ``GoldDiffEngine``).  The
reference writes its collectives inside ``shard_map`` bodies; the
engine's sharded step is written against one small interface and runs
on either of two meshes:

* :class:`LocalMesh` -- every shard lives in this process: on one
  device (one card holds the S slices of the store), or each on a
  listed device.  A shard-local stage runs once per shard, and a
  collective merges the list of the shards' tensors.
* :class:`ProcessMesh` -- one shard per rank of a ``torch.distributed``
  group, or of one axis of a ``DeviceMesh`` (gloo on the CPU, NCCL on
  cards).  The list a rank holds is its own shard's tensor; a collective
  is the shard axis group's all-gather (into one preallocated output) or
  all-reduce.

A *sharded value* is that list: the tensors of the shards this process
holds, in shard order (``mesh.local_shards(axis)``).  ``all_gather``,
``pmax`` and ``psum`` take one and return a replicated tensor.  The
merge math is written once, on gathered tensors, as the reference's
``kth_from_gathered`` already is: the two-stage top-k threshold, the
gathered global top-k and the exact log-sum-exp merge of shard-local
softmax states.  Ties follow ``lax.top_k``: the lowest gathered
position (the lowest shard, then the lowest local slot) wins.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.utils import resolve_device

NEG_INF = -1e30


# -- the LLM's logical-axis rules ---------------------------------------------

_CTX = threading.local()


class AbstractMesh:
    """Mesh axis names and sizes without devices or a process group (the
    counterpart of ``jax.sharding.AbstractMesh``): enough for
    ``Rules.spec``, which reads nothing else of a mesh."""

    def __init__(self, shape, axis_names):
        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} must pair up")

    def size(self, dim: int) -> int:
        return self.shape[dim]


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names, in mesh order."""
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    return int(mesh.size(axis_names(mesh).index(name)))


@dataclasses.dataclass(frozen=True)
class Rules:
    """A logical-axis table on a mesh: logical axis name -> mesh axis, a
    tuple of mesh axes, or None.  ``mesh`` is None for a program without
    sharding (mode "none")."""

    mesh: Any
    table: dict

    def spec(self, logical_axes: tuple, shape: tuple | None = None) -> tuple:
        """Resolve logical axes to per-dimension mesh axes (None, a name,
        or a tuple of names): the reference's ``PartitionSpec``.  With
        ``shape``, mesh axes whose cumulative size does not divide the
        dimension are dropped from that axis on; a mesh axis is used at
        most once."""
        if self.mesh is None:
            return ()
        names = axis_names(self.mesh)
        out = []
        used: set[str] = set()
        for i, ax in enumerate(logical_axes):
            m = self.table.get(ax) if ax is not None else None
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a in names and a not in used)
            if shape is not None:
                keep, prod = [], 1
                for a in ms:
                    prod *= axis_size(self.mesh, a)
                    if shape[i] % prod:
                        break
                    keep.append(a)
                ms = tuple(keep)
            used.update(ms)
            out.append(ms if len(ms) > 1 else (ms[0] if ms else None))
        return tuple(out)

    def sharding(self, logical_axes: tuple, shape: tuple | None = None):
        """The DTensor placements of ``spec(logical_axes, shape)`` on the
        rules' mesh (None without a mesh)."""
        if self.mesh is None:
            return None
        return spec_placements(self.mesh, self.spec(logical_axes, shape))


def spec_placements(mesh, spec: tuple) -> tuple:
    """Per-dimension mesh axes -> one placement per mesh dimension: a
    mesh axis that shards tensor dimension d is ``Shard(d)``, any other
    ``Replicate()``.  A dimension split over several mesh axes must name
    them in mesh order (DTensor splits in mesh order; the reference in
    the tuple's, major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ms in enumerate(spec):
        if ms is None:
            continue
        ms = (ms,) if isinstance(ms, str) else tuple(ms)
        order = [names.index(a) for a in ms]
        if order != sorted(order):
            raise ValueError(f"dimension {dim} is split over mesh axes {ms} "
                             f"out of the mesh's order {names}")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def _pod(mesh) -> tuple[str, ...]:
    if mesh is not None and "pod" in axis_names(mesh):
        return ("pod", "data")
    return ("data",)


def make_rules(mode: str, mesh=None, overrides: dict | None = None) -> Rules:
    """The reference's tables.  mode: 'train' | 'prefill' | 'decode' |
    'decode_long' | 'none' (or no mesh: no sharding)."""
    if mode == "none" or mesh is None:
        return Rules(None, {})
    batch = _pod(mesh)
    base = {
        # weights
        "embed": batch,          # FSDP / ZeRO-3 over the data axis
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",
        "expert_mlp": batch,     # second shard dim of expert weights
        "mamba_inner": "model",
        "mamba_conv": "model",
        "mamba_heads": "model",
        "layers": None,
        # activations
        "batch": batch,
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_experts": "model",
        "kv_seq": None,
    }
    if mode == "train":
        base["act_embed"] = "model"     # the residual stream's d_model
    elif mode == "prefill":
        base["act_embed"] = "model"
        base["kv_seq"] = "model"        # prefill writes a model-sharded cache
    elif mode == "decode":
        base["kv_seq"] = "model"        # flash-decoding: split-S over model
        base["act_heads"] = None        # q replicated for the seq-split merge
    elif mode == "decode_long":
        base["kv_seq"] = (("data", "model") if "pod" not in axis_names(mesh)
                          else ("pod", "data", "model"))
        base["batch"] = None            # global_batch = 1
        base["act_heads"] = None
        base["expert_mlp"] = ("data",)
        base["embed"] = ("data",)
    else:
        raise ValueError(mode)
    if overrides:
        base.update(overrides)
    return Rules(mesh, base)


_IMPLICIT = [0]     # use_rules with a mesh entered and not yet left


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Make ``rules`` the current rules of this thread (and, with a mesh,
    treat plain tensors met beside DTensors as replicated: DTensor's
    ``implicit_replication`` switches a process-wide flag off on exit,
    so only the outermost ``use_rules`` enters it)."""
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    ctx = contextlib.nullcontext()
    if rules.mesh is not None and not _IMPLICIT[0]:
        from torch.distributed.tensor.experimental import implicit_replication
        ctx = implicit_replication()
    _IMPLICIT[0] += rules.mesh is not None
    try:
        with ctx:
            yield rules
    finally:
        _IMPLICIT[0] -= rules.mesh is not None
        _CTX.rules = prev


def current_rules() -> Rules:
    r = getattr(_CTX, "rules", None)
    return r if r is not None else Rules(None, {})


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute onto ``placements`` in the forward and put the
    gradient on the same placements in the backward (the transpose of a
    sharding constraint is the same constraint, as in GSPMD; DTensor's
    own ``redistribute`` sends the gradient back to the input's
    placements, a partial sum included)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard(x, *logical_axes):
    """Constrain an activation's sharding: a no-op without a mesh (or on
    a plain tensor), else a redistribute onto the current rules'
    placements for its shape, its gradient constrained the same way."""
    r = current_rules()
    if r.mesh is None or not is_dtensor(x):
        return x
    want = r.sharding(tuple(logical_axes), tuple(x.shape))
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, want)


def mesh_axis_size(*names: str) -> int:
    """The product of the current mesh's sizes of ``names`` (1 without a
    mesh; an axis the mesh lacks counts 1)."""
    r = current_rules()
    if r.mesh is None:
        return 1
    n = 1
    for name in names:
        if name in axis_names(r.mesh):
            n *= axis_size(r.mesh, name)
    return n


def grad_placements(in_pl, out_pls) -> tuple:
    """The placements of a ``local_map`` input's gradient: where the
    input is whole on a mesh dimension but an output differs along it
    (sharded or partial), each rank's local gradient is a partial sum
    over that dimension (``Partial()``); elsewhere the input's own."""
    from torch.distributed.tensor import Partial, Replicate
    if in_pl is None:
        return None
    out = []
    for i, p in enumerate(in_pl):
        if isinstance(p, Replicate) and any(
                o is not None and not isinstance(o[i], Replicate)
                for o in out_pls):
            out.append(Partial())
        else:
            out.append(p)
    return tuple(out)


def shard_map_compat(fn, mesh, in_placements, out_placements):
    """``fn`` on each rank's local shards (the reference's
    ``shard_map_compat``): ``local_map(fn)`` with its inputs
    redistributed onto ``in_placements`` and the gradients' placements
    from ``grad_placements``.  The placements are DTensor's (one per mesh
    dimension; ``spec_placements`` / ``Rules.sharding`` give them for a
    reference ``PartitionSpec``); ``out_placements`` is one tuple, or a
    tuple of them for several outputs; None marks a non-tensor argument.
    Inside ``fn`` the collectives are the mesh's (``mesh_psum`` /
    ``mesh_pmax``)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    single = all(isinstance(p, Placement) for p in out_placements)
    outs = (out_placements,) if single else tuple(out_placements)
    return local_map(fn, out_placements=(list(out_placements) if single
                                         else tuple(out_placements)),
                     in_placements=tuple(in_placements),
                     in_grad_placements=tuple(grad_placements(p, outs)
                                              for p in in_placements),
                     device_mesh=mesh, redistribute_inputs=True)


def _groups(mesh, axes):
    names = axis_names(mesh)
    return [mesh.get_group(names.index(a)) for a in axes]


def mesh_psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-reduce sum of a local tensor over the mesh axes ``axes`` (one
    all-reduce an axis, in the order given)."""
    import torch.distributed._functional_collectives as fc
    for g in _groups(mesh, axes):
        t = fc.all_reduce(t, "sum", g)
    return t


def mesh_pmax(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    for g in _groups(mesh, axes):
        t = fc.all_reduce(t, "max", g)
    return t


def mesh_coordinate(mesh, axes) -> int:
    """This rank's linear position over ``axes`` (major to minor): the
    index of its shard of a dimension split over them."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return idx


def local_shape(mesh, placements, shape) -> tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` (DTensor's
    chunking: ceil-sized chunks first, the last ones shorter or
    empty)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    names = axis_names(mesh)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = mesh.size(i), int(mesh.get_local_rank(names[i]))
            full = out[p.dim]
            step = -(-full // n)
            out[p.dim] = max(0, min(step, full - c * step))
    return tuple(out)


def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of ``t`` (held whole by every rank) on
    ``placements``, contiguous; a copy where it is a part of ``t``, so
    that ``t`` can be freed."""
    from torch.distributed.tensor import Shard
    local = t
    names = axis_names(mesh)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            c = int(mesh.get_local_rank(names[i]))
            local = torch.chunk(local, n, p.dim)[c]
    if local.numel() < t.numel():
        return local.clone(memory_format=torch.contiguous_format)
    return local.contiguous()


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of the full tensor ``t`` (held whole by every rank) with
    ``placements``: each rank keeps its own chunk, with no collective."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_chunk(t, mesh, placements), mesh,
                              placements, run_check=False, shape=t.shape,
                              stride=t.stride())


class LocalMesh:
    """Named mesh axes whose shards all live in this process.

    ``shape`` and ``axis_names`` name the axes, as ``jax.make_mesh``
    does (``LocalMesh((8,), ("data",))``, ``LocalMesh((4, 2), ("data",
    "model"))``).  ``devices`` (optional) lists one device per position
    of the axis the store shards over; without it every shard lives on
    the engine's device, so one card holds the S slices.  A collective
    moves the shards' tensors to the first shard's device and merges
    them there in shard order."""

    def __init__(self, shape, axis_names, devices=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"must pair up, every size >= 1")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = (None if devices is None
                        else [torch.device(d) for d in devices])

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape})"

    def local_shards(self, axis: str) -> list[int]:
        """The positions along ``axis`` this process holds: all."""
        return list(range(self.shape[axis]))

    def shard_devices(self, axis: str, default) -> list[torch.device]:
        """One device per position of ``axis``: the listed ones, or
        ``default`` for every shard."""
        n = self.shape[axis]
        if self.devices is None:
            return [torch.device(default)] * n
        if len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices listed for "
                             f"axis {axis!r} of size {n}")
        return list(self.devices)

    def capturable(self, axis: str, default) -> bool:
        """Whether a CUDA graph can hold a step: with every shard of
        ``axis`` on one card (the merges are then plain tensor
        operations there)."""
        return len(set(self.shard_devices(axis, default))) == 1

    @staticmethod
    def _home(parts):
        dev = parts[0].device
        return [p.to(dev) for p in parts]

    def all_gather(self, parts, dim: int = 1) -> torch.Tensor:
        """The shards' tensors concatenated along ``dim`` in shard order."""
        return torch.cat(self._home(parts), dim)

    def pmax(self, parts) -> torch.Tensor:
        parts = self._home(parts)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def psum(self, parts) -> torch.Tensor:
        """The sum in shard order."""
        parts = self._home(parts)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


class ProcessMesh:
    """Named mesh axes whose shards are the ranks of ``torch.distributed``
    groups: one shard a rank, and every rank runs the same calls on the
    same inputs (SPMD), so every rank returns the global result.

    * ``ProcessMesh(axis, group=None)`` -- one axis over a group (the
      default group unless ``group`` names one): rank r holds shard r;
    * ``ProcessMesh(device_mesh=dm)`` -- the named axes of a
      ``torch.distributed`` ``DeviceMesh`` (one or two: the reference's
      ``(4, 2)`` ("data", "model") mesh), each axis's collectives on
      ``dm.get_group(axis)``; a rank holds the shard of its coordinate.

    ``shard_axis`` (the first axis; ``along`` picks another) is the axis
    the merges run over: ``all_gather``, ``pmax`` and ``psum`` without
    ``axis``.  A second axis only splits the query batch
    (``GoldDiffEngine(batch_axis=...)``): no merge names it, as in the
    reference.  ``device`` is this
    rank's device: under NCCL its card (``torch.cuda.current_device()``
    unless given); under gloo the one given, else None, and then a rank
    puts its shard where the caller's default says (the engine's device,
    which is the card unless the caller asks for the CPU: :meth:`on`;
    ``shard_layout``'s store device).  ``backend`` is the
    shard group's.  A gather writes into one preallocated output
    (``all_gather_into_tensor``), so that a CUDA graph can capture it
    over NCCL.  Gloo takes the card's tensors as they are and moves them
    through the host itself (torch 2.11 on the H100: ``all_reduce``,
    ``all_gather_into_tensor`` and ``broadcast``, by ``chip_smoke.py``'s
    [pmesh] probe).  The process groups are the caller's to create
    (``repro_torch.launch.mesh.make_process_mesh``).

    **The host channel** (``host_broadcast``, ``host_float``, ``host_max``,
    ``host_any``, ``host_sum``) carries the serving runtime's decisions and the slabs'
    statistics (small Python records, a few integers, float64 sums) over
    ``host_group``, a gloo group of every rank of the mesh on the CPU,
    so that a decision neither synchronizes the card nor enters a
    captured stream.  Given none, it is the shard group
    when that is gloo (``device_mesh``: the world's default group when
    that is gloo); over NCCL ``make_process_mesh`` makes one beside the
    shard group, and a mesh without one raises where the channel is
    used.  The channel's first rank (``host_rank == 0``) is the source
    of every record."""

    def __init__(self, axis: str = "data", group=None, *, device_mesh=None,
                 device=None, host_group=None):
        import torch.distributed as dist
        self._dist = dist
        if device_mesh is None:
            self.axis_names = (axis,)
            self.groups = {axis: group}
            self._coords = {axis: dist.get_rank(group)}
            self.shape = {axis: dist.get_world_size(group)}
        else:
            self.axis_names = axis_names(device_mesh)
            self.groups = {a: device_mesh.get_group(a)
                           for a in self.axis_names}
            self._coords = {a: int(device_mesh.get_local_rank(a))
                            for a in self.axis_names}
            self.shape = {a: axis_size(device_mesh, a)
                          for a in self.axis_names}
        self.shard_axis = self.axis_names[0]
        self.backends = {a: dist.get_backend(g)
                         for a, g in self.groups.items()}
        self.backend = self.backends[self.shard_axis]
        if device is None and self.backend == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = None if device is None else torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group runs on a card, not on "
                             f"{self.device}")
        if host_group is None:
            world = None if device_mesh is not None else group
            if dist.get_backend(world) == "gloo":
                host_group = (world,)
        else:
            if dist.get_backend(host_group) != "gloo":
                raise ValueError("the host channel runs over a gloo group")
            host_group = (host_group,)
        # a 1-tuple holding the group (None names the default group), or
        # None: no channel
        self._host = host_group

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, shard_axis={self.shard_axis!r}, "
                f"coords={self._coords}, {self.backend} on {self.device})")

    def on(self, device=None) -> "ProcessMesh":
        """The same mesh on an entry point's device: ``device``, else the
        mesh's, else the card (``resolve_device``); a mesh that names
        another device raises."""
        device = resolve_device(device if device is not None
                                else self.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.device is not None and device != self.device:
            raise ValueError(f"device {device} is not the ProcessMesh's "
                             f"{self.device}")
        out = copy.copy(self)
        out.device = device
        return out

    def along(self, shard_axis: str) -> "ProcessMesh":
        """The same mesh merging over ``shard_axis``."""
        out = copy.copy(self)
        out.shard_axis = shard_axis
        out.backend = self.backends[shard_axis]
        return out

    def coordinate(self, axis: str) -> int:
        return self._coords[axis]

    @property
    def first(self) -> bool:
        """Whether this is the mesh's first rank (``broadcast``'s source)."""
        return not any(self._coords.values())

    def local_shards(self, axis: str) -> list[int]:
        """The one position along ``axis`` this rank holds."""
        return [self._coords[axis]]

    def shard_devices(self, axis: str, default) -> list[torch.device]:
        """This rank's device (``default`` where the mesh was given none)
        at every position: a rank reads its own position only."""
        dev = torch.device(default) if self.device is None else self.device
        return [dev] * self.shape[axis]

    def capturable(self, axis: str, default) -> bool:
        """Whether a CUDA graph can hold a step's collectives: over NCCL
        on every axis (gloo runs on the host, eagerly)."""
        return all(b == "nccl" for b in self.backends.values())

    def all_gather(self, parts, dim: int = 1, axis: str | None = None
                   ) -> torch.Tensor:
        """This rank's part gathered over ``axis`` (the shard axis) and
        concatenated along ``dim`` in coordinate order."""
        (t,) = parts
        axis = axis or self.shard_axis
        n = self.shape[axis]
        t = t.contiguous()
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        self._dist.all_gather_into_tensor(out, t, group=self.groups[axis])
        shape = list(t.shape)
        shape[dim] *= n
        return out.view((n,) + tuple(t.shape)).movedim(0, dim).reshape(shape)

    def _reduce(self, parts, op, axis) -> torch.Tensor:
        (t,) = parts
        t = t.clone()
        self._dist.all_reduce(t, op=op,
                              group=self.groups[axis or self.shard_axis])
        return t

    def pmax(self, parts, axis: str | None = None) -> torch.Tensor:
        return self._reduce(parts, self._dist.ReduceOp.MAX, axis)

    def psum(self, parts, axis: str | None = None) -> torch.Tensor:
        return self._reduce(parts, self._dist.ReduceOp.SUM, axis)

    def broadcast(self, value: float) -> float:
        """The value of the mesh's first rank (coordinate 0 on every
        axis), on every rank: one broadcast an axis, in mesh order."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device or "cpu")
        for a in self.axis_names:
            g = self.groups[a]
            src = 0 if g is None else self._dist.get_global_rank(g, 0)
            self._dist.broadcast(t, src=src, group=g)
        return float(t.item())

    # -- the host channel: the runtime's decisions, gloo on the CPU -----------
    def _host_group(self):
        if self._host is None:
            raise ValueError(
                f"{self!r} has no host channel: the shard group is "
                f"{self.backend}; make the mesh with make_process_mesh (a "
                f"gloo group beside it) or pass host_group=")
        return self._host[0]

    @property
    def host_rank(self) -> int:
        """This rank's position in the host group: 0 is the front end
        whose records every rank replays."""
        return self._dist.get_rank(self._host_group())

    def host_broadcast(self, obj):
        """The host group's first rank's Python object ``obj`` (small and
        picklable; the other ranks' arguments are ignored), on every
        rank."""
        g = self._host_group()
        box = [obj]
        self._dist.broadcast_object_list(
            box, src=0 if g is None else self._dist.get_global_rank(g, 0),
            group=g)
        return box[0]

    def host_float(self, value: float | None) -> float:
        """The host group's first rank's float (the others pass None), on
        every rank: one float64 broadcast, no pickling (a clock
        reading)."""
        g = self._host_group()
        t = torch.tensor([0.0 if value is None else float(value)],
                         dtype=torch.float64)
        self._dist.broadcast(
            t, src=0 if g is None else self._dist.get_global_rank(g, 0),
            group=g)
        return float(t.item())

    def host_max(self, codes) -> list[int]:
        """The element-wise maximum over every rank of a few integers
        (an int or a sequence of them), as a list."""
        t = torch.tensor(np.atleast_1d(np.asarray(codes, np.int64)))
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX,
                              group=self._host_group())
        return t.tolist()

    def host_sum(self, values) -> np.ndarray:
        """The element-wise float64 sum over every rank of an array (the
        slabs' statistics)."""
        t = torch.from_numpy(np.array(values, np.float64))
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self._host_group())
        return t.numpy()

    def host_any(self, flags) -> np.ndarray:
        """The element-wise OR over every rank of a boolean vector."""
        flags = np.asarray(flags, bool)
        if flags.size == 0:
            return flags
        return np.asarray(self.host_max(flags.astype(np.int64)),
                          bool).reshape(flags.shape)


def kth_from_gathered(g: torch.Tensor, k_sort: int, k) -> torch.Tensor:
    """The k-th largest value of each row of the gathered candidates
    ``g`` [B, ...] (flattened), [B]: the threshold half of
    :func:`crossshard_kth`.  ``k_sort`` is the static sort width (an
    upper bound on k); ``k`` an int or a 0-d integer tensor (the masked
    path's traced k_t), clipped to [1, k_sort]."""
    flat = g.reshape(g.shape[0], -1)
    k_sort = min(int(k_sort), flat.shape[-1])
    vals = torch.topk(flat, k_sort, dim=-1, sorted=True).values
    if isinstance(k, torch.Tensor):
        kidx = torch.clamp(k.reshape(1).long() - 1, 0, k_sort - 1)
        return vals.index_select(1, kidx)[:, 0]
    return vals[:, min(max(int(k) - 1, 0), k_sort - 1)]


def crossshard_kth(neg_parts, k_sort: int, k, mesh) -> torch.Tensor:
    """Value of the k-th *largest* entry across all shards, [B]: stage
    two of the two-stage top-k.  Each shard contributes its local top
    candidates [B, k_loc] (negated distances, so "largest" is
    "closest"; invalid slots -inf or NEG_INF sort last), the gather is
    k_loc floats a shard, never rows, and ``neg >= kth`` selects the
    global top-k (up to ties at the k-th value, which it keeps all)."""
    return kth_from_gathered(mesh.all_gather(neg_parts, 1), k_sort, k)


def gather_global_topk(ids_parts, neg_parts, k: int, mesh) -> torch.Tensor:
    """Global top-k ids across shards, [B, k]: gather (id, score) pairs
    and re-select, ties to the lowest gathered position."""
    g_neg = mesh.all_gather(neg_parts, 1)
    g_ids = mesh.all_gather(ids_parts, 1)
    pos = torch.sort(g_neg, dim=-1, descending=True, stable=True)[1][:, :k]
    return torch.gather(g_ids, -1, pos)


def lse_merge_mean(acc_parts, m_parts, l_parts, mesh) -> torch.Tensor:
    """Exact log-sum-exp merge of the shards' softmax states ``(acc [B,
    D], m [B], l [B])`` into the mean [B, D].  A shard with no members
    carries the finite NEG_INF max, so its scale underflows to exactly 0.
    NaN guard: where every shard carries a hard -inf max, ``m - m_g`` is
    NaN; such shards weigh nothing, so their scale is 0 and the merge
    gives a finite zero mean instead of NaN."""
    m_g = mesh.pmax(m_parts)
    ls, accs = [], []
    for acc, m, l in zip(acc_parts, m_parts, l_parts):
        diff = m - m_g.to(m.device)
        sc = torch.where(torch.isnan(diff), 0.0, torch.exp(diff))
        ls.append(l * sc)
        accs.append(acc * sc[:, None])
    l_g = mesh.psum(ls)
    return mesh.psum(accs) / torch.clamp_min(l_g, 1e-30)[:, None]


__all__ = ["AbstractMesh", "Rules", "make_rules", "use_rules",
           "current_rules", "shard", "mesh_axis_size", "shard_map_compat",
           "spec_placements", "mesh_psum", "mesh_pmax", "mesh_coordinate",
           "place", "local_chunk", "local_shape", "grad_placements",
           "LocalMesh", "ProcessMesh", "kth_from_gathered",
           "crossshard_kth", "gather_global_topk", "lse_merge_mean",
           "NEG_INF"]
