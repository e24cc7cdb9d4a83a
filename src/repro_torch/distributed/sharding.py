"""The mesh interface and the cross-shard merge primitives.

Counterpart of the merge half of ``repro.distributed.sharding``.  The
reference writes its collectives inside ``shard_map`` bodies; the port
has no ``shard_map``, so a sharded step is written against one small
interface and runs on either of two meshes:

* :class:`LocalMesh` -- every shard lives in this process: on one
  device (one card holds the S slices of the store), or each on a
  listed device.  A shard-local stage runs once per shard, and a
  collective merges the list of the shards' tensors.
* :class:`ProcessMesh` -- one shard per rank of a ``torch.distributed``
  group (gloo on the CPU, NCCL across cards).  The list a rank holds is
  its own shard's tensor; a collective is the group's all-gather or
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

import torch

NEG_INF = -1e30


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

    def one_device(self, axis: str, default) -> bool:
        """Whether every shard of ``axis`` shares one device."""
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
    """One axis whose shards are the ranks of a ``torch.distributed``
    group (the default group unless ``group`` names one): rank r holds
    shard r.  The process group is the caller's to create (for example
    ``init_process_group("gloo", init_method="tcp://127.0.0.1:<port>",
    rank=r, world_size=S)``)."""

    def __init__(self, axis: str = "data", group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.axis_names = (axis,)
        self.shape = {axis: self.size}

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"

    def local_shards(self, axis: str) -> list[int]:
        return [self.rank]

    def shard_devices(self, axis: str, default) -> list[torch.device]:
        """``default`` (the store's device) at every position: a rank
        reads its own position only."""
        return [torch.device(default)] * self.size

    def one_device(self, axis: str, default) -> bool:
        return False

    def all_gather(self, parts, dim: int = 1) -> torch.Tensor:
        (t,) = parts
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        self._dist.all_gather(out, t, group=self.group)
        return torch.cat(out, dim)

    def _reduce(self, parts, op) -> torch.Tensor:
        (t,) = parts
        t = t.clone()
        self._dist.all_reduce(t, op=op, group=self.group)
        return t

    def pmax(self, parts) -> torch.Tensor:
        return self._reduce(parts, self._dist.ReduceOp.MAX)

    def psum(self, parts) -> torch.Tensor:
        return self._reduce(parts, self._dist.ReduceOp.SUM)


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


__all__ = ["LocalMesh", "ProcessMesh", "kth_from_gathered",
           "crossshard_kth", "gather_global_topk", "lse_merge_mean",
           "NEG_INF"]
