"""Per-device cost of a traced step (counterpart of
``repro.distributed.hlo_analysis``; the name is kept so a reader finds
the counterpart, though nothing here reads HLO).

The reference compiles each step with XLA and reads the partitioned
program: ``cost_analysis`` (FLOPs, bytes), ``memory_analysis`` and the
collectives of the optimized HLO.  The port runs the step once on fake
tensors (``FakeTensorMode``, a fake process group: nothing is allocated
or sent) under :class:`DeviceCostMode`, a dispatch mode that sees every
operation one rank runs:

* DTensor operations are handed on to DTensor (the mode declines them),
  so the mode sees the *local* operations each rank runs, on local
  shapes: per-device FLOPs.  (``FlopCounterMode`` around a DTensor
  program counts the global shapes.)  The operations DTensor runs on
  global-shaped fake tensors to propagate shapes (``_sharding_prop.py``
  on the stack) are skipped;
* FLOPs come from ``torch.utils.flop_counter``'s formulas (kernel 9 and
  its backward register theirs: 4 B H S^2 dh and twice that, the
  reference's count);
* bytes are each operation's tensor inputs read once and outputs written
  once, views and allocations excluded: the eager (unfused) traffic;
* collectives are the functional collectives DTensor issues; each
  counts its result bytes, by kind (the reference's HLO convention);
* memory is the peak of the live storages: those given to ``track``
  (parameters, optimizer state, inputs) plus every storage an operation
  creates, until it is freed.  It is also kept per phase of the step
  (``phase``: the train step labels its gradients "grad" and its AdamW
  update "update"; the rest is "step"), because the phase that holds
  the peak can change with the depth.

``loop_corrections`` has no counterpart: XLA's cost analysis counts a
while loop's body once, so the reference adds the attention's and the
SSD's inner-loop iterations back analytically; the port's trace runs
every Python loop and every kernel call, so nothing is undercounted
(``tests/test_torch_mesh.py`` holds one attention layer's traced FLOPs
to the reference's formula).

Hardware constants: the H100's (``launch.mesh``).
"""
from __future__ import annotations

import contextlib
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
         ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
         ("permute", "collective-permute"), ("send", "collective-permute"),
         ("recv", "collective-permute"), ("broadcast", "all-gather"))

_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "device", "wait_tensor"}


_PHASE = ["step"]   # the innermost ``phase`` label (a process-wide stack:
                    # a backward may run on autograd's device thread)


@contextlib.contextmanager
def phase(name: str):
    """Label the operations run inside as one phase of a step, for
    ``DeviceCostMode``'s per-phase peak; costs nothing otherwise."""
    _PHASE.append(name)
    try:
        yield
    finally:
        _PHASE.pop()


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if not ns.startswith("_c10d") and ns != "c10d":
        return None
    name = func._opname
    if name == "wait_tensor":
        return None
    for key, kind in _KIND:
        if key in name:
            return kind
    return None


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the Python stack (it
    runs operations on global-shaped fake tensors to learn their output
    metadata; no rank runs them)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCostMode(TorchDispatchMode):
    """Count one rank's FLOPs, bytes, collectives and peak live memory
    (see the module note).  ``records`` lists the collectives as (kind,
    dtype, shape) of their results."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.records: list[tuple[str, torch.dtype, tuple[int, ...]]] = []
        self.live = 0
        self.peak = 0
        self.phase_peaks: dict[str, int] = {}
        self.tracked = 0
        self._storages: dict[int, weakref.ref] = {}

    # -- memory ---------------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key]() is st:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        ph = _PHASE[-1]
        self.phase_peaks[ph] = max(self.phase_peaks.get(ph, 0), self.live)

        def freed(_, n=n, key=key, mode=weakref.ref(self)):
            m = mode()
            if m is not None:
                m.live -= n
                m._storages.pop(key, None)
        self._storages[key] = weakref.ref(st, freed)

    def track(self, *trees) -> None:
        """Count the storages of ``trees`` (parameters, optimizer state,
        inputs; a DTensor by its local shard) as live from now on."""
        from torch.distributed.tensor import DTensor
        for tree in trees:
            for t in _leaves(tree):
                if isinstance(t, DTensor):
                    t = t.to_local()
                before = self.live
                self._hold(t)
                self.tracked += self.live - before

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self.ops += 1
        kind = _collective_kind(func)
        outs = list(_tensors(out))
        if kind is not None:
            for t in outs:
                self.records.append((kind, t.dtype, tuple(t.shape)))
        else:
            formula = self._flops.get(func.overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            schema = func._schema
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in schema.returns)
            if not view and func._opname not in _NO_TRAFFIC:
                self.bytes += sum(_nbytes(t) for t in _tensors((args,
                                                                kwargs)))
                self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t)
        return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def collective_bytes(records) -> dict[str, float]:
    """Per-kind and total result bytes of the collectives ``records``
    ((kind, dtype, shape) each, as ``DeviceCostMode`` lists them)."""
    out = {k: 0.0 for k in COLLECTIVES}
    for kind, dtype, shape in records:
        n = 1
        for d in shape:
            n *= int(d)
        out[kind] += n * torch.empty((), dtype=dtype).element_size()
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def cost_summary(mode: DeviceCostMode) -> dict[str, float]:
    """Per-device FLOPs and bytes of a traced step (``raw``: the count
    of operations one rank ran)."""
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "raw": {"ops": float(mode.ops)}}


def memory_summary(mode: DeviceCostMode) -> dict:
    """Per-device memory of a traced step: ``argument_size_in_bytes`` the
    tracked storages (parameters, optimizer state, inputs),
    ``peak_bytes`` the peak of everything live, ``total_hbm_bytes`` (the
    reference's key, which ``fits_hbm`` reads) the same peak, and
    ``phase_peak_bytes`` the peak within each ``phase``."""
    return {"argument_size_in_bytes": float(mode.tracked),
            "peak_bytes": float(mode.peak),
            "total_hbm_bytes": float(mode.peak),
            "phase_peak_bytes": {k: float(v) for k, v in
                                 sorted(mode.phase_peaks.items())}}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> dict:
    """The three roofline terms in seconds of one card's work (the
    counts are per device): FLOPs over the dense bf16 peak, bytes over
    HBM, collective result bytes over the inter-node link that a 16-wide
    mesh axis crosses."""
    from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": coll_bytes / ICI_BW}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference).

    N_active excludes the embedding gather but includes the LM head; MoE
    layers count experts_per_token / num_experts of their expert params.
    ``cfg`` needs the config fields the count reads (any family's), and
    ``shape`` ``kind``, ``global_batch`` and ``seq_len``."""
    d, ff, n_layers = cfg.d_model, cfg.d_ff, cfg.num_layers
    n_attn = 0
    n_mlp_dense = 3 * d * ff
    n_moe_active = (3 * d * ff * cfg.experts_per_token
                    if cfg.num_experts else 0)
    if cfg.num_heads:
        hd = cfg.hdim
        n_attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    n_mamba = 0
    if cfg.ssm_state:
        di = cfg.ssm_expand * d
        n_mamba = d * (2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim) \
            + di * d
    n = 0
    for i in range(n_layers):
        li = i % cfg.period
        n += n_attn if cfg.mixer_kind(li) == "A" else n_mamba
        n += {"dense": n_mlp_dense, "moe": n_moe_active,
              "none": 0}[cfg.mlp_kind(li)]
    n += d * cfg.vocab_size                      # LM head
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token / seq


__all__ = ["DeviceCostMode", "collective_bytes", "cost_summary",
           "memory_summary", "roofline_terms", "model_flops", "COLLECTIVES"]
