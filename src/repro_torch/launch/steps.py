"""Step builders shared by ``train.py``, the decode path and the dry run
(counterpart of ``repro.launch.steps``), on one device or on a mesh.

* ``make_train_step``: one AdamW step; with ``num_microbatches > 1`` the
  batch is split along its first axis and each microbatch's gradient,
  taken with ``torch.autograd.grad``, is summed into fp32 buffers (the
  reference's ``gsum``: summing into bf16 ``.grad`` would round each
  microbatch).  Parameters, moments and master copy are updated in place.
* ``make_loss_step``: forward and backward without the optimizer.
* ``make_prefill_step``: the prefill, eager.
* ``make_decode_step``: the reference's compiled decode step in the
  port's form: on the card, one CUDA graph a (batch, cache length,
  attention kind), captured at the first call and replayed for every
  later token, with the token and the position as its static inputs and
  the cache (K/V rows, and a Mamba layer's conv and SSM states) updated
  in place; eager on the CPU.

A batch may carry a frontend's ``embeds`` [B, F, d] beside its tokens;
every step passes it to ``loss_fn`` / ``prefill``, and the train step's
metrics report the MoE auxiliary loss (``aux``).

Every builder takes the reference's ``rules`` (``distributed.sharding.
make_rules``).  Without a mesh (None or mode "none") it does exactly the
one-device work above.  With a ``DeviceMesh`` the parameters (and the
optimizer state and caches) are DTensors on the rules' placements
(``models.module.param_shardings``); a batch of plain tensors, held whole
by every rank, is placed on the inputs' placements first
(``place_batch``); the model runs under ``use_rules`` and the metrics
and the loss come back as plain (replicated) tensors.  The train step
then also takes the reference's two knobs:

* ``shard_grad_accum``: each microbatch's fp32 gradient is put on its
  parameter's placements before it is summed (a reduce-scatter a
  microbatch instead of one reduction of partial sums at the end);
* ``zero1_rules``: the AdamW state lives on those rules' placements
  (``optimizer.init_state(params, placements)``); the gradients are put
  there, the update runs shard-locally, and the fresh parameters go back
  onto the rules' placements.

A microbatch of a sharded batch is its rows i x B/n ... (i + 1) x B/n, as
on one device, on the batch's placements (a DTensor batch's rows are
gathered once a step, not once a microbatch).  The
mesh decode step runs eagerly: no CUDA graph holds its collectives yet
(the GoldDiff engine's plan graphs do hold NCCL collectives: PERF.md
section 6), so this is the design of this step, not a fallback from a
graph.
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from repro_torch.distributed.hlo_analysis import phase
from repro_torch.distributed.sharding import (Rules, is_dtensor, make_rules,
                                              place, use_rules)
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import param_shardings, tree_leaves
from repro_torch.training import optimizer as opt

_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "loss_mask": ("batch", "seq"),
               "embeds": ("batch", "seq", "act_embed"), "token": ("batch",)}


def _rules(rules: Rules | None) -> Rules:
    return make_rules("none") if rules is None else rules


def place_batch(batch: dict, rules: Rules) -> dict:
    """A batch's plain tensors (each held whole by every rank) as
    DTensors on the inputs' placements; DTensors and a rules table
    without a mesh pass through."""
    if rules.mesh is None:
        return batch
    return {k: v if is_dtensor(v) or not isinstance(v, torch.Tensor) else
            place(v, rules.mesh, rules.sharding(_BATCH_AXES[k],
                                                tuple(v.shape)))
            for k, v in batch.items()}


def _plain(t):
    """A DTensor's full value (replicated on every rank), else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def _rebuild(paths: list[str], leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, key = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = leaf
    return out


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                    rules: Rules | None = None):
    """``(loss, metrics, grads)`` of ``T.loss_fn`` at ``params``; the
    gradients in the parameters' dtype, as a tree like ``params``."""
    paths, leaves = zip(*tree_leaves(params))
    live = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad(), use_rules(_rules(rules)), phase("grad"):
        loss, metrics = T.loss_fn(cfg, _rebuild(paths, live), batch)
        grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _rebuild(paths, grads))


def _microbatches(batch: dict, n: int, rules: Rules) -> list[dict]:
    """The batch's n microbatches, rows i x B/n ... (i + 1) x B/n of every
    leaf, on the inputs' placements under a mesh.  A plain leaf (held
    whole by every rank) is sliced and placed with no collective; a
    DTensor leaf has its rows gathered once (its other dimensions stay
    split), and each microbatch is a local slice put back on the leaf's
    placements (not one gather of the whole leaf a microbatch)."""
    from torch.distributed.tensor import Replicate, Shard
    out: list[dict] = [{} for _ in range(n)]
    for k, v in batch.items():
        m = v.shape[0] // n
        if is_dtensor(v):
            pl = tuple(v.placements)
            v = v.redistribute(v.device_mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                for p in pl))
        for i in range(n):
            part = v[i * m:(i + 1) * m]
            out[i][k] = (part.redistribute(part.device_mesh, pl)
                         if is_dtensor(part) else part)
    return [place_batch(mb, rules) for mb in out]


def _accumulate(gsum: dict, grads: dict, constrain) -> None:
    """``gsum[path] += grads[path]`` in fp32 (a function of its own, so no
    loop variable keeps a microbatch's gradient alive into the next)."""
    for p, t in tree_leaves(grads):
        gsum[p] += constrain(p, t.float())


def make_train_step(cfg: ModelConfig, rules: Rules | None = None,
                    opt_cfg: opt.AdamWConfig | None = None,
                    num_microbatches: int = 1,
                    shard_grad_accum: bool = False,
                    zero1_rules: Rules | None = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics are the last microbatch's ``nll`` and ``aux``
    plus ``loss`` (the microbatches' mean), ``grad_norm`` and ``lr``, all
    0-d device tensors (nothing is read back).  Under a mesh the
    optimizer state must have been made by ``optimizer.init_state(params,
    param_shardings(model_specs(cfg), zero1_rules))`` when
    ``zero1_rules`` is given (by ``init_state(params)`` otherwise)."""
    opt_cfg = opt_cfg or opt.AdamWConfig()
    rules = _rules(rules)
    par_sh = (dict(tree_leaves(param_shardings(T.model_specs(cfg), rules)))
              if rules.mesh is not None else None)

    def constrain(path, g):
        """The fp32 gradient sum on its parameter's placements."""
        if not shard_grad_accum or par_sh is None:
            return g
        return g.redistribute(g.device_mesh, par_sh[path])

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, metrics, grads = _value_and_grad(
                cfg, params, place_batch(batch, rules), rules)
        else:
            n = num_microbatches
            mbs = _microbatches(batch, n, rules)
            gsum, lsum = None, 0
            for mb in mbs:
                lval, metrics, g = _value_and_grad(cfg, params, mb, rules)
                lsum = lsum + _plain(lval)
                if gsum is None:     # fp32 buffers (fresh grads: no copy)
                    gsum = {p: constrain(p, t.float())
                            for p, t in tree_leaves(g)}
                else:
                    _accumulate(gsum, g, constrain)
                del g
            for t in gsum.values():
                t.div_(n)                          # in place: no 2nd copy
            grads = _rebuild(list(gsum), gsum.values())
            loss = lsum / n
        with phase("update"):
            params, opt_state, om = opt.apply_updates(opt_cfg, params,
                                                      grads, opt_state)
        metrics = dict(metrics, loss=loss, **om)
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_loss_step(cfg: ModelConfig, rules: Rules | None = None
                   ) -> Callable:
    """``loss_step(params, batch) -> (loss, grads)``: forward and backward
    without the optimizer (the dry run's lighter variant)."""
    rules = _rules(rules)

    def loss_step(params, batch):
        loss, _, grads = _value_and_grad(cfg, params,
                                         place_batch(batch, rules), rules)
        return _plain(loss), grads
    return loss_step


def make_prefill_step(cfg: ModelConfig, rules: Rules | None = None
                      ) -> Callable:
    """``prefill_step(params, batch) -> (last logits, cache)``, eager;
    under a mesh both are DTensors (the cache on the rules'
    placements)."""
    rules = _rules(rules)

    def prefill_step(params, batch):
        batch = place_batch(batch, rules)
        with torch.no_grad(), use_rules(rules):
            return T.prefill(cfg, params, batch["tokens"],
                             batch.get("embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: Rules | None = None
                     ) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits, cache)``.

    Under a mesh every call is eager (``T.decode_step`` under the rules:
    the split-S decode with its merges), the token placed on the batch's
    placements.  Without one:

    On the card the first call with a given (batch, first attention
    layer's cache length, 0 without attention) and parameter and cache
    tensors decodes eagerly (which also builds what the step needs) and
    then captures ``T.decode_step`` into one CUDA graph (a capture
    records and runs nothing, so a Mamba layer's states advance once for
    that call, in its eager step); every later call copies
    the token and the position into the graph's inputs, replays it and
    returns a copy of the logits.  A call with other parameter or cache
    tensors (other addresses) captures anew.  The capture runs with the garbage
    collector off, as ``core.engine.capture`` does.  On the CPU every
    call is eager."""
    rules = _rules(rules)
    graphs: dict = {}

    def serve_step(params, cache, token, pos):
        if token.device.type != "cuda":
            with torch.no_grad():
                return T.decode_step(cfg, params, cache, token, pos)
        key = (int(token.shape[0]), T.attn_cache_len(cfg, cache) or 0,
               cfg.attn_kind_decode)
        ptrs = tuple(t.data_ptr() for _, t in tree_leaves(params)) + tuple(
            t.data_ptr() for _, t in tree_leaves(cache))
        entry = graphs.get(key)
        if entry is None or entry["ptrs"] != ptrs:
            entry = graphs[key] = _capture(cfg, params, cache, token, pos)
            entry["ptrs"] = ptrs
            return entry.pop("first"), cache
        entry["token"].copy_(token)
        if isinstance(pos, torch.Tensor):
            entry["pos"].copy_(pos)
        else:
            entry["pos"].fill_(int(pos))
        entry["graph"].replay()
        ops.add_launch_counts(entry["delta"])
        return entry["logits"].clone(), cache

    def mesh_step(params, cache, token, pos):
        token = place_batch({"token": token}, rules)["token"]
        with torch.no_grad(), use_rules(rules):
            return T.decode_step(cfg, params, cache, token, pos)

    serve_step.graphs = graphs
    return mesh_step if rules.mesh is not None else serve_step


def _capture(cfg: ModelConfig, params: dict, cache: dict,
             token: torch.Tensor, pos) -> dict:
    device = token.device
    tok = token.detach().clone()
    at = (pos.to(device=device, dtype=torch.int64).reshape(()).clone()
          if isinstance(pos, torch.Tensor) else
          torch.full((), int(pos), dtype=torch.int64, device=device))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(side):
        first, _ = T.decode_step(cfg, params, cache, tok, at)    # eager
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                logits, _ = T.decode_step(cfg, params, cache, tok, at)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of the decode step "
                               f"failed: {e}") from e
        finally:
            if collect:
                gc.enable()
            delta = [a - b for a, b in zip(ops.launch_counts(), before)]
            ops.add_launch_counts([-d for d in delta])
    torch.cuda.current_stream(device).wait_stream(side)
    return {"graph": graph, "token": tok, "pos": at, "logits": logits,
            "delta": delta, "first": first}
