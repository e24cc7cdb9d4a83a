"""Step builders shared by ``train.py`` and the decode path (counterpart
of ``repro.launch.steps``) for one device.

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

The builders take no ``rules``: there is one card, and the LLM's
logical-axis rules, ``shard_grad_accum`` and ``zero1_rules`` (multi-card)
wait for the LLM sharding (ROADMAP Queue 1).
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves
from repro_torch.training import optimizer as opt


def _rebuild(paths: list[str], leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, key = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = leaf
    return out


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict):
    """``(loss, metrics, grads)`` of ``T.loss_fn`` at ``params``; the
    gradients in the parameters' dtype, as a tree like ``params``."""
    paths, leaves = zip(*tree_leaves(params))
    live = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, _rebuild(paths, live), batch)
        grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _rebuild(paths, grads))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: opt.AdamWConfig | None = None,
                    num_microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics are the last microbatch's ``nll`` and ``aux``
    plus ``loss`` (the microbatches' mean), ``grad_norm`` and ``lr``, all
    0-d device tensors (nothing is read back)."""
    opt_cfg = opt_cfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, metrics, grads = _value_and_grad(cfg, params, batch)
        else:
            n = num_microbatches
            mbs = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            gsum, lsum = None, torch.zeros((), dtype=torch.float32,
                                           device=batch["tokens"].device)
            for mb in mbs:
                lval, metrics, g = _value_and_grad(cfg, params, mb)
                lsum = lsum + lval
                if gsum is None:     # fp32 buffers (fresh grads: no copy)
                    gsum = {p: t.float() for p, t in tree_leaves(g)}
                else:
                    for p, t in tree_leaves(g):
                        gsum[p] += t.float()
                del g
            for t in gsum.values():
                t.div_(n)                          # in place: no 2nd copy
            grads = _rebuild(list(gsum), gsum.values())
            loss = lsum / n
        params, opt_state, om = opt.apply_updates(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_loss_step(cfg: ModelConfig) -> Callable:
    """``loss_step(params, batch) -> (loss, grads)``: forward and backward
    without the optimizer."""
    def loss_step(params, batch):
        loss, _, grads = _value_and_grad(cfg, params, batch)
        return loss, grads
    return loss_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> (last logits, cache)``, eager."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(cfg, params, batch["tokens"],
                             batch.get("embeds"))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits, cache)``.

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

    serve_step.graphs = graphs
    return serve_step


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
