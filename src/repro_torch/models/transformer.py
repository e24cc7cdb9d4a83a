"""Decoder training, prefill and decode (counterpart of
``repro.models.transformer``) for every mixer pattern of the reference:
attention ("A") and Mamba-2 ("M", ``models.mamba2``) layers, with dense,
MoE (``models.moe``) or no MLPs, with or without a modality frontend.

  * train   — the full-sequence forward of ``loss_fn``; every attention
              layer runs causal flash attention through
              ``ops.FlashAttention`` (kernel 9 forward, the hand-written
              backward kernel on the card), every Mamba layer the chunked
              SSD (plain torch); each repeat under
              ``torch.utils.checkpoint`` when ``cfg.remat`` (the
              reference's ``nothing_saveable`` policy: only the repeat's
              input is kept, the repeat runs again in the backward).
  * prefill — the same forward over the prompt, no gradient; fills the
              KV cache [repeats, B, Hkv, S, dh] of an attention layer
              (plus block summaries when ``golden_cached_summaries``)
              and the conv [repeats, B, W-1, conv_dim] and SSM
              [repeats, B, H, P, N] states of a Mamba layer.
  * decode  — one new token at position ``pos`` against the cache, with
              full attention or golden attention (the paper's
              coarse-to-fine subset on the KV cache), the Mamba layers
              one recurrent step, on one device or a mesh (below).

Differences from the reference:

  * the layer loop is a Python loop (no scan); the stacked layer leaves
    are split with ``unbind``, so the gradient of a stacked leaf is one
    ``stack`` and not one full-size zero tensor a layer;
  * ``decode_step`` writes the new key, value and summary and the Mamba
    states into the given cache in place and returns the same dict (the
    reference's functional update copies the whole stacked cache).  A
    second call at the same position from the same cache is the
    reference's result only without cached summaries and without Mamba
    layers, whose running mean and states are not idempotent;
  * ``pos`` is an int or a device int tensor; the cache writes, the
    length mask and the running summary mean read it on the device, so
    no step reads a device value back and one CUDA graph serves every
    position (``launch.steps.make_decode_step``);
  * ``prefill`` applies the LM head to the last position only, whose
    logits it returns (as the reference does, over ``padded_vocab``);
    a Mamba layer's handoff comes from the same SSD pass (the reference
    runs it again);
  * ``forward_full`` returns ``(logits, cache, aux)``, aux the MoE
    auxiliary loss summed over the layers (0 for a dense model), also
    under ``torch.utils.checkpoint``; ``loss_fn`` adds ``aux_weight``
    times it.

The modality frontends are the reference's stub: ``loss_fn`` and
``prefill`` take precomputed embeddings [B, F, d] (``embeds``), cast to
the model's dtype and put ahead of the tokens; the loss masks their F
positions.

Under a mesh (``distributed.sharding.use_rules`` with a ``DeviceMesh``:
``launch.steps`` sets it up) parameters, activations and caches are
DTensors on the rules' placements, and the reference's sharding
constraints are ``shard`` calls at the same places.  The decode
attention then runs the reference's split-S flash decoding: each rank
writes the new key into its own slice of the cache (if the position
falls there) and takes partials over its slice, merged exactly across
the mesh axes that hold the cache (``_kv_axes``); golden attention keeps
``max(1, golden_blocks // shards)`` blocks a shard, as the reference
does, so it is not the one-device golden decode.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (axis_names, current_rules,
                                              is_dtensor, mesh_coordinate,
                                              shard, shard_map_compat,
                                              use_rules)
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import (ParamSpec, abstract_tensor,
                                       sharded_tensor, stack_specs, tree_map)
from repro_torch.utils import resolve_device

def _attn_dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.hdim)


def _mamba_dims(cfg: ModelConfig) -> mamba2.MambaDims:
    return mamba2.MambaDims(cfg.d_model, cfg.ssm_expand * cfg.d_model,
                            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv)


def _layer_specs(cfg: ModelConfig, i: int) -> dict:
    dt = cfg.param_dtype
    sp = {"ln1": L.rmsnorm_spec(cfg.d_model)}
    if cfg.mixer_kind(i) == "A":
        sp["attn"] = L.attn_specs(cfg.d_model, _attn_dims(cfg), dt,
                                  cfg.qkv_bias)
    else:
        sp["mamba"] = mamba2.mamba_specs(_mamba_dims(cfg), dt)
    kind = cfg.mlp_kind(i)
    if kind != "none":
        sp["ln2"] = L.rmsnorm_spec(cfg.d_model)
    if kind == "moe":
        sp["moe"] = moe.moe_specs(cfg.d_model, cfg.d_ff, cfg.num_experts, dt)
    elif kind == "dense":
        sp["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff, dt)
    return sp


def model_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter tree: ``embed``, ``blocks/l{i}`` with
    leaves stacked over ``repeats``, ``final_norm`` and ``lm_head`` when
    the embeddings are not tied."""
    dt = cfg.param_dtype
    period = {f"l{i}": _layer_specs(cfg, i) for i in range(cfg.period)}
    sp = {"embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                             ("vocab", "embed"), dt, "embed", scale=0.02),
          "blocks": stack_specs(period, cfg.repeats),
          "final_norm": L.rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                  ("embed", "vocab"), dt, scale=0.02)
    return sp


def _golden_summaries(cfg: ModelConfig) -> bool:
    return cfg.attn_kind_decode == "golden" and cfg.golden_cached_summaries


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{"l{i}": {"k": (shape, logical_axes, dtype), "v": ...,
    ["summ": ...]}}`` for an attention layer, ``{"l{i}": {"conv": ...,
    "ssm": ...}}`` for a Mamba layer (``seq_len`` unused), each stacked
    over the repeats (the reference's tree)."""
    dt = cfg.param_dtype
    out = {}
    for i in range(cfg.period):
        if cfg.mixer_kind(i) != "A":
            out[f"l{i}"] = {
                name: ((cfg.repeats,) + shp, ("layers",) + ax, dtype)
                for name, (shp, ax, dtype) in mamba2.mamba_cache_specs(
                    _mamba_dims(cfg), batch, dt).items()}
            continue
        shp = (cfg.repeats, batch, cfg.num_kv_heads, seq_len, cfg.hdim)
        ax = ("layers", "batch", "cache_heads", "kv_seq", None)
        out[f"l{i}"] = {"k": (shp, ax, dt), "v": (shp, ax, dt)}
        if _golden_summaries(cfg):
            nb = seq_len // cfg.golden_block_size
            out[f"l{i}"]["summ"] = ((cfg.repeats, batch, cfg.num_kv_heads,
                                     nb, cfg.hdim), ax, dt)
    return out


def _alloc_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
                 fill, rules=None) -> dict:
    """The cache's leaves from ``fill``; DTensors on the rules'
    placements (each rank's shard filled) under a mesh."""
    rules = current_rules() if rules is None else rules

    def mk(shp, ax, dt):
        if rules.mesh is None:
            return fill(shp, dtype=dt, device=device)
        return sharded_tensor(shp, ax, dt, rules, device, fill)
    return {li: {name: mk(*leaf) for name, leaf in leaves.items()}
            for li, leaves in cache_specs(cfg, batch, seq_len).items()}


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int, rules,
                   device=None) -> dict:
    """The decode cache as DTensors on the rules' placements that
    allocate nothing (fake under an active ``FakeTensorMode``, else
    meta), as ``module.abstract_params`` gives the parameters."""
    return {li: {name: abstract_tensor(*leaf, rules, device)
                 for name, leaf in leaves.items()}
            for li, leaves in cache_specs(cfg, batch, seq_len).items()}


def attn_cache_len(cfg: ModelConfig, cache: dict) -> int | None:
    """The positions the first attention layer's K/V cache holds, or
    None in a model without attention (a Mamba-only cache has no
    length)."""
    for i in range(cfg.period):
        if cfg.mixer_kind(i) == "A":
            return int(cache[f"l{i}"]["k"].shape[3])
    return None


def zero_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None, rules=None) -> dict:
    """A zeroed decode cache on ``device`` (the CUDA card unless the
    caller names another); DTensors on ``rules``' placements when they
    hold a mesh (each rank zeroes its shard)."""
    return _alloc_cache(cfg, batch, seq_len, resolve_device(device),
                        torch.zeros, rules)


def _layer(tree: dict, r: int) -> dict:
    """Repeat r's slice of every stacked leaf (views, not copies)."""
    return tree_map(lambda t: t[r], tree)


def _unstack(tree: dict, repeats: int) -> list[dict]:
    """Every repeat's slice of the stacked leaves (views): one ``unbind``
    a leaf, whose gradient is a single ``stack``."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda tup: tup[r], parts) for r in range(repeats)]


def _apply_mixer_full(cfg: ModelConfig, i: int, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict | None
                      ) -> torch.Tensor:
    """Layer i's full-sequence mixer; writes its K/V (and summaries), or
    its conv and SSM states, into ``cache`` (repeat r's views) when
    given."""
    if cfg.mixer_kind(i) != "A":
        return mamba2.mamba_apply(p["mamba"], x, _mamba_dims(cfg),
                                  cfg.ssm_chunk, cache)
    dims = _attn_dims(cfg)
    q, k, v = L.qkv_proj(p["attn"], x, dims, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "act_heads", None)
    o = L.flash_attention(q, k, v, dims, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)
    b, s = o.shape[:2]
    y = L.dense(o.reshape(b, s, -1), p["attn"]["wo"])
    if cache is not None:
        kc = k.transpose(1, 2)
        cache["k"].copy_(kc)
        cache["v"].copy_(v.transpose(1, 2))
        if "summ" in cache:
            full = torch.ones((b, s), dtype=torch.bool, device=x.device)
            if is_dtensor(kc):    # pooled per block: keep S on one rank
                kc = shard(kc, "batch", None, None, None)
            cache["summ"].copy_(L.block_summaries(kc, full,
                                                  cfg.golden_block_size))
    return y


def _kv_axes(rules) -> tuple[str, ...]:
    """The mesh axes that split the KV cache's sequence (the rules'
    ``kv_seq``, in the mesh)."""
    if rules.mesh is None:
        return ()
    m = rules.table.get("kv_seq")
    if m is None:
        return ()
    ms = (m,) if isinstance(m, str) else tuple(m)
    return tuple(a for a in ms if a in axis_names(rules.mesh))


def _decode_attention(cfg: ModelConfig, q: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, mask: torch.Tensor,
                      summ: torch.Tensor | None = None, kv_axes=(),
                      mesh=None) -> torch.Tensor:
    """q: [B, Hkv, G, dh]; kc/vc: [B, Hkv, S, dh]; mask: [B, S] ->
    [B, Hkv, G, dh].  With ``kv_axes`` the tensors are one rank's shard
    of S (local tensors), and the partials merge across those axes."""
    if cfg.attn_kind_decode == "golden":
        nsh = 1
        for a in kv_axes:
            nsh *= mesh.size(axis_names(mesh).index(a))
        m, l, acc = L.golden_decode_partials(
            q, kc, vc, mask, max(1, cfg.golden_blocks // nsh),
            cfg.golden_block_size, summaries=summ)
    else:
        m, l, acc = L.decode_attention_local(q, kc, vc, mask)
    if kv_axes:
        return L.merge_partials_psum(m, l, acc, kv_axes, mesh).to(q.dtype)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _write_and_attend(cfg: ModelConfig, qg, k_new, v_new, cache: dict, pos,
                      s: int, kv_axes=(), mesh=None):
    """Write the new key / value row (and the running mean of its
    block's summary) at ``pos`` into the cache views and attend over
    positions <= pos.  With ``kv_axes`` the cache tensors are this rank's
    slice of S: the row is written only where ``pos`` falls in it."""
    kc, vc, summ = cache["k"], cache["v"], cache.get("summ")
    s_loc = kc.shape[2]
    b = qg.shape[0]
    off = mesh_coordinate(mesh, kv_axes) * s_loc if kv_axes else 0
    lpos = pos - off
    inside = (lpos >= 0) & (lpos < s_loc)
    at = lpos.clamp(0, s_loc - 1).view(1)
    if kv_axes:
        k_new = torch.where(inside, k_new, kc.index_select(2, at))
        v_new = torch.where(inside, v_new, vc.index_select(2, at))
    kc.index_copy_(2, at, k_new)
    vc.index_copy_(2, at, v_new)
    mask = (torch.arange(s_loc, device=qg.device) + off <= pos).expand(
        b, s_loc)
    if summ is not None:
        # running mean of the block from the new key only:
        # m <- m + (k_new - m) / c, c = pos % bs + 1
        bs = cfg.golden_block_size
        nb_loc = summ.shape[2]
        lblk = torch.div(pos, bs, rounding_mode="floor") - off // bs
        blk = lblk.clamp(0, nb_loc - 1).view(1)
        c = (pos % bs + 1).float()
        kf = k_new.float()
        old = summ.index_select(2, blk).float()
        mean = torch.where(c == 1.0, kf, old + (kf - old) / c)
        if kv_axes:
            mean = torch.where((lblk >= 0) & (lblk < nb_loc), mean, old)
        summ.index_copy_(2, blk, mean.to(summ.dtype))
    return _decode_attention(cfg, qg, kc, vc, mask, summ, kv_axes, mesh)


def _mesh_write_and_attend(cfg: ModelConfig, qg, k_new, v_new, cache: dict,
                           pos):
    """``_write_and_attend`` of DTensors under ``local_map``: q and the
    new row on the batch's placements (heads whole), the cache on its
    own (S split over ``_kv_axes``)."""
    from torch.distributed.tensor import Replicate, Shard
    rules = current_rules()
    mesh = rules.mesh
    kv_axes = _kv_axes(rules)
    names = ("k", "v") + (("summ",) if "summ" in cache else ())
    cpl = tuple(cache["k"].placements)
    # the new row and q: the cache's placements on B, the rest whole
    rpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in cpl)
    s = cache["k"].shape[2]

    def body(ql, kl, vl, pos_, *leaves):
        return _write_and_attend(cfg, ql, kl, vl, dict(zip(names, leaves)),
                                 pos_, s, kv_axes, mesh)
    fn = shard_map_compat(body, mesh, (rpl, rpl, rpl, None) + tuple(
        tuple(cache[n].placements) for n in names), rpl)
    return fn(qg, k_new, v_new, pos, *(cache[n] for n in names))


def _apply_mixer_decode(cfg: ModelConfig, i: int, p: dict,
                        x1: torch.Tensor, cache: dict, pos: torch.Tensor
                        ) -> torch.Tensor:
    """Layer i's decode mixer for x1 [B, d] at ``pos`` (a 0-d int64
    tensor on x1's device).  Attention writes the new K/V row (and the
    running-mean summary of its block) into ``cache`` (repeat r's views)
    in place, then attends over positions <= pos; a Mamba layer advances
    its conv and SSM states there."""
    if cfg.mixer_kind(i) != "A":
        return mamba2.mamba_decode_step(p["mamba"], x1, cache,
                                        _mamba_dims(cfg))
    dims = _attn_dims(cfg)
    b = x1.shape[0]
    q, k, v = L.qkv_proj(p["attn"], x1[:, None, :], dims, pos.view(1, 1),
                         cfg.rope_theta)
    k_new = k.transpose(1, 2)                               # [B, Hkv, 1, dh]
    q = shard(q, "batch", "seq", "act_heads", None)   # decode: heads whole
    qg = q[:, 0].reshape(b, dims.num_kv_heads, dims.q_per_kv, dims.head_dim)
    if is_dtensor(qg):
        o = _mesh_write_and_attend(cfg, qg, k_new, v.transpose(1, 2), cache,
                                   pos)
    else:
        o = _write_and_attend(cfg, qg, k_new, v.transpose(1, 2), cache, pos,
                              cache["k"].shape[2])
    return L.dense(o.reshape(b, -1), p["attn"]["wo"])


def _mesh_embed(table, tokens):
    """The vocab-parallel lookup of DTensors: the table gathered on every
    mesh axis but those that split the vocabulary, each rank's rows
    looked up where the token falls in them (zeros elsewhere), the
    result a partial sum over the vocabulary's axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = shard(tokens, *(("batch", "seq")[:tokens.ndim]))
    tpl = tuple(tokens.placements)
    vpl = tuple(Shard(0) if p == Shard(0) and isinstance(t, Replicate)
                else Replicate() for p, t in zip(table.placements, tpl))
    vocab_axes = [axis_names(mesh)[i] for i, p in enumerate(vpl)
                  if isinstance(p, Shard)]
    opl = tuple(Partial() if isinstance(v, Shard) else t
                for v, t in zip(vpl, tpl))

    def body(tab, tok):
        n = tab.shape[0]
        loc = tok - mesh_coordinate(mesh, vocab_axes) * n
        ok = (loc >= 0) & (loc < n)
        return tab[loc.clamp(0, n - 1)] * ok[..., None].to(tab.dtype)
    return shard_map_compat(body, mesh, (vpl, tpl), opl)(table, tokens)


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    if is_dtensor(params["embed"]):
        return _mesh_embed(params["embed"], tokens)
    return params["embed"][tokens]


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.dense(x, w)
    if logits.ndim == 3:
        return shard(logits, "batch", "seq", "vocab")
    return logits


def _apply_mlp(cfg: ModelConfig, i: int, p: dict, x: torch.Tensor):
    """x: [B, S, d] -> (y, aux | None): the dense MLP (no aux) or the
    MoE with its auxiliary loss."""
    if cfg.mlp_kind(i) == "moe":
        return moe.moe_apply(p["moe"], x, cfg.num_experts,
                             cfg.experts_per_token, cfg.capacity_factor,
                             cfg.moe_group_size)
    return L.mlp_apply(p["mlp"], x), None


def _block(cfg: ModelConfig, bp: dict, x: torch.Tensor,
           positions: torch.Tensor, cache_r: dict | None):
    """One repeat of the layer pattern over x [B, S, d]; writes its
    caches into ``cache_r`` (repeat r's views) when given.  Returns
    ``(x, aux)``, aux the repeat's summed MoE auxiliary loss (0-d
    fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.period):
        p = bp[f"l{i}"]
        lc = cache_r[f"l{i}"] if cache_r is not None else None
        x = shard(x, "batch", "seq", "act_embed")
        x = x + _apply_mixer_full(cfg, i, p, L.rmsnorm(p["ln1"], x),
                                  positions, lc)
        if cfg.mlp_kind(i) != "none":
            h, a = _apply_mlp(cfg, i, p, L.rmsnorm(p["ln2"], x))
            x = x + h
            if a is not None:
                aux = aux + a
    return x, aux


def _under_rules(fn):
    """``fn`` run under the current rules wherever it runs: a remat
    repeat runs again in the backward, which on the card is the autograd
    engine's device thread, where this thread's rules are not set."""
    rules = current_rules()
    if rules.mesh is None:
        return fn

    def run(*args):
        with use_rules(rules):
            return fn(*args)
    return run


def _blocks(cfg: ModelConfig, params: dict, x: torch.Tensor,
            want_cache: bool, remat: bool = False):
    """Every layer over x [B, S, d]; returns (x, cache | None, aux).
    With ``remat`` each repeat runs under a non-reentrant checkpoint,
    which keeps only its input and runs it again in the backward."""
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = (_alloc_cache(cfg, b, s, x.device, torch.empty) if want_cache
             else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r, bp in enumerate(_unstack(params["blocks"], cfg.repeats)):
        lc = _layer(cache, r) if want_cache else None
        if remat:
            x, a = checkpoint(_under_rules(_block), cfg, bp, x, positions,
                              None, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block(cfg, bp, x, positions, lc)
        aux = aux + a
    return shard(x, "batch", "seq", "act_embed"), cache, aux


def forward_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 want_cache: bool = False, mode: str = "prefill"):
    """Full-sequence forward.  x: [B, S, d] embeddings; ``mode`` is
    "prefill" or "train" (remat per repeat when ``cfg.remat``, as the
    reference, which remats only in training).

    Returns ``(logits [B, S, V], cache | None, aux)``."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"forward_full: mode {mode!r} is not 'prefill' or "
                         f"'train'")
    remat = mode == "train" and cfg.remat and not want_cache
    x, cache, aux = _blocks(cfg, params, x, want_cache, remat)
    return (_lm_head(cfg, params, L.rmsnorm(params["final_norm"], x)), cache,
            aux)


def _with_embeds(x: torch.Tensor, embeds: torch.Tensor | None
                 ) -> torch.Tensor:
    """The frontend's embeddings [B, F, d], in the model's dtype, ahead
    of the token embeddings [B, S, d]."""
    if embeds is None:
        return x
    return torch.cat([embeds.to(x.dtype), x], 1)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01):
    """The reference's training loss: batch holds tokens and labels [B,
    S] (int), optionally loss_mask [B, S] (bool) and a frontend's embeds
    [B, F, d] (put ahead of the tokens; their F positions take label 0
    under a false mask).  fp32 logits with the padded-vocab columns at
    -1e30, the mean next-token NLL over the mask (over every position
    without one), plus ``aux_weight`` x the MoE auxiliary loss (0 for a
    dense model) plus the z-loss 1e-4 x mean(logz^2) over every position.
    Returns ``(loss, {"nll", "aux"})``."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    labels, mask = batch["labels"], batch.get("loss_mask")
    embeds = batch.get("embeds")
    if embeds is not None:
        x = _with_embeds(x, embeds)
        b, f = embeds.shape[:2]
        labels = torch.cat([torch.zeros((b, f), dtype=labels.dtype,
                                        device=labels.device), labels], 1)
        off = torch.zeros((b, f), dtype=torch.bool, device=labels.device)
        mask = torch.cat([off, torch.ones(tokens.shape, dtype=torch.bool,
                                          device=labels.device)
                          if mask is None else mask], 1)
    logits, _, aux = forward_full(cfg, params, x, mode="train")
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill_(pad, -1e30)   # in place: [B, S, V]
    if is_dtensor(logits):
        logz = _mesh_logsumexp(logits)
    else:
        logz = torch.logsumexp(logits, -1)
    if is_dtensor(logits):
        gold = _mesh_gold(logits, labels)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = torch.where(mask, nll, 0.0)
        denom = torch.clamp_min(mask.sum(), 1)
    else:
        denom = nll.numel()
    loss = nll.sum() / denom
    # a DTensor's mean over a split dimension is a Partial("avg"), which
    # torch 2.11's DTensor cannot add to the loss's Partial("sum")
    zloss = 1e-4 * ((logz ** 2).sum() / logz.numel() if is_dtensor(logz)
                    else (logz ** 2).mean())
    return loss + aux_weight * aux + zloss, {"nll": loss, "aux": aux}


def _mesh_logsumexp(logits):
    """``logsumexp(logits, -1)`` of DTensors with the vocabulary split:
    each rank's ``torch.logsumexp`` over its columns (one value a shard,
    the shards along a new last dimension), then the log-sum-exp of those
    few values; over one shard both are the one-device call's values and
    gradients bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    last = logits.ndim - 1
    lpl = tuple(logits.placements)
    parts = shard_map_compat(
        lambda lg: torch.logsumexp(lg, -1, keepdim=True), mesh, (lpl,),
        lpl)(logits)
    whole = tuple(Replicate() if p == Shard(last) else p for p in lpl)
    return torch.logsumexp(parts.redistribute(mesh, whole), -1)


def _mesh_gold(logits, labels):
    """``gather(logits, -1, labels)`` of DTensors with the vocabulary
    split: each rank reads the labels that fall in its columns (0
    elsewhere), the result a partial sum over the vocabulary's axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    lpl = tuple(logits.placements)
    vocab = [i for i, p in enumerate(lpl) if p == Shard(logits.ndim - 1)]
    ypl = tuple(Replicate() if i in vocab or not isinstance(p, Shard) else p
                for i, p in enumerate(lpl))
    opl = tuple(Partial() if i in vocab else q for i, q in enumerate(ypl))
    names = axis_names(mesh)

    def body(lg, y):
        n = lg.shape[-1]
        loc = y.long() - mesh_coordinate(mesh, [names[i] for i in vocab]) * n
        ok = (loc >= 0) & (loc < n)
        got = torch.gather(lg, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, got, 0.0)
    return shard_map_compat(body, mesh, (lpl, ypl), opl)(logits, labels)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            embeds: torch.Tensor | None = None):
    """Returns ``(last-position logits [B, V], cache)``; the LM head runs
    on the last position only.  With a frontend's ``embeds`` [B, F, d]
    ahead of the tokens [B, S] the cache holds F + S positions."""
    x = _with_embeds(embed_tokens(cfg, params, tokens), embeds)
    x, cache, _ = _blocks(cfg, params, x, True)
    x = L.rmsnorm(params["final_norm"], x[:, -1])
    return _lm_head(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos):
    """One decode step.  token: [B] int; pos: the position written, an
    int or a 0-d int tensor on token's device (read there, never on the
    host).

    Returns ``(logits [B, V], cache)``; the cache is updated in place.
    An int ``pos`` must lie in the first attention layer's cache; a
    model without attention bounds it only below (the reference bounds
    it not at all)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=token.device, dtype=torch.int64).reshape(())
    else:
        seq = attn_cache_len(cfg, cache)
        if int(pos) < 0 or (seq is not None and int(pos) >= seq):
            raise ValueError(f"decode_step: pos {pos} outside the cache's "
                             f"{seq} positions")
        pos = torch.full((), int(pos), dtype=torch.int64, device=token.device)
    x = embed_tokens(cfg, params, token)                        # [B, d]
    for r in range(cfg.repeats):
        bp = _layer(params["blocks"], r)
        for i in range(cfg.period):
            p = bp[f"l{i}"]
            lc = _layer(cache[f"l{i}"], r)
            x = x + _apply_mixer_decode(cfg, i, p, L.rmsnorm(p["ln1"], x),
                                        lc, pos)
            if cfg.mlp_kind(i) != "none":
                # the MoE routes the B new tokens as one group
                h, _ = _apply_mlp(cfg, i, p,
                                  L.rmsnorm(p["ln2"], x)[:, None, :])
                x = x + h[:, 0, :]
    x = L.rmsnorm(params["final_norm"], x)
    return _lm_head(cfg, params, x), cache
