"""Decoder prefill and decode (counterpart of ``repro.models.transformer``)
for dense attention models (the llama family).

  * prefill — the full-sequence forward over the prompt; every attention
              layer runs causal flash attention (``layers.flash_attention``:
              the hand-written kernel on the card) and fills the KV cache
              [repeats, B, Hkv, S, dh] (plus block summaries when
              ``golden_cached_summaries``).
  * decode  — one new token at position ``pos`` against the cache, with
              full attention or golden attention (the paper's
              coarse-to-fine subset on the KV cache), on one device.

Differences from the reference:

  * the layer loop is a Python loop (no scan);
  * ``decode_step`` writes the new key, value and summary into the given
    cache in place and returns the same dict (the reference's functional
    update copies the whole stacked cache).  A second call at the same
    position from the same cache is the reference's result only without
    cached summaries, whose running mean is not idempotent;
  * ``pos`` is a Python int, so no step reads a device value back;
  * ``prefill`` applies the LM head to the last position only, whose
    logits it returns (as the reference does, over ``padded_vocab``).

Mamba mixers, MoE MLPs, the loss and training (with remat) and the
modality frontends raise ``NotImplementedError`` naming their ROADMAP
item; decode runs on one device (the sharded decode waits for the
sharding slice).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import ParamSpec, stack_specs, tree_map
from repro_torch.utils import resolve_device

OTHER_FAMILIES = "ROADMAP Queue 1: the other model families"
LLM_TRAINING = "ROADMAP Queue 1: LLM training (steps.py / train.py)"


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


def _attn_dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.hdim)


def _check_layer(cfg: ModelConfig, i: int) -> None:
    if cfg.mixer_kind(i) != "A":
        raise _unported("the Mamba-2 mixer", OTHER_FAMILIES)
    if cfg.mlp_kind(i) == "moe":
        raise _unported("the MoE MLP", OTHER_FAMILIES)


def _layer_specs(cfg: ModelConfig, i: int) -> dict:
    _check_layer(cfg, i)
    dt = cfg.param_dtype
    sp = {"ln1": L.rmsnorm_spec(cfg.d_model),
          "attn": L.attn_specs(cfg.d_model, _attn_dims(cfg), dt,
                               cfg.qkv_bias)}
    if cfg.mlp_kind(i) == "dense":
        sp["ln2"] = L.rmsnorm_spec(cfg.d_model)
        sp["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff, dt)
    return sp


def model_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter tree: ``embed``, ``blocks/l{i}`` with
    leaves stacked over ``repeats``, ``final_norm`` and ``lm_head`` when
    the embeddings are not tied."""
    dt = cfg.param_dtype
    period = {f"l{i}": _layer_specs(cfg, i) for i in range(cfg.period)}
    sp = {"embed": ParamSpec((cfg.padded_vocab, cfg.d_model), dt, "embed",
                             scale=0.02),
          "blocks": stack_specs(period, cfg.repeats),
          "final_norm": L.rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab), dt,
                                  scale=0.02)
    return sp


def _golden_summaries(cfg: ModelConfig) -> bool:
    return cfg.attn_kind_decode == "golden" and cfg.golden_cached_summaries


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{"l{i}": {"k": (shape, dtype), "v": ..., ["summ": ...]}}``."""
    dt = cfg.param_dtype
    out = {}
    for i in range(cfg.period):
        _check_layer(cfg, i)
        shp = (cfg.repeats, batch, cfg.num_kv_heads, seq_len, cfg.hdim)
        out[f"l{i}"] = {"k": (shp, dt), "v": (shp, dt)}
        if _golden_summaries(cfg):
            nb = seq_len // cfg.golden_block_size
            out[f"l{i}"]["summ"] = ((cfg.repeats, batch, cfg.num_kv_heads,
                                     nb, cfg.hdim), dt)
    return out


def _alloc_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
                 fill) -> dict:
    return {li: {name: fill(shp, dtype=dt, device=device)
                 for name, (shp, dt) in leaves.items()}
            for li, leaves in cache_specs(cfg, batch, seq_len).items()}


def zero_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> dict:
    """A zeroed decode cache on ``device`` (the CUDA card unless the
    caller names another)."""
    return _alloc_cache(cfg, batch, seq_len, resolve_device(device),
                        torch.zeros)


def _layer(tree: dict, r: int) -> dict:
    """Repeat r's slice of every stacked leaf (views, not copies)."""
    return tree_map(lambda t: t[r], tree)


def _apply_mixer_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict | None
                      ) -> torch.Tensor:
    """Prefill attention; writes this layer's K/V (and summaries) into
    ``cache`` (repeat r's views) when given."""
    dims = _attn_dims(cfg)
    q, k, v = L.qkv_proj(p["attn"], x, dims, positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v, dims, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk)
    b, s = o.shape[:2]
    y = o.reshape(b, s, -1) @ p["attn"]["wo"]
    if cache is not None:
        kc = k.transpose(1, 2)
        cache["k"].copy_(kc)
        cache["v"].copy_(v.transpose(1, 2))
        if "summ" in cache:
            full = torch.ones((b, s), dtype=torch.bool, device=x.device)
            cache["summ"].copy_(L.block_summaries(kc, full,
                                                  cfg.golden_block_size))
    return y


def _decode_attention(cfg: ModelConfig, q: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, mask: torch.Tensor,
                      summ: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, Hkv, G, dh]; kc/vc: [B, Hkv, S, dh]; mask: [B, S] ->
    [B, Hkv, G, dh] (one device: the cross-shard merge waits for the
    sharding slice)."""
    if cfg.attn_kind_decode == "golden":
        _, l, acc = L.golden_decode_partials(
            q, kc, vc, mask, max(1, cfg.golden_blocks),
            cfg.golden_block_size, summaries=summ)
    else:
        _, l, acc = L.decode_attention_local(q, kc, vc, mask)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _apply_mixer_decode(cfg: ModelConfig, p: dict, x1: torch.Tensor,
                        cache: dict, pos: int) -> torch.Tensor:
    """Decode attention for x1 [B, d] at ``pos``: writes the new K/V row
    (and the running-mean summary of its block) into ``cache`` (repeat
    r's views) in place, then attends over positions <= pos."""
    dims = _attn_dims(cfg)
    b = x1.shape[0]
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x1.device)
    q, k, v = L.qkv_proj(p["attn"], x1[:, None, :], dims, positions,
                         cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    k_new = k.transpose(1, 2)                               # [B, Hkv, 1, dh]
    kc[:, :, pos:pos + 1] = k_new
    vc[:, :, pos:pos + 1] = v.transpose(1, 2)
    s = kc.shape[2]
    mask = (torch.arange(s, device=x1.device) <= pos).expand(b, s)
    qg = q[:, 0].reshape(b, dims.num_kv_heads, dims.q_per_kv, dims.head_dim)
    summ = cache.get("summ")
    if summ is not None:
        # running mean of the block from the new key only:
        # m <- m + (k_new - m) / c, c = pos % bs + 1
        bs = cfg.golden_block_size
        blk, c = pos // bs, float(pos % bs + 1)
        kf = k_new.float()
        old = summ[:, :, blk:blk + 1].float()
        mean = kf if c == 1.0 else old + (kf - old) / c
        summ[:, :, blk:blk + 1] = mean.to(summ.dtype)
    o = _decode_attention(cfg, qg, kc, vc, mask, summ)
    return o.reshape(b, -1) @ p["attn"]["wo"]


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens]


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w


def _blocks(cfg: ModelConfig, params: dict, x: torch.Tensor,
            want_cache: bool):
    """Every layer over x [B, S, d]; returns (x, cache | None)."""
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :]
    cache = (_alloc_cache(cfg, b, s, x.device, torch.empty) if want_cache
             else None)
    for r in range(cfg.repeats):
        bp = _layer(params["blocks"], r)
        for i in range(cfg.period):
            _check_layer(cfg, i)
            p = bp[f"l{i}"]
            lc = _layer(cache[f"l{i}"], r) if want_cache else None
            x = x + _apply_mixer_full(cfg, p, L.rmsnorm(p["ln1"], x),
                                      positions, lc)
            if cfg.mlp_kind(i) != "none":
                x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x))
    return x, cache


def forward_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 want_cache: bool = False, mode: str = "prefill"):
    """Full-sequence forward.  x: [B, S, d] embeddings.

    Returns ``(logits [B, S, V], cache | None)``."""
    if mode != "prefill":
        raise _unported(f"forward_full(mode={mode!r}) (the loss and "
                        f"remat)", LLM_TRAINING)
    x, cache = _blocks(cfg, params, x, want_cache)
    return _lm_head(cfg, params, L.rmsnorm(params["final_norm"], x)), cache


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01):
    """The training loss (next-token NLL + z-loss) waits for LLM
    training."""
    raise _unported("loss_fn", LLM_TRAINING)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            embeds: torch.Tensor | None = None):
    """Returns ``(last-position logits [B, V], cache)``; the LM head runs
    on the last position only."""
    if embeds is not None:
        raise _unported("the modality frontends", OTHER_FAMILIES)
    x, cache = _blocks(cfg, params, embed_tokens(cfg, params, tokens), True)
    x = L.rmsnorm(params["final_norm"], x[:, -1])
    return _lm_head(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: int):
    """One decode step.  token: [B] int; pos: int (the position written).

    Returns ``(logits [B, V], cache)``; the cache is updated in place."""
    pos = int(pos)
    x = params["embed"][token]                                  # [B, d]
    for r in range(cfg.repeats):
        bp = _layer(params["blocks"], r)
        for i in range(cfg.period):
            _check_layer(cfg, i)
            p = bp[f"l{i}"]
            lc = _layer(cache[f"l{i}"], r)
            x = x + _apply_mixer_decode(cfg, p, L.rmsnorm(p["ln1"], x), lc,
                                        pos)
            if cfg.mlp_kind(i) != "none":
                x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x))
    x = L.rmsnorm(params["final_norm"], x)
    return _lm_head(cfg, params, x), cache
