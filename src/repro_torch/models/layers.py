"""Shared transformer layers (counterpart of ``repro.models.layers``):
RMSNorm, RoPE, the SwiGLU MLP, GQA projections, causal flash attention
for prefill and training (through ``kernels.ops.flash_attention``: the
hand-written kernel on the card, its plain version on the CPU; with a
gradient through ``ops.FlashAttention``, whose backward is the
hand-written backward kernel), and decode attention
as mergeable online-softmax partials, full or golden (top-kb blocks by
mean-pooled key summaries).

GQA head order is the reference's: query head h is (kv = h // G, g =
h % G).  The decode partials stay plain PyTorch, as in the reference
(gathers and einsums with a per-token length mask).  The cross-shard
merge (``merge_partials_psum``) waits for the sharding slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import ParamSpec

NEG_INF = -1e30


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), torch.float32, "ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: broadcastable to [..., S]."""
    half = x.shape[-1] // 2
    # a Python-float base: no host-to-device copy (and no sync) per call
    freq = float(theta) ** (-torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., None].float() * freq               # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {"w_gate": ParamSpec((d_model, d_ff), dtype),
            "w_up": ParamSpec((d_model, d_ff), dtype),
            "w_down": ParamSpec((d_ff, d_model), dtype)}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    num_heads: int
    num_kv_heads: int
    head_dim: int

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def attn_specs(d_model: int, dims: AttnDims, dtype: torch.dtype,
               qkv_bias: bool) -> dict:
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    sp = {"wq": ParamSpec((d_model, h * dh), dtype),
          "wk": ParamSpec((d_model, kv * dh), dtype),
          "wv": ParamSpec((d_model, kv * dh), dtype),
          "wo": ParamSpec((h * dh, d_model), dtype)}
    if qkv_bias:
        sp["bq"] = ParamSpec((h * dh,), dtype, "zeros")
        sp["bk"] = ParamSpec((kv * dh,), dtype, "zeros")
        sp["bv"] = ParamSpec((kv * dh,), dtype, "zeros")
    return sp


def qkv_proj(p: dict, x: torch.Tensor, dims: AttnDims,
             positions: torch.Tensor, rope_theta: float):
    """x [B, S, d] -> q [B, S, H, dh], k / v [B, S, Hkv, dh]."""
    b, s = x.shape[:2]
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if rope_theta > 0:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dims: AttnDims, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: [B, S, H, dh]; k/v: [B, S, Hkv, dh] -> [B, S, H, dh].  The
    chunks are checked as the reference checks them and otherwise only
    order the sums.  When an input needs a gradient the call goes
    through ``ops.FlashAttention`` (the forward also keeps its row
    log-sum-exp for the backward kernel); otherwise it is the plain
    forward call, as in prefill."""
    b, s, h, dh = q.shape
    qg = q.reshape(b, s, dims.num_kv_heads, dims.q_per_kv, dh).permute(
        0, 2, 3, 1, 4)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = ops.FlashAttention.apply(qg, kt, vt, causal, q_chunk, kv_chunk)
    else:
        out = ops.flash_attention(qg, kt, vt, causal=causal, qc=q_chunk,
                                  kc=kv_chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


def decode_attention_local(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length_mask: torch.Tensor):
    """Single-token attention partials (m, l, acc) over a KV cache.

    q: [B, Hkv, G, dh]; k/v: [B, Hkv, S, dh]; length_mask: [B, S] bool."""
    dh = q.shape[-1]
    s_ = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * dh ** -0.5
    s_ = torch.where(length_mask[:, None, None, :], s_, NEG_INF)
    m = s_.amax(-1)
    p = torch.exp(s_ - m[..., None])
    return m, p.sum(-1), torch.einsum("bhgs,bhsd->bhgd", p, v.float())


def block_summaries(k: torch.Tensor, length_mask: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Masked mean-pooled key blocks: [B,Hkv,S,dh] -> [B,Hkv,nb,dh]."""
    b, hkv, s, dh = k.shape
    nb = s // block_size
    lm = length_mask.reshape(b, nb, block_size)
    cnt = torch.clamp_min(lm.sum(-1), 1)[:, None, :, None]
    return ((k.reshape(b, hkv, nb, block_size, dh)
             * lm[:, None, :, :, None]).sum(3) / cnt).to(k.dtype)


def golden_block_idx(q: torch.Tensor, summ: torch.Tensor,
                     length_mask: torch.Tensor, num_blocks: int,
                     block_size: int) -> torch.Tensor:
    """The top-kb golden blocks [B, Hkv, kb] of each (b, kv head): the
    mean query head against the block summaries, blocks with no live key
    at NEG_INF, ties to the lowest block (a stable sort, as
    ``lax.top_k``)."""
    b, nb = length_mask.shape[0], summ.shape[2]
    live = length_mask.reshape(b, nb, block_size).any(-1)
    scores = torch.einsum("bhd,bhnd->bhn", q.mean(2).float(), summ.float())
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    kb = min(num_blocks, nb)
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :kb]


def golden_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length_mask: torch.Tensor, num_blocks: int,
                           block_size: int,
                           summaries: torch.Tensor | None = None):
    """Golden attention on the KV cache: coarse-screen the block
    summaries (``summaries`` if cached, else recomputed), then exact
    partials (m, l, acc) over the top-kb golden blocks only."""
    b, hkv, g, dh = q.shape
    nb = k.shape[2] // block_size
    lm = length_mask.reshape(b, nb, block_size)
    summ = (block_summaries(k, length_mask, block_size)
            if summaries is None else summaries)
    idx = golden_block_idx(q, summ, length_mask, num_blocks, block_size)
    kb = idx.shape[-1]
    take = idx[..., None, None]
    kg = torch.take_along_dim(k.reshape(b, hkv, nb, block_size, dh), take, 2)
    vg = torch.take_along_dim(v.reshape(b, hkv, nb, block_size, dh), take, 2)
    mg = torch.take_along_dim(lm[:, None], idx[..., None], 2)  # [B,Hkv,kb,bs]
    s_ = torch.einsum("bhgd,bhkcd->bhgkc", q.float(), kg.float()) * dh ** -0.5
    s_ = torch.where(mg[:, :, None], s_, NEG_INF).reshape(
        b, hkv, g, kb * block_size)
    m = s_.amax(-1)
    p = torch.exp(s_ - m[..., None]).reshape(b, hkv, g, kb, block_size)
    acc = torch.einsum("bhgkc,bhkcd->bhgd", p, vg.float())
    return m, p.sum((-1, -2)), acc
