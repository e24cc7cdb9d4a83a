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
(gathers and einsums with a per-token length mask);
``merge_partials_psum`` merges them across the mesh axes that split the
KV cache.

Under a mesh (``distributed.sharding.use_rules`` with a ``DeviceMesh``)
the same functions take DTensors: ``shard`` puts an activation on the
rules' placements where the reference constrains it, and
``flash_attention`` runs kernel 9 (and ``ops.FlashAttention``) on each
rank's local shard under ``local_map``, so a DTensor never reaches a
kernel launch.  A head count that the model axis does not divide (40
query heads over 16) leaves the flat [B, S, H x dh] projection sharded;
DTensor cannot split heads unevenly (GSPMD pads), so ``split_heads``
gathers that dimension first: an all-gather the dry run counts.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (axis_names, axis_size,
                                              current_rules, is_dtensor,
                                              mesh_coordinate, mesh_pmax,
                                              mesh_psum, shard,
                                              shard_map_compat)
from repro_torch.kernels import ops
from repro_torch.models.module import ParamSpec

NEG_INF = -1e30


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), (None,), torch.float32, "ones")


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


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out].  Of DTensors, a local product
    under ``local_map`` on a layout chosen per mesh dimension (FSDP with
    tensor and sequence parallelism): where x splits its batch (dim 0), w
    is gathered and y keeps x's split; else where w splits its output
    dimension, x is gathered (column parallel: y split there); else
    where w splits its input dimension, x is split the same way and y is
    a partial sum (row parallel); else both are whole.  DTensor's own
    matmul may pick a layout (a sequence split) whose backward it cannot
    flatten, and GSPMD's layout for the reference is this one."""
    if not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.ndim - 1
    layout = []                     # (x, w, y) a mesh dimension
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(0) and last > 0:
            layout.append((px, Replicate(), px))
        elif pw == Shard(1):
            layout.append((Replicate(), pw, Shard(last)))
        elif pw == Shard(0):
            layout.append((Shard(last), pw, Partial()))
        else:
            layout.append((Replicate(),) * 3)
    xpl, wpl, ypl = zip(*layout)
    return shard_map_compat(torch.matmul, x.device_mesh, (xpl, wpl),
                            ypl)(x, w)


def mlp_specs(d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {"w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
            "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype)}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    h = shard(h, "batch", "seq", "act_mlp")
    return dense(h, p["w_down"])


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
    # the (heads * head_dim) axis stays flat, so the model axis divides
    # it even where it does not divide the heads (40 q heads over 16)
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    sp = {"wq": ParamSpec((d_model, h * dh), ("embed", "heads"), dtype),
          "wk": ParamSpec((d_model, kv * dh), ("embed", "kv_heads"), dtype),
          "wv": ParamSpec((d_model, kv * dh), ("embed", "kv_heads"), dtype),
          "wo": ParamSpec((h * dh, d_model), ("heads", "embed"), dtype)}
    if qkv_bias:
        sp["bq"] = ParamSpec((h * dh,), ("heads",), dtype, "zeros")
        sp["bk"] = ParamSpec((kv * dh,), ("kv_heads",), dtype, "zeros")
        sp["bv"] = ParamSpec((kv * dh,), ("kv_heads",), dtype, "zeros")
    return sp


def qkv_proj(p: dict, x: torch.Tensor, dims: AttnDims,
             positions: torch.Tensor, rope_theta: float):
    """x [B, S, d] -> q [B, S, H, dh], k / v [B, S, Hkv, dh]."""
    h, kv, dh = dims.num_heads, dims.num_kv_heads, dims.head_dim
    q, k, v = dense(x, p["wq"]), dense(x, p["wk"]), dense(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, h, dh)
    k = split_heads(k, kv, dh)
    v = split_heads(v, kv, dh)
    if rope_theta > 0:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


def split_heads(t: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """[B, S, n x dh] -> [B, S, n, dh].  A DTensor whose last dimension is
    split over mesh axes that do not divide ``n`` is gathered along it
    first (DTensor refuses to split a head)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.ndim - 1
        pl = list(t.placements)
        ways = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == last:
                ways *= t.device_mesh.size(i)
        if n % ways:
            pl = [Replicate() if isinstance(p, Shard) and p.dim == last
                  else p for p in pl]
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], n, dh)


def _local_attention(q, k, v, dims: AttnDims, causal: bool, q_chunk: int,
                     kv_chunk: int, h0: int = 0) -> torch.Tensor:
    """Attention of local tensors: q [B, S, Hq, dh] holds the query heads
    h0 .. h0 + Hq - 1, k / v [B, S, Hk, dh] their KV heads (Hk = Hq / G)
    or every KV head (the group is picked by h0)."""
    b, s, hq, dh = q.shape
    g = dims.q_per_kv
    if k.shape[2] * g != hq:               # all KV heads: take the group's
        k0 = h0 // g
        nk = max(1, hq // g)
        if hq % g and g % hq:
            raise ValueError(f"{hq} local query heads from {h0} straddle "
                             f"groups of {g}")
        k, v = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, hq // hk, dh).permute(0, 2, 3, 1, 4)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = ops.FlashAttention.apply(qg, kt, vt, causal, q_chunk, kv_chunk)
    else:
        out = ops.flash_attention(qg, kt, vt, causal=causal, qc=q_chunk,
                                  kc=kv_chunk)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh)


def _mesh_attention(q, k, v, dims: AttnDims, causal: bool, q_chunk: int,
                    kv_chunk: int) -> torch.Tensor:
    """``flash_attention`` of DTensors: each rank runs the local kernel
    on its batch rows and query heads (q's own placements on those two
    dimensions, the sequence and head_dim whole); K/V follow q's head
    split where the KV heads divide it, else every rank holds all KV
    heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = axis_names(mesh)
    qpl, kpl, head_axes = [], [], []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            qpl.append(p)
            kpl.append(p)
        elif isinstance(p, Shard) and p.dim == 2:
            qpl.append(p)
            head_axes.append(names[i])
            kpl.append(None)
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    ways = 1
    for a in head_axes:
        ways *= axis_size(mesh, a)
    kv_split = dims.num_kv_heads % ways == 0
    kpl = [(Shard(2) if kv_split else Replicate()) if p is None else p
           for p in kpl]
    hq = dims.num_heads // ways

    def body(ql, kl, vl):
        h0 = mesh_coordinate(mesh, head_axes) * hq
        return _local_attention(ql, kl, vl, dims, causal, q_chunk, kv_chunk,
                                h0)
    fn = shard_map_compat(body, mesh,
                          (tuple(qpl), tuple(kpl), tuple(kpl)), tuple(qpl))
    return fn(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dims: AttnDims, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: [B, S, H, dh]; k/v: [B, S, Hkv, dh] -> [B, S, H, dh].  The
    chunks are checked as the reference checks them and otherwise only
    order the sums.  When an input needs a gradient the call goes
    through ``ops.FlashAttention`` (the forward also keeps its row
    log-sum-exp for the backward kernel); otherwise it is the plain
    forward call, as in prefill.  DTensors run on each rank's local
    shard (``_mesh_attention``)."""
    if is_dtensor(q):
        return _mesh_attention(q, k, v, dims, causal, q_chunk, kv_chunk)
    return _local_attention(q, k, v, dims, causal, q_chunk, kv_chunk)


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


def merge_partials_psum(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                        axes, mesh=None) -> torch.Tensor:
    """Exact LSE merge of decode partials (m, l [.., G], acc [.., G, dh])
    across the mesh axes ``axes`` (local tensors, inside a ``local_map``
    body; ``mesh`` defaults to the current rules')."""
    mesh = current_rules().mesh if mesh is None else mesh
    m_g = mesh_pmax(m, mesh, axes)
    sc = torch.exp(m - m_g)
    l_g = mesh_psum(l * sc, mesh, axes)
    acc_g = mesh_psum(acc * sc[..., None], mesh, axes)
    return acc_g / torch.clamp_min(l_g, 1e-30)[..., None]


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
