"""Golden (top-kb block-sparse) decode attention on a KV cache.

The paper's coarse-to-fine golden subset transplanted onto the cache:
``select_golden_blocks`` scores each (batch, KV head) query group
against mean-pooled key blocks (the proxy) and keeps the top kb blocks;
``golden_attention_decode`` then attends exactly over those blocks
only.

The kernel replaces ``repro/kernels/golden_attention.py:85``
(``golden_attention_decode`` / ``_gattn_kernel``) as split-kb
flash-decoding (``csrc/golden_attention.cu``): the kb selected blocks of
each (b, h) are cut into chunks of c blocks (``split_chunks``), one CUDA
block per (b * Hkv, chunk) loads each valid block's K and V rows from
the cache by index, paged-attention style (no gathered copy), shares
them across the G query heads and writes a partial (m, l, acc) to fp32
scratch; a second launch merges the chunks by log-sum-exp in a fixed
order.  It is bound by the bytes of the valid blocks.  A (b, h) with no
valid block gives 0, as the TPU kernel does; the plain version
``ref.golden_attention_decode_ref`` follows it.
``select_golden_blocks`` is plain PyTorch, as in the reference: a
stable descending sort, so ties go to the lowest block (``lax.top_k``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float]
         + [ctypes.c_void_p])
HEAD_DIMS = (32, 64, 128)          # head dims the kernel is compiled for
CTAS_PER_SM = 4                    # the split's target occupancy


def split_chunks(bh: int, kb: int, sms: int) -> tuple[int, int]:
    """(c, nch): each (b, h)'s kb blocks in nch chunks of c (the last may
    be shorter, none empty), so that the B * Hkv * nch CTAs are about
    four per SM of a card with ``sms`` SMs, and one block a CTA where
    that is all there is (B * Hkv * kb <= 4 * sms).  kb = 0 gives one
    empty chunk."""
    if kb <= 0:
        return 1, 1
    c = max(1, bh * kb // (CTAS_PER_SM * sms))
    nch = -(-kb // c)
    c = -(-kb // nch)                  # even out the chunks
    return c, -(-kb // c)


def select_golden_blocks(q: torch.Tensor, k: torch.Tensor, num_blocks: int,
                         block_size: int = 128
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse screen over block summaries (paper Eq. 4 analogue): the
    mean of the G query heads against each block's mean key.  q [B,
    Hkv, G, dh], k [B, Hkv, S, dh] -> ``(block_idx, valid)`` int32 [B,
    Hkv, min(num_blocks, S // block_size)], best block first, ties to
    the lowest block."""
    b, hkv, g, dh = q.shape
    nb = k.shape[2] // block_size
    summaries = (k.reshape(b, hkv, nb, block_size, dh).float().mean(3)
                 .to(k.dtype))
    scores = torch.einsum("bhd,bhnd->bhn", q.mean(2).float(),
                          summaries.float())
    kb = min(num_blocks, nb)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :kb]
    idx = idx.to(torch.int32)
    return idx, torch.ones_like(idx)


def golden_attention_decode(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, block_idx: torch.Tensor,
                            valid: torch.Tensor, block_size: int
                            ) -> torch.Tensor:
    """Exact attention over the valid golden blocks only: q [B, Hkv, G,
    dh], k/v [B, Hkv, S, dh] (CUDA, contiguous; q and the cache each
    fp32 or bf16), block_idx / valid [B, Hkv, kb] int32 -> [B, Hkv, G,
    dh] in q's dtype."""
    name, lib = "golden_attention_decode", "golden_attention"
    _build.require(name, q.device, q=q, k=k, v=v, block_idx=block_idx,
                   valid=valid)
    for arg, t in (("q", q), ("k", k)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: {arg} must be float32 or bfloat16, "
                             f"got {t.dtype}")
    _build.require_dtype(name, k.dtype, v=v)
    _build.require_dtype(name, torch.int32, block_idx=block_idx, valid=valid)
    b, hkv, g, dh = q.shape
    s = k.shape[2]
    kb = block_idx.shape[-1]
    _build.require_shape(name, "k", k, (b, hkv, s, dh))
    _build.require_shape(name, "v", v, (b, hkv, s, dh))
    _build.require_shape(name, "block_idx", block_idx, (b, hkv, kb))
    _build.require_shape(name, "valid", valid, (b, hkv, kb))
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    if s % block_size or s == 0:
        raise ValueError(f"{name}: cache length {s} is not a positive "
                         f"multiple of block_size={block_size}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    c, nch = split_chunks(
        b * hkv, kb,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    part = torch.empty(b * hkv * nch * g * (dh + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    fn = _build.load(lib, "golden_attention_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
             _build.ptr(block_idx), _build.ptr(valid), _build.ptr(part),
             _build.ptr(out), b * hkv, g, s, dh, block_size, kb, c, nch,
             int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
             float(1.0 / dh ** 0.5), _build.stream(q.device))
    _build.check(lib, err)
    golden_attention_decode.launches += 1
    return out


golden_attention_decode.launches = 0
