"""Hand-written CUDA kernel: causal (or full) GQA flash attention.

Replaces ``repro/kernels/flash_attention.py:85`` (``flash_attention`` /
``_flash_kernel``), the prefill's attention.  The kernel
(``csrc/flash_attention.cu``) keeps the TPU kernel's fp32 online
softmax and its causal tile skipping; one CUDA block takes one KV head
and a tile of query positions for all G query heads at once, so each
K/V tile crosses HBM once for the G heads.  The TPU's VMEM tile sizes
(``qc``, ``kc``) only order the sums and are not taken here: the
wrapper picks the query tile so that G x tile rows fit the kernel's
16 x RT row grid.  It runs on the CUDA cores in fp32; its bound at the
prefill's shape is the bf16 tensor cores (see the source).  Its plain
version is ``ref.flash_attention_ref``; ``ops.flash_attention`` picks
between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
         + [ctypes.c_void_p])
HEAD_DIMS = (32, 64, 128)          # head dims the kernel is compiled for
MAX_ROWS = 128                     # 16 x RT rows a block, RT <= 8


def _tile(g: int) -> tuple[int, int]:
    """(query positions per block, row groups RT of 16): the largest
    power-of-two tile up to 64 positions whose G x tile rows fit 128."""
    bq = 64
    while bq > 1 and g * bq > MAX_ROWS:
        bq //= 2
    if g * bq > MAX_ROWS:
        raise ValueError(f"flash_attention: G={g} query heads per KV head "
                         f"exceed the kernel's {MAX_ROWS} rows a block")
    return bq, -(-g * bq // 16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh] (CUDA, contiguous, all
    fp32 or all bf16) -> [B, Hkv, G, S, dh] in q's dtype."""
    name = "flash_attention"
    _build.require(name, q.device, q=q, k=k, v=v)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    _build.require_dtype(name, q.dtype, k=k, v=v)
    if q.dim() != 5:
        raise ValueError(f"{name}: q must be [B, Hkv, G, S, dh], got "
                         f"{tuple(q.shape)}")
    b, hkv, g, s, dh = q.shape
    _build.require_shape(name, "k", k, (b, hkv, s, dh))
    _build.require_shape(name, "v", v, (b, hkv, s, dh))
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    bq, rt = _tile(g)
    out = torch.empty_like(q)
    fn = _build.load(name, "flash_attention_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             b * hkv, g, s, dh, bq, rt, int(causal),
             int(q.dtype == torch.bfloat16), float(dh ** -0.5),
             _build.stream(q.device))
    _build.check(name, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
