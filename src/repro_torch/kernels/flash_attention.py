"""Hand-written CUDA kernels: causal (or full) GQA flash attention.

Replace ``repro/kernels/flash_attention.py:85`` (``flash_attention`` /
``_flash_kernel``), the prefill's attention.  Both keep the TPU kernel's
fp32 online softmax and its causal tile skipping, and share each K/V
tile across the G query heads of a KV head.  The route is chosen by
dtype, not tried in turn:

* bf16 (the model's dtype) -> ``csrc/flash_attention_sm90.cu``: wgmma on
  the tensor cores fed by TMA through an mbarrier ring; one CTA per (KV
  head, group of W <= 3 query heads, tile of 64 positions), one consumer
  warpgroup a head (``sm90_plan``).  P enters the P V product as two
  bf16 terms, P_hi + P_lo (the TPU kernel keeps it in fp32).
* fp32 (the ``--reduced`` configuration) -> ``csrc/flash_attention.cu``
  on the CUDA cores in fp32: a tensor-core product would be TF32 and
  miss fp32's tolerance.  The wrapper picks its query tile so that G x
  tile rows fit the kernel's 16 x RT row grid (``_tile``).

Given ``lse``, both kernels also write the row log-sum-exp of the scaled
scores (fp32) that the training backward reads; the prefill passes none.

The TPU's VMEM tile sizes (``qc``, ``kc``) only order the sums and are
not taken here.  The plain version is ``ref.flash_attention_ref``;
``ops.flash_attention`` picks between it and this by device.

``flash_attention_bwd`` is the gradient (no TPU counterpart: the
reference differentiates its attention by autodiff): three launches (D =
rowsum(dO o), dK/dV over key tiles, dQ over query tiles), routed by
dtype like the forward:

* bf16 -> ``csrc/flash_attention_bwd_sm90.cu``: wgmma on TMA-fed tiles,
  P^T, dS^T and dS kept in registers as wgmma's A operands (the dQ
  launch takes the forward's grid: ``sm90_plan``'s W heads a CTA).
* fp32 -> ``csrc/flash_attention_bwd.cu`` on the CUDA cores.

Its plain version is ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
         + [ctypes.c_void_p])
_ARGS_SM90 = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
              + [ctypes.c_void_p])
_ARGS_BWD = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])
_ARGS_BWD_SM90 = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                  + [ctypes.c_float] + [ctypes.c_void_p])
HEAD_DIMS = (32, 64, 128)          # head dims the kernels are compiled for
MAX_ROWS = 128                     # 16 x RT rows a block, RT <= 8
SM90_BQ = 64                       # positions a warpgroup tile (wgmma's M)
SM90_MAX_W = 3                     # consumer warpgroups a CTA


def sm90_plan(g: int) -> tuple[int, int]:
    """(W, head groups) of the bf16 kernel for G query heads per KV head:
    a CTA runs W = min(G, 3) consumer warpgroups, warpgroup w owning the
    64 rows (head group * W + w, one tile of positions); a head index
    past G pads the last group and its warpgroup does nothing."""
    if g < 1:
        raise ValueError(f"flash_attention: G={g} query heads per KV head")
    w = min(g, SM90_MAX_W)
    return w, -(-g // w)


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


def _require_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, **same) -> tuple[int, ...]:
    """The checks both directions share: CUDA, contiguous, 16-byte
    aligned, all fp32 or all bf16 (``same``: more tensors of q's dtype,
    checked by q's shape when 5-D and k's otherwise), q [B, Hkv, G, S,
    dh] and k/v [B, Hkv, S, dh] with dh in HEAD_DIMS.  Returns q's
    shape."""
    _build.require(name, q.device, q=q, k=k, v=v, **same)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    _build.require_dtype(name, q.dtype, k=k, v=v, **same)
    if q.dim() != 5:
        raise ValueError(f"{name}: q must be [B, Hkv, G, S, dh], got "
                         f"{tuple(q.shape)}")
    b, hkv, g, s, dh = q.shape
    _build.require_shape(name, "k", k, (b, hkv, s, dh))
    _build.require_shape(name, "v", v, (b, hkv, s, dh))
    for arg, t in same.items():
        _build.require_shape(name, arg, t, q.shape if t.dim() == 5
                             else k.shape)
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    for arg, t in (("q", q), ("k", k), ("v", v), *same.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    return b, hkv, g, s, dh


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False):
    """q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh] (CUDA, contiguous, all
    fp32 or all bf16) -> [B, Hkv, G, S, dh] in q's dtype, and with
    ``return_lse`` also the row log-sum-exp of the scaled scores [B, Hkv,
    G, S] in fp32.  bf16 runs the tensor-core kernel, fp32 the CUDA-core
    one (see the module note)."""
    name = "flash_attention"
    b, hkv, g, s, dh = _require_qkv(name, q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hkv, g, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = _build.ptr(lse) if return_lse else ctypes.c_void_p(None)
    if q.dtype == torch.bfloat16:
        lib = "flash_attention_sm90"
        fn = _build.load(lib, "flash_attention_sm90_launch", _ARGS_SM90)
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(out), lse_ptr, b * hkv, g, s, dh,
                 sm90_plan(g)[0], int(causal), float(dh ** -0.5),
                 _build.stream(q.device))
    else:
        lib = name
        bq, rt = _tile(g)
        fn = _build.load(lib, "flash_attention_launch", _ARGS)
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                 _build.ptr(out), lse_ptr, b * hkv, g, s, dh, bq, rt,
                 int(causal), float(dh ** -0.5), _build.stream(q.device))
    _build.check(lib, err)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True):
    """The gradient of ``flash_attention``: q, o, do [B, Hkv, G, S, dh],
    k/v [B, Hkv, S, dh] (CUDA, contiguous, all fp32 or all bf16), lse
    [B, Hkv, G, S] fp32 (the forward's) -> (dq, dk, dv) in q's dtype.
    bf16 runs the wgmma kernels, fp32 the CUDA-core ones (see the module
    note); one call is three launches and counts one."""
    name = "flash_attention_bwd"
    b, hkv, g, s, dh = _require_qkv(name, q, k, v, o=o, do=do)
    _build.require(name, q.device, lse=lse)
    _build.require_dtype(name, torch.float32, lse=lse)
    _build.require_shape(name, "lse", lse, (b, hkv, g, s))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty_like(lse)                     # D = rowsum(dO o)
    ptrs = [_build.ptr(t) for t in (q, k, v, o, do, lse, dd, dq, dk, dv)]
    if q.dtype == torch.bfloat16:
        lib = "flash_attention_bwd_sm90"
        w = sm90_plan(g)[0]
        fn = _build.load(lib, "flash_attention_bwd_sm90_launch",
                         _ARGS_BWD_SM90)
        err = fn(*ptrs, b * hkv, g, s, dh, w, int(causal),
                 float(dh ** -0.5), _build.stream(q.device))
    else:
        lib = name
        fn = _build.load(lib, "flash_attention_bwd_launch", _ARGS_BWD)
        err = fn(*ptrs, b * hkv, g, s, dh, int(causal), float(dh ** -0.5),
                 _build.stream(q.device))
    _build.check(lib, err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
