"""Streamed exact coarse screen: the top-m rows of a store by squared
distance, with no [B, N] distance matrix.

Counterpart of ``repro.kernels.screen``.  Two implementations share one
contract: ``(idx, d2)`` [B, m], ``d2`` ascending fp32, ties to the
lowest dataset index (``lax.top_k``'s order), equal to the materialized
``ref.screen_topm_ref`` on every finite slot.  A row with a +inf norm
never takes a slot from the initial carry, so every slot whose distance
is +inf, and every slot past N when m > N, carries ``d2 = +inf`` and
index 0 (the reference kernel's carry-first merge and clamp).

* :func:`screen_topm` -- hand-written CUDA kernel
  (``csrc/screen_topm.cu``), replacing ``repro/kernels/screen.py:151``
  (``screen_topm_pallas``).  The TPU kernel carries a [bq, m] top-m in
  VMEM across its sequential grid; Hopper's blocks run in parallel and
  that carry does not fit their shared memory, so the kernel radix-
  selects the m-th 64-bit key ``(bits(d2) << 32) | index`` in a few
  passes over the proxy store, compacts the m keys below it and sorts
  them per query.  Bound by the bytes of the store it reads.
* :func:`screen_topm_scan` -- its plain PyTorch version: the tiled
  carry loop of ``repro.kernels.screen.screen_topm_scan``, with a
  stable sort in place of ``lax.top_k``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DEFAULT_TILE = 4096     # the reference kernel's N-tile (VMEM block)
SCAN_TILE = 16384       # the plain carry loop's N-tile
MAX_PASSES = 8          # csrc/topm_select.cuh: radix passes at most
STATE_BYTES = 24        # csrc/topm_select.cuh: sizeof(topm::State)


def merge_topm(vals, idx, neg_tile, idx_tile, m: int, *extra):
    """Re-select the running top-m from ``[carry | tile]``.  ``vals``
    holds negated distances, descending; the carry comes first, so a
    stable descending sort sends ties to the lowest dataset index.
    ``extra`` are ``(carry, tile)`` pairs gathered along."""
    cat_v = torch.cat([vals, neg_tile], dim=-1)
    new_v, sel = torch.sort(cat_v, dim=-1, descending=True, stable=True)
    sel = sel[:, :m]
    out = [new_v[:, :m].contiguous(),
           torch.gather(torch.cat([idx, idx_tile], -1), -1, sel)]
    for carry, tile in extra:
        out.append(torch.gather(torch.cat([carry, tile], -1), -1, sel))
    return out


def tile_d2(q32, xt, qn, xnt):
    """Clamped matmul-form squared distances of one tile, fp32."""
    return torch.clamp_min(qn[:, None] + xnt[None, :] - 2.0 * (q32 @ xt.T),
                           0.0)


def scan_tiles(n: int, tile: int):
    """``(start, eff)`` per tile: a ragged last tile slides back to
    ``[n - tile, n)`` and its columns below ``start`` are re-seen."""
    for start in range(0, -(-n // tile) * tile, tile):
        yield start, min(start, n - tile)


def screen_topm_scan(q: torch.Tensor, x: torch.Tensor, m: int,
                     q_norms: torch.Tensor | None = None,
                     x_norms: torch.Tensor | None = None,
                     tile: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled carry loop over N: peak live memory O(B (m + tile)), the
    store sliced in place, never padded.  Returns ``(idx, d2)`` [B, m]:
    int64 indices, fp32 distances ascending."""
    n = x.shape[0]
    b = q.shape[0]
    tile = min(SCAN_TILE if tile is None else tile, max(n, 1))
    q32 = q.float()
    qn = (q32 * q32).sum(-1) if q_norms is None else q_norms.float()
    xn = ((x.float() ** 2).sum(-1) if x_norms is None
          else x_norms.float())
    vals = q32.new_full((b, m), float("-inf"))
    idx = torch.zeros((b, m), dtype=torch.int64, device=q.device)
    for start, eff in scan_tiles(n, tile):
        d2 = tile_d2(q32, x[eff: eff + tile].float(), qn,
                     xn[eff: eff + tile])
        cols = torch.arange(eff, eff + tile, device=q.device)
        neg = torch.where(cols >= start, -d2, float("-inf"))
        vals, idx = merge_topm(vals, idx, neg, cols.expand(b, -1), m)
    return torch.clamp_max(idx, max(n - 1, 0)), -vals


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
         + [ctypes.c_int] + [ctypes.c_void_p] * 3)


def scratch(b: int, n: int, m: int, device) -> dict:
    """The select's scratch: per-query state, histograms, counters and
    the [B, L] key buffer, L the power of two >= min(m, N)."""
    sel = min(m, n)
    length = 1 << max(sel - 1, 0).bit_length()
    return dict(
        st=torch.empty(b * STATE_BYTES, dtype=torch.uint8, device=device),
        hist=torch.empty(MAX_PASSES * b * 256, dtype=torch.int32,
                         device=device),
        cnt=torch.empty(b, dtype=torch.int32, device=device),
        keys=torch.empty(b * length, dtype=torch.int64, device=device),
        length=length)


def padded_batch(b: int) -> int:
    return -(-b // 16) * 16


def screen_topm(q: torch.Tensor, x: torch.Tensor, m: int,
                q_norms: torch.Tensor, x_norms: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: q [B, d], x [N, d], norms [B], [N] (fp32, CUDA,
    contiguous; +inf norms allowed on x) -> ``(idx [B, m] int64,
    d2 [B, m] fp32)``."""
    name = "screen_topm"
    _build.require(name, q.device, q=q, x=x, q_norms=q_norms,
                   x_norms=x_norms)
    _build.require_dtype(name, torch.float32, q=q, x=x, q_norms=q_norms,
                         x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "q_norms", q_norms, (b,))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    if n < 1 or m < 1:
        raise ValueError(f"{name}: needs N >= 1 and m >= 1, got N={n}, m={m}")
    s = scratch(b, n, m, q.device)
    qT = torch.empty(d * padded_batch(b), dtype=torch.float32,
                     device=q.device)
    idx = torch.empty((b, m), dtype=torch.int64, device=q.device)
    d2 = torch.empty((b, m), dtype=torch.float32, device=q.device)
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    fn = _build.load(name, "screen_topm_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), _build.ptr(q_norms),
             _build.ptr(x_norms), b, n, d, m, vec, _build.ptr(qT),
             _build.ptr(s["st"]), _build.ptr(s["hist"]), _build.ptr(s["cnt"]),
             _build.ptr(s["keys"]), s["length"], _build.ptr(idx),
             _build.ptr(d2), _build.stream(q.device))
    _build.check(name, err)
    screen_topm.launches += 1
    return idx, d2


screen_topm.launches = 0
