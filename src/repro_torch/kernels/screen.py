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
  selects the m-th 64-bit key ``(bits(d2) << 32) | index`` in passes of
  11-bit digits over the proxy store (:func:`radix_plan`), stopping as
  soon as at most :func:`select_cap` keys lie at or below the bin that
  holds it; it compacts those keys, sorts them in chunks, merges the
  chunks (:func:`sort_plan`) and keeps the first m.  Bound by the bytes
  of the store it reads; its bf16-row instance (the engine's
  ``storage_dtype``) reads half of them and widens each value.
* :func:`screen_topm_scan` -- its plain PyTorch version: the tiled
  carry loop of ``repro.kernels.screen.screen_topm_scan``, with a
  stable sort in place of ``lax.top_k``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, finite_inv_two_sigma2

DEFAULT_TILE = 4096     # the reference kernel's N-tile (VMEM block)
SCAN_TILE = 16384       # the plain carry loop's N-tile
# csrc/topm_select.cuh, which takes its plan from the functions below
STATE_BYTES = 24        # sizeof(topm::State)
RADIX_BITS = 11         # a digit's bits at most (2048 bins)
HIST_INTS = 2048 + 64   # a query's histogram a pass: fine bins, coarse groups
QUERY_GROUP = 16        # queries a radix block takes
MAX_PASSES = 6          # 3 distance digits + up to 3 row digits
SORT_CHUNK = 2048       # keys one CTA sorts in shared memory
# Bit 63 of a key is the distance's sign bit, always 0 (d2 >= 0, -0.0
# folded to +0.0), so three digits resolve the distance's 31 other bits.
DIST_DIGITS = ((52, 11), (41, 11), (32, 9))


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


def full_scan_partial_stream(q: torch.Tensor, x: torch.Tensor,
                             sigma2: float,
                             x_norms: torch.Tensor | None = None,
                             tile: int = DEFAULT_TILE
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Unnormalized softmax state ``(acc [B, D], m [B], l [B])`` of the
    whole store in one tiled pass (the reference's
    ``full_scan_partial_stream``): logits clamped at the finite NEG_INF
    as in the dense form, so the states merge exactly across shards; a
    ragged last tile slides back and its re-seen columns get a hard
    -inf (zero weight even when every logit is NEG_INF).  Peak live
    memory O(B (tile + D))."""
    n, d = x.shape
    b = q.shape[0]
    q32 = q.float()
    qn = (q32 * q32).sum(-1)
    xn = ((x.float() ** 2).sum(-1) if x_norms is None else x_norms.float())
    tile = min(tile, max(n, 1))
    inv = finite_inv_two_sigma2(sigma2)
    m_run = q32.new_full((b,), NEG_INF)
    l_run = q32.new_zeros((b,))
    acc = q32.new_zeros((b, d))
    for start, eff in scan_tiles(n, tile):
        xt = x[eff: eff + tile].float()
        lg = torch.clamp_min(-tile_d2(q32, xt, qn, xn[eff: eff + tile])
                             * inv, NEG_INF)
        cols = torch.arange(eff, eff + tile, device=q.device)
        lg = torch.where(cols >= start, lg, float("-inf"))
        m_new = torch.maximum(m_run, lg.amax(-1))
        scale = torch.exp(m_run - m_new)
        p = torch.exp(lg - m_new[:, None])
        l_run = l_run * scale + p.sum(-1)
        acc = acc * scale[:, None] + p @ xt
        m_run = m_new
    return acc, m_run, l_run


_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 6 + [ctypes.c_void_p] + [ctypes.c_int] * 2
         + [ctypes.c_void_p] * 6)


def select_cap(n: int, m: int) -> int:
    """Keys a query may select on the way to its m nearest of n rows:
    a radix pass reads the whole store, while sorting one more chunk of
    keys costs far less, so the select stops once at most m + SORT_CHUNK
    keys lie at or below the m-th key's bin (on float data, after the
    second pass; a tie wider than the slack takes the row passes).  At
    least m, at most n."""
    return min(m + SORT_CHUNK, n)


def radix_plan(n: int, m: int) -> tuple[tuple[int, int], ...]:
    """``(shift, width)`` of each radix pass that selects m of n rows by
    the key ``(bits(d2) << 32) | row``: the three distance digits, then
    11-bit digits of the row index from its top bit down (only the bits
    that n - 1 needs).  A query leaves the passes as soon as its cap is
    met, so a row pass does work only when a tie spans more keys than
    the slack.  None when the cap takes every row."""
    if select_cap(n, m) >= n:
        return ()
    bits = (n - 1).bit_length()
    top = RADIX_BITS * ((bits - 1) // RADIX_BITS) if bits else -1
    return DIST_DIGITS + tuple((s, min(RADIX_BITS, bits - s))
                               for s in range(top, -1, -RADIX_BITS))


def sort_plan(s: int) -> tuple[int, int, int]:
    """``(chunk, chunks, rounds)`` of the sort of a query's s = cap
    slots: chunks of a power of two from 64 to SORT_CHUNK keys, each
    sorted by one CTA, then ``ceil(log2(chunks))`` merge rounds."""
    chunk = min(SORT_CHUNK, max(64, 1 << max(s - 1, 0).bit_length()))
    chunks = -(-s // chunk)
    return chunk, chunks, (chunks - 1).bit_length()


def scratch_sizes(b: int, n: int, m: int) -> dict:
    """Element counts of the select's scratch for B queries: ``state``
    bytes, ``work`` int32 (per-query counters, then per pass a ticket per
    query group and a histogram per query), ``keys`` uint64 (two halves
    of ``cap`` slots a query, between which the sort's runs alternate;
    the fused kernel's payloads take as many fp32)."""
    passes = len(radix_plan(n, m))
    groups = -(-b // QUERY_GROUP)
    cap = select_cap(n, m)
    return dict(state=b * STATE_BYTES,
                work=b + passes * (groups + b * HIST_INTS),
                keys=2 * b * cap, cap=cap)


def scratch(b: int, n: int, m: int, device) -> dict:
    """The select's scratch, allocated, and the plan that sizes it:
    ``passes`` (the flattened radix plan, a ctypes int array) and
    ``chunk`` (the sort's)."""
    z = scratch_sizes(b, n, m)
    plan = [v for pair in radix_plan(n, m) for v in pair]
    return dict(
        st=torch.empty(z["state"], dtype=torch.uint8, device=device),
        work=torch.empty(z["work"], dtype=torch.int32, device=device),
        keys=torch.empty(z["keys"], dtype=torch.int64, device=device),
        cap=z["cap"], passes=(ctypes.c_int * max(len(plan), 1))(*plan),
        npasses=len(plan) // 2, chunk=sort_plan(z["cap"])[0])


def screen_topm(q: torch.Tensor, x: torch.Tensor, m: int,
                q_norms: torch.Tensor, x_norms: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: q [B, d], x [N, d] (fp32 or bf16), norms [B], [N]
    (fp32, CUDA, contiguous; +inf norms allowed on x) -> ``(idx [B, m]
    int64, d2 [B, m] fp32)``."""
    name = "screen_topm"
    _build.require(name, q.device, q=q, x=x, q_norms=q_norms,
                   x_norms=x_norms)
    bf16 = _build.require_rows(name, x=x)
    _build.require_dtype(name, torch.float32, q=q, q_norms=q_norms,
                         x_norms=x_norms)
    b, d = q.shape
    n = x.shape[0]
    _build.require_shape(name, "x", x, (n, d))
    _build.require_shape(name, "q_norms", q_norms, (b,))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    if n < 1 or m < 1:
        raise ValueError(f"{name}: needs N >= 1 and m >= 1, got N={n}, m={m}")
    s = scratch(b, n, m, q.device)
    idx = torch.empty((b, m), dtype=torch.int64, device=q.device)
    d2 = torch.empty((b, m), dtype=torch.float32, device=q.device)
    fn = _build.load(name, "screen_topm_launch", _ARGS)
    err = fn(_build.ptr(q), _build.ptr(x), int(bf16), _build.ptr(q_norms),
             _build.ptr(x_norms), b, n, d, m, _build.vec4(x), s["cap"],
             s["passes"], s["npasses"], s["chunk"], _build.ptr(s["st"]),
             _build.ptr(s["work"]), _build.ptr(s["keys"]), _build.ptr(idx),
             _build.ptr(d2), _build.stream(q.device))
    _build.check(name, err)
    _build.count(screen_topm, bf16)
    return idx, d2


screen_topm.launches = 0
screen_topm.launches_bf16 = 0
