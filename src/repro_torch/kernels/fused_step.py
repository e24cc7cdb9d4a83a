"""Fused GoldDiff step: screen, re-rank and aggregate with one pass over
the store.

Counterpart of ``repro.kernels.fused_step``.  The candidate stage reads
every store row once, computing its proxy distance and its exact
distance together; the proxy top-m selection carries each slot's exact
distance along.  So the candidate list equals the staged screen's
(``screen.screen_topm``) and arrives with its re-rank distances
attached: no [B, N] re-rank matrix, no [B, m, D] gather.  Slot
semantics follow ``screen``: a slot whose proxy distance is +inf, or
past N when m > N, carries index 0 and exact ``d2 = +inf``, so it
re-ranks last and gets no weight.

* :func:`fused_candidates` -- hand-written CUDA kernel
  (``csrc/fused_candidates.cu``), replacing
  ``repro/kernels/fused_step.py:178`` (``fused_candidates_pallas``).  It
  radix-selects the proxy top-m (passes over the 38 MB proxy store,
  shared with ``screen_topm``), then reads the 614 MB store once for
  all queries of a block, computing every row's exact distance and
  keeping those of the selected rows, and sorts them by proxy key with
  their exact distances.  Bound by the store's bytes; its bf16-row
  instance (the engine's ``storage_dtype``: proxy and store rows in
  bf16) reads half of them and widens each value.
* :func:`fused_candidates_scan` -- its plain PyTorch version, the tiled
  carry loop of ``repro.kernels.fused_step.fused_candidates_scan``.
* :func:`fused_posterior` -- the shared epilogue: exact top-k inside the
  candidate list (a stable sort, as ``lax.top_k``), clamped logits, and
  the ``golden_support_aggregate`` kernel over the k golden rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.golden_support_aggregate import (
    golden_support_aggregate as _sagg)
from repro_torch.kernels.screen import merge_topm, scan_tiles, scratch, tile_d2

NEG_INF = ref.NEG_INF
DEFAULT_TILE = 4096        # the reference kernel's N-tile (VMEM block)
FUSED_SCAN_TILE = 2048     # the plain carry loop's N-tile (full-D GEMM per tile)


def fused_candidates_scan(qp: torch.Tensor, q: torch.Tensor,
                          proxy: torch.Tensor, x: torch.Tensor, m: int,
                          proxy_norms: torch.Tensor | None = None,
                          x_norms: torch.Tensor | None = None,
                          tile: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled carry loop over N: ``(idx, d2)`` [B, m], the proxy top-m
    in proxy order with each slot's exact distance.  Peak live memory
    O(B (m + tile))."""
    n = x.shape[0]
    b = qp.shape[0]
    tile = min(FUSED_SCAN_TILE if tile is None else tile, max(n, 1))
    qp32, q32 = qp.float(), q.float()
    qpn, qn = (qp32 * qp32).sum(-1), (q32 * q32).sum(-1)
    pn = ((proxy.float() ** 2).sum(-1) if proxy_norms is None
          else proxy_norms.float())
    xn = (x.float() ** 2).sum(-1) if x_norms is None else x_norms.float()
    vals = qp32.new_full((b, m), float("-inf"))
    idx = torch.zeros((b, m), dtype=torch.int64, device=q.device)
    ex = q32.new_full((b, m), float("inf"))
    for start, eff in scan_tiles(n, tile):
        sl = slice(eff, eff + tile)
        pd2 = tile_d2(qp32, proxy[sl].float(), qpn, pn[sl])
        ed2 = tile_d2(q32, x[sl].float(), qn, xn[sl])
        cols = torch.arange(eff, eff + tile, device=q.device)
        neg = torch.where(cols >= start, -pd2, float("-inf"))
        vals, idx, ex = merge_topm(vals, idx, neg, cols.expand(b, -1), m,
                                   (ex, ed2))
    return torch.clamp_max(idx, max(n - 1, 0)), ex


_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7)


def fused_candidates(qp: torch.Tensor, q: torch.Tensor, proxy: torch.Tensor,
                     x: torch.Tensor, m: int, proxy_norms: torch.Tensor,
                     x_norms: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: qp [B, dp], q [B, D] and the store norms [N] fp32,
    proxy [N, dp] and x [N, D] both fp32 or both bf16 (CUDA, contiguous)
    -> ``(idx [B, m] int64, d2 [B, m] fp32)``."""
    name = "fused_candidates"
    _build.require(name, q.device, qp=qp, q=q, proxy=proxy, x=x,
                   proxy_norms=proxy_norms, x_norms=x_norms)
    bf16 = _build.require_rows(name, proxy=proxy, x=x)
    _build.require_dtype(name, torch.float32, qp=qp, q=q,
                         proxy_norms=proxy_norms, x_norms=x_norms)
    b, dp = qp.shape
    n, d = x.shape
    _build.require_shape(name, "q", q, (b, d))
    _build.require_shape(name, "proxy", proxy, (n, dp))
    _build.require_shape(name, "proxy_norms", proxy_norms, (n,))
    _build.require_shape(name, "x_norms", x_norms, (n,))
    if n < 1 or m < 1:
        raise ValueError(f"{name}: needs N >= 1 and m >= 1, got N={n}, m={m}")
    dev = q.device
    s = scratch(b, n, m, dev)
    pays = torch.empty(s["keys"].numel(), dtype=torch.float32, device=dev)
    qpn, qn = (qp * qp).sum(-1), (q * q).sum(-1)
    idx = torch.empty((b, m), dtype=torch.int64, device=dev)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    fn = _build.load(name, "fused_candidates_launch", _ARGS)
    err = fn(_build.ptr(qp), _build.ptr(proxy), _build.ptr(qpn),
             _build.ptr(proxy_norms), _build.ptr(q), _build.ptr(x),
             _build.ptr(qn), _build.ptr(x_norms), int(bf16), b, n, dp, d, m,
             _build.vec4(proxy), _build.vec4(x), s["cap"], s["passes"],
             s["npasses"], s["chunk"],
             _build.ptr(s["st"]), _build.ptr(s["work"]),
             _build.ptr(s["keys"]), _build.ptr(pays),
             _build.ptr(idx), _build.ptr(d2), _build.stream(dev))
    _build.check(name, err)
    _build.count(fused_candidates, bf16)
    return idx, d2


fused_candidates.launches = 0
fused_candidates.launches_bf16 = 0


def fused_posterior(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                    k: int, sigma2, m_t=None, k_t=None) -> torch.Tensor:
    """Candidates with exact distances -> posterior mean [B, D] fp32:
    the exact top-k inside the candidate list (ties to the lowest slot),
    logits ``max(-d2 / (2 sigma2), NEG_INF)``, and the softmax-weighted
    mean of the k golden rows, loaded by index.

    ``sigma2`` is a float or a 0-d tensor; ``m_t`` / ``k_t`` (optional
    0-d integer tensors, the masked path's scheduled sizes) mask slots:
    candidate slots at or past ``m_t`` re-rank at +inf, logit slots at
    or past ``k_t`` clamp to ``NEG_INF`` (an all-masked row averages its
    gathered rows uniformly, never NaN)."""
    if m_t is not None:
        live = torch.arange(d2.shape[-1], device=d2.device) < m_t
        d2 = torch.where(live, d2, float("inf"))
    vals, pos = torch.sort(d2, dim=-1, stable=True)
    gid = torch.gather(idx, -1, pos[:, :k]).contiguous()
    lg = torch.clamp_min(-vals[:, :k] / (2.0 * sigma2), NEG_INF)
    if k_t is not None:
        lg = torch.where(torch.arange(k, device=lg.device) < k_t, lg, NEG_INF)
    if x.device.type == "cpu":
        return ref.golden_support_aggregate_ref(x, gid, lg)
    return _sagg(x, gid, lg.contiguous())
