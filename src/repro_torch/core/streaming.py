"""Streaming (online) softmax aggregation.

Counterpart of ``repro.core.streaming``, the two estimators of the
paper (Sec. 3.2 / Tab. 6):

* ``streaming_softmax_mean`` -- the *unbiased* online softmax of
  FlashAttention: a running (max, denominator, accumulator) state is
  folded chunk by chunk, and the result is ``softmax(logits) @ values``
  for any chunking.  GoldDiff applies it on the golden subset;
* ``weighted_streaming_softmax_mean`` / ``wss_combine`` -- the *biased*
  WSS of the PCA denoiser: chunk-local softmax means combined with
  weights ``n_c * exp(mean logit of chunk)``, which flattens the
  weights across chunks (the smoothing bias).

The reference's ``lax.scan`` over chunks is a Python loop here.  The
partial state merges exactly (``merge_states``, a log-sum-exp merge).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ref import NEG_INF


class SoftmaxState(NamedTuple):
    """Partial state of an online softmax: running max, denom, accum."""

    m: torch.Tensor      # [...]        running max of logits
    l: torch.Tensor      # [...]        sum of exp(logit - m)
    acc: torch.Tensor    # [..., D]     sum of exp(logit - m) * value


def init_state(batch_shape: tuple[int, ...], dim: int,
               dtype=torch.float32, device=None) -> SoftmaxState:
    return SoftmaxState(
        m=torch.full(batch_shape, NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(batch_shape, dtype=dtype, device=device),
        acc=torch.zeros(tuple(batch_shape) + (dim,), dtype=dtype,
                        device=device))


def _weighted(p: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``sum_c p[..., c] values[..., c, :]``; values [C, D] or batched
    [..., C, D], broadcast against p's leading dims without expanding
    (the patch bases' full scan: p [B, HW, C] over values [HW, C, D])."""
    if values.ndim == 2:
        return p @ values
    return torch.einsum("...c,...cd->...d", p, values)


def update_state(state: SoftmaxState, logits: torch.Tensor,
                 values: torch.Tensor,
                 mask: torch.Tensor | None = None) -> SoftmaxState:
    """Fold one chunk into the state.

    logits: [..., C]; values: [..., C, D] or [C, D]; mask: [..., C] bool.
    """
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(state.m, logits.amax(-1))
    scale_old = torch.exp(state.m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = state.l * scale_old + p.sum(-1)
    acc_new = state.acc * scale_old[..., None] + _weighted(p, values)
    return SoftmaxState(m_new, l_new, acc_new)


def merge_states(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Exact log-sum-exp merge of two partial states (associative)."""
    m = torch.maximum(a.m, b.m)
    sa = torch.exp(a.m - m)
    sb = torch.exp(b.m - m)
    return SoftmaxState(m, a.l * sa + b.l * sb,
                        a.acc * sa[..., None] + b.acc * sb[..., None])


def finalize(state: SoftmaxState) -> torch.Tensor:
    return state.acc / torch.clamp_min(state.l, 1e-30)[..., None]


def streaming_softmax_mean(logits: torch.Tensor, values: torch.Tensor,
                           chunk: int = 4096,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact softmax(logits) @ values with an O(chunk) working set.

    logits: [..., N]; values: [N, D]; returns [..., D].
    """
    n = logits.shape[-1]
    chunk = min(chunk, n)
    state = init_state(tuple(logits.shape[:-1]), values.shape[-1],
                       device=logits.device)
    for s in range(0, (n // chunk) * chunk, chunk):
        state = update_state(
            state, logits[..., s:s + chunk].float(),
            values[s:s + chunk].float(),
            None if mask is None else mask[..., s:s + chunk])
    s = (n // chunk) * chunk
    if s < n:
        state = update_state(state, logits[..., s:].float(),
                             values[s:].float(),
                             None if mask is None else mask[..., s:])
    return finalize(state)


def _chunk_stats(lg: torch.Tensor, vals: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk local softmax means and mean logits: lg [..., n, c],
    vals [..., n, c, D] -> ([..., n, D], [..., n])."""
    p = torch.softmax(lg, dim=-1)
    return _weighted(p, vals), lg.mean(-1)


def _combine(mu: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """Chunk means [..., n, D] weighted by softmax of ``ml`` [..., n]."""
    wc = torch.softmax(ml, dim=-1)
    return (wc.unsqueeze(-2) @ mu).squeeze(-2)


def weighted_streaming_softmax_mean(logits: torch.Tensor,
                                    values: torch.Tensor,
                                    chunk: int = 4096) -> torch.Tensor:
    """Biased WSS (PCA-style batch-level averaging).

    Chunk c contributes its local softmax mean mu_c, and chunks combine
    with weights w_c ∝ n_c * exp(mean_c(logits)).  When ``n % chunk != 0``
    the remainder is folded into the last chunk (one larger chunk),
    whose size enters the weights as ``log n_c``.
    """
    n = logits.shape[-1]
    d = values.shape[-1]
    batch = tuple(logits.shape[:-1])
    chunk = min(chunk, n)
    num = max(n // chunk, 1)
    lg32 = logits.float()
    vals32 = values.float()
    if n == num * chunk:
        mu, ml = _chunk_stats(lg32.reshape(batch + (num, chunk)),
                              vals32.reshape(num, chunk, d))
        return _combine(mu, ml)
    # ragged tail: num-1 equal chunks + one final chunk of (chunk + rem)
    s = (num - 1) * chunk
    mus, mls, counts = [], [], []
    if s:
        mu, ml = _chunk_stats(lg32[..., :s].reshape(batch + (num - 1, chunk)),
                              vals32[:s].reshape(num - 1, chunk, d))
        mus.append(mu)
        mls.append(ml)
        counts.extend([chunk] * (num - 1))
    lg_t = lg32[..., s:]
    mus.append((torch.softmax(lg_t, dim=-1) @ vals32[s:])[..., None, :])
    mls.append(lg_t.mean(-1)[..., None])
    counts.append(n - s)
    log_nc = torch.log(torch.tensor(counts, dtype=torch.float32,
                                    device=logits.device))
    return _combine(torch.cat(mus, dim=-2), torch.cat(mls, dim=-1) + log_nc)


def wss_combine(logits: torch.Tensor, values: torch.Tensor,
                chunk: int = 64) -> torch.Tensor:
    """Biased WSS over per-query support sets.

    logits: [..., K]; values: [..., K, D] (aligned).  The bias model of
    ``weighted_streaming_softmax_mean`` on gathered golden subsets, the
    remainder folded into the last chunk the same way.
    """
    k = logits.shape[-1]
    d = values.shape[-1]
    lead_l = tuple(logits.shape[:-1])
    lead_v = tuple(values.shape[:-2])
    chunk = max(1, min(chunk, k))
    nc = k // chunk
    lg32 = logits.float()
    vals32 = values.float()
    if k == nc * chunk:
        mu, ml = _chunk_stats(lg32.reshape(lead_l + (nc, chunk)),
                              vals32.reshape(lead_v + (nc, chunk, d)))
        return _combine(mu, ml)
    s = (nc - 1) * chunk
    mus, mls, counts = [], [], []
    if s:
        mu, ml = _chunk_stats(
            lg32[..., :s].reshape(lead_l + (nc - 1, chunk)),
            vals32[..., :s, :].reshape(lead_v + (nc - 1, chunk, d)))
        mus.append(mu)
        mls.append(ml)
        counts.extend([chunk] * (nc - 1))
    mu_t, ml_t = _chunk_stats(lg32[..., s:][..., None, :],
                              vals32[..., s:, :][..., None, :, :])
    mus.append(mu_t)
    mls.append(ml_t)
    counts.append(k - s)
    log_nc = torch.log(torch.tensor(counts, dtype=torch.float32,
                                    device=logits.device))
    return _combine(torch.cat(mus, dim=-2), torch.cat(mls, dim=-1) + log_nc)


def softmax_mean_reference(logits: torch.Tensor, values: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Naive one-shot reference (for tests)."""
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return torch.softmax(logits.float(), dim=-1) @ values.float()
