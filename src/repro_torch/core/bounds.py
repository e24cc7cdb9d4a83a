"""Theorem 1 (posterior truncation error bound) and concentration diagnostics.

Counterpart of ``repro.core.bounds``:

    || f_D(x_t) - f_S(x_t) ||_2  <=  2 R (N - k) exp(-Delta_k)        (Eq. 7)

with R = max_i ||x_i||_2 and Delta_k = l_(1) - l_(k+1) the Logit Gap;
and the diagnostics behind Fig. 1 / Fig. 3a, posterior entropy and the
participation ratio (the effective golden-support size).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import materialized_topm


def logit_gap(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Delta_k = l_(1) - l_(k+1) along the last axis (sorted descending)."""
    top = torch.topk(logits, min(k + 1, logits.shape[-1]), dim=-1).values
    return top[..., 0] - top[..., -1]


def theorem1_bound(logits: torch.Tensor, k: int,
                   radius: float) -> torch.Tensor:
    """Upper bound 2 R (N - k) exp(-Delta_k); logits: [..., N]."""
    n = logits.shape[-1]
    if k >= n:
        return logits.new_zeros(logits.shape[:-1])
    return 2.0 * radius * (n - k) * torch.exp(-logit_gap(logits, k))


def truncation_error(logits: torch.Tensor, values: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Measured || f_D - f_topk ||_2 (the quantity Theorem 1 bounds).

    The top k are taken with ``lax.top_k``'s order, ties to the lowest
    index (a stable sort of the negated logits)."""
    f_full = torch.softmax(logits, dim=-1) @ values
    lead = logits.shape[:-1]
    idx, neg = materialized_topm(-logits.reshape(-1, logits.shape[-1]), k)
    w_k = torch.softmax(-neg, dim=-1).reshape(lead + (k,))
    f_k = (w_k.unsqueeze(-2) @ values[idx.reshape(lead + (k,))]).squeeze(-2)
    return torch.linalg.norm(f_full - f_k, dim=-1)


def posterior_entropy(logits: torch.Tensor) -> torch.Tensor:
    """H(w) in nats; N-point uniform has entropy log N."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def participation_ratio(logits: torch.Tensor) -> torch.Tensor:
    """1 / sum_i w_i^2 -- the effective number of contributing samples:
    N for a uniform posterior, -> 1 on full collapse (the 'golden
    support size' of Fig. 1)."""
    w = torch.softmax(logits, dim=-1)
    return 1.0 / (w * w).sum(-1)


def data_radius(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x, dim=-1).max())
