"""Public kernel-layer functions for the GoldDiff hot path.

Counterpart of ``repro.kernels.ops`` for the single-host exact path:
coarse screen (``pdist`` + ``screen_topm`` in the materialized form),
exact re-rank (``support_distances`` + ``golden_rerank``) and
aggregation (``golden_support_aggregate`` over supports,
``golden_aggregate`` for full scans).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain PyTorch version in ``ref``; CUDA tensors launch the
hand-written kernel or the call raises.  There is no fallback from the
card to the plain version.  The support functions take the store and
an index, and the kernels load rows by index: no [B, m, D] gather is
materialized on the card.

The top-m / top-k selections stay PyTorch (a stable sort, so ties go
to the lowest index as with ``lax.top_k``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.golden_aggregate import golden_aggregate as _agg
from repro_torch.kernels.golden_rerank import support_sqdist as _sqd
from repro_torch.kernels.golden_support_aggregate import (
    golden_support_aggregate as _sagg)
from repro_torch.kernels.pdist import pdist as _pdist


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def pdist(q, x, q_norms=None, x_norms=None):
    """Pairwise squared distances [B, N] (matmul form, fp32)."""
    if _on_cpu(q):
        return ref.pdist_ref(q, x, q_norms, x_norms)
    q = q.float().contiguous()
    if q_norms is None:
        q_norms = (q * q).sum(-1)
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    return _pdist(q, x, q_norms.float().contiguous(),
                  x_norms.float().contiguous())


def screen_topm(q, x, m: int, q_norms=None, x_norms=None):
    """Exact top-m rows of x by squared distance, materialized form:
    the [B, N] distance matrix plus one stable sort.  Returns
    ``(idx, d2)`` [B, m], ``d2`` ascending; ``m > N`` surplus slots
    carry ``d2 = +inf`` and index 0."""
    return ref.materialized_topm(pdist(q, x, q_norms, x_norms), m)


def support_distances(q, x, idx, x_norms=None):
    """Exact distances q_b -> x[idx[b]]: [B, m] fp32, no [B, m, D]
    subtract temporaries (and on the card no gathered copy at all)."""
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    if _on_cpu(q):
        return ref.support_sqdist_ref(q, x, x_norms, idx)
    return _sqd(q.float().contiguous(), x, x_norms.float().contiguous(),
                idx.contiguous())


def golden_rerank(q, x, cand, k: int, x_norms=None):
    """Exact re-rank inside the candidate set (paper Eq. 5).  Returns
    ``(idx, d2)``: the top-k dataset indices [B, k] and their exact
    squared distances, ascending, ties to the lowest candidate slot."""
    d2 = support_distances(q, x, cand, x_norms)
    vals, pos = torch.sort(d2, dim=-1, stable=True)
    return torch.gather(cand, -1, pos[:, :k]), vals[:, :k]


def golden_support_aggregate(x, idx, logits):
    """softmax(logits)-weighted mean of x[idx] per query -> [B, D] fp32
    (NEG_INF logits get zero weight; masking is the caller's job)."""
    if _on_cpu(logits):
        return ref.golden_support_aggregate_ref(x, idx, logits)
    return _sagg(x, idx.contiguous(), logits.float().contiguous())


def golden_aggregate(q, x, sigma2: float, x_norms=None):
    """Full-scan posterior mean (Eq. 2) -> [B, D] in q's dtype."""
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    if _on_cpu(q):
        return ref.golden_aggregate_ref(q, x, sigma2, x_norms)
    return _agg(q.contiguous(), x, float(sigma2),
                x_norms.float().contiguous())


__all__ = ["pdist", "screen_topm", "support_distances", "golden_rerank",
           "golden_support_aggregate", "golden_aggregate"]
