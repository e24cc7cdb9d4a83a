"""k-means over the proxy embedding, which builds the Golden Index.

Counterpart of ``repro.index.build``: k-means++ seeding followed by
batched Lloyd iterations, in the matmul distance form
(``||p - c||^2 = ||p||^2 + ||c||^2 - 2 p.c``), on the points' device.

Randomness comes from an explicit ``torch.Generator`` on that device.
It draws another stream than ``jax.random``, so the port's index
differs from the reference's for the same seed; parity tests carry the
reference's index across instead (``store.index_from_numpy``).  The
rules are the reference's: the ++ draw is a Gumbel-max over
log-distances (``jax.random.categorical``), ``argmin`` takes the first
minimum, and the e-th empty cluster is re-seeded to the e-th farthest
point (a stable descending sort, ``lax.top_k``'s tie order).

A build is deterministic under a fixed generator on the card too:
the per-cluster sums are a one-hot matrix product (in fp32 at
PyTorch's default matmul precision, TF32 off) instead of
``index_add_``, whose fp32 atomics add in a different order on every
run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import pdist_ref


def _gumbel(n: int, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def kmeans_plusplus(generator: torch.Generator, points: torch.Tensor,
                    k: int) -> torch.Tensor:
    """k-means++ seeding: [N, d] -> [k, d] initial centroids (fp32)."""
    n, d = points.shape
    dev = points.device
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the points "
                         f"on {dev}; pass a generator of the points' device")
    p32 = points.float()
    # rows are picked by index_select on device indices: no host sync
    first = torch.randint(0, n, (1,), generator=generator, device=dev)
    c = torch.index_select(p32, 0, first)                  # [1, d]
    cents = torch.zeros((k, d), dtype=torch.float32, device=dev)
    cents[0] = c[0]
    min_d2 = ((p32 - c) ** 2).sum(-1)
    for i in range(1, k):
        # sample proportional to the squared distance (the ++ rule)
        logits = torch.log(torch.clamp_min(min_d2, 1e-30))
        nxt = torch.argmax(logits + _gumbel(n, generator, dev))
        c = torch.index_select(p32, 0, nxt.view(1))
        cents[i] = c[0]
        min_d2 = torch.minimum(min_d2, ((p32 - c) ** 2).sum(-1))
    return cents


def kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
           iters: int = 25) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Lloyd iterations.  [N, d] -> (centroids [k, d] fp32,
    assign [N] int64).

    Deterministic under a fixed generator state; empty clusters are
    re-seeded, each to a distinct far point."""
    p32 = points.float()
    cents = kmeans_plusplus(generator, points, k)
    ar = torch.arange(k, device=points.device)
    for _ in range(iters):
        d2 = pdist_ref(p32, cents)
        assign = torch.argmin(d2, -1)
        onehot = (assign[:, None] == ar[None, :]).float()      # [N, k]
        counts = onehot.sum(0)
        new = (onehot.T @ p32) / torch.clamp_min(counts, 1.0)[:, None]
        # the e-th empty cluster takes the e-th farthest-from-its-centroid
        # point (a shared seed would leave all but one empty again)
        empty = counts == 0.0
        far = torch.sort(d2.min(-1).values, descending=True,
                         stable=True)[1][:k]
        rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k - 1)
        cents = torch.where(empty[:, None], p32[far[rank]], new)
    assign = torch.argmin(pdist_ref(p32, cents), -1)
    return cents, assign


__all__ = ["kmeans", "kmeans_plusplus"]
