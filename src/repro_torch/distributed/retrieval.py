"""Distributed golden retrieval over a store sharded on a mesh axis.

Counterpart of ``repro.distributed.retrieval``: the GoldDiff selection
and aggregation, shard-parallel, as three shard-local stages separated
by three merges (``distributed.sharding``):

  1. every shard screens its rows by proxy distance (``ops.screen_topm``
     over its slice, or ``ops.ivf_screen_local`` over its windows of the
     globally probed index), and the m-th threshold across shards
     restricts the union to exactly the single-device candidate set;
  2. every shard re-ranks its candidates exactly and keeps its local
     top-k; the k-th threshold across shards (k floats a shard) marks
     each shard's golden members;
  3. every shard aggregates its own members into an unnormalized
     softmax state (``ops.golden_partial_aggregate``: on the card kernel
     3's state entry) and the states merge exactly by log-sum-exp.

Every stage takes and returns *sharded values*: lists of the tensors of
the shards this process holds (``mesh.local_shards``), in shard order;
a replicated input (the query) is one tensor, moved to each shard's
device.  Over a ``ProcessMesh`` a rank's list is its one shard and every
merge runs over the shard axis's group; none names a batch axis (the
reference's rule), so the ranks of one batch group merge apart from the
others'.  The sharded ``GoldDiffEngine`` runs these same functions, so
there is one implementation of the two-stage top-k and the merge.
"""
from __future__ import annotations

import torch

from repro_torch.core.dataset import DatasetStore
from repro_torch.distributed.sharding import crossshard_kth, lse_merge_mean
from repro_torch.index.shard import ShardedLayout, shard_layout
from repro_torch.index.store import build_index
from repro_torch.kernels import ops
from repro_torch.kernels.ref import downsample_proxy

NEG_INF = -1e30


def shard_store(store: DatasetStore, mesh, axis: str = "data"
                ) -> DatasetStore:
    """The store with N padded to a multiple of the shard count (zero
    rows, +inf norms, label -1), as the reference places it: shard s of
    ``distributed_golden_denoise`` takes rows ``[s n_loc, (s+1) n_loc)``."""
    n_sh = int(mesh.shape[axis])
    pad = (-store.n) % n_sh

    def pad_rows(x, fill=0.0):
        if pad == 0 or x is None:
            return x
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    return DatasetStore(
        X=pad_rows(store.X), proxy=pad_rows(store.proxy),
        x_norms=pad_rows(store.x_norms, float("inf")),
        proxy_norms=pad_rows(store.proxy_norms, float("inf")),
        image_shape=store.image_shape,
        labels=pad_rows(store.labels, -1))


def build_shard_indexes(store: DatasetStore, mesh, axis: str = "data",
                        num_clusters: int | None = None,
                        generator: torch.Generator | None = None,
                        iters: int = 25) -> ShardedLayout:
    """One global Golden Index (``index.build_index``) laid out per shard
    at CSR window boundaries (``index.shard.shard_layout``), the layout
    the sharded engine uses: shard-local probing reproduces the
    single-device probe set exactly."""
    index = build_index(store, num_clusters=num_clusters,
                        generator=generator, iters=iters)
    return shard_layout(store, mesh, axis, index=index)


# -- shard-local stages (engine-callable) ---------------------------------------

def local_coarse_exact(qp: torch.Tensor, proxies, pnorms, m_cap: int,
                       m_sort: int, m, mesh, stream: bool = False,
                       tile: int | None = None):
    """Shard-local exact proxy screen and the cross-shard top-m cut:
    each shard's top-``m_cap`` rows by proxy distance, then the global
    m-th distance, so the surviving candidates across shards are the
    single-device top-m set.  ``m`` may be a 0-d tensor (masked path),
    ``m_sort`` its static bound.  Returns ``(cand, valid)``: [B, m_cap]
    local row ids and validity, one each a shard."""
    outs = [ops.screen_topm(qp.to(pr.device), pr, m_cap, x_norms=pn,
                            tile=tile, stream=stream)
            for pr, pn in zip(proxies, pnorms)]
    negp = [-d2 for _, d2 in outs]
    mth = crossshard_kth(negp, m_sort, m, mesh)
    return ([c for c, _ in outs],
            [n >= mth.to(n.device)[:, None] for n in negp])


def golden_local_topk(Xs, xns, q: torch.Tensor, cands, valids, k_cap: int,
                      k_sort: int, k, mesh):
    """Exact shard-local re-rank and the stage-two global top-k
    threshold.  Returns ``(idx, neg, kth)``: each shard's local top-
    ``k_cap`` candidate rows (ties to the lowest slot) and their negated
    exact distances (invalid slots +inf), and the global k-th threshold;
    ``neg >= kth[:, None]`` marks a shard's golden members."""
    idx, neg = [], []
    for X, xn, cand, ok in zip(Xs, xns, cands, valids):
        d2 = ops.support_distances(q.to(X.device), X, cand, xn)
        d2 = torch.where(ok, d2, float("inf"))
        vals, pos = torch.sort(d2, dim=-1, stable=True)
        idx.append(torch.gather(cand, -1, pos[:, :k_cap]))
        neg.append(-vals[:, :k_cap])
    return idx, neg, crossshard_kth(neg, k_sort, k, mesh)


def merged_golden_mean(Xs, idxs, negs, kth: torch.Tensor, sig2, mesh,
                       strategy: str = "gather") -> torch.Tensor:
    """Aggregate each shard's own golden members into a softmax state
    and merge the states by log-sum-exp into the mean [B, D] fp32.
    ``sig2`` a float or a 0-d tensor."""
    states = []
    for X, idx, neg in zip(Xs, idxs, negs):
        k = kth.to(neg.device)
        lg = torch.where(neg >= k[:, None],
                         torch.clamp_min(neg / (2.0 * sig2), NEG_INF),
                         NEG_INF)
        states.append(ops.golden_partial_aggregate(X, idx, lg,
                                                   strategy=strategy))
    return lse_merge_mean(*zip(*states), mesh)


def fused_local_step(Xs, xns, q: torch.Tensor, qp: torch.Tensor, proxies,
                     pnorms, m_cap: int, m_sort: int, m, k_cap: int,
                     k_sort: int, k, sig2, mesh, strategy: str = "gather",
                     stream: bool = False, tile: int | None = None
                     ) -> torch.Tensor:
    """One fused sharded GoldDiff step: the staged stages
    (:func:`local_coarse_exact`, :func:`golden_local_topk`,
    :func:`merged_golden_mean`) in one call, so bitwise the staged
    result.  The reference issues each gather ahead of the shard-local
    work it does not need, for XLA to overlap them; the port runs its
    merges eagerly, in order, so that reordering would change nothing."""
    cands, valids = local_coarse_exact(qp, proxies, pnorms, m_cap, m_sort,
                                       m, mesh, stream=stream, tile=tile)
    idx, neg, kth = golden_local_topk(Xs, xns, q, cands, valids, k_cap,
                                      k_sort, k, mesh)
    return merged_golden_mean(Xs, idx, neg, kth, sig2, mesh, strategy)


def distributed_golden_denoise(store: DatasetStore, mesh, q: torch.Tensor,
                               sigma2: float, m: int, k: int,
                               proxy_factor: int = 4, axis: str = "data",
                               index: ShardedLayout | None = None,
                               nprobe: int | None = None) -> torch.Tensor:
    """A full GoldDiff step, shard-parallel: q [B, D] (the rescaled
    query, the same on every rank) -> the mean [B, D], replicated.

    ``store`` comes from :func:`shard_store`; shard s takes its rows
    ``[s n_loc, (s+1) n_loc)``.  With ``index`` (from
    :func:`build_shard_indexes`) the coarse screen probes ``nprobe``
    windows of the global index (a quarter of them by default) and every
    probed row goes to the re-rank (capacity mode); the rows then come
    from the layout's cluster-sorted slabs."""
    n_sh = int(mesh.shape[axis])
    q_img = q.reshape(q.shape[:-1] + tuple(store.image_shape))
    qp = downsample_proxy(q_img, proxy_factor)
    if index is not None:
        c = index.centroids.shape[0]
        nprobe = min(nprobe or max(1, -(-c // 4)), c)
        w_cap = min(nprobe, index.w_max)
        cap = w_cap * index.max_cluster
        k_cap = max(1, min(k, cap))
        sl = index.slabs
        cands, valids = [], []
        for s in sl:
            pos, pd2 = ops.ivf_screen_local(
                qp.to(s.X.device), s.offsets, s.centroids, s.centroid_norms,
                s.w_lo, s.w_hi, nprobe, index.max_cluster, w_cap,
                index.n_loc)
            cands.append(pos)
            valids.append(torch.isfinite(pd2))
        Xs, xns = [s.X for s in sl], [s.x_norms for s in sl]
        idx, neg, kth = golden_local_topk(Xs, xns, q, cands, valids, k_cap,
                                          k, k, mesh)
        return merged_golden_mean(Xs, idx, neg, kth, sigma2, mesh)
    n_loc = store.X.shape[0] // n_sh
    m_cap = min(m, n_loc)
    k_cap = max(1, min(k, m_cap))
    rows = [slice(s * n_loc, (s + 1) * n_loc)
            for s in mesh.local_shards(axis)]
    Xs = [store.X[r] for r in rows]
    xns = [store.x_norms[r] for r in rows]
    cands, valids = local_coarse_exact(
        qp, [store.proxy[r] for r in rows],
        [store.proxy_norms[r] for r in rows], m_cap, m, m, mesh)
    idx, neg, kth = golden_local_topk(Xs, xns, q, cands, valids, k_cap, k,
                                      k, mesh)
    return merged_golden_mean(Xs, idx, neg, kth, sigma2, mesh)


__all__ = ["shard_store", "build_shard_indexes", "local_coarse_exact",
           "golden_local_topk", "merged_golden_mean", "fused_local_step",
           "distributed_golden_denoise"]
