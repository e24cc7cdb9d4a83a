"""Plain PyTorch versions of the hand-written kernels.

Counterpart of ``repro.kernels.ref``.  ``kernels.ops`` uses these for
CPU tensors; the tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
The support functions take ``(X, idx)`` and gather inside, so each is
the same function as its kernel (which loads rows by index).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30

# Largest inverse temperature the aggregation softmax uses: ``-d2 * inv``
# stays an ordinary fp32 overflow (clamped at NEG_INF) instead of the
# ``0 * inf`` NaN an unguarded ``1/(2*0.0)`` produces.
MAX_INV_TWO_SIGMA2 = 3.0e37


def finite_inv_two_sigma2(sigma2) -> float:
    """``1 / (2 sigma2)`` clamped to an fp32-finite inverse temperature;
    degenerate ``sigma2`` (<= 0, NaN, denormal) returns the cap."""
    s = float(sigma2)
    if not s > 0.0:                      # 0, negative, or NaN
        return MAX_INV_TWO_SIGMA2
    return min(1.0 / (2.0 * s), MAX_INV_TWO_SIGMA2)


def pdist_ref(q: torch.Tensor, x: torch.Tensor,
              q_norms: torch.Tensor | None = None,
              x_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Matmul-form pairwise squared distances [B, N]; precomputed norms
    may carry +inf (masked rows -> +inf distance)."""
    q = q.float()
    x = x.float()
    qn = (q * q).sum(-1) if q_norms is None else q_norms.float()
    xn = (x * x).sum(-1) if x_norms is None else x_norms.float()
    return torch.clamp_min(qn[:, None] + xn[None, :] - 2.0 * (q @ x.T), 0.0)


def centroid_scan_ref(q: torch.Tensor, centroids: torch.Tensor,
                      c_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Query -> centroid distances [B, C] (IVF level 1): ``pdist_ref``
    with the index's centroid norms, as the reference's ``xla`` backend
    computes it.  A +inf norm (a padded window) gives a +inf distance
    whatever the dot product, so such a window is never probed."""
    return pdist_ref(q, centroids, x_norms=c_norms)


def downsample_proxy(x_img: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Paper's proxy: spatially average-pooled image, flattened.

    ``x_img``: [..., H, W, C].  Identity (flattened) for non-image data
    or tiny spatial dims.  The window is summed in row-major order and
    then divided by its size, which is the order XLA:CPU reduces
    ``repro.core.dataset.downsample_proxy``'s mean in: the two agree
    bit for bit.  The plain version of kernel 7's pooling stage.
    """
    if x_img.ndim < 3 or x_img.shape[-2] < factor or x_img.shape[-3] < factor:
        return (x_img.reshape(x_img.shape[: x_img.ndim - 1] + (-1,))
                if x_img.ndim >= 2 else x_img)
    h, w, c = x_img.shape[-3:]
    hh, ww = h // factor, w // factor
    lead = tuple(x_img.shape[:-3])
    v = x_img[..., : hh * factor, : ww * factor, :]
    v = v.reshape(lead + (hh, factor, ww, factor, c))
    acc = None
    for i in range(factor):
        for j in range(factor):
            s = v[..., i, :, j, :]
            acc = s.clone() if acc is None else acc + s
    return (acc / (factor * factor)).reshape(lead + (hh * ww * c,))


class Probe(NamedTuple):
    """IVF level 1's outputs (``ivf_probe_ref`` / the kernel): the probed
    windows [B, P] in stable ascending distance order, and for each of
    the P L candidate slots its cluster-sorted position, dataset id,
    validity and d2 marker (0 real, +inf padding).  A field the caller
    did not ask for is None."""
    probe: torch.Tensor | None
    pos: torch.Tensor | None
    ids: torch.Tensor | None
    valid: torch.Tensor | None
    marker: torch.Tensor | None


PROBE_FIELDS = Probe._fields


def ivf_probe_ref(qp: torch.Tensor, centroids: torch.Tensor,
                  c_norms: torch.Tensor, offsets: torch.Tensor,
                  perm: torch.Tensor | None, n: int, nprobe_max: int,
                  max_cluster: int, nprobe=None) -> Probe:
    """IVF level 1 of proxy queries qp [B, dp] over an index of ``n``
    rows: ``centroid_scan_ref``, the ``nprobe_max`` nearest windows by a
    stable sort (``lax.top_k``'s order: ties, such as the duplicated
    centroids of a split cluster, go to the lowest window), and each
    window's ``max_cluster`` slots L: ``pos = min(offsets[w] + lane,
    n - 1)``, valid where ``offsets[w] + lane < offsets[w + 1]`` and the
    probe is below ``nprobe`` (int or 0-d tensor; default all),
    ``ids = perm[pos]`` (None without ``perm``)."""
    b = qp.shape[0]
    cd2 = centroid_scan_ref(qp, centroids, c_norms)
    probe = torch.sort(cd2, dim=-1, stable=True)[1][:, :nprobe_max]
    starts = offsets[probe]                                 # [B, P]
    ends = offsets[probe + 1]
    lane = torch.arange(max_cluster, dtype=starts.dtype, device=qp.device)
    pos = starts[..., None] + lane                          # [B, P, L]
    valid = pos < ends[..., None]
    if nprobe is not None:
        live = torch.arange(nprobe_max, device=qp.device) < nprobe
        valid = valid & live[None, :, None]
    pos = torch.clamp_max(pos, n - 1).reshape(b, -1)        # [B, R]
    valid = valid.reshape(b, -1)
    return Probe(probe=probe, pos=pos,
                 ids=None if perm is None else perm[pos], valid=valid,
                 marker=torch.where(valid, 0.0, float("inf")))


def materialized_topm(d2: torch.Tensor, m: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-m of a [B, N] distance matrix: ``(idx, d2)`` ascending, ties
    to the lowest index (``lax.top_k``'s order: a stable sort, since
    ``torch.topk`` promises no order among equal values); ``m > N``
    surplus slots carry ``d2 = +inf`` and index 0."""
    n = d2.shape[-1]
    k = min(m, n)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].contiguous()
    if m > k:
        b = d2.shape[0]
        vals = torch.cat([vals, vals.new_full((b, m - k), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_zeros((b, m - k))], 1)
    return idx, vals


def support_sqdist_ref(q: torch.Tensor, x: torch.Tensor,
                       x_norms: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Distances from each q_b to its own rows x[idx[b]]: [B, M] fp32."""
    q32 = q.float()
    xs = x[idx].float()                                   # [B, M, D]
    qn = (q32 * q32).sum(-1, keepdim=True)
    dot = torch.bmm(xs, q32[:, :, None])[..., 0]
    return torch.clamp_min(qn + x_norms.float()[idx] - 2.0 * dot, 0.0)


def golden_support_aggregate_ref(x: torch.Tensor, idx: torch.Tensor,
                                 logits: torch.Tensor) -> torch.Tensor:
    """softmax(logits)-weighted mean of x[idx] per query -> [B, D] fp32."""
    w = torch.softmax(logits.float(), dim=-1)
    return torch.bmm(w[:, None, :], x[idx].float())[:, 0]


def partial_aggregate_ref(x: torch.Tensor, idx: torch.Tensor,
                          logits: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized softmax partial state of x[idx] per query: ``(acc
    [B, D], m [B], l [B])``, the exp-weighted sum, the max logit and the
    partition sum (``streaming.merge`` semantics), so that shards' states
    merge exactly by log-sum-exp (``distributed.sharding``).  Logits all
    at the finite NEG_INF give m = NEG_INF, whose merge scale underflows
    to 0, not NaN.  Takes ``(x, idx)`` as the kernel does; the
    reference's ``partial_aggregate_ref`` takes the gathered rows."""
    lg = logits.float()
    m = lg.amax(-1)
    p = torch.exp(lg - m[:, None])
    acc = torch.bmm(p[:, None, :], x[idx].float())[:, 0]
    return acc, m, p.sum(-1)


def scatter_partial_aggregate_ref(x: torch.Tensor, idx: torch.Tensor,
                                  logits: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The dense form of :func:`partial_aggregate_ref`: the weights
    scattered into a [B, N] matrix (duplicate indices add) times the
    store, as the reference's XLA:CPU-fast form."""
    lg = logits.float()
    m = lg.amax(-1)
    p = torch.exp(lg - m[:, None])
    ws = torch.zeros((lg.shape[0], x.shape[0]), dtype=torch.float32,
                     device=lg.device).scatter_add_(1, idx, p)
    return ws @ x.float(), m, p.sum(-1)


def full_partial_ref(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                     x_norms: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized softmax state of the whole store x (the dense form of
    the reference's ``golden_full_partial``): logits clamped at NEG_INF,
    so +inf-norm padding rows weigh 0 beside any real row and a shard of
    padding alone gives m = NEG_INF.  The plain version of kernel 4's
    state entry."""
    inv = finite_inv_two_sigma2(sigma2)
    lg = torch.clamp_min(-pdist_ref(q, x, x_norms=x_norms) * inv, NEG_INF)
    m = lg.amax(-1)
    p = torch.exp(lg - m[:, None])
    return p @ x.float(), m, p.sum(-1)


def golden_aggregate_ref(q: torch.Tensor, x: torch.Tensor, sigma2: float,
                         x_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Full-scan posterior mean (Eq. 2); logits clamp at the finite
    NEG_INF, so an all-clamped row is the uniform (data-mean) aggregate."""
    inv = finite_inv_two_sigma2(sigma2)
    lg = torch.clamp_min(-pdist_ref(q, x, x_norms=x_norms) * inv, NEG_INF)
    w = torch.softmax(lg, dim=-1)
    return (w @ x.float()).to(q.dtype)


def _attention_scores(q: torch.Tensor, k: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """fp32 scaled scores [B, Hkv, G, S, S], masked ones at NEG_INF."""
    dh, s = q.shape[-1], q.shape[3]
    scores = torch.einsum("bhgqd,bhkd->bhgqk", q.float(),
                          k.float()) * dh ** -0.5
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, return_lse: bool = False):
    """Dense softmax attention: q [B, Hkv, G, S, dh], k/v [B, Hkv, S, dh]
    -> [B, Hkv, G, S, dh] in q's dtype (fp32 scores; masked scores at
    NEG_INF), and with ``return_lse`` the scores' row log-sum-exp [B,
    Hkv, G, S] in fp32.  Materializes the [B, Hkv, G, S, S] scores."""
    scores = _attention_scores(q, k, causal)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True):
    """The gradient of attention, materialized: with scale = dh^-0.5,
    P = exp(Q K^T scale - lse), D = rowsum(dO o o), dS = P o (dO V^T -
    D), dQ = dS K scale, dK = dS^T Q scale (summed over the G query heads
    of a KV head), dV = P^T dO; all in fp32 on [B, Hkv, G, S, S], then
    (dq, dk, dv) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_attention_scores(q, k, causal) - lse[..., None])
    dof = do.float()
    dd = (dof * o.float()).sum(-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
              - dd[..., None])
    del p
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def golden_attention_decode_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, block_idx: torch.Tensor,
                                valid: torch.Tensor, block_size: int = 128
                                ) -> torch.Tensor:
    """Gather the golden blocks densely, mask the invalid ones and
    attend: q [B, Hkv, G, dh], k/v [B, Hkv, S, dh], block_idx / valid
    [B, Hkv, kb] -> [B, Hkv, G, dh] in q's dtype.

    It follows the kernel (``_gattn_kernel``), not the reference's dense
    oracle, where the two differ: a (b, h) with no valid block gives 0
    (the oracle's softmax over an all-NEG_INF row gives the mean of the
    gathered V rows)."""
    b, hkv, g, dh = q.shape
    nb = k.shape[2] // block_size
    kb = block_idx.shape[-1]
    idx = block_idx.long().clamp(0, nb - 1)[..., None, None]
    kg = torch.take_along_dim(k.reshape(b, hkv, nb, block_size, dh), idx, 2)
    vg = torch.take_along_dim(v.reshape(b, hkv, nb, block_size, dh), idx, 2)
    kg = kg.reshape(b, hkv, kb * block_size, dh).float()
    vg = vg.reshape(b, hkv, kb * block_size, dh).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), kg) * (
        1.0 / dh ** 0.5)
    live = (valid == 1).repeat_interleave(block_size, -1)[:, :, None, :]
    scores = torch.where(live, scores, NEG_INF)
    p = torch.where(live, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vg)
    return (out / torch.clamp_min(p.sum(-1), 1e-30)[..., None]).to(q.dtype)
