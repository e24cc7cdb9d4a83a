"""Public kernel-layer functions for the GoldDiff hot path.

Counterpart of ``repro.kernels.ops`` for the single-host exact path:
coarse screen (``screen_topm``: materialized ``pdist`` + sort, or the
streamed kernel), exact re-rank (``support_distances`` +
``golden_rerank``), aggregation (``golden_support_aggregate`` over
supports, ``golden_aggregate`` for full scans) and the fused
single-pass step (``fused_step``), the Golden Index's coarse
screen (``ivf_probe``, one launch from the query to the probed
candidates; ``centroid_scan``; ``ivf_screen``), and the reduced-LLM
attention: causal GQA ``flash_attention`` (the prefill) and golden
block-sparse decode attention (``select_golden_blocks`` +
``golden_attention_decode``).

Dispatch is by the tensors' device and nothing else: CPU tensors take
the plain PyTorch version in ``ref``; CUDA tensors launch the
hand-written kernel or the call raises.  There is no fallback from the
card to the plain version.  The support functions take the store and
an index, and the kernels load rows by index: no [B, m, D] gather is
materialized on the card.

The selections outside the kernels stay PyTorch (a stable sort, so
ties go to the lowest index as with ``lax.top_k``); the streamed screen,
the fused candidates and the indexed probe select inside their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import fused_step as _fused
from repro_torch.kernels import screen as _screen
from repro_torch.kernels import centroid_scan as _probe
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.golden_attention import (
    golden_attention_decode as _gattn, select_golden_blocks)
from repro_torch.kernels.golden_aggregate import golden_aggregate as _agg
from repro_torch.kernels.golden_rerank import support_sqdist as _sqd
from repro_torch.kernels.golden_support_aggregate import (
    golden_support_aggregate as _sagg)
from repro_torch.kernels.pdist import pdist as _pdist


# Every kernel wrapper, each counting the launches it makes in its
# ``launches`` attribute; ``GoldDiffEngine.jitter`` replays a captured
# graph's counts with the graph, so each count stays what the card ran.
COUNTED = (_pdist, _sqd, _sagg, _agg, _screen.screen_topm,
           _fused.fused_candidates, _probe.centroid_scan, _flash, _gattn)


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


def screen_topm(q, x, m: int, q_norms=None, x_norms=None,
                tile: int | None = None, stream: bool = False):
    """Exact top-m rows of x by squared distance.  Returns ``(idx, d2)``
    [B, m], ``d2`` ascending, ties to the lowest index; ``m > N``
    surplus slots carry ``d2 = +inf`` and index 0.

    ``stream=False`` (the default) is the materialized form: the [B, N]
    distance matrix plus one stable sort.  ``stream=True`` never builds
    that matrix: the plain carry loop over N-tiles of ``tile`` rows on
    the CPU, the ``screen_topm`` kernel on the card (which has no
    N-tile).  The streamed forms also give index 0 to every slot whose
    distance is +inf, as the reference kernel does."""
    if not stream:
        return ref.materialized_topm(pdist(q, x, q_norms, x_norms), m)
    if _on_cpu(q):
        return _screen.screen_topm_scan(q, x, m, q_norms, x_norms, tile=tile)
    q = q.float().contiguous()
    if q_norms is None:
        q_norms = (q * q).sum(-1)
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    return _screen.screen_topm(q, x, m, q_norms.float().contiguous(),
                               x_norms.float().contiguous())


def support_distances(q, x, idx, x_norms=None):
    """Exact distances q_b -> x[idx[b]]: [B, m] fp32, no [B, m, D]
    subtract temporaries (and on the card no gathered copy at all)."""
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    if _on_cpu(q):
        return ref.support_sqdist_ref(q, x, x_norms, idx)
    return _sqd(q.float().contiguous(), x, x_norms.float().contiguous(),
                idx.contiguous())


def golden_rerank(q, x, cand, k: int, x_norms=None, valid=None):
    """Exact re-rank inside the candidate set (paper Eq. 5).  Returns
    ``(idx, d2)``: the top-k dataset indices [B, k] and their exact
    squared distances, ascending, ties to the lowest candidate slot.
    ``valid`` (bool [B, m], optional) marks the real slots: the others
    (capacity padding of ``ivf_screen``) get +inf, so they sort last
    and weigh nothing."""
    d2 = support_distances(q, x, cand, x_norms)
    if valid is not None:
        d2 = torch.where(valid, d2, float("inf"))
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


def centroid_scan(q, centroids, c_norms=None):
    """Query -> centroid distances [B, C] fp32 (IVF level 1); +inf
    ``c_norms`` entries (padded windows) give +inf.  On the card: kernel
    7's distance stage alone."""
    if _on_cpu(q):
        return ref.centroid_scan_ref(q, centroids, c_norms)
    if c_norms is None:
        c_norms = (centroids.float() ** 2).sum(-1)
    return _probe.centroid_scan(q.float().contiguous(), centroids,
                                c_norms.float().contiguous())


def ivf_probe(q, image_shape, factor: int, centroids, centroid_norms,
              offsets, perm, n: int, nprobe_max: int, max_cluster: int,
              nprobe=None, fields=ref.PROBE_FIELDS) -> ref.Probe:
    """IVF level 1 from rescaled queries q [B, D] of a store of
    ``image_shape``: the proxy (``downsample_proxy`` by ``factor``), the
    ``nprobe_max`` nearest windows in ``lax.top_k``'s order (ties, such
    as the duplicated centroids of a split cluster, to the lowest
    window) and each window's ``max_cluster`` slots L over an index of
    ``n`` rows (``ref.Probe``: probe list, positions, ``perm`` ids,
    validity, 0 / +inf markers; ``nprobe``, int or 0-d tensor, masks the
    probes beyond it).  On the card one launch of kernel 7 writing only
    ``fields``; on the CPU ``ref.ivf_probe_ref`` (the other fields None
    there too)."""
    _probe.pool_geometry(image_shape, factor)
    if not _on_cpu(q):
        return _probe.ivf_probe(q.float().contiguous(), image_shape, factor,
                                centroids, centroid_norms, offsets, perm, n,
                                nprobe_max, max_cluster, nprobe, fields)
    qp = ref.downsample_proxy(q.reshape((q.shape[0],) + tuple(image_shape)),
                              factor)
    out = ref.ivf_probe_ref(qp, centroids, centroid_norms, offsets, perm, n,
                            nprobe_max, max_cluster, nprobe)
    return ref.Probe(*(v if k in fields else None
                       for k, v in zip(ref.PROBE_FIELDS, out)))


def ivf_screen(qp, proxy_sorted, proxy_norms_sorted, offsets, centroids,
               centroid_norms, m: int, nprobe_max: int, max_cluster: int,
               nprobe=None):
    """Two-level indexed coarse screen over the GoldenIndex layout.

    Level 1 (``ivf_probe`` on the proxy queries qp [B, dp]): the
    ``nprobe_max`` nearest windows, by ``lax.top_k``'s order, and the
    probed CSR windows, each padded to ``max_cluster`` rows L.
    ``nprobe`` (int or 0-d tensor, default ``nprobe_max``) masks the
    probes beyond it.

    Returns ``(pos, d2)`` [B, m]: positions in cluster-sorted row space
    (map them through ``perm``) and their proxy distances; padding
    slots take ``pos = min(pos, N - 1)`` and ``d2 = +inf``.  With ``m >=
    nprobe_max * L`` (capacity mode: everything probed goes to the exact
    re-rank) the rows come back in CSR order and ``d2`` only marks them,
    0 real and +inf padding: on the card that is kernel 7's one launch.
    Below that (screening mode) the probed rows' proxy distances come
    from ``support_distances`` by index on ``proxy_sorted`` (no [B, R,
    dp] gather) and a stable sort keeps the m nearest."""
    capacity = m >= nprobe_max * max_cluster
    pr = ivf_probe(qp, (qp.shape[1],), 1, centroids, centroid_norms,
                   offsets, None, proxy_sorted.shape[0], nprobe_max,
                   max_cluster, nprobe,
                   ("pos", "marker") if capacity else ("pos", "valid"))
    if capacity:
        return pr.pos, pr.marker
    d2 = torch.where(pr.valid, support_distances(
        qp, proxy_sorted, pr.pos, proxy_norms_sorted), float("inf"))
    vals, sel = torch.sort(d2, dim=-1, stable=True)
    return torch.gather(pr.pos, -1, sel[:, :m]), vals[:, :m]


def fused_step(q, qp, x, proxy, m: int, k: int, sigma2,
               x_norms=None, proxy_norms=None, stream: bool = True,
               tile: int | None = None, m_t=None, k_t=None):
    """One fused GoldDiff step: the posterior mean [B, D] fp32 of
    rescaled queries ``q`` [B, D] with proxy queries ``qp`` [B, dp].

    The candidate stage reads the store once (``fused_step`` module):
    the proxy top-m with each slot's exact distance attached.  Then
    ``fused_posterior`` re-ranks inside it, clamps the logits and
    aggregates the k golden rows.  On the card it is always the
    ``fused_candidates`` kernel.  On the CPU ``stream=True`` takes the
    plain carry loop, ``stream=False`` the materialized screen with
    exact distances by index (surplus slots marked +inf, as in the
    streamed forms).  ``sigma2`` may be a 0-d tensor; ``m_t`` / ``k_t``
    (optional 0-d integer tensors) mask the scheduled sizes for the
    masked path (``fused_posterior``)."""
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    if proxy_norms is None:
        proxy_norms = (proxy.float() ** 2).sum(-1)
    if not _on_cpu(q):
        idx, d2 = _fused.fused_candidates(
            qp.float().contiguous(), q.float().contiguous(), proxy, x, m,
            proxy_norms.float().contiguous(), x_norms.float().contiguous())
    elif stream:
        idx, d2 = _fused.fused_candidates_scan(qp, q, proxy, x, m,
                                               proxy_norms, x_norms,
                                               tile=tile)
    else:
        idx, pd2 = screen_topm(qp, proxy, m, x_norms=proxy_norms)
        d2 = torch.where(torch.isinf(pd2), float("inf"),
                         support_distances(q, x, idx, x_norms))
    return _fused.fused_posterior(x, idx, d2, k, sigma2, m_t, k_t)


def flash_attention(q, k, v, causal: bool = True, qc: int = 256,
                    kc: int = 512):
    """Causal (or full) GQA attention: q [B, Hkv, G, S, dh], k/v [B,
    Hkv, S, dh] -> [B, Hkv, G, S, dh] in q's dtype, fp32 accumulation.

    ``qc`` / ``kc`` are the reference kernel's tile sizes: they are
    checked as it checks them (the sequence must tile evenly after
    ``min(., S)``) and otherwise change only the order of the sums."""
    s = q.shape[3]
    qc, kc = min(qc, s), min(kc, s)
    if s % qc or s % kc:
        raise ValueError(f"flash_attention: seq {s} must tile evenly by "
                         f"qc={qc} and kc={kc}")
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal)
    return _flash(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def golden_attention_decode(q, k, v, block_idx, valid, block_size: int = 128):
    """Exact attention over the golden blocks only: q [B, Hkv, G, dh],
    k/v [B, Hkv, S, dh], block_idx / valid [B, Hkv, kb] -> [B, Hkv, G,
    dh] in q's dtype.  Indices are clamped into range; blocks with
    ``valid != 1`` are skipped; a (b, h) with none gives 0."""
    s = k.shape[2]
    if s % block_size:
        raise ValueError(f"golden_attention_decode: cache length {s} must "
                         f"be block-aligned (block_size={block_size})")
    if _on_cpu(q):
        return ref.golden_attention_decode_ref(q, k, v, block_idx, valid,
                                               block_size)
    return _gattn(q.contiguous(), k.contiguous(), v.contiguous(),
                  block_idx.to(torch.int32).contiguous(),
                  valid.to(torch.int32).contiguous(), block_size)


__all__ = ["pdist", "screen_topm", "support_distances", "golden_rerank",
           "golden_support_aggregate", "golden_aggregate", "fused_step",
           "centroid_scan", "ivf_probe", "ivf_screen", "flash_attention",
           "golden_attention_decode", "select_golden_blocks"]
