"""Public kernel-layer functions for the GoldDiff hot path.

Counterpart of ``repro.kernels.ops`` for the single-host exact path:
coarse screen (``screen_topm``: materialized ``pdist`` + sort, or the
streamed kernel), exact re-rank (``support_distances`` +
``golden_rerank``), aggregation (``golden_support_aggregate`` over
supports, ``golden_aggregate`` for full scans) and the fused
single-pass step (``fused_step``), the Golden Index's coarse
screen (``ivf_probe``, one launch from the query to the probed
candidates; ``centroid_scan``; ``ivf_screen``), and the reduced-LLM
attention: causal GQA ``flash_attention`` (the prefill and the training
forward) with its gradient (``flash_attention_bwd``, and
``FlashAttention``, the autograd Function that joins the two), and golden
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

Store rows (``x``, ``proxy``, ``proxy_sorted``) may be fp32 or bf16 (the
engine's ``storage_dtype``); queries, norms and logits are fp32, and
every distance, softmax and sum is fp32.  On the CPU the plain versions
upcast the rows; on the card each of kernels 1-6 has a bf16-row
instance (kernel 7's bf16 instance rounds the pooled query, as the
engine's bf16 proxy query is rounded), and no function copies bf16 rows
up to fp32 to get past one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import fused_step as _fused
from repro_torch.kernels import screen as _screen
from repro_torch.kernels import centroid_scan as _probe
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd as _flash_bwd)
from repro_torch.kernels.golden_attention import (
    golden_attention_decode as _gattn, select_golden_blocks)
from repro_torch.kernels.golden_aggregate import golden_aggregate as _agg
from repro_torch.kernels.golden_aggregate import (
    golden_aggregate_state as _agg_state)
from repro_torch.kernels.golden_rerank import support_sqdist as _sqd
from repro_torch.kernels.golden_support_aggregate import (
    golden_support_aggregate as _sagg)
from repro_torch.kernels.golden_support_aggregate import (
    golden_support_aggregate_state as _sagg_state)
from repro_torch.kernels.pdist import pdist as _pdist


# Every kernel wrapper, each counting the launches it makes in its
# ``launches`` attribute; ``GoldDiffEngine.jitter`` replays a captured
# graph's counts with the graph, so each count stays what the card ran.
# The state entries of kernels 3 and 4 (the sharded engine's shard-local
# softmax states) count apart from their mean entries; the attention
# backward (one count a call of its three launches) comes last.
STATE_ENTRIES = (_sagg_state, _agg_state)
COUNTED = (_pdist, _sqd, _sagg, _agg, _screen.screen_topm,
           _fused.fused_candidates, _probe.centroid_scan, _flash,
           _gattn) + STATE_ENTRIES + (_flash_bwd,)
# ... and those with a bf16-row instance, counted in ``launches_bf16``
# (kernel 7's: the probe with the pooled query rounded to bf16)
COUNTED_BF16 = COUNTED[:7] + STATE_ENTRIES


def launch_counts() -> list[int]:
    """Every launch count: ``launches`` of COUNTED, then
    ``launches_bf16`` of COUNTED_BF16."""
    return ([k.launches for k in COUNTED]
            + [k.launches_bf16 for k in COUNTED_BF16])


def add_launch_counts(delta) -> None:
    """Add ``delta`` (in ``launch_counts``' order) to the counts."""
    for k, d in zip(COUNTED, delta):
        k.launches += d
    for k, d in zip(COUNTED_BF16, delta[len(COUNTED):]):
        k.launches_bf16 += d


# -- the dispatch seam --------------------------------------------------------
# ``GoldDiffEngine.program`` (the program cache) consults this hook on
# every lookup.  With none installed (the default) the cache returns its
# own callables unchanged.  ``repro_torch.launch.faults`` installs its
# seeded injector here and ``repro_torch.obs.trace`` its TraceHook;
# nothing else sets it.
_DISPATCH_HOOK = None


def set_dispatch_hook(hook):
    """Install (or clear, with None) the dispatch hook; returns the hook
    it replaces.  A hook provides ``on_program(engine, key)`` (every
    cache lookup, before the hit/miss check; it may evict) and
    ``wrap(key, fn) -> fn`` (every dispatch; it may return ``fn`` or a
    wrapped callable)."""
    global _DISPATCH_HOOK
    prev = _DISPATCH_HOOK
    _DISPATCH_HOOK = hook
    return prev


def dispatch_hook():
    """The installed dispatch hook (None when off)."""
    return _DISPATCH_HOOK


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


def golden_partial_aggregate(x, idx, logits, strategy: str = "gather"):
    """Unnormalized softmax state of x[idx] per query, ``(acc [B, D], m
    [B], l [B])``: the shard-local half of the golden aggregate, which
    store shards merge exactly by log-sum-exp
    (``distributed.sharding.lse_merge_mean``).  ``idx`` indexes the
    local shard ``x``; ``idx=None`` with dense [B, n_loc] logits takes
    every local row (the full-scan case).  On the CPU ``strategy``
    picks the reference's form ("gather": the gathered rows; "dense":
    the weights scattered into [B, N] times the store); on the card
    kernel 3's state entry (``idx=None``: the plain dense form, which
    only the CPU's callers take)."""
    if idx is None:
        lg = logits.float()
        m = lg.amax(-1)
        p = torch.exp(lg - m[:, None])
        return p @ x.float(), m, p.sum(-1)
    if _on_cpu(logits):
        if strategy == "dense":
            return ref.scatter_partial_aggregate_ref(x, idx, logits)
        return ref.partial_aggregate_ref(x, idx, logits)
    return _sagg_state(x, idx.contiguous(), logits.float().contiguous())


def golden_full_partial(q, x, sigma2: float, x_norms=None,
                        stream: bool = False, tile: int | None = None):
    """Unnormalized softmax state ``(acc, m, l)`` of the WHOLE local
    store: the shard-local half of a full scan (logits clamped at the
    finite NEG_INF, so all-padding rows merge to zero weight).  On the
    card kernel 4's state entry; on the CPU ``stream=True`` the tiled
    pass (``screen.full_scan_partial_stream``), else the dense form."""
    if x_norms is None:
        x_norms = (x.float() ** 2).sum(-1)
    if not _on_cpu(q):
        return _agg_state(q.float().contiguous(), x, float(sigma2),
                          x_norms.float().contiguous())
    if stream:
        return _screen.full_scan_partial_stream(
            q, x, float(sigma2), x_norms=x_norms,
            tile=_screen.DEFAULT_TILE if tile is None else tile)
    return ref.full_partial_ref(q, x, sigma2, x_norms)


def ivf_screen_local(qp, offsets_loc, centroids, centroid_norms, w_lo, w_hi,
                     nprobe_max: int, max_cluster: int, w_cap: int,
                     n_loc: int, nprobe=None):
    """Shard-local lanes of a *globally probed* Golden Index (capacity
    mode): every shard runs the same centroid scan and top-``nprobe_max``
    probe selection (``lax.top_k``'s order: a stable sort, ties to the
    lowest window), keeps only its own probed windows ``[w_lo, w_hi)``
    (ints or 0-d tensors), compacted best-first into ``w_cap`` slots
    (a stable sort again), and expands each into ``max_cluster`` lanes
    of its local CSR window ``offsets_loc``.  So the union of the
    shards' lanes is the single-device probe set, each lane owned by one
    shard.  ``nprobe`` (int or 0-d tensor, default ``nprobe_max``) masks
    the probes beyond it.  Returns ``(pos, d2)`` [B, w_cap * L]:
    positions into the shard's sorted rows (clamped to ``n_loc - 1``) and
    markers, 0 real and +inf padding or foreign.  On the card the
    distances are kernel 7's distance stage (``centroid_scan``); the
    selections are torch."""
    cd2 = centroid_scan(qp, centroids, centroid_norms)
    order = torch.sort(cd2, dim=-1, stable=True)
    cneg, probe = -order[0][:, :nprobe_max], order[1][:, :nprobe_max]
    mine = (probe >= w_lo) & (probe < w_hi)
    if nprobe is not None:
        mine = mine & (torch.arange(nprobe_max, device=qp.device) < nprobe)
    score = torch.where(mine, cneg, float("-inf"))
    svals, spos = torch.sort(score, dim=-1, descending=True, stable=True)
    svals, spos = svals[:, :w_cap], spos[:, :w_cap]
    win = torch.gather(probe, -1, spos)
    wvalid = svals > float("-inf")
    lw = torch.clamp(win - w_lo, 0, offsets_loc.shape[0] - 2)
    starts, ends = offsets_loc[lw], offsets_loc[lw + 1]       # [B, Wc]
    lane = torch.arange(max_cluster, dtype=starts.dtype, device=qp.device)
    pos = starts[..., None] + lane                            # [B, Wc, L]
    valid = (pos < ends[..., None]) & wvalid[..., None]
    b = qp.shape[0]
    pos = torch.clamp_max(pos, n_loc - 1).reshape(b, -1)
    valid = valid.reshape(b, -1)
    return pos, torch.where(valid, 0.0, float("inf"))


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
              nprobe=None, fields=ref.PROBE_FIELDS,
              round_bf16: bool = False) -> ref.Probe:
    """IVF level 1 from rescaled queries q [B, D] of a store of
    ``image_shape``: the proxy (``downsample_proxy`` by ``factor``), the
    ``nprobe_max`` nearest windows in ``lax.top_k``'s order (ties, such
    as the duplicated centroids of a split cluster, to the lowest
    window) and each window's ``max_cluster`` slots L over an index of
    ``n`` rows (``ref.Probe``: probe list, positions, ``perm`` ids,
    validity, 0 / +inf markers; ``nprobe``, int or 0-d tensor, masks the
    probes beyond it).  ``round_bf16`` (an engine with bf16 store rows)
    rounds the pooled query to bf16 first, its norm taken from the
    rounded values, as the reference rounds its proxy query.  On the card
    one launch of kernel 7 writing only ``fields``; on the CPU
    ``ref.ivf_probe_ref`` (the other fields None there too)."""
    _probe.pool_geometry(image_shape, factor)
    if not _on_cpu(q):
        return _probe.ivf_probe(q.float().contiguous(), image_shape, factor,
                                centroids, centroid_norms, offsets, perm, n,
                                nprobe_max, max_cluster, nprobe, fields,
                                round_bf16)
    qp = ref.downsample_proxy(q.reshape((q.shape[0],) + tuple(image_shape)),
                              factor)
    if round_bf16:
        qp = qp.to(torch.bfloat16).float()
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


# -- kernel 9 and the attention backward as custom operators -----------------
# ``torch.library`` operators, so that DTensor's ``local_map``, a fake
# tensor (the dry run) and ``torch.utils.flop_counter`` see one operator
# a call: the CPU kernel is the plain version, the CUDA kernel the
# hand-written one; the fake kernel gives the kernel's outputs only (o
# and the row lse; dq, dk, dv), never the plain version's [S, S] scores,
# so a traced program's memory is the kernel's.

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, return_lse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    if return_lse:
        return ref.flash_attention_ref(q, k, v, causal, True)
    return (ref.flash_attention_ref(q, k, v, causal),
            q.new_empty(0, dtype=torch.float32))


@_flash_op.register_kernel("cuda")
def _flash_op_cuda(q, k, v, causal, return_lse):
    out = _flash(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                 return_lse)
    if return_lse:
        return out
    return out, q.new_empty(0, dtype=torch.float32)


@_flash_op.register_fake
def _flash_op_fake(q, k, v, causal, return_lse):
    lse = (q.new_empty(q.shape[:4], dtype=torch.float32) if return_lse
           else q.new_empty(0, dtype=torch.float32))
    return torch.empty_like(q, memory_format=torch.contiguous_format), lse


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)


@_flash_bwd_op.register_kernel("cuda")
def _flash_bwd_op_cuda(q, k, v, o, do, lse, causal):
    return _flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                      o.contiguous(), do.contiguous(), lse.contiguous(),
                      causal)


@_flash_bwd_op.register_fake
def _flash_bwd_op_fake(q, k, v, o, do, lse, causal):
    c = torch.contiguous_format
    return (torch.empty_like(q, memory_format=c),
            torch.empty_like(k, memory_format=c),
            torch.empty_like(v, memory_format=c))


def attention_flops(q_shape, k_shape) -> int:
    """Kernel 9's FLOPs as the reference counts attention
    (``hlo_analysis.loop_corrections``): Q K^T and P V over every tile,
    4 B H S_q S_k dh, whatever the mask."""
    b, hkv, g, s, dh = q_shape
    return 4 * b * hkv * g * s * k_shape[2] * dh


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _fwd(q, k, v, causal, return_lse, *args, out_shape=None, **kw):
        return attention_flops(q, k)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _bwd(q, k, v, o, do, lse, causal, *args, out_shape=None, **kw):
        return 2 * attention_flops(q, k)


_register_flops()


def flash_attention(q, k, v, causal: bool = True, qc: int = 256,
                    kc: int = 512, return_lse: bool = False):
    """Causal (or full) GQA attention: q [B, Hkv, G, S, dh], k/v [B,
    Hkv, S, dh] -> [B, Hkv, G, S, dh] in q's dtype, fp32 accumulation;
    with ``return_lse``, ``(out, lse)``, lse [B, Hkv, G, S] the fp32 row
    log-sum-exp of the scaled scores (what the backward reads).

    ``qc`` / ``kc`` are the reference kernel's tile sizes: they are
    checked as it checks them (the sequence must tile evenly after
    ``min(., S)``) and otherwise change only the order of the sums."""
    s = q.shape[3]
    qc, kc = min(qc, s), min(kc, s)
    if s % qc or s % kc:
        raise ValueError(f"flash_attention: seq {s} must tile evenly by "
                         f"qc={qc} and kc={kc}")
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal,
                                                     return_lse)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool = True):
    """The gradient of ``flash_attention`` from its output ``o`` and row
    log-sum-exp ``lse``: q, o, do [B, Hkv, G, S, dh], k/v [B, Hkv, S,
    dh] -> (dq, dk, dv) in q's dtype, fp32 sums.  CPU tensors take the
    materialized plain version; CUDA tensors the hand-written kernel, or
    the call raises."""
    return tuple(torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, do,
                                                           lse, causal))


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward keeps q, k, v,
    the output and its row log-sum-exp, the backward is
    ``flash_attention_bwd`` (kernels on the card, plain versions on the
    CPU).  ``apply(q, k, v, causal, qc, kc)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, qc, kc):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal, qc, kc, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.causal)
        return dq, dk, dv, None, None, None


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
           "golden_partial_aggregate", "golden_full_partial",
           "ivf_screen_local",
           "centroid_scan", "ivf_probe", "ivf_screen", "flash_attention",
           "flash_attention_bwd", "FlashAttention",
           "golden_attention_decode", "select_golden_blocks"]
