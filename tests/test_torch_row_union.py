"""Kernels 2 and 3's host plan and a numpy model of their union design.

``support_sqdist`` and ``golden_support_aggregate`` read each row that a
group of queries names once (``csrc/row_union.cuh``).  The CUDA code
runs only on the card (``tests/test_torch_cuda.py``); here the plan that
sizes its buffers and grids is checked by hand, and a numpy model of
what the kernels do (the row map's chunked ballot compaction, the dot
pass and gather, the per-slot weights with their exclusive writers, the
row pass's tiles and the ordered merge) is held against the JAX
package's plain versions: bit-equal distances on integer data, 1e-5
absolute on means of O(1) rows.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import golden_rerank as rr  # noqa: E402
from repro_torch.kernels import golden_support_aggregate as sa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

QG = rr.QUERY_GROUP


# -- the host plan ---------------------------------------------------------

@pytest.mark.parametrize("b,n,s,want", [
    (16, 50000, 12500, dict(groups=1, ucap=50000, chunks=98)),
    (16, 50000, 2500, dict(groups=1, ucap=40000, chunks=98)),
    (1, 50000, 5000, dict(groups=1, ucap=5000, chunks=98)),
    (33, 2000, 150, dict(groups=3, ucap=2000, chunks=4)),
    (17, 100, 3, dict(groups=2, ucap=48, chunks=1)),
    (3, 2049, 700, dict(groups=1, ucap=2049, chunks=5)),
])
def test_union_plan(b, n, s, want):
    assert rr.union_plan(b, n, s) == want


@pytest.mark.parametrize("b,n,m,sms,ctas", [
    (16, 50000, 12500, 132, 396),     # what the card keeps resident
    (16, 50000, 12500, 64, 192),
    (33, 50000, 12500, 132, 132),     # three groups share the card
    (1, 500, 300, 132, 24),           # a short list's tiles x 8 shares
    (2, 10, 1, 132, 8),
    (0, 10, 1, 132, 8),               # no query: the C entry launches nothing
])
def test_sqdist_plan(b, n, m, sms, ctas):
    assert rr.sqdist_plan(b, n, m, sms)["dot_ctas"] == ctas


DOT_ITEMS = 4    # work items a dot-pass CTA at least (ITEMS in the source)


def dot_split(u, grid, d):
    """``dot_split`` of ``csrc/support_sqdist.cu``: the D shares a tile
    for a list of u rows on ``grid`` CTAs, enough for DOT_ITEMS work
    items a CTA, at most DOT_SPLIT_MAX and at most one a 32-column
    slab."""
    tiles = -(-u // rr.DOT_ROWS)
    return 1 if tiles == 0 else max(1, min(rr.DOT_SPLIT_MAX, -(-d // 32),
                                           -(-DOT_ITEMS * grid // tiles)))


@pytest.mark.parametrize("u,grid,d,ks", [
    (49988, 396, 3072, 5),            # B=16: 391 tiles, 1955 items
    (12500, 396, 3072, 8),            # B=1: 98 tiles, at most 8 shares
    (25000, 396, 3072, 8),
    (60000, 396, 3072, 4),
    (300, 12, 3072, 8),
    (300, 12, 7, 1),                  # one slab: nothing to share
    (0, 396, 3072, 1),
])
def test_dot_split(u, grid, d, ks):
    k = dot_split(u, grid, d)
    assert k == ks
    tiles = -(-u // rr.DOT_ROWS)
    slabs = -(-d // 32)
    # DOT_ITEMS items a CTA unless a cap stops it
    assert tiles * k >= min(DOT_ITEMS * grid,
                            tiles * min(rr.DOT_SPLIT_MAX, slabs))


def test_sqdist_scratch_sizes():
    # map words [G, N] (4 ints each), item counters, chunk counts, list
    # counts, query norms, lists; dots in DOT_SPLIT_MAX shares
    assert rr.sqdist_scratch_sizes(16, 50000, 12500) == dict(
        work=4 * 50000 + 1 + 98 + 1 + 16 + 50000, dots=8 * 50000 * QG)
    assert rr.sqdist_scratch_sizes(33, 2000, 150) == dict(
        work=4 * 3 * 2000 + 3 + 3 * 4 + 3 + 33 + 3 * 2000,
        dots=8 * 3 * 2000 * QG)


@pytest.mark.parametrize("b,n,k,d,sms,slices,tiles", [
    (16, 50000, 5000, 3072, 132, 6, 88),
    (1, 50000, 5000, 3072, 132, 6, 78),   # 5000 rows: 64 a tile at least
    (33, 2000, 150, 130, 132, 1, 31),
    (3, 50, 9, 10, 132, 1, 1),
    (16, 50000, 5000, 12288, 132, 24, 22),
    (0, 50, 9, 10, 132, 1, 1),
])
def test_aggregate_plan(b, n, k, d, sms, slices, tiles):
    p = sa.aggregate_plan(b, n, k, d, sms)
    assert (p["slices"], p["tiles"]) == (slices, tiles)


def test_aggregate_scratch_sizes():
    cells = 50000 * QG
    assert sa.scratch_sizes(16, 50000, 5000, 3072) == dict(
        zero=8 * cells + 4 * cells + 16 * 50000,
        work=2 * 16 + 98 + 1 + 50000, part=88 * 16 * 3072)


# -- a numpy model of the kernels ------------------------------------------

def model_row_map(idx, n):
    """mark, union_count and union_compact: per group the ascending list
    of rows its queries name and each row's position in it, built as the
    kernels build it (chunks of CHUNK rows; rounds of 256 rows; a warp's
    ballot, the earlier warps' counts, the earlier chunks' counts)."""
    b = idx.shape[0]
    groups = -(-b // QG)
    words = np.zeros((groups, n, QG), np.uint8)     # byte q % QG a query
    for q in range(b):
        words[q // QG, idx[q], q % QG] = 1
    mask = words.any(-1)
    chunk, threads = rr.UNION_CHUNK, 256
    chunks = max(1, -(-n // chunk))
    lists, pos = [], np.zeros((groups, n), np.int64)
    for g in range(groups):
        counts = [int(mask[g, c * chunk:(c + 1) * chunk].sum())
                  for c in range(chunks)]
        rows = np.full(sum(counts), -1, np.int64)
        for c in range(chunks):
            base = sum(counts[:c])
            for r0 in range(c * chunk, min(n, (c + 1) * chunk), threads):
                flags = [r < min(n, (c + 1) * chunk) and bool(mask[g, r])
                         for r in range(r0, r0 + threads)]
                warp_tot = [sum(flags[w * 32:(w + 1) * 32])
                            for w in range(threads // 32)]
                for t, f in enumerate(flags):
                    if f:
                        w, lane = divmod(t, 32)
                        s = base + sum(warp_tot[:w]) + sum(
                            flags[w * 32: w * 32 + lane])
                        rows[s] = r0 + t
                        pos[g, r0 + t] = s
                base += sum(warp_tot)
        lists.append(rows)
    return lists, pos


def model_sqdist(q, x, xn, idx):
    """The dot pass over each group's list, then the gather."""
    lists, pos = model_row_map(idx, x.shape[0])
    b, m = idx.shape
    qn = (q * q).sum(-1, dtype=np.float32)
    out = np.empty((b, m), np.float32)
    for g, rows in enumerate(lists):
        qs = q[g * QG:(g + 1) * QG]
        dots = x[rows] @ qs.T                            # [U, queries]
        for i in range(qs.shape[0]):
            bq = g * QG + i
            dot = dots[pos[g, idx[bq]], i]
            out[bq] = np.maximum((qn[bq] + xn[idx[bq]]) - np.float32(2) * dot,
                                 0)
    return out


def model_weights(idx, logits):
    """sagg_mark's (max, l), then sagg_tally / sagg_weigh: W[b][row] is
    the sum of query b's slot weights naming that row, one slot storing
    it, two adding onto 0, three or more summed by one slot in slot
    order.  Returns W as a dict and (max, l) per query."""
    b, k = idx.shape
    neg = np.float32(tref.NEG_INF)
    mx = np.maximum(logits.max(-1), neg)
    w = np.exp(logits - mx[:, None]).astype(np.float32)
    ell = w.sum(-1, dtype=np.float32)
    W = []
    for q in range(b):
        tally = {}
        for j in range(k):
            tally.setdefault(int(idx[q, j]), []).append(j)
        wq = {}
        for r, slots in tally.items():
            if len(slots) == 1:
                wq[r] = w[q, slots[0]]
            elif len(slots) == 2:
                wq[r] = np.float32(0) + w[q, slots[1]] + w[q, slots[0]]
            else:
                s = np.float32(0)
                for j in slots:                   # slot order
                    s = np.float32(s + w[q, j])
                wq[r] = s
        W.append(wq)
    return W, mx, ell


def tile_range(t, u, tiles):
    return t * u // tiles, (t + 1) * u // tiles


def model_aggregate(x, idx, logits, tiles=7):
    """The weights, the row pass over each group's list in ``tiles``
    shares, and the merge of the shares in order."""
    b, d = idx.shape[0], x.shape[1]
    lists, _ = model_row_map(idx, x.shape[0])
    W, _, ell = model_weights(idx, logits)
    out = np.zeros((b, d), np.float32)
    for g, rows in enumerate(lists):
        for i in range(min(QG, b - g * QG)):
            bq = g * QG + i
            parts = []
            for t in range(tiles):
                lo, hi = tile_range(t, len(rows), tiles)
                acc = np.zeros(d, np.float32)
                for r in rows[lo:hi]:
                    acc += W[bq].get(int(r), np.float32(0)) * x[r]
                parts.append(acc)
            out[bq] = np.sum(parts, 0) / max(ell[bq], np.float32(1e-30))
    return out


def draw_idx(rng, kind, b, n, s):
    if kind == "shared":
        return np.broadcast_to(rng.permutation(n)[:s], (b, s)).copy()
    if kind == "disjoint":
        return rng.permutation(n)[:b * s].reshape(b, s)
    return rng.integers(0, n, size=(b, s))


@pytest.mark.parametrize("kind,b,n,s", [
    ("shared", 16, 3000, 90), ("disjoint", 16, 3000, 90),
    ("random", 33, 5000, 120), ("random", 3, 64, 200),
    ("random", 1, 4500, 300)])
def test_row_map_model_lists_each_row_once_ascending(kind, b, n, s):
    rng = np.random.default_rng(s)
    idx = draw_idx(rng, kind, b, n, s)
    lists, pos = model_row_map(idx, n)
    for g, rows in enumerate(lists):
        want = np.unique(idx[g * QG:(g + 1) * QG])
        np.testing.assert_array_equal(rows, want)
        assert len(rows) <= rr.union_plan(b, n, s)["ucap"]
        np.testing.assert_array_equal(pos[g, rows], np.arange(len(rows)))


@pytest.mark.parametrize("u,tiles", [(0, 3), (5, 7), (48070, 88), (64, 1),
                                     (1000, 999)])
def test_row_pass_tiles_cover_the_list_once(u, tiles):
    spans = [tile_range(t, u, tiles) for t in range(tiles)]
    assert spans[0][0] == 0 and spans[-1][1] == u
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert max(hi - lo for lo, hi in spans) - min(
        hi - lo for lo, hi in spans) <= 1


@pytest.mark.parametrize("kind,b,n,d,m", [
    ("shared", 16, 400, 24, 60), ("disjoint", 16, 1000, 12, 60),
    ("random", 33, 300, 7, 40), ("random", 3, 20, 10, 50)])
def test_sqdist_model_bit_equal_to_jax(kind, b, n, d, m):
    rng = np.random.default_rng(m + b)
    q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    xn = (x * x).sum(-1)
    idx = draw_idx(rng, kind, b, n, m)
    want = np.asarray(jref.support_sqdist_ref(
        jnp.asarray(q), jnp.asarray(x[idx]), jnp.asarray(xn[idx])))
    np.testing.assert_array_equal(model_sqdist(q, x, xn, idx), want)


@pytest.mark.parametrize("kind,b,n,d,k", [
    ("shared", 16, 400, 24, 60), ("disjoint", 16, 1000, 12, 60),
    ("random", 33, 300, 7, 40), ("random", 3, 8, 10, 50)])
def test_aggregate_model_matches_jax(kind, b, n, d, k):
    rng = np.random.default_rng(k + b)
    x = rng.normal(size=(n, d)).astype(np.float32)
    idx = draw_idx(rng, kind, b, n, k)
    lg = (3 * rng.normal(size=(b, k))).astype(np.float32)
    lg[0] = tref.NEG_INF                  # all-NEG_INF: the uniform mean
    lg[-1, ::3] = tref.NEG_INF
    want = np.asarray(jref.golden_support_aggregate_ref(
        jnp.asarray(x[idx]), jnp.asarray(lg)))
    got = model_aggregate(x, idx, lg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], x[idx[0]].mean(0), atol=1e-5)


def test_weights_model_counts_every_slot():
    """A row named several times by one query weighs once a slot: the
    weights of each query sum to l, whatever the repeats."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 5, size=(4, 64))
    idx[3, 2:] = 0                         # m > N surplus: clamped to 0
    lg = rng.normal(size=(4, 64)).astype(np.float32)
    W, mx, ell = model_weights(idx, lg)
    for q in range(4):
        assert set(W[q]) == set(idx[q].tolist())
        np.testing.assert_allclose(sum(W[q].values()), ell[q], rtol=1e-6)
    assert all(m <= lg.max() for m in mx)
