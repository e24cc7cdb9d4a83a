"""The hand-written CUDA kernels against their plain versions on the card.

Marked ``cuda``; every test takes the ``card`` fixture, which skips when
no CUDA device is present (decided at run time, never at import, so
all workers collect the same tests).  On the chip:

  PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have.)

Integer-valued data keeps every fp32 sum exact: distances and the
selected sets are bit-equal.  Float data agrees to fp32 reduction
order: 1e-5 relative on distances, 1e-5 absolute on means of O(1) rows.
The attention kernels (8 and 9) agree with their plain versions to
2e-5 in fp32 and 1e-2 (relative and absolute: one bf16 rounding of
outputs of a few units, and kernel 9's bf16 weights P) in bf16; the reduced model's logits on the card
agree with the CPU's to 1e-4.
"""
import ctypes
import dataclasses
import re
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (GoldDiff, OptimalDenoiser,  # noqa: E402
                              make_schedule, sample)
from repro_torch.core.engine import STANDBY_EPOCH  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import build_index  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.centroid_scan import centroid_scan  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    fused_candidates, fused_candidates_scan)
from repro_torch.kernels import golden_aggregate as gagg_mod  # noqa: E402
from repro_torch.kernels import pdist as pdist_mod  # noqa: E402
from repro_torch.kernels.golden_aggregate import golden_aggregate  # noqa: E402
from repro_torch.kernels.golden_rerank import support_sqdist  # noqa: E402
from repro_torch.kernels.golden_support_aggregate import (  # noqa: E402
    golden_support_aggregate)
from repro_torch.kernels.pdist import pdist  # noqa: E402
from repro_torch.kernels.screen import screen_topm, screen_topm_scan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.golden_attention import (  # noqa: E402
    golden_attention_decode, select_golden_blocks, split_chunks)
from repro_torch.launch import golden_decode as gd  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def ints(shape, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-3, 4, shape, generator=g).float().to(dev)


@pytest.mark.parametrize("b,n,d", [(16, 5000, 192), (5, 333, 7),
                                   (17, 64, 33), (1, 4099, 64),
                                   (33, 1001, 784), (16, 777, 3072),
                                   (17, 130, 12288)])
def test_pdist_bit_equal_integer(card, b, n, d):
    q, x = ints((b, d), card, 0), ints((n, d), card, 1)
    qn, xn = (q * q).sum(-1), (x * x).sum(-1)
    xn[3] = float("inf")
    got = pdist(q, x, qn, xn)
    assert torch.equal(got, ref.pdist_ref(q, x, qn, xn))
    assert torch.isinf(got[:, 3]).all()
    for m in (40, n + 5):
        gi, gv = ref.materialized_topm(got, m)
        wi, wv = ref.materialized_topm(ref.pdist_ref(q, x, qn, xn), m)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("b,n,d,m", [(16, 4000, 3072, 700), (3, 100, 10, 37)])
def test_support_sqdist_bit_equal_integer(card, b, n, d, m):
    q, x = ints((b, d), card, 2), ints((n, d), card, 3)
    xn = (x * x).sum(-1)
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, n, (b, m), generator=g).to(card)
    got = support_sqdist(q, x, xn, idx)
    assert torch.equal(got, ref.support_sqdist_ref(q, x, xn, idx))
    k = m // 3
    gi, gv = ops.golden_rerank(q, x, idx, k, xn)
    wd = ref.support_sqdist_ref(q, x, xn, idx)
    wv, wp = torch.sort(wd, dim=-1, stable=True)
    assert torch.equal(gi, torch.gather(idx, -1, wp[:, :k]))
    assert torch.equal(gv, wv[:, :k])


@pytest.mark.parametrize("b,n,d,k", [(16, 3000, 3072, 500), (3, 50, 10, 9)])
def test_golden_support_aggregate_matches(card, b, n, d, k):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, d, generator=g).to(card)
    idx = torch.randint(0, n, (b, k), generator=g).to(card)
    lg = (3 * torch.randn(b, k, generator=g)).to(card)
    lg[0, ::2] = ref.NEG_INF
    lg[1] = ref.NEG_INF
    got = golden_support_aggregate(x, idx, lg)
    want = ref.golden_support_aggregate_ref(x, idx, lg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], x[idx[1]].mean(0), rtol=1e-5,
                               atol=1e-5)


# -- kernels 2 and 3 read the batch's row union (csrc/row_union.cuh) ---------
# Each query group's rows are read once; the cases cover every query
# naming the same rows, no row named twice, one query, several query
# groups (B > 16), ragged D, rows named three or more times by one query,
# and m > N surplus slots.

UNION_CASES = [("shared", 16, 6000, 3072, 700),
               ("disjoint", 16, 12000, 3072, 700),
               ("random", 1, 500, 3072, 300),
               ("random", 33, 2000, 130, 150),
               ("random", 5, 300, 7, 40),
               ("random", 16, 64, 3072, 400)]


def union_idx(kind, b, n, s, dev, seed):
    """[b, s] row ids: every query the same rows ("shared"), no row twice
    ("disjoint", b s <= n) or drawn with repeats ("random")."""
    g = torch.Generator().manual_seed(seed)
    if kind == "shared":
        idx = torch.randperm(n, generator=g)[:s].expand(b, s)
    elif kind == "disjoint":
        idx = torch.randperm(n, generator=g)[:b * s].reshape(b, s)
    else:
        idx = torch.randint(0, n, (b, s), generator=g)
    return idx.contiguous().to(dev)


@pytest.mark.parametrize("kind,b,n,d,m", UNION_CASES)
def test_support_sqdist_union_integer(card, kind, b, n, d, m):
    q, x = ints((b, d), card, 30), ints((n, d), card, 31)
    xn = (x * x).sum(-1)
    idx = union_idx(kind, b, n, m, card, 32)
    got = support_sqdist(q, x, xn, idx)
    assert torch.equal(got, ref.support_sqdist_ref(q, x, xn, idx))
    assert torch.equal(got, support_sqdist(q, x, xn, idx))


@pytest.mark.parametrize("kind,b,n,d,m", UNION_CASES)
def test_support_sqdist_union_float(card, kind, b, n, d, m):
    g = torch.Generator().manual_seed(35)
    x = torch.randn(n, d, generator=g).to(card)
    q = (torch.randn(b, d, generator=g)).to(card)
    xn = (x * x).sum(-1)
    idx = union_idx(kind, b, n, m, card, 36)
    got = support_sqdist(q, x, xn, idx)
    want = ref.support_sqdist_ref(q, x, xn, idx)
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max()
    assert float(rel) <= 1e-5
    assert torch.equal(got, support_sqdist(q, x, xn, idx))


@pytest.mark.parametrize("kind,b,n,d,k", UNION_CASES)
def test_golden_support_aggregate_union(card, kind, b, n, d, k):
    g = torch.Generator().manual_seed(33)
    x = torch.randn(n, d, generator=g).to(card)
    idx = union_idx(kind, b, n, k, card, 34)
    lg = (3 * torch.randn(b, k, generator=g)).to(card)
    lg[0] = ref.NEG_INF                 # an all-NEG_INF query
    lg[-1, ::3] = ref.NEG_INF
    got = golden_support_aggregate(x, idx, lg)
    want = ref.golden_support_aggregate_ref(x, idx, lg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[0], x[idx[0]].mean(0), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, golden_support_aggregate(x, idx, lg))


def test_golden_support_aggregate_repeated_rows(card):
    """Rows that one query names three or more times with different
    logits weigh once a slot, in the same sum on every call."""
    g = torch.Generator().manual_seed(37)
    x = torch.randn(10, 3072, generator=g).to(card)
    idx = torch.randint(0, 4, (3, 256), generator=g).to(card)
    idx[2, 5:] = 0                       # one row 251 times
    lg = (3 * torch.randn(3, 256, generator=g)).to(card)
    got = golden_support_aggregate(x, idx, lg)
    torch.testing.assert_close(
        got, ref.golden_support_aggregate_ref(x, idx, lg), rtol=1e-5,
        atol=1e-5)
    for _ in range(3):
        assert torch.equal(got, golden_support_aggregate(x, idx, lg))


def test_union_kernels_surplus_slots(card):
    """m > N: the screen's surplus slots carry row 0, so the re-rank and
    the aggregate see row 0 once more a surplus slot."""
    b, n, d, m, k = 4, 50, 64, 80, 70
    q, x = ints((b, d), card, 38), ints((n, d), card, 39)
    xn = (x * x).sum(-1)
    cand = ref.materialized_topm(ref.pdist_ref(q, x, None, xn), m)[0]
    assert bool((cand[:, n:] == 0).all())
    got = support_sqdist(q, x, xn, cand)
    assert torch.equal(got, ref.support_sqdist_ref(q, x, xn, cand))
    gid, gd2 = ops.golden_rerank(q, x, cand, k, xn)
    lg = torch.clamp_min(-gd2 / 20.0, ref.NEG_INF)
    torch.testing.assert_close(
        golden_support_aggregate(x, gid, lg),
        ref.golden_support_aggregate_ref(x, gid, lg), rtol=1e-5, atol=1e-5)


def test_union_kernels_empty_inputs(card):
    """No query, no slot: empty distances, and zero means for an empty
    softmax, as the plain versions give."""
    q, x = ints((3, 16), card, 43), ints((20, 16), card, 44)
    xn = (x * x).sum(-1)
    none = torch.zeros((3, 0), dtype=torch.int64, device=card)
    assert support_sqdist(q, x, xn, none).shape == (3, 0)
    assert support_sqdist(q[:0], x, xn, none[:0]).shape == (0, 0)
    lg = torch.zeros((3, 0), device=card)
    got = golden_support_aggregate(x, none, lg)
    assert torch.equal(got, ref.golden_support_aggregate_ref(x, none, lg))
    assert golden_support_aggregate(x, none[:0], lg[:0]).shape == (0, 16)


def test_union_kernels_count_once_and_never_sync(card):
    """One call adds 1 to its count however many launches it makes, and
    reads nothing back from the card."""
    q, x = ints((16, 64), card, 40), ints((300, 64), card, 41)
    idx = union_idx("random", 16, 300, 50, card, 42)
    xn = (x * x).sum(-1)
    before = support_sqdist.launches, golden_support_aggregate.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        d2 = support_sqdist(q, x, xn, idx)
        golden_support_aggregate(x, idx, -d2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (support_sqdist.launches, golden_support_aggregate.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("b,n,d", [(16, 5000, 3072), (3, 77, 10),
                                   (1, 40, 12288), (1, 5003, 64),
                                   (17, 2001, 784), (33, 1500, 3072),
                                   (16, 3000, 12288), (16, 999, 3000)])
@pytest.mark.parametrize("sigma2", [0.5, 20.0, 0.0])
def test_golden_aggregate_matches(card, b, n, d, sigma2):
    g = torch.Generator().manual_seed(6)
    x = (torch.randn(n, d, generator=g) / d ** 0.5).to(card)
    q = x[:b] + 0.1 * torch.randn(b, d, generator=g).to(card)
    xn = (x * x).sum(-1)
    got = golden_aggregate(q, x, sigma2, xn)
    want = ref.golden_aggregate_ref(q, x, sigma2, xn)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# -- kernel 4's cluster design (csrc/golden_aggregate.cu) ---------------------
# D is split across the CTAs of a thread block cluster (C = 1, 2, 4 or
# 16 at these widths; 3000 is not a multiple of C x 8), N across the
# clusters; the CTAs of a cluster must hold bit-identical logits.

@pytest.mark.parametrize("b,n,d", [(16, 3001, 3072), (17, 777, 784),
                                   (1, 50, 12288), (5, 1000, 3000),
                                   (33, 301, 64)])
def test_golden_aggregate_inf_norm_rows(card, b, n, d):
    """+inf-norm rows get no weight (the means equal the mean over the
    other rows), on ragged N; two calls are bit-equal."""
    g = torch.Generator().manual_seed(21)
    x = (torch.randn(n, d, generator=g) / d ** 0.5).to(card)
    q = x[:b] + 0.1 * torch.randn(b, d, generator=g).to(card)
    xn = (x * x).sum(-1)
    dead = torch.arange(0, n, 7, device=card)
    xn[dead] = float("inf")
    live = torch.ones(n, dtype=torch.bool, device=card)
    live[dead] = False
    got = golden_aggregate(q, x, 0.5, xn)
    torch.testing.assert_close(got, ref.golden_aggregate_ref(q, x, 0.5, xn),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        got, ref.golden_aggregate_ref(q, x[live], 0.5, xn[live]),
        rtol=1e-4, atol=1e-5)
    assert torch.equal(got, golden_aggregate(q, x, 0.5, xn))


@pytest.mark.parametrize("b,n,d", [(16, 5000, 3072), (17, 2001, 784),
                                   (16, 3000, 12288), (3, 999, 3000)])
def test_golden_aggregate_cluster_ranks_agree(card, b, n, d):
    """Every CTA of a cluster ends with the same (max, l) and had the
    same first-tile weights, bit for bit: the rank-order logit sum."""
    g = torch.Generator().manual_seed(22)
    x = (torch.randn(n, d, generator=g) / d ** 0.5).to(card)
    q = x[:b] + 0.1 * torch.randn(b, d, generator=g).to(card)
    xn = (x * x).sum(-1)
    out, ranks = gagg_mod.cluster_states(q, x, 0.5, xn)
    p = gagg_mod.plan(b, n, d, gagg_mod.active_clusters(
        gagg_mod.cluster_shape(d), card))
    assert tuple(ranks.shape) == (p["splits"], p["cluster"],
                                  16 * p["groups"], 18)
    assert not torch.isnan(ranks).any()
    assert torch.equal(ranks, ranks[:, :1].expand_as(ranks))
    assert torch.equal(out, golden_aggregate(q, x, 0.5, xn))


def test_full_scan_kernels_count_once_and_never_sync(card):
    """One call of kernel 1 or 4 adds 1 to its count, however many
    launches it makes, and reads nothing back from the card; the
    wrappers' plans agree with the C sources' shared-memory sizes."""
    q, x = ints((16, 3072), card, 23), ints((700, 3072), card, 24)
    xn = (x * x).sum(-1)
    golden_aggregate(q, x, 0.5, xn)          # builds, reads the card's shape
    before = pdist.launches, golden_aggregate.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        pdist(q[:, :192].contiguous(), x[:, :192].contiguous(),
              (q[:, :192] ** 2).sum(-1), (x[:, :192] ** 2).sum(-1))
        golden_aggregate(q, x, 0.5, xn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (pdist.launches, golden_aggregate.launches) == \
        (before[0] + 1, before[1] + 1)
    agg_smem = _build.load("golden_aggregate", "golden_aggregate_smem_bytes",
                           [ctypes.c_int] * 4, ctypes.c_size_t)
    pd_smem = _build.load("pdist", "pdist_smem_bytes", [ctypes.c_int] * 3,
                          ctypes.c_size_t)
    for size in (4, 2):                      # fp32 rows, bf16 rows
        for d in (2, 64, 784, 3072, 12288):
            s = gagg_mod.cluster_shape(d, size)
            assert agg_smem(s["slice"], s["stages"], s["cluster"],
                            size) == s["smem"]
            p = pdist_mod.plan(16, 50000, d, itemsize=size)
            assert pd_smem(d, p["stages"], size) == p["smem"]


def test_trajectory_card_matches_cpu(card):
    """A 10-step GoldDiff trajectory on the card (kernels) against the
    same trajectory on the CPU (plain versions), same store and x_T."""
    cpu_store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    x_T = float(sched.b[1000]) * torch.randn(
        8, cpu_store.dim, generator=torch.Generator().manual_seed(0))
    outs = []
    for dev in ("cpu", card):
        gd = GoldDiff(OptimalDenoiser(cpu_store, sched, device=dev))
        outs.append(sample(gd, sched, tuple(x_T.shape), x_init=x_T).cpu())
    assert np.isfinite(outs[1].numpy()).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)


def test_kernels_count_launches(card):
    q, x = ints((2, 8), card, 7), ints((9, 8), card, 8)
    before = pdist.launches
    ops.pdist(q, x)
    assert pdist.launches == before + 1


# -- the streamed screen and the fused candidates ------------------------------
# The plain versions run on the card too (the carry loops, with torch's
# matmul and stable sort); integer data makes them exact, so the
# kernels must match them bit for bit, +inf and surplus slots included.

def norms(a):
    return (a * a).sum(-1)


@pytest.mark.parametrize("b,n,d,m", [
    (16, 50000, 192, 12500),   # the main path's shapes
    (16, 5000, 192, 1250),
    (5, 333, 7, 40),           # d % 4 != 0: scalar loads
    (17, 300, 12, 400),        # B > 16, m > N
    (3, 40000, 8, 20000),      # m > 16384: 11 sort chunks, 4 merge rounds
    (2, 1, 4, 3),              # a one-row store
    # the sort takes cap = min(m + 2048, N) slots in chunks of 2048
    (2, 2048, 8, 100),         # cap = one chunk: no pass, no merge round
    (1, 10000, 16, 1),         # B = 1, cap = one chunk + 1
    (1, 10000, 16, 2048),      # B = 1, cap = two chunks, m = one chunk
    (1, 10000, 16, 2049),      # m = one chunk + 1: a ragged merge round
    (33, 10000, 16, 6143),     # B = 33, cap = four chunks - 1
    (2, 3000, 8, 5000),        # m > N above one chunk
    (2, 200000, 8, 30000),     # several tiles per radix block
])
def test_screen_topm_bit_equal_integer(card, b, n, d, m):
    q, x = ints((b, d), card, 10), ints((n, d), card, 11)
    qn, xn = norms(q), norms(x)
    if n > 3:
        xn[3] = float("inf")
    gi, gv = screen_topm(q, x, m, qn, xn)
    wi, wv = screen_topm_scan(q, x, m, qn, xn)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    assert (gi[torch.isinf(gv)] == 0).all()


@pytest.mark.parametrize("n,m", [(3000, 100), (6000, 2500), (3000, 1000)])
def test_screen_topm_all_tied(card, n, m):
    """Every distance equal: the lowest rows.  The row passes pick them
    where m + 2048 < N (m = 2500 is above one sort chunk); at m + 2048
    >= N every row is sorted."""
    q = torch.zeros(4, 8, device=card)
    x = torch.ones(n, 8, device=card)
    gi, gv = screen_topm(q, x, m, norms(q), norms(x))
    assert torch.equal(gi, torch.arange(m, device=card).expand(4, -1))
    assert (gv == 8).all()


def test_screen_topm_float(card):
    """Float data: distances within 1e-5 relative, and every selected
    row's own distance is within that tolerance of its slot."""
    g = torch.Generator().manual_seed(12)
    q = torch.randn(16, 192, generator=g).to(card)
    x = torch.randn(20000, 192, generator=g).to(card)
    gi, gv = screen_topm(q, x, 3000, norms(q), norms(x))
    wi, wv = screen_topm_scan(q, x, 3000, norms(q), norms(x))
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5)
    own = torch.gather(ref.pdist_ref(q, x), -1, gi)
    torch.testing.assert_close(own, gv, rtol=1e-5, atol=1e-5)
    assert (gi == wi).float().mean() > 0.99


@pytest.mark.parametrize("b,n,dp,d,m", [
    (16, 8000, 192, 3072, 2000),
    (16, 3000, 48, 768, 800),
    (5, 333, 7, 30, 40),        # dp, D % 4 != 0: scalar loads
    (17, 200, 12, 64, 300),     # B > 16, m > N
    (2, 20000, 8, 16, 17000),   # m > 16384: 10 sort chunks, 4 merge rounds
    (2, 2048, 8, 16, 100),      # cap = one chunk: no pass, no merge round
    (1, 6000, 16, 16, 2048),    # B = 1, m = one chunk (cap two)
    (1, 6000, 16, 16, 2049),    # m = one chunk + 1
    (33, 9000, 16, 32, 6143),   # B = 33, cap = four chunks - 1
    (3, 2500, 8, 16, 4000),     # m > N above one chunk
])
def test_fused_candidates_bit_equal_integer(card, b, n, dp, d, m):
    qp, q = ints((b, dp), card, 13), ints((b, d), card, 14)
    proxy, x = ints((n, dp), card, 15), ints((n, d), card, 16)
    pn, xn = norms(proxy), norms(x)
    pn[3] = float("inf")
    xn[5] = float("inf")
    gi, gv = fused_candidates(qp, q, proxy, x, m, pn, xn)
    wi, wv = fused_candidates_scan(qp, q, proxy, x, m, pn, xn)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    si, _ = screen_topm(qp, proxy, m, norms(qp), pn)
    assert torch.equal(gi, si)


def test_fused_candidates_all_tied(card):
    """Every proxy distance equal, m above one sort chunk and m + 2048 <
    N (so the row passes run): the lowest rows in order, each with its
    own exact distance."""
    qp = torch.zeros(3, 8, device=card)
    proxy = torch.ones(6000, 8, device=card)
    q, x = ints((3, 16), card, 20), ints((6000, 16), card, 21)
    gi, gv = fused_candidates(qp, q, proxy, x, 2500, norms(proxy), norms(x))
    assert torch.equal(gi, torch.arange(2500, device=card).expand(3, -1))
    assert torch.equal(gv, ref.support_sqdist_ref(q, x, norms(x), gi))


def test_fused_step_float(card):
    """The fused step on the card against its plain version on the
    card: means within 1e-4."""
    g = torch.Generator().manual_seed(17)
    x = torch.randn(6000, 768, generator=g).to(card)
    proxy = x.reshape(6000, 16, 16, 3)[:, ::4, ::4].reshape(6000, -1)
    proxy = proxy.contiguous()
    q = x[:16] + 0.3 * torch.randn(16, 768, generator=g).to(card)
    qp = q.reshape(16, 16, 16, 3)[:, ::4, ::4].reshape(16, -1).contiguous()
    got = ops.fused_step(q, qp, x, proxy, 1500, 600, 2.0)
    i, d2 = fused_candidates_scan(qp, q, proxy, x, 1500)
    from repro_torch.kernels.fused_step import fused_posterior
    want = fused_posterior(x, i, d2, 600, 2.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(fused=True),
                                dict(screen="streamed", fused=False)])
def test_new_routes_card_match_cpu(card, kw):
    """Ten fused or streamed-screen steps on the card against the same
    route on the CPU (plain versions)."""
    cpu_store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    x_T = float(sched.b[1000]) * torch.randn(
        8, cpu_store.dim, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", card):
        gd = GoldDiff(OptimalDenoiser(cpu_store, sched, device=dev), **kw)
        outs.append(sample(gd, sched, tuple(x_T.shape), x_init=x_T).cpu())
    assert np.isfinite(outs[1].numpy()).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)


def test_new_kernels_count_launches(card):
    q, x = ints((2, 8), card, 18), ints((9, 8), card, 19)
    before = screen_topm.launches, fused_candidates.launches
    ops.screen_topm(q, x, 4, stream=True)
    ops.fused_step(x[:2], q, x, x, 4, 2, 1.0)
    assert screen_topm.launches == before[0] + 1
    assert fused_candidates.launches == before[1] + 1


# -- the Golden Index: centroid scan, ivf_screen, k-means on the card ----------

@pytest.mark.parametrize("b,c,d", [
    (16, 225, 192),            # cifar_like's windows (+1 padded)
    (16, 513, 64),             # the gmm scale store's (+1 padded)
    (5, 37, 7),                # ragged C and d
    (40, 100, 130),            # B > 16: several query tiles
    (3, 1, 9),                 # C = 1
])
def test_centroid_scan_bit_equal_integer(card, b, c, d):
    q, cents = ints((b, d), card, 20), ints((c, d), card, 21)
    cn = norms(cents)
    cn[-1] = float("inf")                       # a padded window
    got = centroid_scan(q, cents, cn)
    want = ref.centroid_scan_ref(q, cents, cn)
    assert torch.equal(got, want)
    assert torch.isinf(got[:, -1]).all()
    assert torch.equal(torch.sort(got, dim=-1, stable=True)[1],
                       torch.sort(want, dim=-1, stable=True)[1])


def test_centroid_scan_float(card):
    g = torch.Generator().manual_seed(22)
    q = torch.randn(16, 192, generator=g).to(card)
    cents = torch.randn(300, 192, generator=g).to(card)
    got = ops.centroid_scan(q, cents)
    torch.testing.assert_close(got, ref.centroid_scan_ref(q, cents),
                               rtol=1e-5, atol=1e-5)


def test_ivf_screen_card_matches_cpu(card):
    """The same carried index on both devices: capacity mode equal slot
    for slot, screening mode equal on integer proxies."""
    from repro_torch.core import store_from_numpy
    rng = np.random.default_rng(23)
    x = rng.integers(-3, 4, (3000, 16)).astype(np.float32)
    n2 = (x * x).sum(-1)
    cpu_store = store_from_numpy(x, x, n2, n2, (16,), device="cpu")
    ix = build_index(cpu_store, 40)
    q = torch.from_numpy(rng.integers(-3, 4, (16, 16)).astype(np.float32))
    for m, p in ((6 * ix.max_cluster, 6), (200, 9)):
        outs = []
        for dev, ixd in (("cpu", ix), (card, ix.to(card))):
            pos, d2 = ops.ivf_screen(q.to(dev), ixd.proxy_sorted,
                                     ixd.proxy_norms_sorted, ixd.offsets,
                                     ixd.centroids, ixd.centroid_norms, m,
                                     p, ixd.max_cluster)
            outs.append((pos.cpu(), d2.cpu()))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


def test_kmeans_on_card_is_deterministic(card):
    store = make_dataset("gmm", n=20000, dim=32, num_modes=64, seed=0,
                         device=card)
    a, b = (build_index(store, 128, generator=torch.Generator(
        device=card).manual_seed(0)) for _ in range(2))
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.perm, b.perm) and torch.equal(a.offsets, b.offsets)
    assert a.device.type == "cuda" and a.perm.dtype == torch.int64


def test_indexed_route_card_matches_cpu(card):
    """Ten indexed steps on the card against the same route on the CPU,
    with an index built on the CPU and moved to the card."""
    from repro_torch.core import GoldDiffConfig
    from repro_torch.index import ProbeSchedule
    cpu_store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    ix = build_index(cpu_store)
    sched = make_schedule("ddpm_linear", 1000)
    cfg = GoldDiffConfig(1 / 64, 1 / 32, 1 / 128, 1 / 64)
    x_T = float(sched.b[1000]) * torch.randn(
        8, cpu_store.dim, generator=torch.Generator().manual_seed(2))
    outs = []
    before = centroid_scan.launches
    for dev in ("cpu", card):
        gd = GoldDiff(OptimalDenoiser(cpu_store, sched, device=dev), cfg,
                      index=ix, probe_schedule=ProbeSchedule(1 / 16, 1 / 4),
                      index_mode="always")
        outs.append(sample(gd, sched, tuple(x_T.shape), x_init=x_T).cpu())
    assert centroid_scan.launches == before + 10
    assert np.isfinite(outs[1].numpy()).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)


# -- kernel 7 as one probe launch (ops.ivf_probe) ------------------------------

IMAGE = (32, 32, 3)            # cifar_like's queries, pooled 4x to d=192


def probe_index(c, L, dev, seed, dp=192):
    """A CSR layout of C windows of 1..L rows (one of L rows) and a
    permutation of its rows; integer centroids of width dp, every third
    window a copy of the one before it (a split cluster), the last one
    padded (+inf norm) when C > 3."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, L + 1, c)
    sizes[rng.integers(0, c)] = L
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    cents = rng.integers(-3, 4, (c, dp)).astype(np.float32)
    if c > 2:
        cents[1::3] = cents[0::3][: len(cents[1::3])]
    cn = (cents * cents).sum(-1)
    if c > 3:
        cn[-1] = np.inf

    def t(a, dt):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)

    return dict(centroids=t(cents, np.float32),
                centroid_norms=t(cn, np.float32),
                offsets=t(offsets, np.int64),
                perm=t(rng.permutation(n), np.int64), n=n, L=L)


def probe_pair(q, ix, p, shape=IMAGE, nprobe=None, fields=ref.PROBE_FIELDS,
               factor=4):
    """(kernel, plain version) of level 1 on the same card tensors."""
    args = (ix["centroids"], ix["centroid_norms"], ix["offsets"], ix["perm"],
            ix["n"], p, ix["L"])
    got = ops.ivf_probe(q, shape, factor, *args, nprobe=nprobe, fields=fields)
    qp = ref.downsample_proxy(q.reshape((q.shape[0],) + tuple(shape)), factor)
    return got, ref.ivf_probe_ref(qp, *args, nprobe=nprobe)


def assert_probe_equal(got, want):
    for name, g, w in zip(ref.PROBE_FIELDS, got, want):
        if g is not None:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("c", [1, 5, 230, 617, 4097])
@pytest.mark.parametrize("b", [1, 16, 17])
def test_ivf_probe_bit_equal_integer(card, b, c):
    ix = probe_index(c, 12, card, seed=c + b)
    q = ints((b, 3072), card, 30 + c)
    for p in sorted({1, min(8, c), c}):
        got, want = probe_pair(q, ix, p)
        assert_probe_equal(got, want)
        if p == c > 3:                      # the padded window comes last
            assert (got.probe[:, -1] == c - 1).all()


def test_ivf_probe_identity_gmm_shape(card):
    """The gmm scale store's shape: no pooling, d=64, C=617, every window
    probed, with the int and 0-d tensor masks."""
    ix = probe_index(617, 192, card, seed=5, dp=64)
    q = ints((16, 64), card, 31)
    for nprobe in (None, 300, torch.tensor(300, device=card)):
        got, want = probe_pair(q, ix, 617, shape=(64,), nprobe=nprobe)
        assert_probe_equal(got, want)


@pytest.mark.parametrize("factor", [1, 2, 3, 8])
def test_ivf_probe_pooling_factors(card, factor):
    """Factors other than the stores' 4 (the fold reads a window's f^2
    samples in chunks of 16: 1, 4, 9 (cropped to 30x30) and 64 of them):
    bit-equal to ``ref.downsample_proxy`` then the plain version.  The
    integers are multiples of f^2, so every pooled mean is an integer and
    the distances are exact (a mean of nine integers is not)."""
    dp = (32 // factor) ** 2 * 3
    ix = probe_index(230, 12, card, seed=20 + factor, dp=dp)
    q = factor * factor * ints((16, 3072), card, 38 + factor)
    for p in (8, 230):
        got, want = probe_pair(q, ix, p, factor=factor)
        assert_probe_equal(got, want)


@pytest.mark.parametrize("nprobe", [0, 3, 8, 13, "int64", "int32"])
def test_ivf_probe_nprobe_mask(card, nprobe):
    ix = probe_index(40, 9, card, seed=7)
    q = ints((16, 3072), card, 32)
    if isinstance(nprobe, str):
        nprobe = torch.tensor(5, dtype=getattr(torch, nprobe), device=card)
    got, want = probe_pair(q, ix, 8, nprobe=nprobe)
    assert_probe_equal(got, want)
    live = min(8, int(nprobe))
    assert not got.valid.reshape(16, 8, 9)[:, live:].any()


def test_ivf_probe_reads_the_mask_on_the_card(card):
    """A 0-d tensor nprobe is read by the kernel: no host sync."""
    ix = probe_index(40, 9, card, seed=8)
    q = ints((16, 3072), card, 33)
    nprobe = torch.tensor(4, device=card)
    ops.ivf_probe(q, IMAGE, 4, ix["centroids"], ix["centroid_norms"],
                  ix["offsets"], ix["perm"], ix["n"], 8, 9, nprobe)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.ivf_probe(q, IMAGE, 4, ix["centroids"],
                            ix["centroid_norms"], ix["offsets"], ix["perm"],
                            ix["n"], 8, 9, nprobe)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not got.valid.reshape(16, 8, 9)[:, 4:].any()


def test_ivf_probe_zero_distance_first(card):
    """A query whose proxy equals a centroid: its distance is exactly 0
    (no -0.0 after +inf) and that window is probed first."""
    ix = probe_index(230, 12, card, seed=9)
    c2 = ix["centroids"][2].reshape(8, 8, 3)
    q = c2.repeat_interleave(4, 0).repeat_interleave(4, 1).reshape(1, -1)
    q = torch.cat([q, ints((2, 3072), card, 34)])
    qp = ref.downsample_proxy(q.reshape(3, *IMAGE), 4)
    assert torch.equal(qp[0], ix["centroids"][2])
    d2 = ops.centroid_scan(qp, ix["centroids"], ix["centroid_norms"])
    assert d2[0, 2].item() == 0.0 and not torch.signbit(d2[0, 2])
    got, want = probe_pair(q, ix, 8)
    assert_probe_equal(got, want)
    assert got.probe[0, 0].item() == int(torch.nonzero(d2[0] == 0)[0])


def test_ivf_probe_ties_go_to_the_lowest_window(card):
    """Split windows share a centroid: equal keys but for the window, in
    ascending window order, as lax.top_k breaks the tie."""
    ix = probe_index(230, 12, card, seed=10)
    q = ints((16, 3072), card, 35)
    got, _ = probe_pair(q, ix, 230)
    d2 = ref.centroid_scan_ref(
        ref.downsample_proxy(q.reshape(16, *IMAGE), 4), ix["centroids"],
        ix["centroid_norms"])
    ranked = torch.gather(d2, 1, got.probe)
    same = ranked[:, 1:] == ranked[:, :-1]
    assert same.any()
    assert (got.probe[:, 1:][same] > got.probe[:, :-1][same]).all()


def test_ivf_probe_float(card):
    """Float queries and centroids: the distance stage within 1e-5, the
    probe lists equal up to near-ties (windows within 1e-5 relative)."""
    g = torch.Generator().manual_seed(36)
    ix = probe_index(617, 64, card, seed=11, dp=64)
    ix["centroids"] = torch.randn(617, 64, generator=g).to(card)
    ix["centroid_norms"] = norms(ix["centroids"])
    q = ix["centroids"][:16] + 0.3 * torch.randn(16, 64, generator=g).to(card)
    got, want = probe_pair(q, ix, 40, shape=(64,))
    d2 = ref.centroid_scan_ref(q, ix["centroids"], ix["centroid_norms"])
    torch.testing.assert_close(
        ops.centroid_scan(q, ix["centroids"], ix["centroid_norms"]), d2,
        rtol=1e-5, atol=1e-5)
    diff = got.probe != want.probe
    a = torch.gather(d2, 1, got.probe)[diff]
    w = torch.gather(d2, 1, want.probe)[diff]
    assert ((a - w).abs() <= 1e-5 * w.abs().clamp_min(1.0)).all()


def test_ivf_probe_is_one_launch(card):
    """The engine's fields: one kernel on the card, one count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ix = probe_index(230, 12, card, seed=12)
    q = ints((16, 3072), card, 37)
    got, want = probe_pair(q, ix, 8, fields=("ids", "valid"))
    assert got.probe is None and got.pos is None and got.marker is None
    assert_probe_equal(got, want)
    before = centroid_scan.launches
    torch.cuda.synchronize()
    # the pauses keep the launch inside the session, whose window the
    # card's clock skew can otherwise push it out of
    # (scripts/card_timing.device_profile)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        ops.ivf_probe(q, IMAGE, 4, ix["centroids"], ix["centroid_norms"],
                      ix["offsets"], ix["perm"], ix["n"], 8, 12,
                      fields=("ids", "valid"))
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert centroid_scan.launches == before + 1
    assert len(names) == 1 and "ivf_probe_kernel" in names[0], names


# -- the reduced-LLM attention kernels (8 and 9) -------------------------------

ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def randn(shape, dev, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize("b,hkv,g,s,dh", [
    (2, 8, 3, 512, 128),       # the llama prefill's heads
    (1, 4, 5, 256, 64),
    (2, 1, 2, 96, 32),         # S not a multiple of the key tile
    (2, 2, 9, 130, 128),       # G x tile rows padded, ragged S
    (1, 1, 1, 64, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(card, b, hkv, g, s, dh, causal,
                                       dtype):
    q = randn((b, hkv, g, s, dh), card, dtype, 0)
    k = randn((b, hkv, s, dh), card, dtype, 1)
    v = randn((b, hkv, s, dh), card, dtype, 2)
    got = flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_bf16_prefill_shape(card):
    """The tensor-core kernel at the full prefill's attention shape."""
    q = randn((2, 8, 3, 4096, 128), card, torch.bfloat16, 20)
    k = randn((2, 8, 4096, 128), card, torch.bfloat16, 21)
    v = randn((2, 8, 4096, 128), card, torch.bfloat16, 22)
    got = flash_attention(q, k, v, True)
    want = ref.flash_attention_ref(q, k, v, True)
    tol = ATT_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_routes_through_ops(card, dtype):
    """Each route (fp32 on the CUDA cores, bf16 on the tensor cores)
    through ``ops.flash_attention`` against the plain version."""
    q = randn((1, 4, 5, 256, 64), card, dtype, 23)
    k = randn((1, 4, 256, 64), card, dtype, 24)
    v = randn((1, 4, 256, 64), card, dtype, 25)
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, True)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def golden_case(card, b, hkv, g, dh, s, bs, kb, dtype, q_dtype=None):
    q = randn((b, hkv, g, dh), card, q_dtype or dtype, 3)
    k = randn((b, hkv, s, dh), card, dtype, 4)
    v = randn((b, hkv, s, dh), card, dtype, 5)
    idx, _ = select_golden_blocks(q.float(), k, kb, bs)
    idx[0, 0, -1] = s // bs + 3                    # clamped into range
    gen = torch.Generator().manual_seed(6)
    valid = (torch.rand(idx.shape, generator=gen) < 0.8).int().to(card)
    valid[0, 0, 0] = 1
    valid[-1, -1] = 0                              # no valid block
    return q, k, v, idx, valid


@pytest.mark.parametrize("b,hkv,g,dh,s,bs,kb", [
    (2, 8, 3, 128, 4096, 64, 8),       # the entry point's ops section
    (4, 8, 3, 128, 8192, 128, 16),
    (2, 2, 1, 32, 256, 32, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golden_attention_matches_plain(card, b, hkv, g, dh, s, bs, kb,
                                        dtype):
    q, k, v, idx, valid = golden_case(card, b, hkv, g, dh, s, bs, kb, dtype)
    got = golden_attention_decode(q, k, v, idx, valid, bs)
    want = ref.golden_attention_decode_ref(q, k, v, idx, valid, bs)
    assert got.dtype == dtype and not got[-1, -1].any()
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golden_attention_split_chunks(card, dtype):
    """decode_32k-like split (B * Hkv * kb large enough for several
    blocks a CTA, kb not a multiple of the chunk): a (b, h) whose valid
    blocks all sit in one chunk, one with none (gives 0), clamped
    indices on both sides."""
    b, hkv, g, dh, s, bs, kb = 4, 8, 3, 128, 32768, 128, 64
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    c, nch = split_chunks(b * hkv, kb, sms)
    assert c > 1 and kb % c
    q, k, v, idx, valid = golden_case(card, b, hkv, g, dh, s, bs, kb, dtype)
    idx[0, 1, 0] = -2                              # clamped to block 0
    valid[0, 1, 0] = 1
    valid[1, 2] = 0
    valid[1, 2, c:2 * c] = 1                       # only chunk 1 counts
    got = golden_attention_decode(q, k, v, idx, valid, bs)
    want = ref.golden_attention_decode_ref(q, k, v, idx, valid, bs)
    assert not got[-1, -1].any()
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_kernels_are_deterministic(card):
    """Two calls of each kernel give bit-equal outputs (the split's
    merge runs in a fixed order)."""
    q = randn((2, 8, 3, 1024, 128), card, torch.bfloat16, 26)
    k = randn((2, 8, 1024, 128), card, torch.bfloat16, 27)
    assert torch.equal(flash_attention(q, k, k, True),
                       flash_attention(q, k, k, True))
    args = golden_case(card, 16, 8, 3, 128, 8192, 128, 64, torch.bfloat16)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert split_chunks(16 * 8, 64, sms)[1] > 1
    assert torch.equal(golden_attention_decode(*args, 128),
                       golden_attention_decode(*args, 128))


def test_golden_attention_fp32_query_over_bf16_cache(card):
    q, k, v, idx, valid = golden_case(card, 2, 8, 3, 128, 4096, 64, 8,
                                      torch.bfloat16, torch.float32)
    got = ops.golden_attention_decode(q, k, v, idx, valid, block_size=64)
    want = ref.golden_attention_decode_ref(q, k, v, idx, valid, 64)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_attention_kernels_count_launches(card):
    q = randn((1, 2, 2, 64, 32), card, torch.float32, 7)
    k = randn((1, 2, 64, 32), card, torch.float32, 8)
    f0, g0 = flash_attention.launches, golden_attention_decode.launches
    ops.flash_attention(q, k, k)
    idx, valid = ops.select_golden_blocks(q[:, :, :, 0], k, 2, 16)
    ops.golden_attention_decode(q[:, :, :, 0].contiguous(), k, k, idx, valid,
                                block_size=16)
    assert (flash_attention.launches, golden_attention_decode.launches) == \
        (f0 + 1, g0 + 1)


def test_attention_kernel_faults_raise(card, tmp_path, monkeypatch):
    q = randn((1, 1, 1, 64, 48), card, torch.float32, 9)
    k = randn((1, 1, 64, 48), card, torch.float32, 10)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q.cpu(), k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q[..., :32].contiguous(),
                        k[..., :32].contiguous().double(),
                        k[..., :32].contiguous())
    # a launch the C entry point refuses (dh 48 has no instance) raises
    fn = _build.load("flash_attention", "flash_attention_launch",
                     flash_mod._ARGS)
    out = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(k), _build.ptr(out),
             ctypes.c_void_p(None), 1, 1, 64, 48, 64, 4, 1, 1.0,
             _build.stream(card))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check("flash_attention", err)
    # a build that fails raises, and no library is loaded
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        _build.load("golden_attention", "golden_attention_launch", [])


# --- LLM training: the attention backward, the train step, decode graph ----

BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # x the grad's max abs


@pytest.mark.parametrize("b,hkv,g,s,dh", [
    (2, 8, 3, 512, 128),       # the llama train step's heads
    (1, 4, 1, 256, 64),        # the reduced config's
    (2, 1, 2, 100, 32),        # S not a multiple of any tile
    (1, 2, 4, 1000, 128),      # S past the 128-key tile; G = 4 pads a
                               # head group of the bf16 dQ launch
    (1, 2, 1, 1000, 64),       # dh = 64 with G = 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_plain(card, b, hkv, g, s, dh, dtype,
                                           causal):
    """The backward kernel against the materialized plain backward from
    the same q, k, v, dO and the forward's own output and lse (within
    1e-5 of the plain lse); two calls bit-equal; one count a call."""
    q = randn((b, hkv, g, s, dh), card, dtype, 31)
    k, v = (randn((b, hkv, s, dh), card, dtype, sd) for sd in (32, 33))
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    assert torch.equal(o, flash_attention(q, k, v, causal))
    _, lse_plain = ref.flash_attention_ref(q, k, v, causal, True)
    assert float((lse - lse_plain).abs().max()) <= 1e-5
    do = randn(o.shape, card, dtype, 34)
    before = flash_mod.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal)
    assert flash_mod.flash_attention_bwd.launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    for a, c, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, c)
        err = float((a.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_attention_bwd_runs_its_route_only(card, dtype):
    """A bf16 call runs only csrc/flash_attention_bwd_sm90.cu's three
    kernels (D, dK/dV, dQ), an fp32 call only the CUDA-core instance's
    (csrc/flash_attention_bwd.cu), by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = randn((1, 2, 3, 200, 64), card, dtype, 41)
    k, v = (randn((1, 2, 200, 64), card, dtype, sd) for sd in (42, 43))
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    do = randn(o.shape, card, dtype, 44)
    flash_mod.flash_attention_bwd(q, k, v, o, do, lse, True)
    sm90 = "_sm90" if dtype == torch.bfloat16 else ""
    want = {f"{kind}{sm90}_kernel" for kind in ("bwd_dot", "bwd_dkdv",
                                               "bwd_dq")}
    seen = set()
    # late in a long process a session loses its first device events (a
    # session around one call kept only its last two kernels), so each
    # session profiles five calls: every event kept must be the route's,
    # and the sessions must show all three kernels
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(5):
                flash_mod.flash_attention_bwd(q, k, v, o, do, lse, True)
            torch.cuda.synchronize()
            time.sleep(0.05)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"bwd_\w+?_kernel", e.name)
                assert m and m.group(0) in want, e.name
                seen.add(m.group(0))
        if seen == want:
            break
    assert seen == want, seen


def test_flash_attention_bwd_refuses(card):
    q = randn((1, 1, 1, 64, 64), card, torch.float32, 9)
    k = randn((1, 1, 64, 64), card, torch.float32, 10)
    lse = torch.zeros((1, 1, 1, 64), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_mod.flash_attention_bwd(q.cpu(), k.cpu(), k.cpu(), q.cpu(),
                                      q.cpu(), lse.cpu())
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention_bwd(q, k, k, q, q, lse.double())
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention_bwd(q, k, k, q[..., :32], q, lse)


def test_reduced_train_step_card_matches_cpu(card):
    """Three train steps of the reduced config on the card against the
    CPU from the same weights and batches (losses 1e-4); each step runs
    kernel 9 and the backward once per layer."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps as step_lib
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.module import init_params
    from repro_torch.training import optimizer as opt
    cfg = get_config("llama3.2-3b").reduced()
    np_params = tree_map(lambda t: t.numpy(), init_params(
        T.model_specs(cfg), torch.Generator().manual_seed(0)))
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 128, 4))
    batches = [pipe.batch(i) for i in range(3)]
    losses = {}
    for dev in (card, torch.device("cpu")):
        p = params_from_numpy(cfg, np_params, device=dev)
        st = opt.init_state(p)
        step = step_lib.make_train_step(cfg, None, opt.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=3))
        f0, b0 = flash_attention.launches, flash_mod.flash_attention_bwd.launches
        losses[dev.type] = []
        for bt in batches:
            p, st, m = step(p, st, {k: t.to(dev) for k, t in bt.items()})
            losses[dev.type].append(float(m["loss"]))
        if dev.type == "cuda":
            assert flash_attention.launches - f0 == 3 * cfg.num_layers
            assert flash_mod.flash_attention_bwd.launches - b0 == \
                3 * cfg.num_layers
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("kind", ["full", "golden"])
def test_decode_graph_replay_matches_eager(card, kind):
    """``make_decode_step`` on the card: one CUDA graph, its replays at
    three positions bit-equal to the eager ``decode_step`` (logits and
    cache), tokens and positions as ints and as device tensors."""
    from repro_torch.launch import steps as step_lib
    cfg = dataclasses.replace(gd.example_config(reduced=True),
                              attn_kind_decode=kind)
    params = tree_map(lambda t: t.to(card), gd.draw_params(cfg, 0, "cpu"))
    toks = gd.draw_tokens(cfg, 2, 256, 0).to(card)
    _, cache = T.prefill(cfg, params, toks)
    eager_c = tree_map(torch.clone, cache)
    step = step_lib.make_decode_step(cfg)
    tok = toks[:, -1]
    step(params, cache, tok, 200)
    T.decode_step(cfg, params, eager_c, tok, 200)
    for i, pos in enumerate((201, 202, 203)):
        at = torch.tensor(pos, device=card) if i % 2 else pos
        want, _ = T.decode_step(cfg, params, eager_c, tok, pos)
        got, _ = step(params, cache, tok, at)
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert len(step.graphs) == 1
    for (p, a), (_, b) in zip(tree_leaves(eager_c), tree_leaves(cache)):
        assert torch.equal(a, b), p


def test_reduced_model_card_matches_cpu(card):
    """The golden-decode entry point at the example's reduced width (a
    512-token cache) on the card against the CPU, from the same weights
    (drawn on the CPU and moved): logits, the sweep and the ops
    section's block choices; kernel 9 runs once per layer."""
    cfg = gd.example_config(reduced=True)
    params = gd.draw_params(cfg, 0, "cpu")
    toks = gd.draw_tokens(cfg, 2, 512, 0)
    want = gd.run(cfg, params, toks)
    before = flash_attention.launches
    got = gd.run(cfg, tree_map(lambda t: t.to(card), params), toks.to(card))
    assert flash_attention.launches == before + cfg.num_layers
    for key in ("prefill_logits", "full_logits"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4,
                                   atol=1e-4)
    for kb, lg in want["golden_logits"].items():
        torch.testing.assert_close(got["golden_logits"][kb].cpu(), lg,
                                   rtol=1e-4, atol=1e-4)
    assert torch.equal(got["block_idx"].cpu(), want["block_idx"])
    assert [r["top1"] for r in got["rows"]] == [r["top1"] for r in
                                               want["rows"]]
    assert got["ops_err"] <= 2e-5


def test_model_steps_do_not_synchronize(card):
    """Prefill and decode never wait on the device from the host: the
    position is a Python int and nothing is read back."""
    cfg = gd.example_config(reduced=True)
    params = gd.draw_params(cfg, 0, card)
    toks = gd.draw_tokens(cfg, 2, 256, 0).to(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache = T.prefill(cfg, params, toks)
        for kind in ("full", "golden"):
            T.decode_step(dataclasses.replace(cfg, attn_kind_decode=kind),
                          params, cache, toks[:, -1], 255)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# -- the frontend and MoE archs: new head groups, train steps, decode graph --
# (Hkv, G, dh) of qwen2.5-32b, qwen2-7b, starcoder2-3b, internvl2-1b,
# musicgen-medium, phi3.5-moe-42b-a6.6b and dbrx-132b at full width

ARCH_HEADS = [(8, 5, 128), (4, 7, 128), (2, 12, 128), (2, 7, 64),
              (24, 1, 64), (8, 4, 128), (8, 6, 128)]


@pytest.mark.parametrize("hkv,g,dh", ARCH_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_at_new_head_groups(card, hkv, g, dh, dtype):
    """Kernel 9 and the backward at an arch's (Hkv, G, dh), causal, S
    past the tiles: within ATT_TOL / BWD_TOL of the plain versions, two
    calls bit-equal."""
    s = 300
    q = randn((1, hkv, g, s, dh), card, dtype, 51)
    k, v = (randn((1, hkv, s, dh), card, dtype, sd) for sd in (52, 53))
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    want_o, want_lse = ref.flash_attention_ref(q, k, v, True, True)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    do = randn(o.shape, card, dtype, 54)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, True)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        err = float((a.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())


@pytest.mark.parametrize("hkv,g,dh", ARCH_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golden_attention_at_new_head_groups(card, hkv, g, dh, dtype):
    """Kernel 8 at an arch's (Hkv, G, dh) (G = 12: two z-blocks of its
    G = 8 instance) against its plain version."""
    q, k, v, idx, valid = golden_case(card, 2, hkv, g, dh, 1024, 128, 4,
                                      dtype)
    got = golden_attention_decode(q, k, v, idx, valid, 128)
    want = ref.golden_attention_decode_ref(q, k, v, idx, valid, 128)
    assert not got[-1, -1].any()
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _spy_routes(monkeypatch) -> list:
    """Wrap ``moe.route``: each call appends its expert choices [G, T, k]
    and which of them were kept (read from the dispatch tensor it
    returns), on the CPU."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def spy(p, xg, e, k, cap):
        out = route(p, xg, e, k, cap)
        idx, dispatch = out[1], out[2]
        seen.append((idx.detach().cpu(), torch.gather(
            dispatch.detach().sum(-1) != 0, -1, idx).cpu()))
        return out
    monkeypatch.setattr(moe, "route", spy)
    return seen


def _train_card_vs_cpu(monkeypatch, card, arch, steps=2, num_layers=2):
    """``steps`` train steps of an arch's reduced config (``num_layers``
    deep) through ``launch.train``'s setup and batches on the card and on
    the CPU from the same weights; returns both runs' losses, MoE
    routings and the card's launches."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import optimizer as opt
    cfg = get_config(arch).reduced(num_layers=num_layers)
    p0, _, batches, _ = train_lib.setup(cfg, steps, 2, 128,
                                        torch.device("cpu"))
    np_params = tree_map(lambda t: t.numpy(), p0)
    runs = {}
    for dev in (card, torch.device("cpu")):
        p = params_from_numpy(cfg, np_params, device=dev)
        st = opt.init_state(p)
        step = step_lib.make_train_step(cfg, None, opt.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=steps))
        f0, b0 = flash_attention.launches, flash_mod.flash_attention_bwd.launches
        losses = []
        rec = _spy_routes(monkeypatch)
        for i in range(steps):
            bt = {k: t.to(dev) for k, t in train_lib.step_batch(
                cfg, batches, i).items()}
            p, st, m = step(p, st, bt)
            losses.append((float(m["loss"]), float(m["aux"])))
        monkeypatch.undo()
        runs[dev.type] = (losses, rec,
                          (flash_attention.launches - f0,
                           flash_mod.flash_attention_bwd.launches - b0))
    return cfg, runs


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "internvl2-1b"])
def test_reduced_arch_train_steps_card_match_cpu(monkeypatch, card, arch):
    """Two train steps of a reduced MoE arch and a reduced frontend arch
    (its embeddings from ``step_batch``) on the card against the CPU:
    losses and aux 1e-4, every MoE routing equal, kernel 9 and the
    backward once a layer a step."""
    cfg, runs = _train_card_vs_cpu(monkeypatch, card, arch)
    (lc, rc, counts), (lh, rh, _) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lh, atol=1e-4, rtol=0)
    assert counts == (2 * cfg.num_layers, 2 * cfg.num_layers)
    assert len(rc) == len(rh) == (2 * cfg.num_layers if cfg.num_experts
                                  else 0)
    for (ec, kc), (eh, kh) in zip(rc, rh):
        assert torch.equal(ec, eh) and torch.equal(kc, kh)


def test_moe_decode_graph_replay_matches_eager(card):
    """``make_decode_step`` on a reduced MoE arch: the routing of the B
    new tokens lives inside the one CUDA graph; replays bit-equal to the
    eager step."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.models.module import init_params
    cfg = get_config("dbrx-132b").reduced()
    params = init_params(T.model_specs(cfg),
                         torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 128), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    _, cache = T.prefill(cfg, params, toks)
    eager_c = tree_map(torch.clone, cache)
    step = step_lib.make_decode_step(cfg)
    tok = toks[:, -1]
    step(params, cache, tok, 120)
    T.decode_step(cfg, params, eager_c, tok, 120)
    for pos in (121, 122, 123):
        want, _ = T.decode_step(cfg, params, eager_c, tok, pos)
        got, _ = step(params, cache, tok, pos)
        assert torch.equal(got, want)
        tok = want.argmax(-1)
    assert len(step.graphs) == 1
    for (p, a), (_, b) in zip(tree_leaves(eager_c), tree_leaves(cache)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("arch,layers", [("mamba2-2.7b", 2),
                                         ("jamba-v0.1-52b", 8)])
def test_reduced_mamba_train_steps_card_match_cpu(monkeypatch, card, arch,
                                                  layers):
    """Two train steps of a reduced Mamba-2 arch (jamba over its whole
    pattern: attention at layer 3, MoE on 1, 3, 5, 7) on the card
    against the CPU: losses and aux 1e-4, every MoE routing equal,
    kernel 9 and the backward once an attention layer a step."""
    cfg, runs = _train_card_vs_cpu(monkeypatch, card, arch,
                                   num_layers=layers)
    (lc, rc, counts), (lh, rh, _) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lh, atol=1e-4, rtol=0)
    n_attn = cfg.pattern.count("A") * cfg.repeats
    assert counts == (2 * n_attn, 2 * n_attn)
    assert len(rc) == len(rh)
    for (ec, kc), (eh, kh) in zip(rc, rh):
        assert torch.equal(ec, eh) and torch.equal(kc, kh)


@pytest.mark.parametrize("arch,layers", [("mamba2-2.7b", 2),
                                         ("jamba-v0.1-52b", 8)])
def test_mamba_decode_graph_replay_matches_eager(card, arch, layers):
    """``make_decode_step`` on a reduced Mamba-2 arch: the first call
    advances the conv and SSM states once (its capture runs nothing),
    then every replay equals an eager step from a copy of the same cache
    bit for bit, states included."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.models.module import init_params
    cfg = get_config(arch).reduced(num_layers=layers)
    params = init_params(T.model_specs(cfg),
                         torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 128), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    _, cache = T.prefill(cfg, params, toks)
    eager_c = tree_map(torch.clone, cache)
    step = step_lib.make_decode_step(cfg)
    tok = toks[:, -1]
    step(params, cache, tok, 120)
    T.decode_step(cfg, params, eager_c, tok, 120)
    for (p, a), (_, b) in zip(tree_leaves(eager_c), tree_leaves(cache)):
        assert torch.equal(a, b), p
    for pos in range(121, 127):
        want, _ = T.decode_step(cfg, params, eager_c, tok, pos)
        got, _ = step(params, cache, tok, pos)
        assert torch.equal(got, want), pos
        tok = want.argmax(-1)
    assert len(step.graphs) == 1
    for (p, a), (_, b) in zip(tree_leaves(eager_c), tree_leaves(cache)):
        assert torch.equal(a, b), p


# -- plan mode: masked segments as CUDA graphs ---------------------------------
# Every kernel on the masked path is deterministic, so a replayed graph
# equals the same segment run eagerly bit for bit.

def plan_route(card, route):
    """A GoldDiff on a cifar_like store (N=1024) on the card for one
    masked route, its plan and an x_T of 8 rows."""
    from repro_torch.core import GoldDiffConfig, build_plan
    from repro_torch.index import ProbeSchedule
    store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    kw = {"fused": dict(fused=True),
          "staged": dict(fused=False, screen="materialized"),
          "streamed": dict(fused=False, screen="streamed"),
          "indexed": dict(cfg=GoldDiffConfig(1 / 64, 1 / 32, 1 / 128, 1 / 64),
                          index=build_index(store),
                          probe_schedule=ProbeSchedule(1 / 16, 1 / 4),
                          index_mode="always")}[route]
    gd = GoldDiff(OptimalDenoiser(store, sched, device=card), **kw)
    x = float(sched.b[1000]) * torch.randn(
        8, store.dim, generator=torch.Generator().manual_seed(3))
    return gd, sched, build_plan(gd.engine, 10), x.to(card)


def counts():
    return [k.launches for k in ops.COUNTED]


@pytest.mark.parametrize("route", ["fused", "staged", "streamed", "indexed"])
def test_plan_graph_bit_equal_eager(card, route):
    """Each bucket's segment replayed from its graph equals the segment
    run eagerly; N replays add N times the eager launches."""
    from repro_torch.core import plan_segment
    gd, sched, plan, x = plan_route(card, route)
    assert all(b.caps.indexed == (route == "indexed") for b in plan.buckets)
    for bucket in plan.buckets:
        seg = plan_segment(gd.call_masked, sched, plan, bucket)
        c0 = counts()
        eager = seg(x)
        once = [b - a for a, b in zip(c0, counts())]
        graph = gd.engine.jitter(seg, tuple(x.shape), label=route)
        c1 = counts()
        for _ in range(3):
            got = graph(x)
        assert [b - a for a, b in zip(c1, counts())] == [3 * n for n in once]
        assert torch.equal(got, eager), (route, bucket)
        assert got.data_ptr() != graph(x).data_ptr()     # a clone each call
        x = eager
    assert gd.engine._captures == plan.num_buckets


def test_plan_graph_replays_new_input(card):
    from repro_torch.core import plan_segment
    gd, sched, plan, x = plan_route(card, "fused")
    seg = plan_segment(gd.call_masked, sched, plan, plan.buckets[0])
    graph = gd.engine.jitter(seg, tuple(x.shape))
    first = graph(x)
    y = x.flip(0) * 0.5
    second = graph(y)
    assert torch.equal(second, seg(y)) and not torch.equal(second, first)
    assert torch.equal(graph(x), first)


def test_mixed_segment_captured(card):
    from repro_torch.core import plan_segment, plan_segment_mixed
    gd, sched, plan, x = plan_route(card, "fused")
    bucket = plan.buckets[-1]
    pos = torch.tensor([bucket.start, 0, bucket.start, 1, bucket.start, 2,
                        bucket.start, 3], dtype=torch.int32, device=card)
    mixed = plan_segment_mixed(gd.call_masked, sched, plan, bucket)
    graph = gd.engine.jitter(mixed, tuple(x.shape), ((8,), torch.int32))
    got = graph(x, pos)
    assert torch.equal(got, mixed(x, pos))
    active = pos == bucket.start
    plain = plan_segment(gd.call_masked, sched, plan, bucket)(x)
    assert torch.equal(got[active], plain[active])
    assert torch.equal(got[~active], x[~active])


@pytest.mark.parametrize("mode", ["plan", "scan"])
def test_serve_captures_nothing_after_warmup(card, mode):
    """warmup() captures every (batch bucket x plan bucket) graph; a mixed
    request stream then captures none, and plan serving on the card
    agrees with the CPU."""
    from repro_torch.launch.serve import Request, ServeEngine
    store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    eng = ServeEngine(store, num_steps=10, max_batch=4, mode=mode,
                      device=card)
    stats = eng.warmup()
    buckets = eng.plan.num_buckets if mode == "plan" else 1
    assert stats["programs_compiled"] == 3 * buckets
    assert eng.engine._captures == 3 * buckets
    n0 = eng.engine._builds
    reqs = [Request(0, 1, seed=1), Request(1, 3, seed=2),
            Request(2, 2, seed=3), Request(3, 4, seed=4)]
    got = eng.serve(reqs)
    assert eng.engine._builds == n0 and eng.engine._captures == 3 * buckets
    want = ServeEngine(store, num_steps=10, max_batch=4, mode=mode,
                       device="cpu").serve(reqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.images, w.images, rtol=1e-3, atol=1e-3)


def test_plan_capture_failure_raises(card):
    """A segment that reads a value back to the host cannot be captured:
    the capture raises, naming the segment, and the card works on."""
    gd, _, _, x = plan_route(card, "fused")

    def reads_back(y):
        return y * float(y.abs().max())

    with pytest.raises(RuntimeError, match="reads-back segment"):
        gd.engine.jitter(reads_back, tuple(x.shape),
                         label="reads-back segment")
    assert gd.engine._builds == 0
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    assert float(torch.ones(4, device=card).sum()) == 4.0


# -- the patch bases (Kamb, PCA) and GoldDiff over them ----------------------

def test_patch_convolutions_fp32_with_tf32_on(card):
    """The PCA projection and the Kamb box sum compute in fp32 even with
    cuDNN's TF32 flag on (the denoisers turn it off around their
    convolutions and restore it): within 1e-5 relative of a float64
    convolution on the CPU."""
    import torch.nn.functional as F
    from repro_torch.core import PCADenoiser
    from repro_torch.core.denoisers import _box_patch_dist
    store = make_dataset("cifar_like", n=128, seed=0, device=card)
    den = PCADenoiser(store, make_schedule("ddpm_linear", 1000), device=card)
    imgs = store.X[:16].reshape(16, 32, 32, 3)
    torch.backends.cudnn.allow_tf32 = True
    try:
        feats = {p: den.features(imgs, p) for p in (3, 7, 11)}
        box = _box_patch_dist(imgs[:4], imgs[4:8], 9)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False

    def rel(got, want):
        return float((got.double().cpu() - want).abs().max()
                     / want.abs().max())

    x64 = imgs.double().cpu().permute(0, 3, 1, 2)
    for p, f in feats.items():
        w64 = den._basis(p).double().cpu().permute(3, 2, 0, 1)
        want = F.conv2d(x64, w64, padding=p // 2).permute(0, 2, 3, 1)
        assert rel(f, want) <= 1e-5, p
    d64 = ((imgs[:4, None] - imgs[None, 4:8]) ** 2).sum(-1).double().cpu()
    want = F.conv2d(F.pad(d64.reshape(-1, 1, 32, 32), (4,) * 4),
                    torch.ones(1, 1, 9, 9, dtype=torch.float64))
    assert rel(box, want.reshape(d64.shape)) <= 1e-5


@pytest.mark.parametrize("base", ["kamb", "pca"])
def test_golddiff_patch_base_card_matches_cpu(card, base):
    """GoldDiff over a patch base on the card: kernels 1 and 2 once a
    step (the selection) and no other; supports equal to the CPU's on
    noisy data; a 10-step trajectory within 1e-3 of the CPU's."""
    from repro_torch.core import denoise_trajectory, make_denoiser
    store = make_dataset("cifar_like", n=1024, seed=2, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    gds = {dev: GoldDiff(make_denoiser(base, store, sched, device=dev))
           for dev in (card, "cpu")}
    g = torch.Generator().manual_seed(3)
    x_T = float(sched.b[1000]) * torch.randn(4, store.dim, generator=g)
    for k in ops.COUNTED:
        k.launches = 0
    got, _ = denoise_trajectory(gds[card], sched, x_T)
    assert pdist.launches == 10 and support_sqdist.launches == 10
    assert sum(k.launches for k in ops.COUNTED) == 20
    want, _ = denoise_trajectory(gds["cpu"], sched, x_T)
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    t = 500
    x_t = (float(sched.a[t]) * store.X[:4] + float(sched.b[t])
           * torch.randn(4, store.dim, generator=g))
    s_card = gds[card].select(x_t.to(card), t).cpu()
    s_cpu = gds["cpu"].select(x_t, t)
    assert torch.equal(s_card.sort(-1).values, s_cpu.sort(-1).values)
    np.testing.assert_allclose(gds[card](x_t.to(card), t).cpu().numpy(),
                               gds["cpu"](x_t, t).numpy(), rtol=0,
                               atol=1e-4)


def test_static_pca_serve_builds_nothing_after_warmup(card):
    """ServeEngine(base="pca") serves static mode; warmup() builds the
    feature cache of every patch size the trajectory takes, and serving
    then builds no cache, program or graph."""
    from repro_torch.launch.serve import Request, ServeEngine
    store = make_dataset("cifar_like", n=512, seed=0, device="cpu")
    eng = ServeEngine(store, base="pca", num_steps=4, max_batch=4,
                      device=card)
    assert eng.mode == "static" and eng.plan is None
    base = eng.denoiser.base
    stats = eng.warmup()
    patches = {base.patch_size(t) for t in (1000, 750, 500, 250)}
    assert set(base._features) == patches
    assert stats["feature_cache_bytes"] == base.feature_cache_bytes() \
        == len(patches) * 512 * 32 * 32 * 8 * 4
    n0 = (len(base._features), eng.engine._builds, eng.engine._captures)
    out = eng.serve([Request(0, 3, seed=1), Request(1, 4, seed=2)])
    assert [r.images.shape[0] for r in out] == [3, 4]
    assert all(np.isfinite(r.images).all() for r in out)
    assert (len(base._features), eng.engine._builds,
            eng.engine._captures) == n0


# -- bf16 store rows (storage_dtype): each kernel's bf16-row instance ----------
# Values in [-3, 3] are exact in bf16, so on integer data each instance
# is bit-equal to its plain version on the same bf16 rows; on float data
# the instances keep the fp32 tolerances (the rows widen exactly).  The
# queries, norms and logits stay fp32.  Each call counts in
# ``launches_bf16`` and not in ``launches``.

BF = torch.bfloat16


def bints(shape, dev, seed):
    return ints(shape, dev, seed).to(BF)


def counted_bf16(fn, *args):
    """(result, fp32 launches added, bf16 launches added) of one call."""
    before = ops.launch_counts()
    out = fn(*args)
    delta = [b - a for a, b in zip(before, ops.launch_counts())]
    k = len(ops.COUNTED)
    return out, sum(delta[:k]), sum(delta[k:])


def relerr_d2(got, want):
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("b,n,d", [(16, 5000, 192), (5, 333, 7),
                                   (17, 64, 33), (1, 4099, 64),
                                   (16, 777, 3072), (3, 100, 300)])
def test_pdist_bf16_bit_equal_integer(card, b, n, d):
    q, x = ints((b, d), card, 50), bints((n, d), card, 51)
    qn, xn = norms(q), norms(x.float())
    if d % 8:                       # no 16-byte rows: refused, not padded
        with pytest.raises(ValueError, match="multiple of 8"):
            pdist(q, x, qn, xn)
        return
    xn[3] = float("inf")
    got, fp32, bf = counted_bf16(pdist, q, x, qn, xn)
    assert (fp32, bf) == (0, 1)
    assert torch.equal(got, ref.pdist_ref(q, x, qn, xn))
    assert torch.isinf(got[:, 3]).all()


@pytest.mark.parametrize("b,n,d", [(16, 5000, 192), (3, 700, 3072)])
def test_pdist_bf16_float(card, b, n, d):
    """An fp32 query (not rounded) against bf16 rows: the hi and lo
    query terms, 1e-5 relative."""
    g = torch.Generator().manual_seed(52)
    x = torch.randn(n, d, generator=g).to(card)
    q = torch.randn(b, d, generator=g).to(card)
    xb = x.to(BF)
    xn = norms(x)                        # from the fp32 master, as the engine
    got = pdist(q, xb, norms(q), xn)
    assert relerr_d2(got, ref.pdist_ref(q, xb, norms(q), xn)) <= 1e-5


@pytest.mark.parametrize("kind,b,n,d,m", UNION_CASES)
def test_support_sqdist_bf16(card, kind, b, n, d, m):
    q, x = ints((b, d), card, 53), bints((n, d), card, 54)
    xn = norms(x.float())
    idx = union_idx(kind, b, n, m, card, 55)
    got, fp32, bf = counted_bf16(support_sqdist, q, x, xn, idx)
    assert (fp32, bf) == (0, 1)
    assert torch.equal(got, ref.support_sqdist_ref(q, x, xn, idx))
    g = torch.Generator().manual_seed(56)
    xf = torch.randn(n, d, generator=g).to(card)
    qf = torch.randn(b, d, generator=g).to(card)
    got = support_sqdist(qf, xf.to(BF), norms(xf), idx)
    want = ref.support_sqdist_ref(qf, xf.to(BF), norms(xf), idx)
    assert relerr_d2(got, want) <= 1e-5


@pytest.mark.parametrize("kind,b,n,d,k", UNION_CASES)
def test_golden_support_aggregate_bf16(card, kind, b, n, d, k):
    g = torch.Generator().manual_seed(57)
    x = torch.randn(n, d, generator=g).to(card).to(BF)
    idx = union_idx(kind, b, n, k, card, 58)
    lg = (3 * torch.randn(b, k, generator=g)).to(card)
    lg[0] = ref.NEG_INF
    got, fp32, bf = counted_bf16(golden_support_aggregate, x, idx, lg)
    assert (fp32, bf) == (0, 1)
    torch.testing.assert_close(
        got, ref.golden_support_aggregate_ref(x, idx, lg), rtol=1e-5,
        atol=1e-5)
    assert torch.equal(got, golden_support_aggregate(x, idx, lg))


@pytest.mark.parametrize("b,n,d", [(16, 5000, 3072), (3, 77, 10),
                                   (1, 40, 12288), (17, 2001, 784),
                                   (16, 999, 3000), (5, 300, 3001)])
@pytest.mark.parametrize("sigma2", [0.5, 20.0, 0.0])
def test_golden_aggregate_bf16(card, b, n, d, sigma2):
    g = torch.Generator().manual_seed(59)
    x = (torch.randn(n, d, generator=g) / d ** 0.5).to(card)
    q = x[:b] + 0.1 * torch.randn(b, d, generator=g).to(card)
    xb, xn = x.to(BF), norms(x)
    if d % 8:                       # no 16-byte rows: refused, not padded
        with pytest.raises(ValueError, match="multiple of 8"):
            golden_aggregate(q, xb, sigma2, xn)
        return
    got, fp32, bf = counted_bf16(golden_aggregate, q, xb, sigma2, xn)
    assert (fp32, bf) == (0, 1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.golden_aggregate_ref(q, xb, sigma2,
                                                             xn),
                               rtol=1e-4, atol=1e-5)
    if sigma2 == 0.5:
        out, ranks = gagg_mod.cluster_states(q, xb, 0.5, xn)
        assert torch.equal(ranks, ranks[:, :1].expand_as(ranks))
        assert torch.equal(out, got)


def test_golden_aggregate_bf16_integer(card):
    """Integer rows: the logits' distances are exact, so the bf16 instance
    equals the fp32 instance on the widened rows bit for bit."""
    q, x = ints((16, 3072), card, 60), bints((700, 3072), card, 61)
    xn = norms(x.float())
    assert torch.equal(golden_aggregate(q, x, 20.0, xn),
                       golden_aggregate(q, x.float(), 20.0, xn))


@pytest.mark.parametrize("b,n,d,m", [(16, 5000, 192, 700), (3, 6000, 8, 2500),
                                     (5, 300, 7, 400), (17, 4000, 64, 2049)])
def test_screen_topm_bf16_bit_equal_integer(card, b, n, d, m):
    q, x = ints((b, d), card, 62), bints((n, d), card, 63)
    qn, xn = norms(q), norms(x.float())
    xn[4] = float("inf")
    (gi, gv), fp32, bf = counted_bf16(screen_topm, q, x, m, qn, xn)
    assert (fp32, bf) == (0, 1)
    wi, wv = screen_topm_scan(q, x, m, qn, xn)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("b,n,dp,d,m", [(16, 3000, 192, 3072, 700),
                                        (3, 6000, 8, 16, 2500),
                                        (5, 200, 7, 10, 300)])
def test_fused_candidates_bf16_bit_equal_integer(card, b, n, dp, d, m):
    qp, q = ints((b, dp), card, 64), ints((b, d), card, 65)
    proxy, x = bints((n, dp), card, 66), bints((n, d), card, 67)
    pn, xn = norms(proxy.float()), norms(x.float())
    pn[3] = float("inf")
    (gi, gv), fp32, bf = counted_bf16(fused_candidates, qp, q, proxy, x, m,
                                      pn, xn)
    assert (fp32, bf) == (0, 1)
    wi, wv = fused_candidates_scan(qp, q, proxy, x, m, pn, xn)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


def test_fused_candidates_refuses_mixed_rows(card):
    q, x = ints((2, 8), card, 68), ints((9, 8), card, 69)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        fused_candidates(q, q, x.to(BF), x, 4, norms(x), norms(x))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        pdist(q, x.half(), norms(q), norms(x))


@pytest.mark.parametrize("c", [5, 230])
def test_ivf_probe_bf16_integer(card, c):
    """Integer pooled queries are exact in bf16: the rounding launch is
    bit-equal to the plain version in every field."""
    ix = probe_index(c, 12, card, seed=70 + c)
    q = ints((16, 3072), card, 71)
    args = (ix["centroids"], ix["centroid_norms"], ix["offsets"], ix["perm"],
            ix["n"], min(8, c), ix["L"])
    got, fp32, bf = counted_bf16(lambda: ops.ivf_probe(
        q, IMAGE, 4, *args, round_bf16=True))
    assert (fp32, bf) == (0, 1)
    qp = ref.downsample_proxy(q.reshape(16, *IMAGE), 4).to(BF).float()
    assert_probe_equal(got, ref.ivf_probe_ref(qp, *args))


def test_ivf_probe_bf16_float(card):
    """Float queries: the launch rounds the pooled query to bf16 as the
    CPU path does; the probe lists equal the plain version's up to
    near-ties of the rounded distances."""
    g = torch.Generator().manual_seed(72)
    ix = probe_index(230, 12, card, seed=73)
    ix["centroids"] = torch.randn(230, 192, generator=g).to(card)
    ix["centroid_norms"] = norms(ix["centroids"])
    q = torch.randn(16, 3072, generator=g).to(card)
    args = (ix["centroids"], ix["centroid_norms"], ix["offsets"], ix["perm"],
            ix["n"], 40, ix["L"])
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    got = ops.ivf_probe(q, IMAGE, 4, *args, round_bf16=True)
    want = ops.ivf_probe(q.cpu(), IMAGE, 4, *cpu, round_bf16=True)
    qp = ref.downsample_proxy(q.cpu().reshape(16, *IMAGE), 4).to(BF).float()
    d2 = ref.centroid_scan_ref(qp, cpu[0], cpu[1])
    diff = got.probe.cpu() != want.probe
    a = torch.gather(d2, 1, got.probe.cpu())[diff]
    w = torch.gather(d2, 1, want.probe)[diff]
    assert ((a - w).abs() <= 1e-5 * w.abs().clamp_min(1.0)).all()


@pytest.mark.parametrize("route", ["fused", "staged", "streamed", "indexed",
                                   "full_scan", "plan"])
def test_bf16_routes_card_match_cpu(card, route):
    """Ten bf16-storage steps on the card against the same route on the
    CPU (plain versions on the same bf16 rows); the card launches bf16
    instances only."""
    from repro_torch.core import (FullScan, GoldDiffConfig, build_plan,
                                  sample_plan)
    from repro_torch.index import ProbeSchedule
    cpu_store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    kw = {"fused": dict(fused=True), "plan": {}, "full_scan": {},
          "staged": dict(fused=False, screen="materialized"),
          "streamed": dict(fused=False, screen="streamed"),
          "indexed": dict(cfg=GoldDiffConfig(1 / 64, 1 / 32, 1 / 128, 1 / 64),
                          index=build_index(cpu_store),
                          probe_schedule=ProbeSchedule(1 / 16, 1 / 4),
                          index_mode="always")}[route]
    x_T = float(sched.b[1000]) * torch.randn(
        8, cpu_store.dim, generator=torch.Generator().manual_seed(4))
    outs = []
    for dev in ("cpu", card):
        den = OptimalDenoiser(cpu_store, sched, device=dev)
        gd = GoldDiff(den, storage_dtype=BF, **kw)
        assert gd.engine.X.dtype == BF and gd.engine.x_norms.dtype == \
            torch.float32

        def run():
            x0 = x_T.to(dev)
            if route == "full_scan":
                return sample(FullScan(gd.engine), sched, tuple(x_T.shape),
                              x_init=x0)
            if route == "plan":
                return sample_plan(gd.call_masked, sched, tuple(x_T.shape),
                                   build_plan(gd.engine, 10), x_init=x0)
            return sample(gd, sched, tuple(x_T.shape), x_init=x0)
        out, fp32, bf = counted_bf16(run)
        if dev != "cpu":
            assert fp32 == 0 and bf >= 10, (fp32, bf)
        outs.append(out.cpu())
    assert np.isfinite(outs[1].numpy()).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)


# -- store epochs on operand slots and the runtime's hot swap ------------------

def _lifecycle_engine(card, tmp_path, **kw):
    """A padded gmm lifecycle and a plan-mode ServeEngine on its view."""
    from repro_torch.index import IngestConfig, StoreLifecycle
    from repro_torch.launch.serve import ServeEngine
    store = make_dataset("gmm", n=2048, dim=32, seed=3, device="cpu")
    store = dataclasses.replace(store, labels=None)
    lc = StoreLifecycle.create(str(tmp_path), store,
                               build_index(store, 16), IngestConfig())
    ds, ix = lc.view(device=card)
    eng = ServeEngine(ds, num_steps=6, max_batch=4, index=ix,
                      index_mode="always", device=card, **kw)
    return lc, eng


def _grow(lc, b, seed, card):
    lc.append(np.random.default_rng(seed).normal(
        size=(b, lc.dim)).astype(np.float32))
    lc.commit()
    return lc.view(device=card)


def test_standby_slot_graph_replays_installed_epoch(card, tmp_path):
    """A segment captured on the standby slot before any epoch lives
    there, replayed after ``install_epoch`` copied a new epoch into the
    slot, is bit-equal to the segment run eagerly on that epoch."""
    from repro_torch.core import plan_segment
    lc, srv = _lifecycle_engine(card, tmp_path)
    eng, plan = srv.engine, srv.plan
    assert eng.reserve_standby() == [0, STANDBY_EPOCH]
    seg = plan_segment(srv.denoiser.call_masked, srv.schedule, plan,
                       plan.buckets[0])
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0)).to(card)
    with eng.at_epoch(STANDBY_EPOCH):
        graph = eng.jitter(seg, (4, 32), label="standby segment")
    eng.retire_epoch(STANDBY_EPOCH)               # the slot goes free
    c0 = eng._captures
    eng.install_epoch(1, *_grow(lc, 64, 1, card))
    assert eng._epochs[1] == 1 and eng._captures == c0
    with eng.at_epoch(1):
        assert torch.equal(graph(x), seg(x))
        eager1 = seg(x)
    assert not torch.equal(eager1, seg(x))       # epoch 0 still serves


def test_runtime_two_swaps_capture_nothing(card, tmp_path):
    """Two hot swaps, one with a wave in flight, capture and build
    nothing after warmup; the in-flight wave equals its no-swap run,
    and a request after each swap equals a fresh engine on that view."""
    from repro_torch.core import sample_plan
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    lc, srv = _lifecycle_engine(card, tmp_path)
    rt = ServeRuntime(srv, RuntimeConfig())
    stats = rt.warmup()
    assert stats["slots"] == [0, 1] and stats["graphs_captured"] > 0
    c0, b0 = srv.engine._captures, srv.engine._builds

    def serve(rid, seed):
        t = rt.submit(Request(rid, 2, seed=seed))
        rt.run_until_idle()
        assert t.status == "done"
        return t.images

    base = serve(0, 7)
    t = rt.submit(Request(1, 2, seed=7))
    assert rt.pump()
    rt.hot_swap(*_grow(lc, 64, 1, card))           # mid-trajectory
    rt.run_until_idle()
    assert np.array_equal(t.images, base)
    for swap in range(2):
        if swap:
            rt.hot_swap(*_grow(lc, 32, 2, card))
        got = serve(2 + swap, 9)
        ds, ix = lc.view(device=card)
        fresh = ServeEngine(ds, num_steps=6, max_batch=4, index=ix,
                            index_mode="always", device=card)
        x = fresh._init_noise([(Request(0, 2, seed=9), 0, 2)], 2)
        want = sample_plan(fresh.denoiser.call_masked, fresh.schedule,
                           (2, 32), fresh.plan, x_init=x)
        np.testing.assert_array_equal(got, want.cpu().numpy())
    assert srv.engine._captures == c0 and srv.engine._builds == b0
    assert rt.health()["compiles_post_warmup"] == 0
    assert rt.health()["epochs_resident"] == 1


def test_third_live_epoch_builds_are_counted(card, tmp_path):
    """With both kept slots live, a third epoch takes a new slot: its
    first dispatch captures its graph and counts a build; retiring it
    frees the slot and drops the graph."""
    lc, srv = _lifecycle_engine(card, tmp_path)
    eng = srv.engine
    srv.warmup()
    eng.reserve_standby()
    eng.retire_epoch(STANDBY_EPOCH)
    eng.install_epoch(1, *_grow(lc, 16, 1, card))
    eng.install_epoch(2, *_grow(lc, 16, 2, card))
    assert eng._epochs == {0: 0, 1: 1, 2: 2}
    n0, b0 = len(eng._programs), eng._builds
    x = torch.zeros(4, 32, device=card)
    from repro_torch.core import sample_plan
    with eng.at_epoch(2):
        sample_plan(srv.denoiser.call_masked, srv.schedule, (4, 32),
                    srv.plan, x_init=x, program_cache=eng.program,
                    jitter=eng.jitter)
    assert eng._builds == b0 + srv.plan.num_buckets
    eng.retire_epoch(2)
    assert sorted(eng._slots) == [0, 1] and len(eng._programs) == n0


def test_capture_is_not_invalidated_by_dying_graphs(card):
    """An engine's graphs die in a reference cycle (its replay closures
    hold the engine), so the garbage collector frees them; a collection
    inside another capture would reset them there, which the capture
    forbids.  With collections forced at every allocation, a capture
    still succeeds and replays."""
    import gc
    from repro_torch.core import GoldDiffEngine
    store = make_dataset("gmm", n=256, dim=8, seed=0, device=card)
    sched = make_schedule("ddpm_linear", 1000)
    old = GoldDiffEngine(store, sched, device=card)
    for i in range(4):
        old.program(("seg", i), lambda: old.jitter(lambda v: v * 2.0,
                                                   (4, 8)))
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = GoldDiffEngine(store, sched, device=card)
        graph = eng.jitter(lambda v: v + 1.0, (4, 8), label="after")
    finally:
        gc.set_threshold(*thresholds)
    x = torch.ones(4, 8, device=card)
    assert torch.equal(graph(x), x + 1.0)


# -- the sharded store: the state entries of kernels 3 and 4, the mesh path ---

def _state_close(got, want):
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) / scale <= 1e-5
    assert float((got[0] / got[2][:, None] - want[0] / want[2][:, None])
                 .abs().max()) <= 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k", [(16, 6250, 3072, 5000), (4, 126, 16, 17),
                                     (17, 1003, 64, 300), (5, 777, 304, 64)])
def test_support_aggregate_state_entry(card, dt, b, n, d, k):
    """Kernel 3's state entry: (acc, m, l) undivided, bit-equal to
    ``ref.partial_aggregate_ref`` on integer rows with 0 / NEG_INF
    logits (an all-NEG_INF query: m = NEG_INF, l = k), 1e-5 of the
    largest value on float data; counted in its own launches."""
    from repro_torch.kernels.golden_support_aggregate import (
        golden_support_aggregate_state)
    g = torch.Generator().manual_seed(b * n + k)
    x = ints((n, d), card, 1).to(dt)
    idx = torch.randint(0, n, (b, k), generator=g).to(card)
    lg = torch.where(torch.rand(b, k, generator=g) < 0.5, 0.0,
                     ref.NEG_INF).to(card)
    lg[0] = ref.NEG_INF
    n0 = (golden_support_aggregate_state.launches,
          golden_support_aggregate_state.launches_bf16)
    got = golden_support_aggregate_state(x, idx, lg)
    want = ref.partial_aggregate_ref(x, idx, lg)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert got[1][0] == ref.NEG_INF and float(got[2][0]) == k
    xf = torch.randn(n, d, generator=g).to(card, dt)
    lgf = (-50.0 * torch.rand(b, k, generator=g)).to(card)
    _state_close(golden_support_aggregate_state(xf, idx, lgf),
                 ref.partial_aggregate_ref(xf, idx, lgf))
    bf = dt == torch.bfloat16
    assert (golden_support_aggregate_state.launches,
            golden_support_aggregate_state.launches_bf16) == (
        n0[0] + 2 * (not bf), n0[1] + 2 * bf)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(16, 6250, 3072), (4, 126, 16),
                                   (17, 25001, 192), (1, 4099, 64)])
def test_full_scan_state_entry(card, dt, b, n, d):
    """Kernel 4's state entry: bit-equal on an integer store at sigma2=0
    with its own rows as queries; a shard of +inf-norm padding alone
    gives the plain version's finite state (m = NEG_INF, l = n, acc 0);
    1e-5 of the largest value on float data."""
    from repro_torch.kernels.golden_aggregate import golden_aggregate_state
    g = torch.Generator().manual_seed(n + d)
    x = ints((n, d), card, 2).to(dt)
    xn = (x.float() ** 2).sum(-1)
    q = x[:b].float().clone()
    got = golden_aggregate_state(q, x, 0.0, xn)
    assert all(torch.equal(u, v) for u, v in zip(
        got, ref.full_partial_ref(q, x, 0.0, xn)))
    pad = torch.full((n,), float("inf"), device=card)
    got = golden_aggregate_state(q, torch.zeros_like(x), 0.7, pad)
    assert (got[1] == ref.NEG_INF).all() and (got[2] == n).all()
    assert (got[0] == 0).all()
    xf = torch.randn(n, d, generator=g).to(card, dt)
    xfn = (xf.float() ** 2).sum(-1)
    qf = torch.randn(b, d, generator=g).to(card)
    _state_close(golden_aggregate_state(qf, xf, 0.25 * d, xfn),
                 ref.full_partial_ref(qf, xf, 0.25 * d, xfn))


@pytest.mark.parametrize("m_over_n", [1, 3])
def test_screen_topm_at_m_equal_and_above_n(card, m_over_n):
    """The sharded screen asks kernel 5 for m = n_loc: no radix pass,
    every row sorted; m > n leaves +inf surplus slots at index 0."""
    n = 6250 if m_over_n == 1 else 257
    m = n if m_over_n == 1 else n + 100
    q, x = ints((16, 48), card, 3), ints((n, 48), card, 4)
    idx, d2 = screen_topm(q, x, m, (q * q).sum(-1), (x * x).sum(-1))
    ri, rd = ref.materialized_topm(ref.pdist_ref(q, x), m)
    assert torch.equal(d2, rd) and torch.equal(idx, ri)


@pytest.mark.parametrize("route", ["staged", "streamed", "fused", "indexed",
                                   "full_scan"])
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_routes_match_one_card(card, route, shards):
    """The engine over a LocalMesh of ``shards`` slices on the card: a
    10-step trajectory within 1e-3 of the one-card engine's, every
    shard-local kernel launched ``shards`` times a step, the unsharded
    entries of kernels 3 and 4 never."""
    from repro_torch.core import FullScan
    from repro_torch.distributed import LocalMesh
    from repro_torch.kernels.golden_aggregate import golden_aggregate_state
    from repro_torch.kernels.golden_support_aggregate import (
        golden_support_aggregate_state)
    store = make_dataset("cifar_like", n=3001, seed=1, device=card)
    sched = make_schedule("ddpm_linear", 1000)
    kw = {"staged": dict(fused=False, screen="materialized"),
          "streamed": dict(fused=False, screen="streamed"),
          "fused": dict(fused=True), "full_scan": {},
          "indexed": dict(index=build_index(store),
                          index_mode="always")}[route]
    x = float(sched.b[1000]) * torch.randn(
        8, store.dim, generator=torch.Generator().manual_seed(7)).to(card)
    outs = []
    for mesh in (None, LocalMesh((shards,), ("data",))):
        gd = GoldDiff(OptimalDenoiser(store, sched, device=card), mesh=mesh,
                      **kw)
        den = FullScan(gd.engine) if route == "full_scan" else gd
        for k in ops.COUNTED:
            k.launches = 0
        outs.append(sample(den, sched, x.shape, num_steps=10, x_init=x))
    torch.cuda.synchronize()
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-3
    state = golden_aggregate_state if route == "full_scan" else \
        golden_support_aggregate_state
    assert state.launches == 10 * shards
    assert golden_support_aggregate.launches == 0
    assert golden_aggregate.launches == 0


def test_sharded_plan_graph_replay_bit_equal(card):
    """A sharded plan segment captured as one CUDA graph (S slices read
    from the layout's fixed slabs) replays bit-equal to the eager
    segments, and a warmed sharded ServeEngine captures nothing more."""
    from repro_torch.core import build_plan, sample_plan
    from repro_torch.distributed import LocalMesh
    from repro_torch.launch.serve import Request, ServeEngine
    store = make_dataset("cifar_like", n=3001, seed=1, device=card)
    sched = make_schedule("ddpm_linear", 1000)
    gd = GoldDiff(OptimalDenoiser(store, sched, device=card),
                  mesh=LocalMesh((4,), ("data",)))
    plan = build_plan(gd.engine, 10)
    x = float(sched.b[1000]) * torch.randn(
        8, store.dim, generator=torch.Generator().manual_seed(8)).to(card)
    eager = sample_plan(gd.call_masked, sched, x.shape, plan, x_init=x)
    for _ in range(2):
        graph = sample_plan(gd.call_masked, sched, x.shape, plan, x_init=x,
                            program_cache=gd.engine.program,
                            jitter=gd.engine.jitter)
        assert torch.equal(graph, eager)
    assert gd.engine._captures == plan.num_buckets
    srv = ServeEngine(store, num_steps=10, max_batch=4,
                      mesh=LocalMesh((4,), ("data",)))
    srv.warmup()
    c0 = srv.engine._captures
    srv.serve([Request(0, 3, seed=1), Request(1, 4, seed=2)])
    assert srv.engine._captures == c0


def test_gloo_process_mesh_keeps_a_card_store_on_the_card(card, tmp_path):
    """A gloo ``ProcessMesh`` given no device lays out a store on the card
    on the card (the store's device), and an engine over it runs on the
    card (``resolve_device``): the CPU only where the caller asks."""
    import torch.distributed as dist
    from repro_torch.core import GoldDiffEngine
    from repro_torch.distributed import ProcessMesh
    from repro_torch.index.shard import shard_layout
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        store = make_dataset("cifar_like", n=1001, seed=1, device=card)
        pm = ProcessMesh("data")
        assert pm.device is None
        lay = shard_layout(store, pm, "data")
        assert lay.X.device.type == "cuda"
        assert lay.slabs[0].X.device.type == "cuda"
        eng = GoldDiffEngine(store, make_schedule("ddpm_linear", 1000),
                             mesh=pm)
        assert eng.device.type == "cuda" and eng.store.device.type == "cpu"
        assert eng.current_operands().X.device.type == "cuda"
        cpu = GoldDiffEngine(store, make_schedule("ddpm_linear", 1000),
                             mesh=pm, device="cpu")
        assert cpu.current_operands().X.device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_runtime_monitor_captures_its_probes(card):
    """``ServeRuntime(monitor=QualityMonitor(...))`` on an indexed plan
    engine: warmup captures the probe screens (the indexed one returns a
    (positions, markers) pair) on both kept slots, serving probes at
    every seam with 0 builds and 0 captures after warmup, and each
    probe's recall equals the one computed from eager screens."""
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quality import QualityMonitor
    from repro_torch.index import screening_recall
    store = make_dataset("gmm", n=2048, dim=16, seed=0, device=card)
    srv = ServeEngine(store, num_steps=4, max_batch=4, index_mode="always",
                      index=build_index(store, num_clusters=16))
    mon = QualityMonitor(srv.engine, registry=MetricsRegistry(),
                         sample_rate=1.0)
    rt = ServeRuntime(srv, RuntimeConfig(backoff_base_s=0.0), monitor=mon)
    stats = rt.warmup()
    assert stats["probe_ts_warmed"] > 0
    eng = srv.engine
    c0, b0 = eng._captures, eng._builds
    tickets = [rt.submit(Request(i, 1 + i % 4, seed=i)) for i in range(4)]
    rt.run_until_idle()
    assert all(t.status == "done" for t in tickets)
    h = rt.health()
    assert eng._captures == c0 and eng._builds == b0
    assert h["n_recall_probes"] > 0 and 0.0 <= h["screen_recall_last"] <= 1.0
    t = 500
    x = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    rec = mon.probe_recall(x.numpy(), t)
    q = (x / float(eng.constants(t)[0])).to(card)
    pos, pd2 = eng.coarse_indexed(q, eng.padded_m(t), eng.nprobe(t))
    want = screening_recall(pos, pd2, eng.index_perm,
                            eng.coarse(q, eng.sizes(t)[0]))
    assert rec == pytest.approx(want)


_DRYRUN_PIN = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.distributed import hlo_analysis as H
from repro_torch.distributed.sharding import place
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
mesh = D.make_mesh(False, sys.argv[1], (2, 2))
with FakeTensorMode():
    x = place(torch.empty(8, 16, 32, device=sys.argv[1]), mesh,
              (Shard(0), Shard(2)))
    w = place(torch.empty(32, 64, device=sys.argv[1]), mesh,
              (Shard(0), Shard(1)))
    m = H.DeviceCostMode()
    with m:
        L.dense(x, w)
    with FlopCounterMode(display=False) as fc:
        x @ w
print(json.dumps({"flops": m.flops, "global": fc.get_total_flops(),
                  "coll": H.collective_bytes(m.records)}))
"""


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_dryrun_counts_pinned_on_this_torch(card, device):
    """The dry run's reliance on torch internals, pinned on the card's
    torch: a fake process group ("fake" backend, ``FakeStore``) over
    fake tensors, and ``DeviceCostMode`` counting each rank's local
    operations (declining DTensor ops, skipping the shape propagation
    under ``_sharding_prop.py``): one sharded product's local FLOPs and
    collective bytes are the hand count that ``tests/test_torch_mesh.py``
    holds on the CPU's torch, where ``FlopCounterMode`` counts the
    global product."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", _DRYRUN_PIN, device],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["flops"] == 2 * 64 * 32 * 32
    assert got["global"] == 4 * got["flops"]
    assert got["coll"]["all-gather"] == got["coll"]["total"] == \
        (32 * 32 + 4 * 16 * 32) * 4
