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
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core import (GoldDiff, OptimalDenoiser,  # noqa: E402
                              make_schedule, sample)
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import build_index  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.centroid_scan import centroid_scan  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    fused_candidates, fused_candidates_scan)
from repro_torch.kernels.golden_aggregate import golden_aggregate  # noqa: E402
from repro_torch.kernels.golden_rerank import support_sqdist  # noqa: E402
from repro_torch.kernels.golden_support_aggregate import (  # noqa: E402
    golden_support_aggregate)
from repro_torch.kernels.pdist import pdist  # noqa: E402
from repro_torch.kernels.screen import screen_topm, screen_topm_scan  # noqa: E402

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
                                   (17, 64, 33)])
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


@pytest.mark.parametrize("b,n,d", [(16, 5000, 3072), (3, 77, 10),
                                   (1, 40, 12288)])
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
    (3, 40000, 8, 20000),      # m > 16384: global bitonic merge steps
    (2, 1, 4, 3),              # a one-row store
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


def test_screen_topm_all_tied(card):
    q = torch.zeros(4, 8, device=card)
    x = torch.ones(3000, 8, device=card)
    gi, gv = screen_topm(q, x, 1000, norms(q), norms(x))
    assert torch.equal(gi, torch.arange(1000, device=card).expand(4, -1))
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
    (2, 20000, 8, 16, 17000),   # m > 16384: global bitonic merge steps
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
    got = centroid_scan(q, cents, norms(q), cn)
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
