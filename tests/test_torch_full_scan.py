"""Kernels 1 and 4's host plans and a numpy model of kernel 4's design.

``golden_aggregate`` (kernel 4, ``csrc/golden_aggregate.cu``) splits D
across a thread block cluster and N across the clusters; ``pdist``
(kernel 1, ``csrc/pdist.cu``) walks 64-row tiles with persistent CTAs.
Both run their products on the tensor cores with the 3xTF32 split
(``csrc/dist_tile.cuh``).  The CUDA code runs only on the card
(``tests/test_torch_cuda.py``); here the plans that size the grids,
the shared memory and the scratch are held against fixed expectations,
a numpy model of kernel 4's arithmetic order (per-warp partial dots
summed in warp order, then in rank order; a tile-wise online softmax;
the split-order log-sum-exp merge) is held against the JAX package's
``golden_aggregate`` (its Pallas kernel in interpret mode) and the
port's plain version within 1e-5, and a numpy emulation of the 3xTF32
split shows that it keeps the distances within 1e-5 relative and the
means within 1e-4 at every step of a 10-step schedule, where one TF32
product does not.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import make_schedule, sampling_timesteps  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import golden_aggregate as ga  # noqa: E402
from repro_torch.kernels import pdist as pd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SMEM_MAX = 232448          # bytes a block may opt in to on the H100
BATCHES = (1, 5, 16, 17, 64)
WIDTHS = (2, 64, 784, 3072, 12288)     # every dataset's D


# -- kernel 4's plan ---------------------------------------------------------

@pytest.mark.parametrize("d,cluster,ds,stages,smem", [
    (2, 1, 64, 8, 49920),
    (64, 1, 64, 8, 49920),
    (784, 2, 448, 7, 219392),
    (3072, 4, 768, 4, 217856),
    (12288, 16, 768, 3, 192768),
    (3000, 4, 768, 4, 217856),     # not a multiple of C x 8
    (1000, 2, 768, 4, 213760),
])
def test_cluster_shape(d, cluster, ds, stages, smem):
    assert ga.cluster_shape(d) == dict(cluster=cluster, slice=ds,
                                       stages=stages, smem=smem)


@pytest.mark.parametrize("b,n,d,splits,rows", [
    (16, 50000, 3072, 33, 1520),     # 33 clusters of 4 on 132 SMs
    (1, 50000, 3072, 33, 1520),
    (17, 50000, 3072, 16, 3136),     # two groups share the clusters
    (64, 50000, 3072, 8, 6256),
    (16, 16384, 12288, 8, 2048),     # 8 clusters of 16
    (16, 50000, 784, 66, 768),
    (16, 50000, 64, 131, 384),
    (5, 40, 3072, 3, 16),            # fewer tiles than clusters
])
def test_grid_plan(b, n, d, splits, rows):
    p = ga.plan(b, n, d)
    assert (p["splits"], p["rows"]) == (splits, rows)
    assert p["part_acc"] == splits * b * d
    assert p["part_ml"] == 2 * splits * b


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("d", WIDTHS)
def test_plan_invariants(b, d):
    """Every dataset width fits a block's shared memory; the slices cover
    D; every split holds at least one row and the splits cover N; the
    groups of 16 cover B; the resident clusters are shared, not
    exceeded."""
    for n, clusters in ((50000, None), (16384, 7), (37, 29)):
        p = ga.plan(b, n, d, clusters)
        assert p["smem"] <= SMEM_MAX
        assert p["smem"] == ga.smem_bytes(p["slice"], p["stages"],
                                          p["cluster"])
        assert p["slice"] in ga.SLICES and p["cluster"] in ga.CLUSTERS
        assert p["cluster"] * p["slice"] >= d
        assert -(-d // p["cluster"]) <= p["slice"]
        assert p["rows"] % ga.TILE_ROWS == 0
        assert (p["splits"] - 1) * p["rows"] < n <= p["splits"] * p["rows"]
        assert p["groups"] * 16 >= b > (p["groups"] - 1) * 16
        resident = clusters or 132 // p["cluster"]
        assert p["splits"] <= max(1, resident // p["groups"])


def test_cluster_shape_refuses_too_wide():
    with pytest.raises(ValueError, match="CTAs"):
        ga.cluster_shape(16 * 768 + 1)


def test_pad4_keeps_aligned_rows():
    x = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    assert ga.pad4(x) is x
    for d in (0, 2, 5):
        y = ga.pad4(torch.ones(3, d))
        assert y.shape == (3, -(-d // 4) * 4 or 4)
        assert torch.equal(y[:, :d], torch.ones(3, d))
        assert not y[:, d:].any()


# -- kernel 1's plan ---------------------------------------------------------

@pytest.mark.parametrize("d,stages,smem", [
    (2, 3, 36416),
    (64, 3, 63040),
    (192, 3, 169536),
    (256, 3, 222784),
    (784, 2, 173632),      # slabs of 256 columns, each with its queries
    (3072, 2, 173632),
    (12288, 2, 173632),
])
def test_pdist_shared_memory(d, stages, smem):
    p = pd.plan(16, 50000, d)
    assert (p["stages"], p["smem"]) == (stages, smem)
    assert p["slabs"] == max(1, -(-d // 256))


@pytest.mark.parametrize("b,ctas", [(1, 132), (5, 132), (16, 132), (17, 66),
                                    (64, 33)])
@pytest.mark.parametrize("d", WIDTHS)
def test_pdist_persistent_grid(b, ctas, d):
    """One CTA an SM, shared among the groups of 16 queries; no more CTAs
    than tiles; the shared memory fits."""
    p = pd.plan(b, 50000, d)
    assert p["groups"] == -(-b // 16)
    assert p["ctas"] == ctas and p["tiles"] == 782
    assert p["smem"] <= SMEM_MAX
    assert pd.plan(b, 100, d)["ctas"] == 2      # two 64-row tiles


# -- the 3xTF32 split --------------------------------------------------------

def tf32(a):
    """``x & 0xffffe000``: the TF32 value the kernels keep (truncated)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(np.asarray(a, np.float32) - hi)


def mm3(a, b):
    """a @ b by the kernels' three TF32 products (small terms first), each
    product exact, summed in float64 and rounded once to fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    f = np.float64
    return (al.astype(f) @ bh.astype(f) + ah.astype(f) @ bl.astype(f)
            + ah.astype(f) @ bh.astype(f)).astype(np.float32)


def mm1(a, b):
    """a @ b with one TF32 product (what a TF32 MMA makes of fp32 data)."""
    f = np.float64
    return (tf32(a).astype(f) @ tf32(b).astype(f)).astype(np.float32)


def mm_exact(a, b):
    f = np.float64
    return (np.asarray(a, f) @ np.asarray(b, f)).astype(np.float32)


def test_split_is_exact_on_small_integers():
    """Integers below 2^11 are TF32 values: lo = 0, and the products and
    their sums below 2^24 are exact, so kernel 1 stays bit-equal to the
    plain version on integer data."""
    rng = np.random.default_rng(0)
    a = rng.integers(-3, 4, size=(16, 192)).astype(np.float32)
    b = rng.integers(-3, 4, size=(192, 300)).astype(np.float32)
    hi, lo = split(a)
    assert np.array_equal(hi, a) and not lo.any()
    assert np.array_equal(mm3(a, b), a @ b)
    ints = np.arange(-2048, 2049, dtype=np.float32)
    assert np.array_equal(tf32(ints), ints)


def posterior(q, x, xn, sigma2, mm):
    """(d2, the posterior means) for queries q over rows x, with the
    products of ``mm`` and the rest in float64 (the emulation's error is
    the products')."""
    q = q.astype(np.float32)
    qn = (q.astype(np.float64) ** 2).sum(-1)
    d2 = np.maximum(qn[:, None] + xn[None, :] - 2.0 * mm(q, x.T), 0.0)
    inv = tref.finite_inv_two_sigma2(sigma2)
    lg = np.maximum(-d2 * inv, tref.NEG_INF)
    w = np.exp(lg - lg.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return d2, mm(w.astype(np.float32), x).astype(np.float64)


@pytest.fixture(scope="module")
def cifar_steps():
    """A cifar_like store (N=1024, D=3072), 4 queries near its rows at each
    of the 10 DDIM steps of ddpm_linear (x_t / a_t, sigma_t^2), and the
    float64 reference distances and means at each."""
    store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    x = store.X.numpy().astype(np.float32)
    xn = (x.astype(np.float64) ** 2).sum(-1)
    sched = make_schedule("ddpm_linear", 1000)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, x.shape[0], size=4)
    steps = []
    for t in sampling_timesteps(sched, 10)[:-1]:
        a = float(sched.a[int(t)])
        sig2 = float(sched.sigma_np(int(t))) ** 2
        eps = rng.normal(size=(4, x.shape[1]))
        q = ((a * x[rows] + float(sched.b[int(t)]) * eps) / a)
        q = q.astype(np.float32)
        steps.append((int(t), sig2, q, *posterior(q, x, xn, sig2, mm_exact)))
    return x, xn, steps


def rel(got, want):
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("step", range(10))
def test_3xtf32_keeps_distances_and_means(cifar_steps, step):
    x, xn, steps = cifar_steps
    t, sig2, q, d2, mean = steps[step]
    got_d2, got_mean = posterior(q, x, xn, sig2, mm3)
    assert rel(got_d2, d2) <= 1e-5, (t, sig2)
    assert np.abs(got_mean - mean).max() <= 1e-4, (t, sig2)


def test_1xtf32_misses(cifar_steps):
    """One TF32 product per term, the split's alternative: its distances
    and its means leave the contract at some step (why the kernels pay
    three)."""
    x, xn, steps = cifar_steps
    worst_d2 = worst_mean = 0.0
    for t, sig2, q, d2, mean in steps:
        got_d2, got_mean = posterior(q, x, xn, sig2, mm1)
        worst_d2 = max(worst_d2, rel(got_d2, d2))
        worst_mean = max(worst_mean, float(np.abs(got_mean - mean).max()))
    assert worst_d2 > 1e-5 and worst_mean > 1e-4, (worst_d2, worst_mean)


# -- a numpy model of kernel 4 -----------------------------------------------

def model_golden_aggregate(q, x, sigma2, xn, clusters):
    """Kernel 4's arithmetic order in numpy fp32 (the MMAs as ``mm3`` over
    each warp's columns): the plan's clusters, D slices and splits; each
    tile's dots summed over a slice's 8 warps in order, then over the
    ranks in order; the logits' clamp; the online softmax tile by tile;
    the weighted rows; and the split-order log-sum-exp merge."""
    b, d = q.shape
    n = x.shape[0]
    p = ga.plan(b, n, d, clusters)
    c, ds, rows, r = p["cluster"], p["slice"], p["rows"], ga.TILE_ROWS
    wcols = ds // 8
    f = np.float32
    inv = f(tref.finite_inv_two_sigma2(sigma2))
    q = q.astype(f)
    qn = (q * q).sum(-1, dtype=f)
    out = np.zeros((b, d), f)
    for g0 in range(0, b, 16):
        qg, qng = q[g0:g0 + 16], qn[g0:g0 + 16]
        states = []
        for s in range(p["splits"]):
            r0, r1 = s * rows, min(n, (s + 1) * rows)
            m = np.full(len(qg), f(tref.NEG_INF), f)
            l = np.zeros(len(qg), f)
            acc = np.zeros((len(qg), d), f)
            for t0 in range(r0, r1, r):
                xt = x[t0:min(r1, t0 + r)]
                dot = np.zeros((len(qg), len(xt)), f)
                for k in range(c):                     # ranks in order
                    part = np.zeros_like(dot)
                    for w in range(8):                 # warps in order
                        lo = k * ds + w * wcols
                        hi = min(d, lo + wcols)
                        if lo < hi:
                            part += mm3(qg[:, lo:hi], xt[:, lo:hi].T)
                    dot += part
                d2 = np.maximum((qng[:, None] + xn[None, t0:t0 + len(xt)])
                                - f(2) * dot, f(0))
                with np.errstate(over="ignore"):    # -> -inf, then clamped
                    lg = np.maximum(-d2 * inv, f(tref.NEG_INF))
                mn = np.maximum(m, lg.max(-1))
                sc = np.exp(m - mn)
                pw = np.exp(lg - mn[:, None])
                l = l * sc + pw.sum(-1, dtype=f)
                acc = acc * sc[:, None] + mm3(pw, xt)
                m = mn
            states.append((m, l, acc))
        big = np.max([st[0] for st in states], axis=0)
        big = np.maximum(big, f(tref.NEG_INF))
        tot_l = np.zeros(len(qg), f)
        tot = np.zeros((len(qg), d), f)
        for m, l, acc in states:                        # splits in order
            e = np.exp(m - big)
            tot_l += l * e
            tot += acc * e[:, None]
        out[g0:g0 + 16] = tot / np.maximum(tot_l, f(1e-30))[:, None]
    return out


MODEL_CASES = [
    (5, 203, 10, 0.5, 3),        # ragged N and D (one CTA, a 64-column slice)
    (3, 77, 100, 0.05, 2),
    (17, 130, 784, 0.5, 4),      # two query groups, a cluster of 2
    (4, 150, 1000, 0.2, 5),      # the second rank's slice holds 232 columns
]


@pytest.mark.parametrize("b,n,d,sigma2,clusters", MODEL_CASES)
def test_model_matches_jax_and_plain(b, n, d, sigma2, clusters):
    rng = np.random.default_rng(b + n + d)
    x = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    q = (x[rng.integers(0, n, size=b)]
         + 0.1 * rng.normal(size=(b, d)) / np.sqrt(d)).astype(np.float32)
    xn = (x * x).sum(-1)
    got = model_golden_aggregate(q, x, sigma2, xn, clusters)
    plain = tref.golden_aggregate_ref(torch.from_numpy(q),
                                      torch.from_numpy(x), sigma2,
                                      torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    jax_out = np.asarray(jops.golden_aggregate(
        jnp.asarray(q), jnp.asarray(x), sigma2, x_norms=jnp.asarray(xn),
        backend="pallas_interpret"))
    np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sigma2", [0.0, 1e-30, -1.0])
def test_model_clamp_gives_the_data_mean(sigma2):
    """Degenerate sigma2: the finite temperature clamps every logit at
    NEG_INF, so every split's weights are uniform and the merge gives the
    data mean (the NEG_INF clamp and sigma2 = 0 contracts)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(150, 70)).astype(np.float32)
    q = (x[:4] + 0.5).astype(np.float32)
    xn = (x * x).sum(-1)
    got = model_golden_aggregate(q, x, sigma2, xn, 4)
    np.testing.assert_allclose(got, np.tile(x.mean(0), (4, 1)), atol=1e-5)
    plain = tref.golden_aggregate_ref(torch.from_numpy(q),
                                      torch.from_numpy(x), sigma2,
                                      torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_model_inf_norm_rows_are_weightless():
    """Rows whose norm is +inf get d2 = +inf, a NEG_INF logit and, beside
    finite rows, no weight: the means are those of the other rows."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(140, 40)) / 6.0).astype(np.float32)
    q = (x[:5] + 0.05).astype(np.float32)
    xn = (x * x).sum(-1)
    dead = np.arange(0, 140, 9)
    xn[dead] = np.inf
    live = np.setdiff1d(np.arange(140), dead)
    got = model_golden_aggregate(q, x, 0.3, xn, 3)
    want = model_golden_aggregate(q, x[live], 0.3, xn[live], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    plain = tref.golden_aggregate_ref(torch.from_numpy(q),
                                      torch.from_numpy(x), 0.3,
                                      torch.from_numpy(xn)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
