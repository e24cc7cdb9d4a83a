"""The port's Golden Index (IVF) path against the JAX package, on the CPU.

Stores come from the reference's generators (gmm 4096 x 16 with 64
clusters, mnist_like 2048 with 32) and cross with ``store_from_numpy``.
The reference's index crosses with ``index_from_numpy``: ``jax.random``
and torch draw different streams, so the port's own k-means is held by
its properties instead (determinism, a valid CSR layout, quantization,
recall >= 0.95 at every bucket).  The JAX side runs on ``xla`` and on
``pallas_interpret`` (the interpret-mode Pallas kernels).

Tolerances: distances bit-equal on integer data (every fp32 sum is
exact) and 1e-5 relative on floats; candidate and golden sets equal, or
on floats equal up to near-ties (rows whose distances differ by < 1e-6
of ||q||^2); posterior means 1e-4 (fp32 reduction order); a 10-step
trajectory 1e-3 (the per-step differences compound through DDIM).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GoldDiff as JGoldDiff  # noqa: E402
from repro.core import GoldDiffConfig as JConfig  # noqa: E402
from repro.core import GoldDiffEngine as JEngine  # noqa: E402
from repro.core import OptimalDenoiser as JOptimal  # noqa: E402
from repro.core import make_schedule as jmake_schedule  # noqa: E402
from repro.core import sample as jsample  # noqa: E402
from repro.data import gmm as jgmm  # noqa: E402
from repro.data import mnist_like as jmnist_like  # noqa: E402
from repro.index import GoldenIndex as JIndex  # noqa: E402
from repro.index import ProbeSchedule as JProbes  # noqa: E402
from repro.index import build_index as jbuild_index  # noqa: E402
from repro.index import load_index as jload_index  # noqa: E402
from repro.index import save_index as jsave_index  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (GoldDiff, GoldDiffConfig,  # noqa: E402
                              GoldDiffEngine, OptimalDenoiser,
                              make_schedule, sample, sampling_timesteps,
                              store_from_numpy)
from repro_torch.index import (GoldenIndex, ProbeSchedule,  # noqa: E402
                               StoreCorruptionError, build_index,
                               index_from_numpy, kmeans, kmeans_plusplus,
                               load_index, save_index, screening_recall)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.serve import Request, ServeEngine  # noqa: E402

JBACKENDS = ["xla", "pallas_interpret"]
FRACS = dict(m_min_frac=1 / 64, m_max_frac=1 / 16, k_min_frac=1 / 128,
             k_max_frac=1 / 64)
JCFG, TCFG = JConfig(**FRACS), GoldDiffConfig(**FRACS)
RECALL_PROBES = dict(f_lo=1 / 8, f_hi=1.0, safety=4.0)
T_BUCKETS = (999, 800, 600, 400, 200, 50)
JSCH = jmake_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)


def carry_store(js):
    return store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                            js.image_shape, device="cpu")


def carry_index(jix):
    return index_from_numpy(*(np.asarray(getattr(jix, f))
                              for f in JIndex._fields[:-1]),
                            max_cluster=jix.max_cluster, device="cpu")


@pytest.fixture(scope="module")
def gmm_setup():
    js = jgmm(4096, dim=16, seed=3)
    jix = jbuild_index(js, num_clusters=64)
    x = np.random.default_rng(3).normal(size=(6, 16)).astype(np.float32)
    return js, jix, carry_store(js), carry_index(jix), x


@pytest.fixture(scope="module")
def image_setup():
    js = jmnist_like(2048, seed=1)
    return js, carry_store(js)


def queries(x_np, t, seed, b=8):
    """Noised store rows rescaled by a_t: the engine's q at step t."""
    rng = np.random.default_rng(seed)
    x0 = x_np[:b]
    eps = rng.normal(size=x0.shape)
    return ((TSCH.a[t] * x0 + TSCH.b[t] * eps) / TSCH.a[t]).astype(np.float32)


def noisy(x_np, t, seed, b=6):
    rng = np.random.default_rng(seed)
    x0 = x_np[rng.integers(0, x_np.shape[0], b)]
    return (TSCH.a[t] * x0 + TSCH.b[t] * rng.normal(size=x0.shape)
            ).astype(np.float32)


def assert_sets_equal_up_to_near_ties(tidx, jidx, q, x):
    """Equal sets, or differences only where the two rows' distances
    differ by less than 1e-6 of ||q||^2."""
    for b in range(tidx.shape[0]):
        diff = np.nonzero(tidx[b] != jidx[b])[0]
        if diff.size == 0:
            continue
        rows = np.concatenate([tidx[b, diff], jidx[b, diff]])
        d = ((x[rows].astype(np.float64) - q[b]) ** 2).sum(-1)
        gap = np.abs(d[: diff.size] - d[diff.size:])
        assert (gap < 1e-6 * float(np.sum(q[b] ** 2))).all(), (b, diff, gap)


def ints(shape, seed):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float32)


# -- probe schedule -------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(f_lo=1 / 64, f_hi=1 / 32),
                                RECALL_PROBES,
                                dict(f_lo=0.0, f_hi=0.0, safety=0.0,
                                     min_probes=1)])
def test_probe_schedule_matches_reference(kw):
    tp, jp = ProbeSchedule(**kw), JProbes(**kw)
    for g in (0.0, 0.1, 0.37, 0.5, 0.9, 1.0):
        for m_t in (1, 64, 390, 781, 1024, 12500):
            for n in (2048, 4096, 50000, 65536):
                for c in (32, 64, 224, 512):
                    assert tp.nprobe(g, m_t, n, c) == jp.nprobe(g, m_t, n, c)


# -- centroid_scan ----------------------------------------------------------------

def padded(cents):
    """The centroids with one zero window appended, its norm +inf."""
    c = np.concatenate([cents, np.zeros((1, cents.shape[1]), np.float32)])
    cn = (c * c).sum(-1)
    cn[-1] = np.inf
    return c, cn.astype(np.float32)


@pytest.mark.parametrize("backend", JBACKENDS)
def test_centroid_scan_integer_bit_equal(backend):
    q = ints((11, 19), 0)
    c, cn = padded(ints((37, 19), 1))
    want = np.asarray(jops.centroid_scan(jnp.asarray(q), jnp.asarray(c),
                                         jnp.asarray(cn), backend=backend))
    got = ops.centroid_scan(torch.from_numpy(q), torch.from_numpy(c),
                            torch.from_numpy(cn))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(got[:, -1].numpy()).all()
    # the probe lists: a stable sort is lax.top_k's order, ties included
    p = 20
    jprobe = np.asarray(jax.lax.top_k(-jnp.asarray(want), p)[1])
    tprobe = torch.sort(got, dim=-1, stable=True)[1][:, :p].numpy()
    np.testing.assert_array_equal(tprobe, jprobe)


@pytest.mark.parametrize("backend", JBACKENDS)
def test_centroid_scan_float(gmm_setup, backend):
    js, jix, ts, tix, x = gmm_setup
    c, cn = padded(np.asarray(jix.centroids))
    want = np.asarray(jops.centroid_scan(jnp.asarray(x), jnp.asarray(c),
                                         jnp.asarray(cn), backend=backend))
    got = ops.centroid_scan(torch.from_numpy(x), torch.from_numpy(c),
                            torch.from_numpy(cn)).numpy()
    assert np.isinf(got[:, -1]).all() and np.isinf(want[:, -1]).all()
    fin = np.isfinite(want)
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)
    assert rel.max() <= 1e-5


def test_centroid_scan_ref_keeps_inf_on_padding():
    """Padded windows (+inf norms) give +inf whatever the dot product,
    large or negative, so the probe sort never picks them."""
    q = torch.tensor([[1e3, -1e3], [0.0, 0.0], [-5.0, 2.0]])
    c = torch.tensor([[1e3, -1e3], [0.0, 1.0], [-1e3, 1e3]])
    cn = torch.tensor([float("inf"), 1.0, float("inf")])
    d2 = ref.centroid_scan_ref(q, c, cn)
    assert torch.isinf(d2[:, 0]).all() and torch.isinf(d2[:, 2]).all()
    assert torch.isfinite(d2[:, 1]).all()
    assert (torch.sort(d2, dim=-1, stable=True)[1][:, 0] == 1).all()
    assert torch.equal(ops.centroid_scan(q, c, cn), d2)


# -- ivf_screen ---------------------------------------------------------------------

def both_ivf(jix, tix, x, m, p, nprobe=None, backend="xla"):
    jpos, jd2 = jops.ivf_screen(
        jnp.asarray(x), jix.proxy_sorted, jix.proxy_norms_sorted, jix.offsets,
        jix.centroids, jix.centroid_norms, m, p, jix.max_cluster,
        nprobe=nprobe, backend=backend)
    tpos, td2 = ops.ivf_screen(
        torch.from_numpy(x), tix.proxy_sorted, tix.proxy_norms_sorted,
        tix.offsets, tix.centroids, tix.centroid_norms, m, p,
        tix.max_cluster, nprobe=nprobe)
    return np.asarray(jpos), np.asarray(jd2), tpos.numpy(), td2.numpy()


@pytest.mark.parametrize("backend", JBACKENDS)
def test_ivf_screen_capacity_mode(gmm_setup, backend):
    js, jix, ts, tix, x = gmm_setup
    for p in (1, 5, 16):
        m = p * jix.max_cluster
        jpos, jd2, tpos, td2 = both_ivf(jix, tix, x, m, p, backend=backend)
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(td2, jd2)
        assert set(np.unique(td2)) <= {0.0, np.inf}


def integer_index(jix):
    """The reference index's CSR layout over integer-valued proxies and
    centroids, in both packages' types."""
    n, dp = np.asarray(jix.proxy_sorted).shape
    ps = ints((n, dp), 7)
    cents = ints((jix.num_clusters, dp), 8)
    f = dict(centroids=cents, centroid_norms=(cents * cents).sum(-1),
             perm=np.asarray(jix.perm), offsets=np.asarray(jix.offsets),
             proxy_sorted=ps, proxy_norms_sorted=(ps * ps).sum(-1))
    jint = JIndex(max_cluster=jix.max_cluster,
                  **{k: jnp.asarray(v) for k, v in f.items()})
    return jint, index_from_numpy(max_cluster=jix.max_cluster,
                                  device="cpu", **f)


@pytest.mark.parametrize("backend", JBACKENDS)
def test_ivf_screen_screening_mode_integer(gmm_setup, backend):
    js, jix, ts, tix, x = gmm_setup
    jint, tint = integer_index(jix)
    q = ints((6, 16), 9)
    for m, p in ((128, 16), (40, 3)):
        jpos, jd2, tpos, td2 = both_ivf(jint, tint, q, m, p, backend=backend)
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(td2, jd2)


def test_ivf_screen_screening_mode_float(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    jpos, jd2, tpos, td2 = both_ivf(jix, tix, x, 128, 16)
    rel = np.abs(td2 - jd2) / np.maximum(np.abs(jd2), 1.0)
    assert rel.max() <= 1e-5
    assert_sets_equal_up_to_near_ties(tpos, jpos, x,
                                      np.asarray(jix.proxy_sorted))


def test_ivf_screen_nprobe_mask_matches_static(gmm_setup):
    """Masking probes beyond ``nprobe`` == probing fewer windows."""
    js, jix, ts, tix, x = gmm_setup
    xt = torch.from_numpy(x)
    args = (xt, tix.proxy_sorted, tix.proxy_norms_sorted, tix.offsets,
            tix.centroids, tix.centroid_norms)
    for m in (64, 16 * tix.max_cluster):
        s_pos, s_d2 = ops.ivf_screen(*args, min(m, 7 * tix.max_cluster), 7,
                                     tix.max_cluster)
        for nprobe in (7, torch.tensor(7)):
            m_pos, m_d2 = ops.ivf_screen(*args, m, 16, tix.max_cluster,
                                         nprobe=nprobe)
            for b in range(x.shape[0]):
                fs, fm = torch.isfinite(s_d2[b]), torch.isfinite(m_d2[b])
                assert torch.equal(torch.sort(s_pos[b][fs])[0],
                                   torch.sort(m_pos[b][fm])[0])
                assert torch.equal(torch.sort(s_d2[b][fs])[0],
                                   torch.sort(m_d2[b][fm])[0])
    # and the masked form agrees with the reference's masked form
    jpos, jd2, tpos, td2 = both_ivf(jix, tix, x, 64, 16, nprobe=7)
    np.testing.assert_allclose(td2, jd2, rtol=1e-5, atol=1e-5)


def test_ivf_screen_excludes_unprobed_rows(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    p = 5
    cd2 = ops.centroid_scan(torch.from_numpy(x), tix.centroids,
                            tix.centroid_norms)
    probes = torch.sort(cd2, dim=-1, stable=True)[1][:, :p].numpy()
    off = tix.offsets.numpy()
    for m in (64, p * tix.max_cluster):
        pos, d2 = ops.ivf_screen(torch.from_numpy(x), tix.proxy_sorted,
                                 tix.proxy_norms_sorted, tix.offsets,
                                 tix.centroids, tix.centroid_norms, m, p,
                                 tix.max_cluster)
        for b in range(x.shape[0]):
            ok = set()
            for c in probes[b]:
                ok.update(range(off[c], off[c + 1]))
            fin = torch.isfinite(d2[b]).numpy()
            assert set(pos[b].numpy()[fin].tolist()) <= ok
            assert fin.sum() > 0


def test_golden_rerank_valid_masks_slots():
    q = torch.zeros(1, 2)
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    cand = torch.tensor([[0, 1, 2, 3]])
    valid = torch.tensor([[False, True, False, True]])
    idx, d2 = ops.golden_rerank(q, x, cand, 3, valid=valid)
    assert idx.tolist() == [[1, 3, 0]]
    assert d2[0, :2].tolist() == [1.0, 9.0] and torch.isinf(d2[0, 2])


# -- engine routing against the reference --------------------------------------------

def engines(gmm_setup, mode="always", probes=None, backend="xla"):
    js, jix, ts, tix, x = gmm_setup
    probes = probes or {}
    je = JEngine(js, JSCH, JCFG, backend=backend, index=jix,
                 index_mode=mode, probe_schedule=JProbes(**probes))
    te = GoldDiffEngine(ts, TSCH, TCFG, device="cpu", index=tix,
                        index_mode=mode, probe_schedule=ProbeSchedule(**probes))
    return je, te


@pytest.mark.parametrize("mode", ["always", "auto"])
@pytest.mark.parametrize("probes", [{}, dict(f_lo=1 / 64, f_hi=1 / 32),
                                    dict(f_lo=0.0, f_hi=0.0, safety=0.0,
                                         min_probes=1)])
def test_engine_routing_matches_reference(gmm_setup, mode, probes):
    je, te = engines(gmm_setup, mode, probes)
    for t in list(sampling_timesteps(TSCH, 10)) + [999, 500, 20, 1]:
        t = int(t)
        assert te.nprobe(t) == je.nprobe(t)
        assert te.padded_m(t) == je.padded_m(t)
        assert te.use_index(t) == je.use_index(t)
        assert te.use_fused(t) == je.use_fused(t)


def test_engine_select_and_denoise_every_step(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    je, te = engines(gmm_setup)
    X = np.asarray(js.X)
    for i, t in enumerate(sampling_timesteps(TSCH, 10)[:-1]):
        t = int(t)
        x_t = noisy(X, t, seed=i)
        jidx = np.asarray(je.select(jnp.asarray(x_t), t))
        tidx = te.select(torch.from_numpy(x_t), t).numpy()
        assert tidx.shape == jidx.shape
        assert tidx.max() < js.n and tidx.min() >= 0
        q = x_t / np.float32(TSCH.a[t])
        assert_sets_equal_up_to_near_ties(tidx, jidx, q, X)
        np.testing.assert_allclose(
            te.denoise(torch.from_numpy(x_t), t).numpy(),
            np.asarray(je.denoise(jnp.asarray(x_t), t)),
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [900, 50])
def test_engine_denoise_matches_pallas_interpret(gmm_setup, t):
    js, jix, ts, tix, x = gmm_setup
    je, te = engines(gmm_setup, backend="pallas_interpret")
    x_t = noisy(np.asarray(js.X), t, seed=t)
    np.testing.assert_allclose(
        te.denoise(torch.from_numpy(x_t), t).numpy(),
        np.asarray(je.denoise(jnp.asarray(x_t), t)), rtol=1e-4, atol=1e-4)


def test_occupancy_floor_keeps_select_on_real_rows(gmm_setup):
    """A schedule of one probe: the occupancy floor alone must widen the
    probes until the golden support holds only real rows."""
    js, jix, ts, tix, x = gmm_setup
    je, te = engines(gmm_setup, probes=dict(f_lo=0.0, f_hi=0.0, safety=0.0,
                                            min_probes=1))
    for t in (999, 500, 20):
        assert te.nprobe(t) == je.nprobe(t) > 1
        x_t = noisy(np.asarray(js.X), t, seed=t)
        idx, d2 = te._select_body(torch.from_numpy(x_t) / TSCH.a[t], t)
        assert torch.isfinite(d2).all()
        assert int(idx.max()) < js.n
        for row in idx:
            assert row.unique().numel() == row.numel()


def test_whole_indexed_trajectory(gmm_setup):
    """sample(GoldDiff(index=, probe_schedule=)) from the same x_T."""
    js, jix, ts, tix, x = gmm_setup
    probes = dict(f_lo=1 / 16, f_hi=1 / 4)
    jgd = JGoldDiff(JOptimal(js, JSCH), JCFG, index=jix,
                    probe_schedule=JProbes(**probes), index_mode="always")
    tgd = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"), TCFG, index=tix,
                   probe_schedule=ProbeSchedule(**probes),
                   index_mode="always")
    assert all(tgd.engine.use_index(int(t))
               for t in sampling_timesteps(TSCH, 10)[:-1])
    shape = (4, js.dim)
    x_T = np.array(float(JSCH.b[1000]) * jax.random.normal(
        jax.random.PRNGKey(1), shape))
    want = np.asarray(jsample(jgd, JSCH, shape, jax.random.PRNGKey(7),
                              num_steps=10, x_init=jnp.asarray(x_T)))
    got = sample(tgd, TSCH, shape, num_steps=10,
                 x_init=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_engine_index_validation(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    other = carry_store(jgmm(512, dim=16, seed=0))
    with pytest.raises(ValueError, match="N=4096"):
        GoldDiffEngine(other, TSCH, TCFG, device="cpu", index=tix)
    with pytest.raises(ValueError, match="index_mode"):
        GoldDiffEngine(ts, TSCH, TCFG, device="cpu", index=tix,
                       index_mode="bogus")


def test_serve_with_index(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    eng = ServeEngine(ts, num_steps=4, gd_cfg=TCFG, max_batch=4,
                      index=tix, index_mode="always", device="cpu")
    assert eng.engine.use_index(999)
    out = eng.serve([Request(0, 3, seed=1), Request(1, 2, seed=2)])
    assert [r.images.shape for r in out] == [(3, 16), (2, 16)]
    assert all(np.isfinite(r.images).all() for r in out)


# -- the port's own k-means ------------------------------------------------------------

def test_build_determinism(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    a = build_index(ts, 64, generator=torch.Generator().manual_seed(0))
    b = build_index(ts, 64, generator=torch.Generator().manual_seed(0))
    for f in ("centroids", "perm", "offsets", "proxy_sorted"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.max_cluster == b.max_cluster
    assert a.perm.dtype == a.offsets.dtype == torch.int64
    c = build_index(ts, 64, generator=torch.Generator().manual_seed(9))
    assert not torch.equal(a.centroids, c.centroids)


def test_build_csr_layout_valid(gmm_setup):
    js, jix, ts, tix, x = gmm_setup
    ix = build_index(ts, 64)
    perm, off = ix.perm.numpy(), ix.offsets.numpy()
    assert sorted(perm.tolist()) == list(range(ts.n))
    assert off[0] == 0 and off[-1] == ts.n and (np.diff(off) >= 0).all()
    assert int(np.diff(off).max()) == ix.max_cluster
    assert ix.max_cluster <= int(np.ceil(1.5 * ts.n / 64))
    # every row of window c is nearest to window c's centroid (split
    # windows duplicate a centroid, so compare centroid vectors)
    assign = torch.argmin(ops.centroid_scan(ts.proxy, ix.centroids,
                                            ix.centroid_norms), -1).numpy()
    cents = ix.centroids.numpy()
    assign = assign[perm]
    for c in range(ix.num_clusters):
        rows = assign[off[c]:off[c + 1]]
        np.testing.assert_array_equal(cents[rows], np.broadcast_to(
            cents[c], (len(rows),) + cents[c].shape))
    assert torch.equal(ix.proxy_sorted, ts.proxy[ix.perm])
    assert torch.equal(ix.centroid_norms, (ix.centroids ** 2).sum(-1))


def test_kmeans_improves_quantization():
    ts = carry_store(jgmm(2048, dim=16, seed=5))
    seeds = kmeans_plusplus(torch.Generator().manual_seed(0), ts.proxy, 32)
    cents, assign = kmeans(torch.Generator().manual_seed(0), ts.proxy, 32)

    def obj(c):
        return float(ref.pdist_ref(ts.proxy, c).min(-1).values.mean())

    assert obj(cents) <= obj(seeds) + 1e-6
    assert assign.dtype == torch.int64 and int(assign.max()) < 32


@pytest.mark.parametrize("which", ["gmm", "image"])
def test_recall_at_mt_every_bucket(gmm_setup, image_setup, which):
    """The port's own index recalls >= 0.95 of the exact top-m_t at
    every bucket (the reference's gate and schedule)."""
    ts = gmm_setup[2] if which == "gmm" else image_setup[1]
    ix = build_index(ts, 64 if which == "gmm" else 32)
    eng = GoldDiffEngine(ts, TSCH, TCFG, device="cpu", index=ix,
                         index_mode="always",
                         probe_schedule=ProbeSchedule(**RECALL_PROBES))
    X = ts.X.numpy()
    for t in T_BUCKETS:
        m_t, _ = eng.sizes(t)
        q = torch.from_numpy(queries(X, t, seed=t))
        exact = eng.coarse(q, m_t)
        pos, pd2 = eng.coarse_indexed(q, eng.padded_m(t), eng.nprobe(t))
        recall = screening_recall(pos, pd2, ix.perm, exact)
        assert recall >= 0.95, (which, t, recall, eng.nprobe(t))


# -- persistence ---------------------------------------------------------------------

def test_save_load_interop(gmm_setup, tmp_path):
    js, jix, ts, tix, x = gmm_setup
    # the reference writes, the port reads
    jpath = str(tmp_path / "jax_index.npz")
    jsave_index(jix, jpath)
    back = load_index(jpath, device="cpu")
    assert isinstance(back, GoldenIndex) and back.max_cluster == jix.max_cluster
    for f in JIndex._fields[:-1]:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jix, f)))
    assert back.perm.dtype == back.offsets.dtype == torch.int64
    # the port writes (its own k-means), the reference reads
    own = build_index(ts, 64)
    tpath = str(tmp_path / "torch_index.npz")
    save_index(own, tpath)
    jback = jload_index(tpath)
    assert jback.max_cluster == own.max_cluster
    for f in JIndex._fields[:-1]:
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)),
                                      getattr(own, f).numpy())
    # and the port reads its own file back
    again = load_index(tpath, device="cpu")
    for f in JIndex._fields[:-1]:
        assert torch.equal(getattr(again, f), getattr(own, f))
    # a flipped byte in the npz is caught by the checksum
    raw = bytearray(open(tpath, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(tpath, "wb").write(bytes(raw))
    with pytest.raises(StoreCorruptionError):
        load_index(tpath, device="cpu")


def test_load_index_defaults_to_card(gmm_setup, tmp_path, monkeypatch):
    js, jix, ts, tix, x = gmm_setup
    path = str(tmp_path / "ix.npz")
    save_index(tix, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(path)
