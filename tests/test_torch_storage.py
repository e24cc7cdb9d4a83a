"""bf16 store rows (``storage_dtype``) and ``strategy=`` of the port's
engine against the JAX package with ``storage_dtype=jnp.bfloat16``, on
the CPU (plain versions; the reference on its ``xla`` backend).

Inputs are made with numpy from a seed and reach both packages as the
same bf16 values: rounded once to bf16 (held in fp32), then cast to
bf16 on both sides (exact).  The engines cast the stores themselves, and
torch's and JAX's float32 -> bfloat16 casts both round to nearest even,
so the operands are bit-equal too.  Only the rows (X, the proxy, the
index's cluster-sorted proxy) are bf16; the norms are fp32 from the
fp32 master copy, the proxy query is rounded to bf16 and the exact query
stays fp32.

Tolerances: integer-valued data bit-equal (every fp32 sum exact);
distances 1e-5 relative, means 1e-4 absolute, candidate and golden sets
equal up to near-ties (rows whose distances differ by < 1e-6 of
||q||^2, as ``tests/test_torch_engine.py``); trajectories 1e-3 (the
per-step differences compound through DDIM); a bf16 step against the
fp32 step 5e-2 (the reference's own bound, ``tests/test_engine.py``).
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
from repro.core import plan as jplan  # noqa: E402
from repro.core import sample as jsample  # noqa: E402
from repro.core import sample_plan as jsample_plan  # noqa: E402
from repro.core.dataset import make_store as jmake_store  # noqa: E402
from repro.data import gmm as jgmm  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.index import GoldenIndex as JIndex  # noqa: E402
from repro.index import build_index as jbuild_index  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (GoldDiff, GoldDiffConfig,  # noqa: E402
                              GoldDiffEngine, OptimalDenoiser, build_plan,
                              make_schedule, sample, sample_plan,
                              store_from_numpy)
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import index_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import golden_aggregate as gagg  # noqa: E402
from repro_torch.kernels import pdist as pdist_mod  # noqa: E402

BF = torch.bfloat16
JSCH = jmake_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)
INDEXED_FRACS = dict(m_min_frac=1 / 64, m_max_frac=1 / 16,
                     k_min_frac=1 / 128, k_max_frac=1 / 64)


def rounded(a) -> np.ndarray:
    """a rounded once to bf16, held in fp32."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))


def jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def tbf(a):
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array of either package."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def relerr_d2(got, want) -> float:
    """Largest |got - want| / max(|want|, 1) over the finite slots; the
    +inf slots (surplus, masked) must agree."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0))[fin]
                 .max(initial=0.0))


def carry_store(js):
    return store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                            js.image_shape, device="cpu")


def carry_index(jix):
    return index_from_numpy(*(np.asarray(getattr(jix, f))
                              for f in JIndex._fields[:-1]),
                            max_cluster=jix.max_cluster, device="cpu")


def near_tie_sets(tidx, jidx, d2, qn):
    """Equal sets slot for slot, or differing only where the two rows'
    reference distances (d2 [B, N]) differ by < 1e-6 of ||q||^2."""
    tidx, jidx = np.asarray(tidx), np.asarray(jidx)
    for b in range(tidx.shape[0]):
        diff = np.nonzero(tidx[b] != jidx[b])[0]
        if diff.size == 0:
            continue
        gap = np.abs(d2[b, tidx[b, diff]] - d2[b, jidx[b, diff]])
        assert (gap < 1e-6 * max(float(qn[b]), 1.0)).all(), (b, diff, gap)


# -- ops with bf16 rows, against the reference's ops on bf16 rows ---------------

def op_data(kind: str, seed: int, b=6, n=300, d=48, dp=12):
    """Queries fp32; rows rounded to bf16; norms fp32 of the rounded rows."""
    rng = np.random.default_rng(seed)
    if kind == "ints":
        def draw(*s):
            return rng.integers(-3, 4, s).astype(np.float32)
    else:
        def draw(*s):
            return rng.normal(size=s).astype(np.float32)
    x, p = rounded(draw(n, d)), rounded(draw(n, dp))
    q = x[:b] + (0.5 * draw(b, d) if kind == "float" else draw(b, d))
    qp = rounded(p[:b] + (0.5 * draw(b, dp) if kind == "float"
                          else draw(b, dp)))
    return dict(q=q.astype(np.float32), qp=qp, x=x, p=p,
                xn=(x * x).sum(-1), pn=(p * p).sum(-1))


KINDS = ["ints", "float"]


def check_d2(kind, got, want):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    if kind == "ints":
        np.testing.assert_array_equal(got, want)
    else:
        assert relerr_d2(got, want) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_pdist_bf16_rows(kind):
    v = op_data(kind, 1)
    got = ops.pdist(t32(v["q"]), tbf(v["x"]), x_norms=t32(v["xn"]))
    want = jops.pdist(jnp.asarray(v["q"]), jbf(v["x"]),
                      x_norms=jnp.asarray(v["xn"]), backend="xla")
    check_d2(kind, got.numpy(), want)


@pytest.mark.parametrize("m", [70, 350])          # 350 > N: surplus slots
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_screen_topm_bf16_rows(kind, stream, m):
    v = op_data(kind, 2)
    gi, gd = ops.screen_topm(t32(v["qp"]), tbf(v["p"]), m,
                             x_norms=t32(v["pn"]), stream=stream, tile=64)
    wi, wd = jops.screen_topm(jnp.asarray(v["qp"]), jbf(v["p"]), m,
                              x_norms=jnp.asarray(v["pn"]), stream=stream,
                              tile=64, backend="xla")
    check_d2(kind, gd.numpy(), wd)
    assert np.isinf(gd.numpy()[:, 300:]).all()
    if kind == "ints":
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    else:
        d2 = np.asarray(jops.pdist(jnp.asarray(v["qp"]), jbf(v["p"]),
                                   x_norms=jnp.asarray(v["pn"]),
                                   backend="xla"))
        near_tie_sets(gi.numpy(), wi, d2, (v["qp"] ** 2).sum(-1))


@pytest.mark.parametrize("kind", KINDS)
def test_support_distances_bf16_rows(kind):
    v = op_data(kind, 3)
    idx = np.random.default_rng(4).integers(0, 300, (6, 90))
    got = ops.support_distances(t32(v["q"]), tbf(v["x"]),
                                torch.from_numpy(idx), t32(v["xn"]))
    want = jops.support_distances(jnp.asarray(v["q"]), jbf(v["x"]),
                                  jnp.asarray(idx), jnp.asarray(v["xn"]),
                                  backend="xla", strategy="gather")
    check_d2(kind, got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_golden_support_aggregate_bf16_rows(kind):
    v = op_data(kind, 5)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 300, (6, 40))
    lg = (3 * rng.normal(size=(6, 40))).astype(np.float32)
    lg[0] = ref.NEG_INF
    got = ops.golden_support_aggregate(tbf(v["x"]), torch.from_numpy(idx),
                                       t32(lg))
    for strategy in ("gather", "dense"):
        want = jops.golden_support_aggregate(
            jbf(v["x"]), jnp.asarray(idx), jnp.asarray(lg), backend="xla",
            strategy=strategy)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("sigma2", [0.5, 20.0, 0.0])
@pytest.mark.parametrize("kind", KINDS)
def test_golden_aggregate_bf16_rows(kind, sigma2):
    v = op_data(kind, 7)
    got = ops.golden_aggregate(t32(v["q"]), tbf(v["x"]), sigma2,
                               x_norms=t32(v["xn"]))
    want = jops.golden_aggregate(jnp.asarray(v["q"]), jbf(v["x"]), sigma2,
                                 x_norms=jnp.asarray(v["xn"]), backend="xla")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("m", [80, 320])          # 320 > N: surplus slots
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_step_bf16_rows(kind, stream, m):
    v = op_data(kind, 8)
    k, sigma2 = 30, 4.0
    got = ops.fused_step(t32(v["q"]), t32(v["qp"]), tbf(v["x"]), tbf(v["p"]),
                         m, k, sigma2, x_norms=t32(v["xn"]),
                         proxy_norms=t32(v["pn"]), stream=stream, tile=64)
    want = jops.fused_step(jnp.asarray(v["q"]), jnp.asarray(v["qp"]),
                           jbf(v["x"]), jbf(v["p"]), m, k, sigma2,
                           x_norms=jnp.asarray(v["xn"]),
                           proxy_norms=jnp.asarray(v["pn"]), backend="xla",
                           strategy="gather", stream=stream, tile=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.fixture(scope="module")
def gmm_index():
    js = jgmm(2048, dim=16, num_modes=16, spread=0.05, seed=5)
    jix = jbuild_index(js, num_clusters=32)
    return js, jix, carry_index(jix)


@pytest.mark.parametrize("capacity", [True, False])
def test_ivf_screen_bf16_proxy(gmm_index, capacity):
    """The reference's indexed screen on a bf16 cluster-sorted proxy with a
    bf16-rounded proxy query; capacity mode reads no proxy row."""
    js, jix, tix = gmm_index
    qp = rounded(np.random.default_rng(9).normal(size=(6, 16)))
    p = 5
    m = p * jix.max_cluster if capacity else 60
    gp, gd = ops.ivf_screen(t32(qp), tix.proxy_sorted.to(BF),
                            tix.proxy_norms_sorted, tix.offsets,
                            tix.centroids, tix.centroid_norms, m, p,
                            tix.max_cluster)
    wp, wd = jops.ivf_screen(jnp.asarray(qp), jix.proxy_sorted.astype(
        jnp.bfloat16), jix.proxy_norms_sorted, jix.offsets, jix.centroids,
        jix.centroid_norms, m, p, jix.max_cluster, backend="xla")
    if capacity:
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    else:
        assert relerr_d2(gd.numpy(), wd) <= 1e-5
        np.testing.assert_array_equal(np.sort(gp.numpy(), -1),
                                      np.sort(np.asarray(wp), -1))


def test_ivf_probe_rounds_the_pooled_query():
    """``round_bf16``: the pooled query rounded to bf16 (norm from the
    rounded values) before the centroid distances, as the reference's
    ``_proxy_query`` rounds it; the windows equal the reference's on the
    rounded query."""
    js = jsynth.image_store(384, 16, 16, 3, seed=2)
    jix = jbuild_index(js, num_clusters=12)
    tix = carry_index(jix)
    q = np.random.default_rng(10).normal(size=(6, js.dim)).astype(np.float32)
    pr = ops.ivf_probe(t32(q), js.image_shape, 4, tix.centroids,
                       tix.centroid_norms, tix.offsets, tix.perm, tix.n, 4,
                       tix.max_cluster, round_bf16=True)
    jeng = JEngine(js, JSCH, storage_dtype=jnp.bfloat16, index=jix)
    jqp = jeng._proxy_query(jnp.asarray(q))
    assert jqp.dtype == jnp.bfloat16
    wp, wd = jops.ivf_screen(jqp, jeng._operands().proxy_sorted,
                             jix.proxy_norms_sorted, jix.offsets,
                             jix.centroids, jix.centroid_norms,
                             4 * jix.max_cluster, 4, jix.max_cluster,
                             backend="xla")
    np.testing.assert_array_equal(pr.pos.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(pr.valid.numpy(), np.isfinite(wd))
    plain = ops.ivf_probe(t32(q), js.image_shape, 4, tix.centroids,
                          tix.centroid_norms, tix.offsets, tix.perm, tix.n,
                          4, tix.max_cluster)
    qp = ref.downsample_proxy(t32(q).reshape(6, *js.image_shape), 4)
    want = ref.ivf_probe_ref(qp.to(BF).float(), tix.centroids,
                             tix.centroid_norms, tix.offsets, tix.perm,
                             tix.n, 4, tix.max_cluster)
    assert torch.equal(pr.probe, want.probe)
    assert plain.probe.shape == pr.probe.shape


# -- the engine's operands ---------------------------------------------------------

@pytest.fixture(scope="module")
def image():
    js = jsynth.image_store(384, 16, 16, 3, seed=0)
    return js, carry_store(js)


@pytest.fixture(scope="module")
def image_rounded():
    """A store whose rows are bf16 values: the fp32 master equals the rows."""
    js0 = jsynth.image_store(384, 16, 16, 3, seed=1)
    js = jmake_store(rounded(js0.X), js0.image_shape)
    return js, carry_store(js)


@pytest.fixture(scope="module")
def gmm_indexed():
    js = jgmm(4096, dim=16, num_modes=32, spread=0.05, seed=3)
    jix = jbuild_index(js, num_clusters=64)
    return js, carry_store(js), jix, carry_index(jix)


@pytest.mark.parametrize("which", ["image", "image_rounded"])
def test_operands_bf16_rows_fp32_norms(request, which):
    js, ts = request.getfixturevalue(which)
    je = JEngine(js, JSCH, storage_dtype=jnp.bfloat16)
    te = GoldDiffEngine(ts, TSCH, device="cpu", storage_dtype=BF)
    assert te.X.dtype == te.proxy.dtype == BF
    assert te.x_norms.dtype == te.proxy_norms.dtype == torch.float32
    np.testing.assert_array_equal(bits(te.X), bits(je.X))
    np.testing.assert_array_equal(bits(te.proxy), bits(je.proxy))
    np.testing.assert_array_equal(te.x_norms.numpy(), np.asarray(je.x_norms))
    np.testing.assert_array_equal(te.proxy_norms.numpy(),
                                  np.asarray(je.proxy_norms))
    # the master copy stays fp32 (the base denoiser reads it)
    assert te.store.X.dtype == torch.float32
    q = np.random.default_rng(11).normal(size=(3, js.dim)).astype(np.float32)
    tqp = te._proxy_query(t32(q))
    jqp = je._proxy_query(jnp.asarray(q))
    assert tqp.dtype == torch.float32 and jqp.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tqp.numpy(),
                                  np.asarray(jqp.astype(jnp.float32)))


def test_operands_indexed(gmm_indexed):
    js, ts, jix, tix = gmm_indexed
    je = JEngine(js, JSCH, storage_dtype=jnp.bfloat16, index=jix)
    te = GoldDiffEngine(ts, TSCH, device="cpu", storage_dtype=BF, index=tix)
    jo = je._operands()
    assert te.proxy_sorted.dtype == BF
    np.testing.assert_array_equal(bits(te.proxy_sorted),
                                  bits(jo.proxy_sorted))
    np.testing.assert_array_equal(tix.proxy_norms_sorted.numpy(),
                                  np.asarray(jo.proxy_norms_sorted))
    assert te.index.centroids.dtype == torch.float32


def test_storage_none_changes_nothing(image):
    js, ts = image
    plain = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"))
    none = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"),
                    storage_dtype=None)
    assert none.engine.X is ts.X and none.engine.proxy is ts.proxy
    x = torch.from_numpy(noisy(js.X, 500, seed=12))
    for t in (800, 300):
        assert torch.equal(none(x, t), plain(x, t))
        assert torch.equal(none.call_masked(x, t), plain.call_masked(x, t))
        assert torch.equal(none.engine.full_scan(x, t),
                           plain.engine.full_scan(x, t))


def test_unknown_storage_dtype_raises(image):
    _, ts = image
    for bad in (torch.float16, torch.float32, "bf16"):
        with pytest.raises(ValueError, match="storage_dtype"):
            GoldDiffEngine(ts, TSCH, device="cpu", storage_dtype=bad)


def test_require_rows():
    x32, xbf = torch.zeros(2, 8), torch.zeros(2, 8, dtype=BF)
    assert _build.require_rows("k", x=x32) is False
    assert _build.require_rows("k", x=xbf, p=xbf) is True
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        _build.require_rows("k", x=x32, p=xbf)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        _build.require_rows("k", x=x32.half())
    assert _build.vec4(xbf) == 1 and _build.vec4(xbf[:, 1:5]) == 0


def test_build_report_names_row_types():
    """``_build.instances`` writes a bf16-row instance's row type out."""
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1_x_cu"
        "_10radix_passI13__nv_bfloat16Lb1EEEvPKfPKT_' for 'sm_90a'",
        "ptxas info    : Used 90 registers, used 4 barriers",
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1_x_cu"
        "_10radix_passIfLb0EEEvPKfPKT_' for 'sm_90a'",
        "ptxas info    : Used 80 registers, used 4 barriers"])
    assert [n for n, *_ in _build.instances(report, "radix_pass")] == [
        "radix_pass<bf16,1>", "radix_pass<float,0>"]


@pytest.mark.parametrize("d", [1, 7, 8, 12, 3072])
def test_pad4_bf16_rows_pad_to_16_bytes(d):
    x = torch.ones(3, d, dtype=BF)
    y = gagg.pad4(x)
    assert y.dtype == BF and y.shape[1] % 8 == 0 and y.shape[1] >= d
    assert (y is x) == (d % 8 == 0)
    assert torch.equal(y[:, :d], x) and not y[:, d:].float().any()


@pytest.mark.parametrize("d", [7, 12, 49, 192, 3072])
def test_rows16_refuses_unaligned_bf16_rows(d):
    """Kernels 1 and 4 take bf16 rows only 16 bytes wide as they are (no
    per-call copy of the store); fp32 rows still pad."""
    x = torch.ones(3, d, dtype=BF)
    if d % 8:
        with pytest.raises(ValueError, match="pdist: bf16 store rows"):
            gagg.rows16("pdist", x)
    else:
        assert gagg.rows16("pdist", x) is x
    with pytest.raises(ValueError, match="multiple of 8"):
        gagg.rows16("golden_aggregate", torch.ones(4, 9, dtype=BF)[:, 1:])
    y = gagg.rows16("pdist", x.float())
    assert y.shape[1] % 4 == 0 and torch.equal(y[:, :d], x.float())


@pytest.mark.parametrize("d", [7, 192, 784, 3072, 12288])
def test_bf16_plans_fit(d):
    """The bf16 instances' shared memory: the ring and the store boxes take
    half the bytes, so kernel 4 keeps at least the fp32 ring's depth and
    kernel 1 at least its stages."""
    for b in (1, 16, 17):
        s32, s16 = gagg.cluster_shape(d), gagg.cluster_shape(d, 2)
        assert s16["smem"] <= gagg.MAX_SMEM
        assert (s16["cluster"], s16["slice"]) == (s32["cluster"],
                                                  s32["slice"])
        assert s16["stages"] >= s32["stages"]
        assert s16["smem"] == gagg.smem_bytes(s16["slice"], s16["stages"],
                                              s16["cluster"], 2)
        p32 = pdist_mod.plan(b, 50000, d)
        p16 = pdist_mod.plan(b, 50000, d, itemsize=2)
        assert p16["smem"] <= gagg.MAX_SMEM
        assert p16["stages"] >= p32["stages"]
        assert p16["smem"] <= p32["smem"] + 1024 * (d > 256)


# -- the engine's routes with bf16 rows ------------------------------------------

def noisy(store_x, t, seed, b=6):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(store_x)[rng.integers(0, store_x.shape[0], b)]
    eps = rng.normal(size=x0.shape)
    return (TSCH.a[t] * x0 + TSCH.b[t] * eps).astype(np.float32)


ROUTES = {
    "staged": (dict(strategy="gather", screen="materialized", fused=False),
               dict(screen="materialized", fused=False)),
    "fused": (dict(fused=True), dict(fused=True)),
    "streamed": (dict(strategy="gather", screen="streamed", fused=False),
                 dict(screen="streamed", fused=False)),
}


def pair(js, ts, jkw, tkw, cfg=None, storage=True):
    cfg = cfg or {}
    j = JGoldDiff(JOptimal(js, JSCH), JConfig(**cfg),
                  storage_dtype=jnp.bfloat16 if storage else None, **jkw)
    t = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"),
                 GoldDiffConfig(**cfg), storage_dtype=BF if storage else None,
                 **tkw)
    return j, t


def indexed_pair(gmm_indexed, storage=True):
    js, ts, jix, tix = gmm_indexed
    return pair(js, ts, dict(index=jix, index_mode="always",
                             strategy="gather"),
                dict(index=tix, index_mode="always"), INDEXED_FRACS,
                storage)


def route_pair(request, route, storage=True):
    if route == "indexed":
        return indexed_pair(request.getfixturevalue("gmm_indexed"), storage)
    js, ts = request.getfixturevalue("image")
    return pair(js, ts, *ROUTES[route], storage=storage)


def store_x(request, route):
    which = "gmm_indexed" if route == "indexed" else "image"
    return request.getfixturevalue(which)[0].X


@pytest.mark.parametrize("t", [800, 300])
@pytest.mark.parametrize("route", ["staged", "fused", "streamed", "indexed"])
def test_static_step_bf16(request, route, t):
    j, tg = route_pair(request, route)
    assert tg.engine.use_fused(t) == (route == "fused")
    assert tg.engine.use_index(t) == (route == "indexed")
    x = noisy(store_x(request, route), t, seed=t)
    got = tg(torch.from_numpy(x), t)
    want = np.asarray(j(jnp.asarray(x), t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the golden sets, up to near-ties of the exact (fp32) distances
    q = x / np.float32(TSCH.a[t])
    xs = np.asarray(jnp.asarray(j.engine.X, jnp.float32))
    d2 = ((q[:, None, :] - xs[None]) ** 2).sum(-1)
    near_tie_sets(tg.select(torch.from_numpy(x), t).numpy(),
                  np.asarray(j.select(jnp.asarray(x), t)), d2,
                  (q * q).sum(-1))
    # against the fp32 step: the reference's own bf16 bound
    _, t32_ = route_pair(request, route, storage=False)
    np.testing.assert_allclose(got.numpy(),
                               t32_(torch.from_numpy(x), t).numpy(),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("route", ["staged", "fused", "indexed"])
def test_call_masked_bf16(request, route):
    j, tg = route_pair(request, route)
    _, t32_ = route_pair(request, route, storage=False)
    x = noisy(store_x(request, route), 500, seed=21)
    for t in (900, 400, 50):
        got = tg.call_masked(torch.from_numpy(x), t)
        want = np.asarray(j.call_masked(jnp.asarray(x), jnp.asarray(t)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            got.numpy(), t32_.call_masked(torch.from_numpy(x), t).numpy(),
            rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("which", ["image", "image_rounded"])
@pytest.mark.parametrize("t", [800, 300, 20])
def test_full_scan_bf16(request, which, t):
    js, ts = request.getfixturevalue(which)
    je = JEngine(js, JSCH, storage_dtype=jnp.bfloat16)
    te = GoldDiffEngine(ts, TSCH, device="cpu", storage_dtype=BF)
    x = noisy(js.X, t, seed=t + 1)
    got = te.full_scan(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(je.full_scan(jnp.asarray(x), t)),
                               rtol=0, atol=1e-4)


def x_T(dim, seed, b=4):
    return (float(TSCH.b[1000]) * np.random.default_rng(seed).normal(
        size=(b, dim))).astype(np.float32)


@pytest.mark.parametrize("route", ["staged", "fused", "indexed"])
def test_trajectory_bf16(request, route):
    """10 DDIM steps from the reference's x_T, static mode."""
    j, tg = route_pair(request, route)
    x0 = x_T(tg.store.dim, 13)
    want = np.asarray(jsample(j, JSCH, x0.shape, jax.random.PRNGKey(0),
                              num_steps=10, x_init=jnp.asarray(x0)))
    got = sample(tg, TSCH, x0.shape, num_steps=10,
                 x_init=torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("route", ["fused", "indexed"])
def test_sample_plan_bf16(request, route):
    """The plan-mode trajectory (one masked segment a plan bucket)."""
    j, tg = route_pair(request, route)
    x0 = x_T(tg.store.dim, 14)
    want = np.asarray(jsample_plan(
        j.call_masked, JSCH, x0.shape, jax.random.PRNGKey(0),
        jplan.build_plan(j.engine, 10), x_init=jnp.asarray(x0),
        program_cache=j.engine.program))
    plan = build_plan(tg.engine, 10)
    got = sample_plan(tg.call_masked, TSCH, x0.shape, plan,
                      x_init=torch.from_numpy(x0),
                      program_cache=tg.engine.program,
                      jitter=tg.engine.jitter).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    static = sample(tg, TSCH, x0.shape, num_steps=10,
                    x_init=torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, static, rtol=1e-3, atol=1e-3)


def test_patch_base_reads_fp32_store(image):
    """GoldDiff over a patch base: the engine's bf16 selection, then the
    base's own fp32 store on the support (as the reference)."""
    from repro_torch.core import PCADenoiser
    js, ts = image
    base = PCADenoiser(ts, TSCH, rank=4, device="cpu")
    gd = GoldDiff(base, storage_dtype=BF)
    x = torch.from_numpy(noisy(js.X, 400, seed=15))
    sup = gd.select(x, 400)
    assert base.store.X.dtype == torch.float32
    assert torch.equal(gd(x, 400), base(x, 400, support=sup))


# -- strategy= (the reference's tests/test_index.py and test_fused_step.py) -----

def test_engine_strategy_selection(image):
    js, ts = image
    for s in ("gather", "dense"):
        assert GoldDiffEngine(ts, TSCH, device="cpu",
                              strategy=s).strategy == s
    eng = GoldDiffEngine(ts, TSCH, device="cpu")
    frac = eng.cfg.sizes(ts.n)[1] / ts.n
    assert eng.strategy == ("gather" if frac <= eng.crossover_frac
                            else "dense")
    assert eng.crossover_frac == engine_mod.GATHER_CROSSOVER_FRAC["cpu"]
    for storage in (None, BF):
        m = GoldDiffEngine(ts, TSCH, device="cpu", strategy="measure",
                           storage_dtype=storage)
        assert 0.0 < m.crossover_frac <= 1.0
        assert m.strategy in ("gather", "dense")
        assert m.strategy == ("gather" if frac <= m.crossover_frac
                              else "dense")
    # the reference agrees on the rule for the explicit and auto cases
    for s in ("gather", "dense", "auto"):
        assert JEngine(js, JSCH, strategy=s).strategy == GoldDiffEngine(
            ts, TSCH, device="cpu", strategy=s).strategy
    with pytest.raises(ValueError, match="strategy"):
        GoldDiffEngine(ts, TSCH, device="cpu", strategy="bogus")
    with pytest.raises(ValueError, match="strategy"):
        GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"), strategy="fast")


def test_measure_crossover_clip():
    """The reference's formula: (t_dense / t_gather) (rows / N), clipped to
    [1e-3, 1]; rows above N probe every row."""
    st = make_dataset("gmm", n=300, dim=8, seed=1, device="cpu")
    frac = engine_mod.measure_crossover(st.X, st.x_norms, rows=5000)
    assert 1e-3 <= frac <= 1.0
    frac = engine_mod.measure_crossover(st.X.to(BF), st.x_norms, batch=2,
                                        rows=16, repeats=1)
    assert 1e-3 <= frac <= 1.0


def test_fused_policy():
    """``use_fused``: False never fuses, True always, auto fuses the
    dense-strategy steps (the reference's tests/test_fused_step.py)."""
    st = make_dataset("gmm", n=512, dim=16, seed=0, device="cpu")
    dense = GoldDiffEngine(st, TSCH, device="cpu", strategy="dense")
    gather = GoldDiffEngine(st, TSCH, device="cpu", strategy="gather")
    t = 500
    assert dense.use_fused(t)
    assert not gather.use_fused(t)
    assert GoldDiffEngine(st, TSCH, device="cpu", strategy="gather",
                          fused=True).use_fused(t)
    assert not GoldDiffEngine(st, TSCH, device="cpu", strategy="dense",
                              fused=False).use_fused(t)
    assert gather._fused_masked(False) is False
    assert dense._fused_masked(False) is True
    with pytest.raises(ValueError, match="fused"):
        GoldDiffEngine(st, TSCH, device="cpu", fused="yes")
