"""The port's plain kernel versions (``repro_torch.kernels.ref`` through
``ops`` on CPU tensors) against the JAX package.

Integer-valued data makes every fp32 sum exact, so distances, top-m
candidate sets and top-k golden sets must be bit-equal, tie order
included (``tests/test_screen.py``'s device).  Float data agrees to
fp32 reduction order: 1e-5 relative on distances, 1e-5 absolute on
means of O(1) rows.  One tiny case per kernel also runs the JAX side's
Pallas kernel in interpret mode."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import golden_aggregate as tagg_mod  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pdist as tpdist_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def ints(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("b,n,d,m", [(5, 300, 12, 40), (3, 50, 7, 64),
                                     (4, 257, 16, 257)])
def test_screen_bit_equal_on_integer_data(b, n, d, m):
    """pdist + materialized top-m: bit-equal distances, candidate sets
    in lax.top_k's order (integer data forces many ties), and the
    m > N surplus slots (d2=+inf, index 0)."""
    rng = np.random.default_rng(n + m)
    q, x = ints(rng, (b, d)), ints(rng, (n, d))
    jd2 = np.asarray(jref.pdist_ref(jnp.asarray(q), jnp.asarray(x)))
    td2 = tops.pdist(t(q), t(x)).numpy()
    np.testing.assert_array_equal(td2, jd2)
    jidx, jv = jref.screen_topm_ref(jnp.asarray(q), jnp.asarray(x), m)
    tidx, tv = tops.screen_topm(t(q), t(x), m)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if m > n:
        assert np.isinf(tv.numpy()[:, n:]).all()
        assert (tidx.numpy()[:, n:] == 0).all()


@pytest.mark.parametrize("b,n,d,m,k", [(4, 200, 24, 60, 20),
                                       (3, 90, 10, 90, 45)])
def test_rerank_bit_equal_on_integer_data(b, n, d, m, k):
    """support distances and the re-rank top-k, tie order included,
    against the JAX gather strategy."""
    rng = np.random.default_rng(k)
    q, x = ints(rng, (b, d)), ints(rng, (n, d))
    xn = (x * x).sum(-1)
    cand = np.stack([rng.permutation(n)[:m] for _ in range(b)])
    jd2 = np.asarray(jops.support_distances(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(cand), jnp.asarray(xn),
        backend="xla", strategy="gather"))
    td2 = tops.support_distances(t(q), t(x), t(cand), t(xn)).numpy()
    np.testing.assert_array_equal(td2, jd2)
    jidx, jv = jops.golden_rerank(jnp.asarray(q), jnp.asarray(x),
                                  jnp.asarray(cand), k, jnp.asarray(xn),
                                  backend="xla", strategy="gather")
    tidx, tv = tops.golden_rerank(t(q), t(x), t(cand), k, t(xn))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_distances_float_data():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 48)).astype(np.float32)
    x = rng.normal(size=(333, 48)).astype(np.float32)
    xn = (x * x).sum(-1)
    jd2 = np.asarray(jref.pdist_ref(jnp.asarray(q), jnp.asarray(x),
                                    x_norms=jnp.asarray(xn)))
    np.testing.assert_allclose(tops.pdist(t(q), t(x), x_norms=t(xn)).numpy(),
                               jd2, rtol=1e-5)
    cand = rng.integers(0, 333, size=(6, 50))
    js = np.asarray(jref.support_sqdist_ref(jnp.asarray(q),
                                            jnp.asarray(x[cand]),
                                            jnp.asarray(xn[cand])))
    np.testing.assert_allclose(
        tops.support_distances(t(q), t(x), t(cand), t(xn)).numpy(), js,
        rtol=1e-5)


def test_support_aggregate_masked_rows():
    """NEG_INF-masked slots get zero weight; an all-masked query is the
    uniform mean of its rows; duplicates count twice."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 20)).astype(np.float32)
    idx = rng.integers(0, 64, size=(3, 9))
    idx[0, 1] = idx[0, 0]
    lg = rng.normal(size=(3, 9)).astype(np.float32)
    lg[1, ::2] = tref.NEG_INF
    lg[2, :] = tref.NEG_INF
    want = np.asarray(jref.golden_support_aggregate_ref(
        jnp.asarray(x[idx]), jnp.asarray(lg)))
    got = tops.golden_support_aggregate(t(x), t(idx), t(lg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], x[idx[2]].mean(0), atol=1e-5)
    sub = x[idx[1, 1::2]]
    w = np.exp(lg[1, 1::2] - lg[1, 1::2].max())
    np.testing.assert_allclose(got[1], (w / w.sum()) @ sub, atol=1e-5)


@pytest.mark.parametrize("sigma2", [0.25, 4.0, 1e6, 0.0, -1.0, 1e-45,
                                    float("nan")])
def test_full_scan_matches_and_stays_finite(sigma2):
    """golden_aggregate_ref against JAX, and the finite-guard contract
    (tests/test_finite_guards.py): degenerate sigma2 clamps every logit,
    giving the data mean, never NaN."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(128, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    xn = (x * x).sum(-1)
    want = np.asarray(jref.golden_aggregate_ref(jnp.asarray(q),
                                                jnp.asarray(x), sigma2,
                                                jnp.asarray(xn)))
    got = tops.golden_aggregate(t(q), t(x), sigma2, t(xn)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not sigma2 > 1e-40:
        np.testing.assert_allclose(got, np.tile(x.mean(0), (3, 1)),
                                   atol=1e-4)
    assert tref.finite_inv_two_sigma2(sigma2) == \
        jref.finite_inv_two_sigma2(sigma2)


def test_pallas_interpret_kernels_match_plain_versions():
    """One tiny case per kernel, the JAX side's Pallas kernel run in
    interpret mode, against the port's plain versions."""
    rng = np.random.default_rng(3)
    b, n, d, m = 3, 70, 16, 12
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    xn = (x * x).sum(-1)
    idx = rng.integers(0, n, size=(b, m))
    lg = rng.normal(size=(b, m)).astype(np.float32)
    be = "pallas_interpret"
    jq, jx, jxn = jnp.asarray(q), jnp.asarray(x), jnp.asarray(xn)
    np.testing.assert_allclose(
        tops.pdist(t(q), t(x), x_norms=t(xn)).numpy(),
        np.asarray(jops.pdist(jq, jx, x_norms=jxn, backend=be)), rtol=1e-5)
    np.testing.assert_allclose(
        tops.support_distances(t(q), t(x), t(idx), t(xn)).numpy(),
        np.asarray(jops.support_sqdist(jq, jx[idx], jxn[idx], backend=be)),
        rtol=1e-5)
    np.testing.assert_allclose(
        tops.golden_support_aggregate(t(x), t(idx), t(lg)).numpy(),
        np.asarray(jops.golden_support_aggregate(
            jx, jnp.asarray(idx), jnp.asarray(lg), backend=be)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tops.golden_aggregate(t(q), t(x), 0.5, t(xn)).numpy(),
        np.asarray(jops.golden_aggregate(jq, jx, 0.5, x_norms=jxn,
                                         backend=be)),
        rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a kernel wrapper raises before building or
    launching anything (ops routes CPU tensors to the plain versions)."""
    q, x = torch.zeros(2, 4), torch.zeros(5, 4)
    before = tpdist_mod.pdist.launches
    with pytest.raises(ValueError, match="CUDA"):
        tpdist_mod.pdist(q, x, torch.zeros(2), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        tagg_mod.golden_aggregate(q, x, 0.5, torch.zeros(5))
    assert tpdist_mod.pdist.launches == before


def test_build_report_instances():
    """``_build.instances`` reads each kernel instance's registers,
    static shared memory and spills out of an ``-Xptxas -v`` report, its
    template arguments written out."""
    from repro_torch.kernels import _build
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1_x_cu"
        "_17flash_sm90_kernelILi3ELi128EEEv14CUtensorMap_stS1_' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN56_GLOBAL__N_x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1_x_cu"
        "_11gattn_splitILi64ELi4ELb1EEEvPKv' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 147 registers, used 1 barriers, 4352 bytes "
        "smem",
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__1_x_cu"
        "_11gattn_mergeEPKfPviiii' for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert _build.instances(report, "flash_sm90_kernel") == [
        ("flash_sm90_kernel<3,128>", 128, "0 bytes static smem",
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    got = _build.instances(report, "gattn_")
    assert [(n, r, m) for n, r, m, _ in got] == [
        ("gattn_split<64,4,1>", 147, "4352 bytes static smem"),
        ("gattn_merge", 32, "0 bytes static smem")]
    assert got[0][3].startswith("8 bytes stack frame, 4 bytes spill")
    assert got[1][3] == ""
