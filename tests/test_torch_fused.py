"""The port's fused single-pass GoldDiff step against the JAX package (CPU
tensors, plain versions).

``fused_candidates_scan`` is held against the reference's Pallas kernel
in interpret mode (``fused_candidates_pallas``): on integer-valued data
the candidate indices, their order and the carried exact distances are
bit-equal, ties, ragged N, m > N and +inf rows included.  The step
(``ops.fused_step``) and whole trajectories are held against the
reference on its ``pallas_interpret`` backend.  Tolerances: float
indices equal and distances within 1e-5 relative (fp32 reduction
order); posterior means within 1e-4 absolute; a 10-step trajectory
within 1e-3 (per-step differences compound through DDIM)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GoldDiff as JGoldDiff  # noqa: E402
from repro.core import OptimalDenoiser as JOptimal  # noqa: E402
from repro.core import make_schedule as jmake_schedule  # noqa: E402
from repro.core import sample as jsample  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fused_step import fused_candidates_pallas  # noqa: E402
from repro.kernels.fused_step import fused_posterior as jposterior  # noqa: E402
from repro_torch.core import (GoldDiff, OptimalDenoiser,  # noqa: E402
                              make_schedule, sample, store_from_numpy)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.fused_step import (  # noqa: E402
    fused_candidates_scan, fused_posterior)
from repro_torch.launch.serve import Request, ServeEngine, main  # noqa: E402

DIST_RTOL = 1e-5     # fp32 reduction order of the distance dot products
MEAN_ATOL = 1e-4     # fp32 reduction order of the softmax-weighted means
TRAJ_TOL = 1e-3      # 10 DDIM steps compound the per-step differences


def ints(rng, shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def operands(rng, b, n, dp, d, make=ints):
    return make(rng, (b, dp)), make(rng, (b, d)), make(rng, (n, dp)), \
        make(rng, (n, d))


def pallas(qp, q, proxy, x, m, pn=None, xn=None, tile=16):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    idx, d2 = fused_candidates_pallas(
        jnp.asarray(qp), jnp.asarray(q), jnp.asarray(proxy), jnp.asarray(x),
        m, opt(pn), opt(xn), bn=tile, interpret=True)
    return np.asarray(idx), np.asarray(d2)


def scan(qp, q, proxy, x, m, pn=None, xn=None, tile=16):
    opt = lambda a: None if a is None else t(a)  # noqa: E731
    idx, d2 = fused_candidates_scan(t(qp), t(q), t(proxy), t(x), m,
                                    opt(pn), opt(xn), tile=tile)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("b,n,dp,d,m,tile", [
    (5, 300, 8, 24, 40, 64),       # several tiles
    (4, 257, 6, 20, 30, 64),       # ragged N: N % tile != 0
    (3, 50, 4, 12, 64, 16),        # m > N: surplus slots
    (2, 40, 4, 10, 1, 8),          # m == 1
    (6, 120, 5, 16, 100, 32),      # m spans several tiles
])
def test_scan_bit_equal_to_pallas_on_integer_data(b, n, dp, d, m, tile):
    rng = np.random.default_rng(n + m)
    qp, q, proxy, x = operands(rng, b, n, dp, d)
    si, sd = scan(qp, q, proxy, x, m, tile=tile)
    pi, pd = pallas(qp, q, proxy, x, m, tile=tile)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    # the candidate list is the streamed screen's, in its order
    ci, _ = tops.screen_topm(t(qp), t(proxy), m, stream=True, tile=tile)
    np.testing.assert_array_equal(si, ci.numpy())
    if m > n:
        assert (si[:, n:] == 0).all() and np.isinf(sd[:, n:]).all()


def test_all_tied_proxy_lowest_index_first():
    """Every proxy distance equal: the m lowest rows, in order, each with
    its own exact distance."""
    rng = np.random.default_rng(9)
    qp, proxy = np.zeros((2, 4), np.float32), np.ones((40, 4), np.float32)
    q, x = ints(rng, (2, 12)), ints(rng, (40, 12))
    si, sd = scan(qp, q, proxy, x, 12, tile=8)
    pi, pd = pallas(qp, q, proxy, x, 12, tile=8)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    np.testing.assert_array_equal(si, np.tile(np.arange(12), (2, 1)))
    want = ((q[:, None, :] - x[None, :12, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(sd, want)


@pytest.mark.parametrize("m", [40, 49, 64])
def test_inf_rows_pinned_to_pallas(m):
    """+inf proxy norms: the row never takes a slot (index 0, exact
    +inf); a +inf exact norm on a screened row carries +inf exactly."""
    rng = np.random.default_rng(m)
    qp, q, proxy, x = operands(rng, 3, 50, 6, 16)
    pn, xn = (proxy * proxy).sum(-1), (x * x).sum(-1)
    pn[[3, 10, 49]] = np.inf
    xn[7] = np.inf
    si, sd = scan(qp, q, proxy, x, m, pn, xn)
    pi, pd = pallas(qp, q, proxy, x, m, pn, xn)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    assert not np.isin(si[np.isfinite(sd)], [3, 10, 49]).any()
    assert np.isinf(sd[si == 7]).all()


def test_float_data_indices_equal_distances_close():
    rng = np.random.default_rng(1)
    norm = lambda r, s: r.normal(size=s).astype(np.float32)  # noqa: E731
    qp, q, proxy, x = operands(rng, 6, 1500, 12, 48, make=norm)
    si, sd = scan(qp, q, proxy, x, 100, tile=256)
    pi, pd = pallas(qp, q, proxy, x, 100, tile=256)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_allclose(sd, pd, rtol=DIST_RTOL, atol=DIST_RTOL)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("m,k", [(60, 20), (300, 150), (333, 40)])
def test_fused_step_matches_reference_pallas(stream, m, k):
    """ops.fused_step (carry loop, or the materialized form) against the
    reference's ops.fused_step on its interpret-mode kernels; m=333 > N
    leaves surplus slots that must get no weight."""
    rng = np.random.default_rng(m + k)
    norm = lambda r, s: r.normal(size=s).astype(np.float32)  # noqa: E731
    qp, q, proxy, x = operands(rng, 4, 300, 12, 48, make=norm)
    sigma2 = 3.0
    want = np.asarray(jops.fused_step(
        jnp.asarray(q), jnp.asarray(qp), jnp.asarray(x), jnp.asarray(proxy),
        m, k, sigma2, backend="pallas_interpret", tile=64))
    got = tops.fused_step(t(q), t(qp), t(x), t(proxy), m, k, sigma2,
                          stream=stream, tile=64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_ATOL)


def test_fused_posterior_matches_reference():
    """Top-k inside the candidates (ties to the lowest slot), clamped
    logits with +inf slots at NEG_INF, and the aggregate."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(80, 16)).astype(np.float32)
    idx = rng.integers(0, 80, size=(3, 30))
    d2 = rng.integers(0, 6, size=(3, 30)).astype(np.float32)  # many ties
    d2[0, 5:] = np.inf
    want = np.asarray(jposterior(jnp.asarray(x), jnp.asarray(idx),
                                 jnp.asarray(d2), 10, 0.7))
    got = fused_posterior(t(x), t(idx), t(d2), 10, 0.7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MEAN_ATOL)


# -- the engine's fused route --------------------------------------------------

@pytest.fixture(scope="module")
def stores():
    js = jsynth.image_store(256, 16, 16, 3, seed=3)
    ts = store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                          js.image_shape, device="cpu")
    return js, ts, jmake_schedule("ddpm_linear", 1000), \
        make_schedule("ddpm_linear", 1000)


@pytest.mark.parametrize("screen", ["streamed", "materialized"])
def test_fused_trajectory_matches_reference_pallas(stores, screen):
    """sample(GoldDiff(fused=True)) against the reference's fused route on
    its Pallas kernels in interpret mode, from its x_T."""
    js, ts, jsched, tsched = stores
    shape = (3, js.dim)
    x_T = np.array(float(jsched.b[1000]) * jax.random.normal(
        jax.random.PRNGKey(6), shape))
    jgd = JGoldDiff(JOptimal(js, jsched), backend="pallas_interpret",
                    fused=True)
    tgd = GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"), fused=True,
                   screen=screen)
    assert tgd.engine.use_fused(999)
    want = np.asarray(jsample(jgd, jsched, shape, jax.random.PRNGKey(0),
                              num_steps=10, x_init=jnp.asarray(x_T)))
    got = sample(tgd, tsched, shape, num_steps=10,
                 x_init=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


def test_fused_step_equals_staged_step(stores):
    """Fused and staged bodies agree to fp32 reduction order."""
    js, ts, jsched, tsched = stores
    rng = np.random.default_rng(2)
    x_t = torch.from_numpy(rng.normal(size=(4, js.dim)).astype(np.float32))
    fused = GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"), fused=True)
    staged = GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"), fused=False)
    for step in (999, 500, 20):
        np.testing.assert_allclose(fused(x_t, step).numpy(),
                                   staged(x_t, step).numpy(), rtol=0,
                                   atol=MEAN_ATOL)


def test_serve_fused_on_cpu(stores, capsys):
    js, ts, jsched, tsched = stores
    eng = ServeEngine(ts, num_steps=3, max_batch=2, device="cpu", fused=True)
    assert eng.engine.use_fused(0)
    out = eng.serve([Request(0, 3, seed=1)])[0].images
    assert out.shape == (3, 16, 16, 3) and np.isfinite(out).all()
    staged = ServeEngine(ts, num_steps=3, max_batch=2, device="cpu",
                         fused=False)
    np.testing.assert_allclose(
        staged.serve([Request(0, 3, seed=1)])[0].images, out, rtol=0,
        atol=TRAJ_TOL)
    main(["--n", "64", "--requests", "1", "--batch", "2", "--steps", "3",
          "--device", "cpu", "--fused", "on"])
    printed = capsys.readouterr().out
    assert "fused steps: True" in printed and "finite=True" in printed
