"""The port's GoldDiff engine, denoiser and sampler against the JAX
package on a tiny image store (CPU tensors, plain kernel versions).

The reference is the JAX engine on its ``xla`` backend with the
port's path fixed: gather strategy, materialized screen, staged steps.
Both packages share the store's arrays (``store_from_numpy``) and the
terminal noise (``x_init``).  Tolerances: golden sets equal up to
near-ties (rows whose JAX distances differ by < 1e-6 of ||q||^2);
posterior means 1e-4 (fp32 reduction order); a 10-step trajectory 1e-3
(the per-step differences compound through DDIM)."""
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
from repro_torch.core import (GoldDiff, GoldDiffEngine,  # noqa: E402
                              OptimalDenoiser, make_schedule, sample,
                              sampling_timesteps, store_from_numpy)

REF_ENGINE = dict(strategy="gather", screen="materialized", fused=False)


@pytest.fixture(scope="module")
def setup():
    js = jsynth.image_store(384, 16, 16, 3, seed=0)
    ts = store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                          js.image_shape, device="cpu")
    jsched = jmake_schedule("ddpm_linear", 1000)
    tsched = make_schedule("ddpm_linear", 1000)
    jgd = JGoldDiff(JOptimal(js, jsched), **REF_ENGINE)
    tgd = GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"),
                   screen="materialized", fused=False)
    return js, ts, jsched, tsched, jgd, tgd


def noisy(store_x, sched, t, seed, b=6):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(store_x)[rng.integers(0, store_x.shape[0], b)]
    eps = rng.normal(size=x0.shape)
    return (sched.a[t] * x0 + sched.b[t] * eps).astype(np.float32)


def assert_sets_equal_up_to_near_ties(tidx, jidx, q, x):
    """Equal golden sets, or differences only where the two rows' JAX
    distances differ by less than 1e-6 of ||q||^2."""
    for b in range(tidx.shape[0]):
        diff = np.nonzero(tidx[b] != jidx[b])[0]
        if diff.size == 0:
            continue
        d = np.asarray(jax.vmap(lambda r: jnp.sum((q[b] - x[r]) ** 2))(
            jnp.asarray(np.concatenate([tidx[b, diff], jidx[b, diff]]))))
        gap = np.abs(d[: diff.size] - d[diff.size:])
        assert (gap < 1e-6 * float(np.sum(q[b] ** 2))).all(), (b, diff, gap)


def test_engine_select_every_step(setup):
    js, ts, jsched, tsched, jgd, tgd = setup
    for i, t in enumerate(sampling_timesteps(tsched, 10)[:-1]):
        t = int(t)
        x_t = noisy(js.X, tsched, t, seed=i)
        jidx = np.asarray(jgd.engine.select(jnp.asarray(x_t), t))
        tidx = tgd.select(torch.from_numpy(x_t), t).numpy()
        assert tidx.shape == jidx.shape == (6, tgd.engine.sizes(t)[1])
        q = x_t / np.float32(tsched.a[t])
        assert_sets_equal_up_to_near_ties(tidx, jidx, q, np.asarray(js.X))


@pytest.mark.parametrize("t", [999, 600, 200, 20])
def test_engine_denoise_and_full_scan(setup, t):
    js, ts, jsched, tsched, jgd, tgd = setup
    x_t = noisy(js.X, tsched, t, seed=t)
    eng = tgd.engine
    np.testing.assert_allclose(
        eng.denoise(torch.from_numpy(x_t), t).numpy(),
        np.asarray(jgd.engine.denoise(jnp.asarray(x_t), t)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        eng.full_scan(torch.from_numpy(x_t), t).numpy(),
        np.asarray(jgd.engine.full_scan(jnp.asarray(x_t), t)),
        rtol=1e-4, atol=1e-4)


def test_optimal_support_path(setup):
    js, ts, jsched, tsched, jgd, tgd = setup
    t = 400
    x_t = noisy(js.X, tsched, t, seed=11)
    idx = np.random.default_rng(5).integers(0, 384, size=(6, 30))
    want = np.asarray(jgd.base(jnp.asarray(x_t), t, support=jnp.asarray(idx)))
    got = tgd(torch.from_numpy(x_t), t, support=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_whole_slice_trajectory(setup, eta):
    """sample(GoldDiff(OptimalDenoiser)) from the same x_T (and, for
    eta > 0, the JAX sampler's own per-step noise handed to the port)."""
    js, ts, jsched, tsched, jgd, tgd = setup
    shape = (4, js.dim)
    key = jax.random.PRNGKey(7)
    x_T = np.array(float(jsched.b[1000]) * jax.random.normal(
        jax.random.PRNGKey(1), shape))
    rng, _ = jax.random.split(key)
    noise = []
    for _ in range(10):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape))))
    want = np.asarray(jsample(jgd, jsched, shape, key, num_steps=10,
                              eta=eta, x_init=jnp.asarray(x_T)))
    got = sample(tgd, tsched, shape, num_steps=10, eta=eta,
                 x_init=torch.from_numpy(x_T), noise=noise).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_engine_rejects_unported_base_and_defaults_to_card(setup, monkeypatch):
    js, ts, jsched, tsched, jgd, tgd = setup
    # every base of make_denoiser wraps (tests/test_torch_golddiff.py);
    # an object that is no denoiser (it has no store) is refused, as the
    # reference refuses it
    with pytest.raises(AttributeError, match="store"):
        GoldDiff(object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GoldDiffEngine(ts, tsched)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OptimalDenoiser(ts, tsched)
