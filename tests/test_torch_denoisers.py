"""The port's four denoisers and four schedules against the JAX package.

Both packages get the same store arrays (``store_from_numpy``) and the
same numpy-seeded queries, supports and masks.  Tolerances: schedule
grids (``a``, ``b``) and sampling timesteps bit-equal; the PCA basis
bit-equal (the same numpy draws and SVD on the same patches); features
within 1e-5 relative (convolution sum order); every denoiser call within
1e-4 max abs (fp32 reduction order).  The properties the reference's own
``tests/test_denoisers.py`` pins are pinned on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import denoisers as jden  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch.core import denoisers as tden  # noqa: E402
from repro_torch.core import (DENOISERS, make_denoiser,  # noqa: E402
                              make_schedule, sampling_timesteps,
                              store_from_numpy)
from repro_torch.core.dataset import make_store  # noqa: E402

ATOL = 1e-4
JSCH = jsched.make_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)
STORES = {"mnist": lambda: jsynth.mnist_like(128, seed=0),
          "cifar": lambda: jsynth.cifar_like(256, seed=1),
          "gmm": lambda: jsynth.gmm(2048, dim=8, seed=0)}


@pytest.fixture(scope="module")
def stores():
    out = {}
    for name, build in STORES.items():
        js = build()
        out[name] = (js, store_from_numpy(js.X, js.proxy, js.x_norms,
                                          js.proxy_norms, js.image_shape,
                                          device="cpu"))
    return out


def _queries(seed, b, d):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _noisy(store, seed, b, t):
    """x_t = a_t x_0 + b_t eps from ``b`` store rows: the inputs a sampler
    gives a denoiser (random points far from the data make the sharp
    posteriors of small t ill-conditioned in fp32)."""
    rng = np.random.default_rng(seed)
    x0 = store.X.numpy()[rng.choice(store.n, b, replace=False)]
    eps = rng.normal(size=x0.shape)
    return (float(TSCH.a[t]) * x0 + float(TSCH.b[t]) * eps).astype(np.float32)


def _support(seed, b, n, k):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b)])
    mask = rng.random((b, k)) < 0.7
    mask[:, 0] = True
    return idx, mask


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _call(den, x, t, idx=None, mask=None, torch_side=False):
    if torch_side:
        cv = torch.from_numpy
    else:
        cv = jnp.asarray
    if idx is None:
        return den(cv(x), t)
    if mask is None:
        return den(cv(x), t, support=cv(idx))
    return den._on_support(cv(x), t, cv(idx), cv(mask)) \
        if isinstance(den, (jden.OptimalDenoiser, tden.OptimalDenoiser)) \
        else den(cv(x), t, support=cv(idx), mask=cv(mask))


# -- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["ddpm_linear", "cosine", "edm_vp",
                                  "edm_ve"])
@pytest.mark.parametrize("steps", [256, 1000])
def test_schedule_grids_bit_equal(name, steps):
    js, ts = jsched.make_schedule(name, steps), make_schedule(name, steps)
    assert ts.name == js.name and ts.num_steps == steps
    np.testing.assert_array_equal(ts.a, js.a)
    np.testing.assert_array_equal(ts.b, js.b)
    for n_samp in (10, 25):
        np.testing.assert_array_equal(sampling_timesteps(ts, n_samp),
                                      jsched.sampling_timesteps(js, n_samp))
    t = torch.tensor([1, steps // 3, steps // 2, steps])
    np.testing.assert_array_equal(ts.sigma(t).numpy(),
                                  np.asarray(js.sigma(jnp.asarray(t.numpy()))))
    np.testing.assert_allclose(ts.g(t).numpy(),
                               np.asarray(js.g(jnp.asarray(t.numpy()))),
                               rtol=0, atol=1e-6)
    for ti in (1, steps // 2, steps):
        assert ts.g_np(ti) == js.g_np(ti)
    # sigma increases, g runs 0 -> 1 (the reference's consistency test)
    sig = ts.sigma(torch.tensor([1, steps // 2, steps])).numpy()
    g = ts.g(torch.tensor([1, steps // 2, steps])).numpy()
    assert np.all(np.diff(sig) > 0) and g[0] == 0.0 and g[2] == 1.0


@pytest.mark.parametrize("name", ["cosine", "edm_ve"])
def test_add_noise_matches(name):
    js, ts = jsched.make_schedule(name, 1000), make_schedule(name, 1000)
    rng = np.random.default_rng(1)
    x0, eps = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
    tt = np.array([10, 500, 999])
    for t in (700, tt):
        want = js.add_noise(jnp.asarray(x0), jnp.asarray(eps),
                            jnp.asarray(t) if np.ndim(t) else t)
        got = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(eps),
                           torch.from_numpy(t) if np.ndim(t) else t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# -- Optimal and Wiener ------------------------------------------------------

@pytest.mark.parametrize("store", ["gmm", "cifar"])
@pytest.mark.parametrize("weighting", ["ss", "wss"])
def test_optimal_matches(stores, store, weighting):
    js, ts = stores[store]
    jd = jden.OptimalDenoiser(js, JSCH, chunk=100, weighting=weighting)
    td = tden.OptimalDenoiser(ts, TSCH, chunk=100, weighting=weighting,
                              device="cpu")
    idx, mask = _support(4, 4, ts.n, 37)
    for t in (900, 300, 20):
        x = _noisy(ts, 3, 4, t)
        want = np.asarray(jd.logits(jnp.asarray(x), t))
        _close(td.logits(torch.from_numpy(x), t), want,
               atol=1e-5 * np.abs(want).max())
        _close(_call(td, x, t, torch_side=True), _call(jd, x, t))
        _close(_call(td, x, t, idx, torch_side=True), _call(jd, x, t, idx))
        _close(_call(td, x, t, idx, mask, torch_side=True),
               _call(jd, x, t, idx, mask))


@pytest.mark.parametrize("store,rank", [("gmm", None), ("gmm", 3),
                                        ("cifar", 32)])
def test_wiener_matches(stores, store, rank):
    js, ts = stores[store]
    jd = jden.WienerDenoiser(js, JSCH, rank=rank)
    td = tden.WienerDenoiser(ts, TSCH, rank=rank, device="cpu")
    np.testing.assert_array_equal(td.V.numpy(), np.asarray(jd.V))
    np.testing.assert_array_equal(td.lam.numpy(), np.asarray(jd.lam))
    x = _queries(5, 3, ts.dim)
    for t in (999, 500, 50):
        _close(_call(td, x, t, torch_side=True), _call(jd, x, t))


def test_wiener_is_linear_mmse_on_gaussian():
    """On Gaussian data the Wiener filter beats the mean and identity
    predictors on held-out noise."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2048, 8)) @ (rng.normal(size=(8, 8)) * 0.3)
         ).astype(np.float32)
    store = make_store(x, (8,), proxy_factor=1, device="cpu")
    den = tden.WienerDenoiser(store, TSCH, device="cpu")
    t = 500
    x0 = torch.from_numpy(x[:64])
    xt = TSCH.add_noise(x0, torch.from_numpy(
        rng.normal(size=(64, 8)).astype(np.float32)), t)
    mse_w = float(((den(xt, t) - x0) ** 2).mean())
    mse_mean = float(((torch.from_numpy(x.mean(0)) - x0) ** 2).mean())
    mse_id = float(((xt / float(TSCH.a[t]) - x0) ** 2).mean())
    assert mse_w < mse_mean and mse_w < mse_id


# -- patch bases -------------------------------------------------------------

@pytest.mark.parametrize("patch", [1, 3, 4, 7])
def test_box_patch_dist_matches(patch):
    rng = np.random.default_rng(patch)
    qf = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    xf = rng.normal(size=(5, 9, 7, 3)).astype(np.float32)
    _close(tden._box_patch_dist(torch.from_numpy(qf), torch.from_numpy(xf),
                                patch),
           jden._box_patch_dist(jnp.asarray(qf), jnp.asarray(xf), patch),
           atol=1e-5)


def test_patch_schedule_matches(stores):
    js, ts = stores["cifar"]
    for pmin, pmax in ((3, 11), (2, 8), (1, 5)):
        jd = jden.PatchDenoiser(js, JSCH, patch_min=pmin, patch_max=pmax)
        td = tden.PatchDenoiser(ts, TSCH, patch_min=pmin, patch_max=pmax,
                                device="cpu")
        sizes = [td.patch_size(t) for t in range(0, 1001, 7)]
        assert sizes == [jd.patch_size(t) for t in range(0, 1001, 7)]
        assert all(p % 2 == 1 for p in sizes)
    assert td.patch_size(999) >= td.patch_size(10)


def test_patch_bases_need_images(stores):
    with pytest.raises(ValueError, match="H, W, C"):
        tden.PatchDenoiser(stores["gmm"][1], TSCH, device="cpu")


@pytest.fixture(scope="module")
def patch_pairs(stores):
    """(reference, port) patch denoisers per (store, base), shared so that
    each builds its PCA bases and feature caches once; a test sets the
    weighting it needs on both."""
    out = {}
    for store in ("mnist", "cifar"):
        js, ts = stores[store]
        for cls, jcls in (("kamb", jden.PatchDenoiser),
                          ("pca", jden.PCADenoiser)):
            out[store, cls] = (jcls(js, JSCH, chunk=48),
                               make_denoiser(cls, ts, TSCH, chunk=48,
                                             device="cpu"))
    return out


@pytest.mark.parametrize("store", ["mnist", "cifar"])
@pytest.mark.parametrize("cls", ["kamb", "pca"])
@pytest.mark.parametrize("weighting", ["ss", "wss"])
def test_patch_denoisers_match(stores, patch_pairs, store, cls, weighting):
    """Full scan (it reads no weighting: compared under "ss"), support and
    masked support under both weightings."""
    ts = stores[store][1]
    jd, td = patch_pairs[store, cls]
    jd.weighting = td.weighting = weighting
    idx, mask = _support(7, 2, ts.n, 40)
    for t in (900, 400, 30):
        x = _noisy(ts, 6, 2, t)
        if weighting == "ss":
            out = _call(td, x, t, torch_side=True)
            assert out.shape == (2, ts.dim)
            assert bool(torch.isfinite(out).all())
            _close(out, _call(jd, x, t))
        _close(_call(td, x, t, idx, torch_side=True), _call(jd, x, t, idx))
        _close(_call(td, x, t, idx, mask, torch_side=True),
               _call(jd, x, t, idx, mask))


@pytest.mark.parametrize("store", ["mnist", "cifar"])
def test_pca_basis_and_features(stores, patch_pairs, store):
    """The basis bit-equal; the projection within 1e-5 relative."""
    js, ts = stores[store]
    jd, td = patch_pairs[store, "pca"]
    imgs = np.array(js.X[:20]).reshape((20,) + js.image_shape)
    for patch in (3, 7, 11):
        np.testing.assert_array_equal(td._basis(patch).numpy(),
                                      np.asarray(jd._basis(patch)))
        want = np.asarray(jd.features(jnp.asarray(imgs), patch))
        got = td.features(torch.from_numpy(imgs), patch).numpy()
        assert got.shape == want.shape == imgs.shape[:3] + (8,)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    feats = td._dataset_features(7)
    assert tuple(feats.shape) == (ts.n,) + ts.image_shape[:2] + (8,)
    np.testing.assert_allclose(feats.numpy(),
                               np.asarray(jd._dataset_features(7)),
                               rtol=1e-5, atol=1e-5 * float(feats.abs().max()))
    assert td.feature_cache_bytes() == len(td._features) * feats.numel() * 4


def test_pca_full_vs_support_consistency():
    """support = every row reproduces the (unbiased) full scan, 2e-4."""
    js = jsynth.mnist_like(96, seed=1)
    ts = store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                          js.image_shape, device="cpu")
    den = tden.PCADenoiser(ts, TSCH, weighting="ss", chunk=96, device="cpu")
    x = torch.from_numpy(_queries(4, 2, ts.dim))
    idx = torch.arange(96).repeat(2, 1)
    np.testing.assert_allclose(den(x, 300).numpy(),
                               den(x, 300, support=idx).numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cls", ["kamb", "pca"])
def test_support_query_groups(stores, patch_pairs, cls, monkeypatch):
    """Queries taken in groups under the gather budget give what one
    group gives."""
    ts = stores["cifar"][1]
    den = patch_pairs["cifar", cls][1]
    den.weighting = "ss"
    x = torch.from_numpy(_queries(8, 5, ts.dim))
    idx = torch.from_numpy(_support(9, 5, ts.n, 30)[0])
    whole = den(x, 500, support=idx)
    monkeypatch.setattr(tden, "SUPPORT_GATHER_BYTES",
                        2 * 4 * 30 * 32 * 32 * max(den.feature_dim, 3))
    assert den._query_group(30) == 2
    np.testing.assert_allclose(den(x, 500, support=idx).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)


def test_make_denoiser_builds_all_four(stores):
    js, ts = stores["cifar"]
    assert sorted(DENOISERS) == sorted(jden.DENOISERS)
    for name in DENOISERS:
        den = make_denoiser(name, ts, TSCH, device="cpu")
        assert den.name == jden.DENOISERS[name].name
        assert den.store.device.type == "cpu"
    assert make_denoiser("pca", ts, TSCH, device="cpu").weighting == "wss"
    assert make_denoiser("kamb", ts, TSCH, device="cpu").weighting == "ss"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_denoiser("pca", ts, TSCH)


def test_build_caches_holds_every_step_patch(stores):
    """``build_caches`` builds the PCA feature map of each patch size the
    steps take, each as the reference's, and reports the bytes held; the
    Kamb base holds none."""
    js, ts = stores["mnist"]
    steps = sampling_timesteps(TSCH, 10)[:-1]
    kamb = make_denoiser("kamb", ts, TSCH, device="cpu")
    assert kamb.build_caches(steps) == 0
    jd = jden.PCADenoiser(js, JSCH)
    td = make_denoiser("pca", ts, TSCH, device="cpu")
    patches = {td.patch_size(int(t)) for t in steps}
    assert patches == {jd.patch_size(int(t)) for t in steps}
    assert len(patches) > 1
    held = td.build_caches(steps)
    assert sorted(td._features) == sorted(patches)
    assert held == len(patches) * ts.n * 28 * 28 * td.rank * 4
    assert td.build_caches(steps) == held            # nothing built again
    for p in patches:
        want = np.asarray(jd._dataset_features(p))
        np.testing.assert_allclose(td._features[p].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
