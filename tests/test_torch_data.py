"""The port's data and schedules against the JAX package.

Stores and schedules are built by numpy in both packages, so equal
seeds must give bit-equal rows, proxies, labels and grids; the proxy's
average pool sums each window in the order XLA:CPU does, so it is
bit-equal too (the tolerance below is the contract, 1e-6)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dataset as jdataset  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch.core import dataset as tdataset  # noqa: E402
from repro_torch.core import schedules as tsched  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402


@pytest.mark.parametrize("name,kw", [
    ("cifar_like", {"n": 96, "seed": 3}),
    ("mnist_like", {"n": 64, "seed": 1}),
])
def test_make_dataset_bit_equal(name, kw):
    js = jsynth.make_dataset(name, **kw)
    ts = tsynth.make_dataset(name, device="cpu", **kw)
    assert ts.image_shape == js.image_shape
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    np.testing.assert_array_equal(ts.proxy.numpy(), np.asarray(js.proxy))
    np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))
    # norms are fp32 sums in another order: equal to fp32 rounding
    np.testing.assert_allclose(ts.x_norms.numpy(), np.asarray(js.x_norms),
                               rtol=1e-6)


@pytest.mark.parametrize("n,h,c,classes,batch", [(300, 28, 1, 10, 64),
                                                  (130, 32, 3, 10, 50),
                                                  (50, 16, 3, 40, 7)])
def test_procedural_images_bit_equal_in_batches(n, h, c, classes, batch):
    """The threaded generator (row slices on a pool, several batches,
    more prototypes than a slice) gives the reference's arrays."""
    want = jsynth.procedural_images(n, h, h, c, classes, seed=3, batch=batch)
    got = tsynth.procedural_images(n, h, h, c, classes, seed=3, batch=batch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_image_store_small_images_bit_equal():
    js = jsynth.image_store(40, 16, 16, 3, seed=7)
    ts = tsynth.image_store(40, 16, 16, 3, seed=7, device="cpu")
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    np.testing.assert_array_equal(ts.proxy.numpy(), np.asarray(js.proxy))


@pytest.mark.parametrize("shape,factor", [((5, 16, 16, 3), 4),
                                          ((3, 8, 8, 3), 4),
                                          ((2, 9, 10, 1), 3),
                                          ((4, 6), 4)])
def test_downsample_proxy_matches(shape, factor):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jdataset.downsample_proxy(jnp.asarray(x), factor))
    got = tdataset.downsample_proxy(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_store_from_numpy_carries_arrays():
    js = jsynth.image_store(16, 8, 8, 3, seed=2)
    ts = tdataset.store_from_numpy(js.X, js.proxy, js.x_norms,
                                   js.proxy_norms, js.image_shape,
                                   labels=js.labels, device="cpu")
    for name in ("X", "proxy", "x_norms", "proxy_norms", "labels"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.n == 16 and ts.dim == 192 and ts.device.type == "cpu"


@pytest.mark.parametrize("steps", [10, 25])
def test_schedule_grids_equal(steps):
    js = jsched.make_schedule("ddpm_linear", 1000)
    ts = tsched.make_schedule("ddpm_linear", 1000)
    np.testing.assert_array_equal(ts.a, js.a)
    np.testing.assert_array_equal(ts.b, js.b)
    np.testing.assert_array_equal(tsched.sampling_timesteps(ts, steps),
                                  jsched.sampling_timesteps(js, steps))
    for t in (1, 100, 500, 1000):
        assert ts.g_np(t) == js.g_np(t)
        assert ts.sigma_np(t) == js.sigma_np(t)


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_step_matches(eta):
    """fp32 elementwise update: agreement to a few fp32 ulps (1e-6)."""
    js = jsched.make_schedule("ddpm_linear", 1000)
    ts = tsched.make_schedule("ddpm_linear", 1000)
    rng = np.random.default_rng(4)
    x, x0, nz = (rng.normal(size=(3, 12)).astype(np.float32)
                 for _ in range(3))
    want = np.asarray(js.ddim_step(jnp.asarray(x), jnp.asarray(x0), 700, 600,
                                   eta, jnp.asarray(nz)))
    got = ts.ddim_step(torch.from_numpy(x), torch.from_numpy(x0), 700, 600,
                       eta, torch.from_numpy(nz)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_schedule_raises():
    """The port has every schedule of the reference; a name neither
    package knows raises in both."""
    assert sorted(tsched.SCHEDULES) == sorted(jsched.SCHEDULES)
    with pytest.raises(KeyError):
        tsched.make_schedule("bogus", 1000)
    with pytest.raises(KeyError):
        jsched.make_schedule("bogus", 1000)


@pytest.mark.parametrize("name", ["ddpm_linear", "cosine", "edm_vp",
                                  "edm_ve"])
def test_schedule_matches(name):
    """Each schedule's grids bit-equal, and one DDIM step on it within
    fp32 ulps (1e-6)."""
    js, ts = jsched.make_schedule(name, 1000), tsched.make_schedule(name,
                                                                    1000)
    np.testing.assert_array_equal(ts.a, js.a)
    np.testing.assert_array_equal(ts.b, js.b)
    rng = np.random.default_rng(2)
    x, x0 = (rng.normal(size=(3, 12)).astype(np.float32) for _ in range(2))
    want = np.asarray(js.ddim_step(jnp.asarray(x), jnp.asarray(x0), 700,
                                   600))
    got = ts.ddim_step(torch.from_numpy(x), torch.from_numpy(x0), 700,
                       600).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
