"""GoldDiff over the patch bases, the paired-trajectory sampler extras and
the paper's presets, in the port against the JAX package, on the CPU.

Stores cross with ``store_from_numpy``, x_T through ``x_init`` /
``denoise_trajectory``.  The reference GoldDiff runs its staged ``xla``
route (gather strategy, materialized screen, no fused step), which the
port's ``select`` takes.  Tolerances: golden supports equal (the same
rows in the same order); one step 1e-4 max abs; a 10-step trajectory
1e-3 (per-step differences compound through DDIM); ``sample_plan`` on
the cosine and edm_ve schedules 1e-3 relative; presets field for
field."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import golddiff as jpresets  # noqa: E402
from repro.core import dataset as jdataset  # noqa: E402
from repro.core import denoisers as jden  # noqa: E402
from repro.core import golddiff as jgd  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro_torch.configs import golddiff as tpresets  # noqa: E402
from repro_torch.core import (GoldDiff, GoldDiffConfig,  # noqa: E402
                              OptimalDenoiser, build_plan,
                              denoise_trajectory, make_denoiser,
                              make_schedule, sample, sample_conditional,
                              sample_plan, store_from_numpy)
from repro_torch.core import golddiff as tgd  # noqa: E402
from repro_torch.core.dataset import restrict  # noqa: E402

REF_ENGINE = dict(strategy="gather", screen="materialized", fused=False)
JSCH = jsched.make_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)


def carry(js):
    return store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                            js.image_shape, labels=js.labels, device="cpu")


@pytest.fixture(scope="module")
def cifar():
    js = jsynth.cifar_like(256, seed=1)
    return js, carry(js)


@pytest.fixture(scope="module")
def mnist():
    js = jsynth.mnist_like(128, seed=0)
    return js, carry(js)


def x_T(seed, b, d):
    return (float(TSCH.b[1000]) * np.random.default_rng(seed).normal(
        size=(b, d))).astype(np.float32)


def noisy(ts, seed, b, t):
    rng = np.random.default_rng(seed)
    x0 = ts.X.numpy()[rng.choice(ts.n, b, replace=False)]
    return (float(TSCH.a[t]) * x0 + float(TSCH.b[t]) * rng.normal(
        size=x0.shape)).astype(np.float32)


def bases(name, js, ts, sched=JSCH, tsched=TSCH):
    jcls = jden.DENOISERS[name]
    return jcls(js, sched), make_denoiser(name, ts, tsched, device="cpu")


@pytest.fixture(scope="module")
def cifar_gd(cifar):
    """(reference, port) GoldDiff over each patch base, shared by the
    step tests so that each builds its PCA caches once."""
    js, ts = cifar
    out = {}
    for name in ("kamb", "pca"):
        jb, tb = bases(name, js, ts)
        out[name] = (jgd.GoldDiff(jb, **REF_ENGINE), GoldDiff(tb))
    return out


@pytest.mark.parametrize("name", ["kamb", "pca"])
@pytest.mark.parametrize("t", [900, 400, 60])
def test_golddiff_patch_step_matches(cifar, cifar_gd, name, t):
    ts = cifar[1]
    j, g = cifar_gd[name]
    tb = g.base
    assert g.base is tb and g.base.weighting == "ss"
    assert j.base.weighting == "ss" and g.name == j.name
    x = noisy(ts, t, 3, t)
    sup = g.select(torch.from_numpy(x), t)
    np.testing.assert_array_equal(sup.numpy(),
                                  np.asarray(j.select(jnp.asarray(x), t)))
    assert tuple(sup.shape) == (3, g.engine.sizes(t)[1])
    got = g(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(x), t)),
                               rtol=0, atol=1e-4)
    # the step is the base on the selected support
    np.testing.assert_allclose(got.numpy(),
                               tb(torch.from_numpy(x), t, support=sup).numpy(),
                               rtol=0, atol=1e-6)
    if name == "pca":
        assert tb.patch_size(t) in tb._features


def test_coarse_screen_and_golden_select_match(cifar):
    js, ts = cifar
    x = noisy(ts, 2, 4, 500)
    q = x / float(TSCH.a[500])
    want = jgd.coarse_screen(js, jnp.asarray(q), 40, 4)
    cand = tgd.coarse_screen(ts, torch.from_numpy(q), 40, 4)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tgd.golden_select(ts, torch.from_numpy(q), cand, 12).numpy(),
        np.asarray(jgd.golden_select(js, jnp.asarray(q), want, 12)))


def test_plug_and_play_all_bases(cifar):
    """GoldDiff wraps every base (Tab. 5) and always aggregates with the
    unbiased softmax; the masked step is the Optimal base's alone."""
    _, ts = cifar
    x = torch.from_numpy(x_T(2, 2, ts.dim))
    for name in ("optimal", "kamb", "pca", "wiener"):
        gd = GoldDiff(make_denoiser(name, ts, TSCH, device="cpu"))
        out = gd(x, 400)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
        assert getattr(gd.base, "weighting", "ss") == "ss"
        if name != "optimal":
            with pytest.raises(ValueError, match="static mode"):
                gd.call_masked(x, 400)


@pytest.mark.parametrize("name", ["optimal", "wiener", "kamb", "pca",
                                  "golddiff+optimal", "golddiff+kamb",
                                  "golddiff+pca"])
def test_denoise_trajectory_matches(mnist, name):
    """The paper's paired comparison: every method from one x_T."""
    js, ts = mnist
    base = name.removeprefix("golddiff+")
    jd, td = bases(base, js, ts)
    if name.startswith("golddiff+"):
        jd, td = jgd.GoldDiff(jd, **REF_ENGINE), GoldDiff(td)
    x0 = x_T(5, 2, ts.dim)
    want, wxs = jsampler.denoise_trajectory(jd, JSCH, jnp.asarray(x0))
    got, xs = denoise_trajectory(td, TSCH, x0)
    assert len(xs) == len(wxs) == 11
    np.testing.assert_array_equal(xs[0].numpy(), x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
    again, _ = denoise_trajectory(td, TSCH, x0)
    assert torch.equal(again, got)


@pytest.mark.parametrize("schedule", ["cosine", "edm_ve"])
def test_sample_plan_other_schedules(schedule):
    js = jsynth.gmm(1024, dim=16, num_modes=8, spread=0.05, seed=0)
    jsch, tsch = jsched.make_schedule(schedule, 1000), make_schedule(
        schedule, 1000)
    j = jgd.GoldDiff(jden.OptimalDenoiser(js, jsch))
    t = GoldDiff(OptimalDenoiser(carry(js), tsch, device="cpu"))
    x0 = (float(tsch.b[1000]) * np.random.default_rng(11).normal(
        size=(8, 16))).astype(np.float32)
    want = jsampler.sample_plan(j.call_masked, jsch, x0.shape,
                                jax.random.PRNGKey(0),
                                jplan.build_plan(j.engine, 10), x_init=x0)
    got = sample_plan(t.call_masked, tsch, x0.shape, build_plan(t.engine, 10),
                      x_init=x0)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-3
    # plan against the port's static sampler: the masked step reads fp32
    # a_t, sigma_t^2 where the static step reads float64 host values, and
    # on edm_ve (sigma to 100) the reference's own plan and static
    # trajectories differ by 2.7e-5 relative here (3.7e-7 on cosine)
    static = sample(t, tsch, x0.shape, x_init=x0)
    assert float((static - got).abs().max()) / float(got.abs().max()) < 1e-4


def test_sample_trace_matches(mnist):
    js, ts = mnist
    jd, td = bases("optimal", js, ts)
    x0 = x_T(8, 2, ts.dim)
    want, wtraj = jsampler.sample(jd, JSCH, x0.shape, jax.random.PRNGKey(0),
                                  num_steps=6, trace=True, x_init=x0)
    got, traj = sample(td, TSCH, x0.shape, num_steps=6, trace=True,
                       x_init=x0)
    assert tuple(traj.shape) == (6,) + x0.shape
    np.testing.assert_allclose(traj.numpy(), np.asarray(wtraj), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)
    assert torch.equal(got, sample(td, TSCH, x0.shape, num_steps=6,
                                   x_init=x0))


def test_restrict_and_conditional_match():
    js = jsynth.cifar_like(128, seed=0)
    ts = carry(js)
    idx = np.nonzero(np.asarray(js.labels) == 0)[0]
    jsub, tsub = jdataset.restrict(js, jnp.asarray(idx)), restrict(ts, idx)
    assert tsub.n == jsub.n == len(idx) and bool((tsub.labels == 0).all())
    for f in ("X", "proxy", "x_norms", "proxy_norms", "labels"):
        np.testing.assert_array_equal(getattr(tsub, f).numpy(),
                                      np.asarray(getattr(jsub, f)))
    x0 = x_T(3, 2, ts.dim)

    def jmake(c):
        return jden.OptimalDenoiser(jdataset.restrict(
            js, jnp.asarray(np.nonzero(np.asarray(js.labels) == c)[0])),
            JSCH)

    def tmake(c):
        return OptimalDenoiser(restrict(ts, torch.nonzero(
            ts.labels == c)[:, 0]), TSCH, device="cpu")

    want = jsampler.sample_conditional(jmake, JSCH, x0.shape,
                                       jax.random.PRNGKey(0), 0, x_init=x0)
    got = sample_conditional(tmake, TSCH, x0.shape, 0, x_init=x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_presets_match_field_for_field():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    for name, jp in jpresets.PRESETS.items():
        tp = tpresets.PRESETS[name]
        for f in dataclasses.fields(jp):
            if f.name == "golddiff":
                assert dataclasses.asdict(tp.golddiff) == \
                    dataclasses.asdict(jp.golddiff)
                assert isinstance(tp.golddiff, GoldDiffConfig)
            else:
                assert getattr(tp, f.name) == getattr(jp, f.name), (name, f)
    assert [f.name for f in dataclasses.fields(tpresets.ExperimentPreset)] \
        == [f.name for f in dataclasses.fields(jpresets.ExperimentPreset)]
