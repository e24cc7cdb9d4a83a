"""The port's trajectory plans, masked step and plan/scan samplers
against the JAX package, on the CPU.

Stores come from the reference's generators and cross with
``store_from_numpy`` (the Golden Index with ``index_from_numpy``); x_T
crosses through ``x_init``.  The reference runs on ``xla`` and, for the
fused body, on ``pallas_interpret`` too.

Tolerances: plan structure, stage costs and the traced sizes (m_t, k_t,
nprobe_t at every t) equal; masked steps 1e-4 against the reference
(fp32 reduction order); trajectories 1e-3 against the reference after
10 steps (the per-step differences compound through DDIM), 1e-5 against
the port's own static and scan samplers and 1e-6 at the plan's two
degenerate ends (the reference's own bounds); ``sample`` vs
``sample_scan`` 2e-3 (the masked scan pads every step to the worst
case); padded caps and the mixed segment's active rows bit-equal.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GoldDiff as JGoldDiff  # noqa: E402
from repro.core import GoldDiffConfig as JConfig  # noqa: E402
from repro.core import OptimalDenoiser as JOptimal  # noqa: E402
from repro.core import make_schedule as jmake_schedule  # noqa: E402
from repro.core import sample_plan as jsample_plan  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.data import gmm as jgmm  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.index import GoldenIndex as JIndex  # noqa: E402
from repro.index import ProbeSchedule as JProbes  # noqa: E402
from repro.index import build_index as jbuild_index  # noqa: E402
from repro_torch.core import (BucketCaps, GoldDiff, GoldDiffConfig,  # noqa: E402
                              OptimalDenoiser, build_plan,
                              full_scan_costs, fused_step_costs,
                              make_schedule, plan_segment,
                              plan_segment_mixed, sample, sample_plan,
                              sample_scan, step_shapes, step_stage_costs,
                              store_from_numpy)
from repro_torch.core.engine import masked_sizes  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.index import ProbeSchedule, index_from_numpy  # noqa: E402

JSCH = jmake_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)
INDEXED_FRACS = dict(m_min_frac=1 / 64, m_max_frac=1 / 16,
                     k_min_frac=1 / 128, k_max_frac=1 / 64)
ALL_T = np.arange(1, 1001)


def relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def carry_store(js):
    return store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                            js.image_shape, device="cpu")


def carry_index(jix):
    return index_from_numpy(*(np.asarray(getattr(jix, f))
                              for f in JIndex._fields[:-1]),
                            max_cluster=jix.max_cluster, device="cpu")


def pair(js, ts, jkw=None, tkw=None, cfg=None):
    """(reference GoldDiff, port GoldDiff) over the same store."""
    cfg = cfg or {}
    j = JGoldDiff(JOptimal(js, JSCH), JConfig(**cfg), **(jkw or {}))
    t = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"),
                 GoldDiffConfig(**cfg), **(tkw or {}))
    return j, t


@pytest.fixture(scope="module")
def gmm_exact():
    js = jgmm(1024, dim=16, num_modes=8, spread=0.05, seed=0)
    return pair(js, carry_store(js))


@pytest.fixture(scope="module")
def gmm_indexed():
    js = jgmm(4096, dim=16, num_modes=32, spread=0.05, seed=3)
    jix = jbuild_index(js, num_clusters=64)
    kw = dict(index_mode="always")
    return pair(js, carry_store(js), dict(kw, index=jix),
                dict(kw, index=carry_index(jix)), INDEXED_FRACS)


@pytest.fixture(scope="module")
def image_store():
    js = jsynth.image_store(384, 16, 16, 3, seed=0)
    return js, carry_store(js)


def jcaps(caps):
    return None if caps is None else jplan.BucketCaps(*caps.sig())


def plan_fields(plan):
    return (plan.ts, plan.threshold,
            [dataclasses.astuple(s) for s in plan.steps],
            [(b.start, b.stop, b.caps.sig(), b.padded_flops, b.exact_flops)
             for b in plan.buckets])


# -- plan structure and costs: host Python, equal to the reference ----------------

@pytest.mark.parametrize("which", ["gmm_exact", "gmm_indexed"])
@pytest.mark.parametrize("kw", [{}, dict(threshold=0.0),
                                dict(threshold=float("inf")),
                                dict(threshold=0.0, max_buckets=2),
                                dict(num_steps=20, threshold=0.05)])
def test_plan_equals_reference(request, which, kw):
    j, t = request.getfixturevalue(which)
    steps = kw.pop("num_steps", 10)
    want = jplan.build_plan(j.engine, num_steps=steps, **kw)
    got = build_plan(t.engine, num_steps=steps, **kw)
    assert plan_fields(got) == plan_fields(want)
    assert got.describe() == want.describe()
    got_ts, got_steps = step_shapes(t.engine, steps)
    want_ts, want_steps = jplan.step_shapes(j.engine, steps)
    assert got_ts == want_ts
    assert [dataclasses.astuple(s) for s in got_steps] == \
        [dataclasses.astuple(s) for s in want_steps]


def test_plan_structure_and_edges(gmm_exact):
    """The reference's own structural cases (tests/test_plan.py:58-113)."""
    eng = gmm_exact[1].engine
    plan = build_plan(eng, num_steps=10)
    assert 1 <= plan.num_buckets <= 4
    assert plan.buckets[0].start == 0 and plan.buckets[-1].stop == 10
    for a, b in zip(plan.buckets, plan.buckets[1:]):
        assert a.stop == b.start
    for bk in plan.buckets:
        assert bk.overhead <= plan.threshold + 1e-9
        for s in plan.steps[bk.start: bk.stop]:
            assert s.m_t <= bk.caps.m_cap and s.k_t <= bk.caps.k_cap
            assert s.indexed == bk.caps.indexed
    masked = build_plan(eng, num_steps=10, threshold=float("inf"))
    assert plan.padded_flops < masked.padded_flops
    assert plan.exact_flops == masked.exact_flops
    per_step = build_plan(eng, num_steps=10, threshold=0.0)
    assert per_step.num_buckets == 10 and per_step.overhead == 0.0
    assert masked.num_buckets == 1
    forced = build_plan(eng, num_steps=10, threshold=0.0, max_buckets=2)
    assert forced.num_buckets == 2


def test_plan_never_straddles_index_boundary():
    class FakeEngine:
        class store:
            dim = 8

        class index:
            max_cluster = 16

        schedule = TSCH

        def sizes(self, t):
            return 100, 50

        def use_index(self, t):
            return t > 500

        def nprobe(self, t):
            return 4

    plan = build_plan(FakeEngine(), num_steps=10, threshold=float("inf"))
    assert plan.num_buckets == 2
    assert plan.buckets[0].caps.indexed and not plan.buckets[1].caps.indexed


@pytest.mark.parametrize("which", ["gmm_exact", "gmm_indexed"])
@pytest.mark.parametrize("batch", [1, 16])
def test_stage_costs_equal_reference(request, which, batch):
    j, t = request.getfixturevalue(which)
    for step in jplan.step_shapes(j.engine, 10)[1]:
        assert step_stage_costs(t.engine, step.t, batch) == \
            jplan.step_stage_costs(j.engine, step.t, batch)
        assert fused_step_costs(t.engine, step.t, batch) == \
            jplan.fused_step_costs(j.engine, step.t, batch)
    assert full_scan_costs(t.engine, batch) == \
        jplan.full_scan_costs(j.engine, batch)


# -- traced sizes at every timestep ------------------------------------------------

def jtraced_sizes(cfg, n):
    """The reference's masked (m_t, k_t) at every t in 1..1000, as its
    ``denoise_masked`` computes them (core/engine.py:1258-1260)."""
    m_min, m_max, k_min, k_max = cfg.sizes(n)
    g = JSCH.g(jnp.asarray(ALL_T))
    m_t = jnp.floor(m_min + (m_max - m_min) * (1.0 - g)).astype(jnp.int32)
    k_t = jnp.floor(k_min + (k_max - k_min) * g).astype(jnp.int32)
    return g, m_t, k_t


@pytest.mark.parametrize("fracs", [{}, INDEXED_FRACS])
@pytest.mark.parametrize("n", [384, 1024, 2048, 4096, 50000, 65536])
def test_traced_sizes_equal_reference(fracs, n):
    jg, jm, jk = jtraced_sizes(JConfig(**fracs), n)
    g, m_t, k_t = masked_sizes(GoldDiffConfig(**fracs), TSCH,
                               torch.as_tensor(ALL_T), n)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(jk))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        TSCH.sigma(torch.as_tensor(ALL_T)).numpy(),
        np.asarray(JSCH.sigma(jnp.asarray(ALL_T))))
    assert torch.equal(TSCH.g(500, "cpu"), TSCH.g(torch.tensor(500)))
    # the probe rule, without the occupancy floor, at three index sizes
    for c, probes in ((64, {}), (224, dict(f_lo=1 / 32, f_hi=1 / 8)),
                      (512, dict(f_lo=1 / 8, f_hi=1.0, safety=4.0))):
        want = JProbes(**probes).nprobe_jnp(jg, jm, n, c)
        got = ProbeSchedule(**probes).nprobe_tensor(g, m_t, n, c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_traced_nprobe_equals_reference(gmm_indexed):
    """nprobe_t with the occupancy floor, on the carried index, at every t
    and at the worst-case pad and a narrower one."""
    j, t = gmm_indexed
    jg, jm, jk = jtraced_sizes(j.cfg, j.store.n)
    g, m_t, k_t = masked_sizes(t.cfg, TSCH, torch.as_tensor(ALL_T), t.store.n)
    pad = t.engine._masked_nprobe_pad()
    assert pad == j.engine._masked_nprobe_pad()
    for p_cap in (pad, max(1, pad // 3)):
        want = j.engine._masked_nprobe_t(jg, jm, jk, p_cap)
        got = t.engine._masked_nprobe_t(g, m_t, k_t, p_cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # on the grid the traced count equals the static programs' nprobe(t)
    for step in step_shapes(t.engine, 10)[1]:
        assert int(t.engine._masked_nprobe_t(
            g[step.t - 1], m_t[step.t - 1], k_t[step.t - 1], pad)) == \
            t.engine.nprobe(step.t)


# -- the masked step against the reference ----------------------------------------

def noisy_x(dim, seed, b=5):
    return np.random.default_rng(seed).normal(size=(b, dim)).astype(np.float32)


def masked_cases(t_engine):
    """(t, caps) pairs: caps=None at three noise levels, and every plan
    bucket's caps at its first and last step."""
    cases = [(t, None) for t in (900, 400, 50)]
    plan = build_plan(t_engine, num_steps=10)
    for b in plan.buckets:
        cases += [(plan.ts[b.start], b.caps), (plan.ts[b.stop - 1], b.caps)]
    return cases


@pytest.mark.parametrize("body,jkw", [
    ("staged", dict(fused=False, screen="materialized")),
    ("fused", dict(fused=True)),
    ("fused", dict(fused=True, backend="pallas_interpret")),
])
def test_denoise_masked_matches_reference(image_store, body, jkw):
    js, ts = image_store
    tkw = {k: v for k, v in jkw.items() if k != "backend"}
    j, t = pair(js, ts, jkw, tkw)
    assert t.engine._fused_masked(False) == (body == "fused")
    x = noisy_x(js.dim, 1)
    for step, caps in masked_cases(t.engine):
        want = np.asarray(j.call_masked(jnp.asarray(x), jnp.asarray(step),
                                        jcaps(caps)))
        got = t.call_masked(torch.from_numpy(x), step, caps).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # a 0-d tensor t is the same step
        again = t.call_masked(torch.from_numpy(x), torch.tensor(step), caps)
        assert torch.equal(again, torch.from_numpy(got))


def test_denoise_masked_indexed_matches_reference(gmm_indexed):
    j, t = gmm_indexed
    x = noisy_x(16, 2)
    for step, caps in masked_cases(t.engine):
        want = np.asarray(j.call_masked(jnp.asarray(x), jnp.asarray(step),
                                        jcaps(caps)))
        got = t.call_masked(torch.from_numpy(x), step, caps).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(fused=False), dict(fused=True)])
def test_worst_case_caps_bit_equal_uncapped(gmm_exact, kw):
    j, t = gmm_exact
    t = GoldDiff(t.base, t.cfg, **kw)
    _, m_max, _, k_max = t.cfg.sizes(t.store.n)
    caps = BucketCaps(m_cap=m_max, k_cap=k_max)
    x = torch.from_numpy(noisy_x(16, 3, b=3))
    for step in (900, 400, 50):
        assert torch.equal(t.call_masked(x, step),
                           t.call_masked(x, step, caps))


@pytest.mark.parametrize("which,kw", [("gmm_exact", dict(fused=False)),
                                      ("gmm_exact", dict(fused=True)),
                                      ("gmm_indexed", {})])
def test_masked_distances_computed_once(request, monkeypatch, which, kw):
    from repro_torch.kernels import ops
    j, t = request.getfixturevalue(which)
    t = GoldDiff(t.base, t.cfg, index=t.engine.index,
                 index_mode=t.engine.index_mode, **kw)
    calls = []
    orig = ops.support_distances
    monkeypatch.setattr(ops, "support_distances",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    t.call_masked(torch.from_numpy(noisy_x(16, 4)), 300)
    assert len(calls) == 1


def test_masked_matches_static_step():
    """The reference's tests/test_golddiff.py:89 on the port."""
    ts = make_dataset("gmm", n=512, dim=8, seed=4, device="cpu")
    gd = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"))
    x = torch.from_numpy(noisy_x(8, 7, b=4))
    for step in (900, 500, 100):
        np.testing.assert_allclose(gd.call_masked(x, step).numpy(),
                                   gd(x, step).numpy(), rtol=1e-4, atol=1e-4)


# -- trajectories ------------------------------------------------------------------

def x_T(dim, seed, b=4):
    return (float(TSCH.b[1000]) * np.random.default_rng(seed).normal(
        size=(b, dim))).astype(np.float32)


@pytest.mark.parametrize("which", ["gmm_exact", "gmm_indexed"])
def test_sample_plan_matches_reference(request, which):
    import jax
    j, t = request.getfixturevalue(which)
    x0 = x_T(16, 11)
    want = jsample_plan(j.call_masked, JSCH, x0.shape, jax.random.PRNGKey(0),
                        jplan.build_plan(j.engine, 10), x_init=x0,
                        program_cache=j.engine.program)
    plan = build_plan(t.engine, 10)
    got = sample_plan(t.call_masked, TSCH, x0.shape, plan, x_init=x0,
                      program_cache=t.engine.program,
                      jitter=t.engine.jitter)
    assert relerr(got, want) < 1e-3
    # the port's plan against its own static and scan samplers
    x_static = sample(t, TSCH, x0.shape, x_init=x0)
    assert relerr(got, x_static) < 1e-5
    if which == "gmm_exact":
        assert relerr(got, sample_scan(t.call_masked, TSCH, x0.shape,
                                       x_init=x0)) < 1e-5


def test_plan_degenerate_ends(gmm_exact):
    """One bucket is the scan; one bucket a step is static mode."""
    t = gmm_exact[1]
    x0 = x_T(16, 2, b=3)
    one = build_plan(t.engine, 10, threshold=float("inf"))
    x_one = sample_plan(t.call_masked, TSCH, x0.shape, one, x_init=x0)
    x_scan = sample_scan(t.call_masked, TSCH, x0.shape, x_init=x0)
    assert relerr(x_one, x_scan) < 1e-6
    per = build_plan(t.engine, 10, threshold=0.0)
    x_per = sample_plan(t.call_masked, TSCH, x0.shape, per, x_init=x0)
    assert relerr(x_per, sample(t, TSCH, x0.shape, x_init=x0)) < 1e-6


def test_sample_and_scan_agree():
    """The reference's tests/test_sampler_data.py:34 on the port."""
    ts = make_dataset("gmm", n=256, dim=4, seed=1, device="cpu")
    gd = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"))
    x0 = x_T(4, 3)
    x1 = sample(gd, TSCH, x0.shape, num_steps=10, clip_value=None, x_init=x0)
    x2 = sample_scan(gd.call_masked, TSCH, x0.shape, num_steps=10,
                     clip_value=None, x_init=x0)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=2e-3, atol=2e-3)
    with pytest.raises(TypeError):
        sample_scan(gd.call_masked, TSCH, x0.shape, eta=0.5)


def test_mixed_segment_active_rows_bit_equal(gmm_exact):
    t = gmm_exact[1]
    plan = build_plan(t.engine, 10)
    x = torch.from_numpy(x_T(16, 5, b=6))
    for bucket in plan.buckets:
        plain = plan_segment(t.call_masked, TSCH, plan, bucket)(x)
        pos = torch.tensor([bucket.start, bucket.start + 1, bucket.start,
                            0, bucket.start, 99], dtype=torch.int32)
        mixed = plan_segment_mixed(t.call_masked, TSCH, plan, bucket)(x, pos)
        active = pos == bucket.start
        assert torch.equal(mixed[active], plain[active])
        assert torch.equal(mixed[~active], x[~active])


def test_program_count_and_reuse():
    """One program per (bucket, batch shape); re-sampling builds none."""
    ts = make_dataset("gmm", n=512, dim=16, num_modes=8, spread=0.05, seed=5,
                      device="cpu")
    gd = GoldDiff(OptimalDenoiser(ts, TSCH, device="cpu"))
    plan = build_plan(gd.engine, num_steps=10)
    assert plan.num_buckets <= 4
    kw = dict(program_cache=gd.engine.program, jitter=gd.engine.jitter)
    sample_plan(gd.call_masked, TSCH, (4, 16), plan, **kw)
    segs = [k for k in gd.engine._programs if k[0] == "plan_seg"]
    assert len(segs) == plan.num_buckets == gd.engine._builds
    sample_plan(gd.call_masked, TSCH, (4, 16), plan, **kw)
    assert gd.engine._builds == plan.num_buckets
    sample_plan(gd.call_masked, TSCH, (8, 16), plan, **kw)
    segs = [k for k in gd.engine._programs if k[0] == "plan_seg"]
    assert len(segs) == 2 * plan.num_buckets
    # compile_only builds exactly what a run then uses
    assert sample_plan(gd.call_masked, TSCH, (2, 16), plan, compile_only=True,
                       **kw) is None
    n0 = gd.engine._builds
    sample_plan(gd.call_masked, TSCH, (2, 16), plan, **kw)
    assert gd.engine._builds == n0 == 3 * plan.num_buckets
    with pytest.raises(ValueError, match="program_cache"):
        sample_plan(gd.call_masked, TSCH, (2, 16), plan, compile_only=True)
    # on the CPU nothing is captured: jitter hands the function back
    assert gd.engine._captures == 0
    assert gd.engine.jitter(test_program_count_and_reuse, (2, 16)) is \
        test_program_count_and_reuse
