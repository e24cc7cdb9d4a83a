"""Observability (``repro_torch.obs``) held against the reference's
(``repro.obs``): the same tracer calls give the same events under a
fake clock, the histograms the same quantiles, the registries the same
snapshot and Prometheus text; the disabled tracer changes no output and
builds nothing; the static entry points' ``engine.*`` spans and
``sample_plan``'s ``plan.segment`` spans carry the reference's event
names in order."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as r_obs
from repro.core import GoldDiffEngine as RGoldDiffEngine
from repro.core import build_plan as r_build_plan
from repro.core import make_schedule as r_make_schedule
from repro.core import sample_plan as r_sample_plan
from repro.data import gmm as r_gmm
from repro_torch.core import (GoldDiffEngine, build_plan, make_schedule,
                              sample_plan)
from repro_torch.core.dataset import store_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.faults import FaultConfig, injected
from repro_torch.obs import (NULL_TRACER, Histogram, MetricsRegistry, Tracer,
                             install_dispatch_tracing, set_tracer, tracer,
                             uninstall_dispatch_tracing)


class StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(autouse=True)
def _no_obs_leak():
    yield
    assert tracer() is NULL_TRACER, "a test leaked an installed tracer"
    assert ops.dispatch_hook() is None, "a test leaked a dispatch hook"


def drive(tr):
    with tr.span("outer", t=400):
        tr.event("mark", rows=3)
        with tr.span("inner", shape=(2, 3)):
            tr.event("deep")
        tr.event("after")
    tr.event("top")
    return tr.events()


@pytest.mark.parametrize("capacity", [3, 64])
def test_tracer_events_equal_reference(capacity):
    ev = drive(Tracer(capacity=capacity, clock=StepClock()))
    r_ev = drive(r_obs.Tracer(capacity=capacity, clock=StepClock()))
    assert ev == r_ev
    assert NULL_TRACER.events() == [] and not NULL_TRACER.enabled


def test_set_tracer_and_dump(tmp_path):
    tr = Tracer(clock=StepClock())
    assert set_tracer(tr) is NULL_TRACER and tracer() is tr
    drive(tr)
    assert set_tracer(None) is tr
    n = tr.dump(str(tmp_path / "t.jsonl"))
    lines = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert n == len(lines) == 8 and lines[0]["name"] == "outer"


@pytest.mark.parametrize("n, reservoir", [(50, 1024), (5000, 64)])
def test_histogram_quantiles_equal_reference(n, reservoir):
    vals = np.random.default_rng(n).exponential(size=n)
    h, r_h = Histogram("h", reservoir=reservoir), \
        r_obs.Histogram("h", reservoir=reservoir)
    for v in vals:
        h.observe(v)
        r_h.observe(v)
    assert h.cell() == r_h.cell()


def test_registry_exports_equal_reference():
    outs = []
    for mod in (r_obs, __import__("repro_torch.obs", fromlist=["x"])):
        reg = mod.MetricsRegistry()
        reg.counter("serve_done_total", "done").inc(3)
        reg.gauge("queue depth").set(2.5)
        h = reg.histogram("lat", "latency", reservoir=8)
        for v in range(20):
            h.observe(v / 7)
        with pytest.raises(TypeError):
            reg.gauge("serve_done_total")
        outs.append((reg.snapshot(), reg.prometheus()))
    assert outs[0] == outs[1]


# -- engine and sampler spans -------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    store = r_gmm(256, dim=8, seed=0)._replace(labels=None)
    sched = make_schedule("ddpm_linear", 1000)
    p = store_from_numpy(*(np.asarray(a) for a in (
        store.X, store.proxy, store.x_norms, store.proxy_norms)),
        store.image_shape, device="cpu")
    return (RGoldDiffEngine(store, r_make_schedule("ddpm_linear", 1000)),
            GoldDiffEngine(p, sched, device="cpu"))


def names(tr):
    return [(e["kind"], e["name"]) for e in tr.events()]


@pytest.mark.parametrize("entry", ["denoise", "select", "full_scan"])
def test_engine_spans_match_reference(pair, entry):
    r_eng, eng = pair
    x = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    plain = getattr(eng, entry)(torch.from_numpy(x), 300)
    r_tr, tr = r_obs.Tracer(), Tracer()
    r_obs.set_tracer(r_tr)
    set_tracer(tr)
    try:
        getattr(r_eng, entry)(jnp.asarray(x), 300)
        traced = getattr(eng, entry)(torch.from_numpy(x), 300)
    finally:
        r_obs.set_tracer(None)
        set_tracer(None)
    assert names(tr) == names(r_tr)
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)
    begin = tr.events()[0]
    assert begin["tags"]["t"] == 300 and begin["tags"]["shape"] == (3, 8)
    for e in tr.events()[1:-1]:
        assert e["tags"]["flops"] > 0 and e["tags"]["bytes"] > 0


def test_plan_segment_spans_and_dispatch_tracing(pair):
    r_eng, eng = pair
    plan, r_plan = build_plan(eng, 6), r_build_plan(r_eng, 6)
    x = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32)
    out = []
    for kind, e, p in (("ref", r_eng, r_plan), ("port", eng, plan)):
        tr = r_obs.Tracer() if kind == "ref" else Tracer()
        (r_obs.set_tracer if kind == "ref" else set_tracer)(tr)
        try:
            if kind == "ref":
                y = r_sample_plan(e.denoise_masked, e.schedule, (2, 8),
                                  jax.random.PRNGKey(0), p,
                                  x_init=jnp.asarray(x),
                                  program_cache=e.program, jitter=e.jitter)
            else:
                y = sample_plan(e.denoise_masked, e.schedule, (2, 8), p,
                                x_init=torch.from_numpy(x),
                                program_cache=e.program, jitter=e.jitter)
        finally:
            (r_obs.set_tracer if kind == "ref" else set_tracer)(None)
        out.append((names(tr), np.asarray(y)))
    assert out[0][0] == out[1][0]
    assert [n for n in out[1][0] if n[0] == "begin"] == \
        [("begin", "plan.segment")] * plan.num_buckets
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=1e-5)
    # the dispatch seam: spans per dispatch, counts per kind, composes
    # with the fault injector, and uninstalls back to the injector
    reg = MetricsRegistry()
    tr = Tracer()
    with injected(FaultConfig(seed=1)) as inj:
        hook = install_dispatch_tracing(tr, reg)
        set_tracer(tr)
        try:
            sample_plan(eng.denoise_masked, eng.schedule, (2, 8), plan,
                        x_init=torch.from_numpy(x),
                        program_cache=eng.program, jitter=eng.jitter)
        finally:
            set_tracer(None)
            uninstall_dispatch_tracing(hook)
        assert ops.dispatch_hook() is inj
    assert reg.counter("golddiff_dispatch_total_plan_seg").value == \
        plan.num_buckets
    assert [n for n in names(tr) if n[0] == "begin"] == [
        ("begin", "plan.segment"), ("begin", "dispatch.plan_seg")] * \
        plan.num_buckets


def test_disabled_tracer_builds_nothing(pair):
    _, eng = pair
    plan = build_plan(eng, 6)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8)).astype(np.float32))
    kw = dict(x_init=x, program_cache=eng.program, jitter=eng.jitter)
    a = sample_plan(eng.denoise_masked, eng.schedule, (2, 8), plan, **kw)
    b0 = eng._builds
    b = sample_plan(eng.denoise_masked, eng.schedule, (2, 8), plan, **kw)
    assert eng._builds == b0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
