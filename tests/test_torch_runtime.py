"""The serving runtime (``repro_torch.launch.runtime``) held against the
reference's (``repro.launch.runtime``): the same scripted scenarios run
on both, and their ticket statuses, degraded flags, counters, breaker
states and trace event names (in order) must be equal.  Deliveries are
held bit for bit against the port's own ``sample_plan`` from the same
``row_seed`` x_T.  Both runtimes run on a fake clock with an injected
sleep, on module-scoped warmed engines (gmm, N=512, dim 16, 4 steps in
two plan buckets, max_batch 4), so nothing waits."""
import numpy as np
import pytest

import repro.launch.runtime as r_runtime
import repro.launch.serve as r_serve
import repro_torch.launch.faults as t_faults
from _runtime_parity import (ENG_KW, PORT, REF, FakeClock, assert_same,
                             fresh, plan_alone, run_both)
from repro_torch.launch.runtime import (CircuitBreaker, RuntimeConfig,
                                        ServeRuntime, validate_request)
from repro_torch.launch.serve import Request, ServeEngine

@pytest.fixture(scope="module")
def engines():
    ref = r_serve.ServeEngine("gmm", {"n": 512, "dim": 16}, **ENG_KW)
    port = ServeEngine("gmm", {"n": 512, "dim": 16}, device="cpu", **ENG_KW)
    return {REF: ref, PORT: port}


# -- admission ---------------------------------------------------------------

@pytest.mark.parametrize("req, match", [
    (Request(0, 2.5, seed=0), "num_images must be an int"),
    (Request(0, True, seed=0), "num_images must be an int"),
    (Request(0, 0, seed=0), ">= 1"),
    (Request(0, 9, seed=0), "exceeds the per-request cap"),
    (Request(0, 1, seed=1.5), "seed must be an int"),
    (Request(0, 1, seed=-1), "seed must be >= 0"),
    (Request(0, 1, seed=0, deadline_s=0.0), "deadline_s must be positive"),
])
def test_validate_request_matches_reference(req, match):
    ref_req = r_serve.Request(req.request_id, req.num_images, req.seed,
                              deadline_s=req.deadline_s)
    with pytest.raises(ValueError, match=match):
        validate_request(req, 8)
    with pytest.raises(ValueError, match=match):
        r_runtime.validate_request(ref_req, 8)


def test_queue_full(engines):
    def scen(pkg, rt, clk):
        ts = [rt.submit(pkg.serve.Request(i, 1, seed=i + 1)) for i in range(2)]
        with pytest.raises(pkg.runtime.QueueFullError):
            rt.submit(pkg.serve.Request(2, 1, seed=3))
        rt.run_until_idle()
        return ts
    assert_same(run_both(engines, scen, max_queue=2))


def test_static_engine_and_monitor_rejected(engines):
    # a QualityMonitor is accepted and joins health(); a static engine
    # is still rejected
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quality import QualityMonitor
    mon = QualityMonitor(engines[PORT].engine, registry=MetricsRegistry())
    rt = ServeRuntime(engines[PORT], monitor=mon)
    assert rt.monitor is mon and rt.registry is mon.registry
    h = rt.health()
    assert h["n_recall_probes"] == 0 and h["n_steps_observed"] == 0
    assert set(mon.health()) <= set(h)
    static = ServeEngine("cifar_like", {"n": 64}, base="pca", num_steps=3,
                         device="cpu")
    with pytest.raises(ValueError, match="static"):
        ServeRuntime(static)


# -- clean path: parity with serve and sample_plan, zero builds ---------------

def test_clean_path_bit_equal_and_zero_builds(engines):
    eng = engines[PORT]

    def scen(pkg, rt, clk):
        ts = [rt.submit(pkg.serve.Request(0, 3, seed=7)),
              rt.submit(pkg.serve.Request(1, 1, seed=9))]
        rt.run_until_idle()
        return ts
    fresh(PORT, eng, FakeClock())
    b0 = eng.engine._builds
    out = run_both(engines, scen)
    assert_same(out)
    rec, rt, tickets = out[PORT]
    assert eng.engine._builds == b0
    assert rt.health()["compiles_post_warmup"] == 0
    served = eng.serve([Request(0, 3, seed=7), Request(1, 1, seed=9)])
    for t, r in zip(tickets, served):
        assert t.status == "done" and not t.degraded
        np.testing.assert_array_equal(t.images, r.images)
    np.testing.assert_array_equal(tickets[0].images,
                                  plan_alone(eng, Request(0, 3, seed=7)))


# -- deadlines ---------------------------------------------------------------

def test_deadlines_in_queue_at_seams_and_at_delivery(engines):
    def scen(pkg, rt, clk):
        R = pkg.serve.Request
        t_q = rt.submit(R(0, 1, seed=1, deadline_s=5.0))
        clk.t = 10.0
        rt.run_until_idle()
        t_a = rt.submit(R(1, 1, seed=21))
        t_b = rt.submit(R(2, 2, seed=22, deadline_s=5.0))
        assert rt.pump()
        clk.t = 20.0
        rt.run_until_idle()
        t_c = rt.submit(R(3, 1, seed=23, deadline_s=1000.0))
        rt.pump()
        clk.t = 2020.0
        rt.run_until_idle()
        return [t_q, t_a, t_b, t_c]
    out = run_both(engines, scen)
    assert_same(out)
    rec, rt, tickets = out[PORT]
    assert rec["status"] == ["expired", "done", "expired", "expired"]
    assert rt.health()["deadline_miss_rate"] == pytest.approx(3 / 4)
    assert rec["counters"]["repacks"] >= 1


# -- the degradation ladder --------------------------------------------------

def two_waves(pkg, rt, clk):
    R = pkg.serve.Request
    t1 = rt.submit(R(0, 2, seed=31))
    rt.run_until_idle()
    t2 = rt.submit(R(1, 2, seed=32))
    rt.run_until_idle()
    return [t1, t2]


def test_nan_storm_finite_guard_and_exact_rung(engines):
    out = run_both(engines, two_waves, faults=dict(seed=3, nan_rate=1.0),
                   breaker_threshold=1)
    assert_same(out)
    rec = out[PORT][0]
    assert rec["degraded"] == [True, True] and all(rec["done_finite"])
    assert rec["counters"]["finite_trips"] >= 1
    assert rec["counters"]["exact_waves"] >= 1


def test_transient_errors_retry_then_succeed(engines):
    def scen(pkg, rt, clk):
        t = rt.submit(pkg.serve.Request(0, 3, seed=41))
        rt.run_until_idle()
        return [t]
    out = run_both(engines, scen, faults=dict(seed=5, error_rate=0.6),
                   max_retries=100)
    assert_same(out)
    assert out[PORT][0]["counters"]["retries"] >= 1


def test_retries_exhausted_then_gaussian_rung(engines):
    def scen(pkg, rt, clk):
        t = rt.submit(pkg.serve.Request(0, 2, seed=51))
        rt.run_until_idle()
        return [t]
    out = run_both(engines, scen, faults=dict(seed=6, error_rate=1.0),
                   max_retries=2, seed=123)
    assert_same(out)
    rec, rt, (t,) = out[PORT]
    assert t.status == "done" and t.degraded and np.isfinite(t.images).all()
    assert rec["counters"]["gauss_segments"] >= 1
    ref_rt = out[REF][1]
    assert rt.cfg.clock.slept == ref_rt.cfg.clock.slept   # seeded backoff


def test_oom_split_and_short_rung(engines):
    def scen(pkg, rt, clk):
        R = pkg.serve.Request
        ts = [rt.submit(R(0, 2, seed=61)), rt.submit(R(1, 2, seed=62))]
        rt.run_until_idle()
        return ts
    out = run_both(engines, scen, faults=dict(seed=7, oom_rate=0.7),
                   max_retries=1, breaker_threshold=1)
    assert_same(out)
    assert out[PORT][0]["counters"]["oom_splits"] >= 1


def test_evict_storm_to_scan_rung(engines):
    eng = engines[PORT]
    fresh(PORT, eng, FakeClock())
    b0 = eng.engine._builds
    out = run_both(engines, two_waves, faults=dict(seed=8, evict_rate=1.0),
                   breaker_threshold=1)
    assert_same(out)
    rec, rt, _ = out[PORT]
    assert eng.engine._builds > b0
    assert rt.health()["compiles_post_warmup"] > 0
    assert rec["counters"]["scan_waves"] >= 1


def test_cuda_error_propagates_unretried(engines):
    """Only the retryable classes are retried: any other error from a
    dispatch (on the card a sticky context error) leaves ``pump()``."""
    eng = engines[PORT]

    class Sticky:
        calls = 0

        def on_program(self, engine, key):
            pass

        def wrap(self, key, fn):
            def boom(*a, **k):
                Sticky.calls += 1
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return boom if key[0] == "plan_seg" else fn

    clk = FakeClock()
    rt = fresh(PORT, eng, clk)
    prev = t_faults.ops.set_dispatch_hook(Sticky())
    try:
        rt.submit(Request(0, 1, seed=3))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            rt.pump()
    finally:
        t_faults.ops.set_dispatch_hook(prev)
    assert Sticky.calls == 1
    assert rt.counters["retries"] == 0 and rt.counters["gauss_segments"] == 0
    assert not issubclass(RuntimeError, t_faults.RETRYABLE_ERRORS)


# -- continuous batching -------------------------------------------------------

def test_mid_trajectory_join_runs_mixed_segments(engines):
    eng = engines[PORT]

    def scen(pkg, rt, clk):
        R = pkg.serve.Request
        t1 = rt.submit(R(0, 1, seed=11))
        assert rt.pump()
        t2 = rt.submit(R(1, 2, seed=12))
        rt.run_until_idle()
        return [t1, t2]
    out = run_both(engines, scen)
    assert_same(out)
    rec, rt, (t1, t2) = out[PORT]
    assert rec["counters"]["joins"] == 1
    assert rec["counters"]["mixed_segments"] >= 1
    for t, req in ((t1, Request(0, 1, seed=11)), (t2, Request(1, 2, seed=12))):
        np.testing.assert_allclose(t.images, plan_alone(eng, req), rtol=0,
                                   atol=1e-5)


# -- the breaker and observability ----------------------------------------------

@pytest.mark.parametrize("events", [
    [("f", 1.0), ("f", 2.0)], [("f", 1.0), ("s", 1.5), ("f", 2.0)],
    [("f", 1.0), ("f", 2.0), ("s", 7.5), ("f", 100.0), ("f", 120.0)],
    [("f", 1.0), ("f", 2.0), ("s", 3.0), ("s", 8.0)],
])
def test_breaker_state_machine_matches_reference(events):
    brs = [CircuitBreaker(2, 10.0, 5.0), r_runtime.CircuitBreaker(2, 10.0,
                                                                  5.0)]
    for kind, now in events:
        for br in brs:
            (br.record_failure if kind == "f" else br.record_success)(now)
        for at in (now, now + 4.0, now + 6.0):
            assert brs[0].state(at) == brs[1].state(at)
            assert brs[0].dwell_s(at) == brs[1].dwell_s(at)


def test_metrics_and_prometheus(engines):
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    clk = FakeClock()
    rt = ServeRuntime(engines[PORT], RuntimeConfig(clock=clk, sleep=clk.sleep),
                      registry=reg)
    rt.warmup()
    rt.submit(Request(0, 1, seed=1))
    rt.run_until_idle()
    snap = rt.metrics_snapshot()
    assert snap["serve_completed_total"]["value"] == 1.0
    assert snap["serve_latency_seconds"]["count"] == 1
    text = rt.prometheus()
    assert "serve_breaker_exec_open 0" in text
    assert 'serve_latency_seconds{quantile="0.5"}' in text


def test_background_thread_serves(engines):
    rt = ServeRuntime(engines[PORT], RuntimeConfig())
    rt.warmup()
    rt.start()
    try:
        t = rt.submit(Request(0, 2, seed=91))
        for _ in range(6000):
            if t.status in ("done", "expired", "failed"):
                break
            rt._stop.wait(0.01)
        assert t.status == "done" and np.isfinite(t.images).all()
    finally:
        rt.stop()


def test_scan_mode_runtime():
    e = ServeEngine("gmm", {"n": 256, "dim": 16}, num_steps=4, max_batch=2,
                    mode="scan", device="cpu")
    rt = ServeRuntime(e, RuntimeConfig(backoff_base_s=0.001))
    rt.warmup()
    t = rt.submit(Request(0, 2, seed=5))
    rt.run_until_idle()
    assert t.status == "done" and not t.degraded
    assert np.isfinite(t.images).all()
