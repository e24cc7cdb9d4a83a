"""The online quality monitor (``repro_torch.obs.quality``) against the
reference's (``repro.obs.quality``), on the CPU: the recall probe, its
static shapes and warmup, the sampling stream and the concentration
curve (the cases of the reference's monitor tests), and the monitor
inside ``ServeRuntime`` beside the reference's runtime on the same
store, index and x_T.  Stores and the index cross from the reference
(``store_from_numpy``, ``index_from_numpy``); recall values are set
overlaps and must be equal."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.runtime as r_runtime
import repro.launch.serve as r_serve
import repro_torch.launch.runtime as t_runtime
from _runtime_parity import FakeClock, port_noise
from repro.core import GoldDiffEngine as JEngine
from repro.core import make_schedule as jmake_schedule
from repro.data import gmm as jgmm
from repro.index import build_index as jbuild_index
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import QualityMonitor as JMonitor
from repro_torch.core import GoldDiffEngine, make_schedule, store_from_numpy
from repro_torch.index import index_from_numpy, screening_recall
from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.obs import MetricsRegistry, QualityMonitor

JSCH, TSCH = jmake_schedule("ddpm_linear", 1000), make_schedule(
    "ddpm_linear", 1000)
IX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
             "proxy_sorted", "proxy_norms_sorted")


def carry(js, jix):
    st = store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                          js.image_shape, device="cpu")
    ix = index_from_numpy(*(np.asarray(getattr(jix, f)) for f in IX_FIELDS),
                          max_cluster=jix.max_cluster, device="cpu")
    return st, ix


@pytest.fixture(scope="module")
def engines():
    js = jgmm(256, dim=8, seed=0)
    jix = jbuild_index(js, num_clusters=8)
    st, ix = carry(js, jix)
    return (JEngine(js, JSCH, index=jix, index_mode="always"),
            GoldDiffEngine(st, TSCH, index=ix, index_mode="always",
                           device="cpu"))


@pytest.mark.parametrize("t", [400, 700, 950])
def test_recall_probe_matches_reference(engines, t):
    jeng, eng = engines
    x = np.random.default_rng(t).normal(size=(4, 8)).astype(np.float32)
    want = JMonitor(jeng, registry=JRegistry(), probe_rows=2).probe_recall(
        jnp.asarray(x), t)
    mon = QualityMonitor(eng, registry=MetricsRegistry(), probe_rows=2)
    rec = mon.probe_recall(x, t)
    assert rec == want and 0.0 <= rec <= 1.0
    # recomputed from the engine's own screens, outside the monitor
    a, _ = eng.constants(t)
    q = torch.from_numpy(x[:2] / np.float32(a))
    m_t, _ = eng.sizes(t)
    pos, pd2 = eng.coarse_indexed(q, eng.padded_m(t), eng.nprobe(t))
    direct = screening_recall(pos, pd2, eng.index_perm, eng.coarse(q, m_t))
    assert rec == pytest.approx(direct)
    h = mon.health()
    assert h["n_recall_probes"] == 1 and h["screen_recall_last"] == rec
    # a tensor input gives the same
    assert mon.probe_recall(torch.from_numpy(x), t) == rec


def test_probe_is_static_shape_and_warmup_builds(engines):
    _, eng = engines
    mon = QualityMonitor(eng, registry=MetricsRegistry(), probe_rows=2)
    assert mon.warmup([400, 700]) == 2
    keys = [k for k in eng._programs if str(k[0]).startswith("obs_screen")]
    assert {k[0] for k in keys} == {"obs_screen_exact", "obs_screen_ivf"}
    b0 = eng._builds
    assert mon.probe_recall(np.ones((4, 8), np.float32), 400) is not None
    assert mon.probe_recall(np.ones((1, 8), np.float32), 700) is not None
    assert eng._builds == b0, "warmed probes must not build"
    # the fault injector's default targets leave the probes alone
    from repro_torch.launch.faults import DEFAULT_TARGETS
    assert not any(k[0] in DEFAULT_TARGETS for k in keys)


def test_sampling_and_concentration_match_reference(engines):
    jeng, eng = engines
    x = np.ones((2, 8), np.float32)

    def decisions(mon, xx):
        return [mon.maybe_probe_recall(xx, 400) is not None
                for _ in range(16)]
    d = decisions(QualityMonitor(eng, registry=MetricsRegistry(),
                                 sample_rate=0.5, seed=7), x)
    assert d == decisions(QualityMonitor(eng, registry=MetricsRegistry(),
                                         sample_rate=0.5, seed=7), x)
    assert d == decisions(JMonitor(jeng, registry=JRegistry(),
                                   sample_rate=0.5, seed=7), jnp.asarray(x))
    assert any(d) and not all(d)
    mons = (JMonitor(jeng, registry=JRegistry()),
            QualityMonitor(eng, registry=MetricsRegistry()))
    for mon in mons:
        for t in (900, 500, 100):
            mon.record_step(t)
        mon.on_finite_trips(3)
        mon.on_degrade()
    snaps = [m.registry.snapshot() for m in mons]
    assert set(snaps[0]) == set(snaps[1])
    for k in snaps[0]:
        assert snaps[1][k]["value" if "value" in snaps[0][k] else "count"] \
            == snaps[0][k]["value" if "value" in snaps[0][k] else "count"], k
    assert mons[0].health() == mons[1].health()
    with pytest.raises(ValueError, match="sample_rate"):
        QualityMonitor(eng, registry=MetricsRegistry(), sample_rate=1.5)


@pytest.fixture(scope="module")
def served():
    """An indexed plan-mode engine on both sides (gmm N=512, 8 windows),
    a runtime with a monitor (every seam probes) on each, the same
    requests and x_T."""
    js = jgmm(512, dim=16, seed=1)
    jix = jbuild_index(js, num_clusters=8)
    st, ix = carry(js, jix)
    kw = dict(num_steps=4, max_batch=4, index_mode="always")
    ref = r_serve.ServeEngine(js, index=jix, **kw)
    port = ServeEngine(st, index=ix, device="cpu", **kw)
    out = {}
    for name, eng, rt_mod, mk in (
            ("ref", ref, r_runtime, lambda e: JMonitor(
                e.engine, registry=JRegistry(), sample_rate=1.0)),
            ("port", port, t_runtime, lambda e: QualityMonitor(
                e.engine, registry=MetricsRegistry(), sample_rate=1.0))):
        clk = FakeClock()
        mon = mk(eng)
        rt = rt_mod.ServeRuntime(eng, rt_mod.RuntimeConfig(
            clock=clk, sleep=clk.sleep, backoff_base_s=0.001), monitor=mon)
        stats = rt.warmup()
        b0 = eng.engine._builds
        ctx = port_noise(ref, port) if name == "ref" else \
            contextlib.nullcontext()
        with ctx:
            req = (r_serve.Request if name == "ref" else Request)
            tickets = [rt.submit(req(i, 1 + i % 3, seed=40 + i))
                       for i in range(4)]
            rt.run_until_idle()
        out[name] = dict(rt=rt, tickets=tickets, stats=stats,
                         builds=eng.engine._builds - b0, health=rt.health())
    return out


def test_runtime_monitor_matches_reference(served):
    ref, port = served["ref"], served["port"]
    assert port["stats"]["probe_ts_warmed"] == ref["stats"]["probe_ts_warmed"]
    assert port["builds"] == 0 and port["health"]["compiles_post_warmup"] == 0
    for t in port["tickets"]:
        assert t.status == "done" and np.isfinite(t.images).all()
    keys = ("n_recall_probes", "n_steps_observed", "subset_frac_p50",
            "probe_occupancy_p50", "screen_recall_last",
            "screen_recall_p50")
    for k in keys:
        assert port["health"][k] == pytest.approx(ref["health"][k]), k
    assert port["health"]["n_recall_probes"] > 0
    for r, p in zip(ref["tickets"], port["tickets"]):
        np.testing.assert_allclose(p.images, np.asarray(r.images), atol=1e-4)
    # the monitor's metrics live in the runtime's registry
    snap = port["rt"].metrics_snapshot()
    assert "golddiff_steps_total" in snap


def test_runtime_monitor_counts_guard_trips():
    """A NaN storm's finite-guard trips and the degraded waves reach the
    monitor's counters (the runtime's hooks)."""
    from repro_torch.launch.faults import FaultConfig, injected
    eng = ServeEngine("gmm", {"n": 256, "dim": 8}, num_steps=4, max_batch=2,
                      device="cpu")
    mon = QualityMonitor(eng.engine, registry=MetricsRegistry())
    clk = FakeClock()
    rt = ServeRuntime(eng, RuntimeConfig(clock=clk, sleep=clk.sleep),
                      monitor=mon)
    rt.warmup()
    with injected(FaultConfig(nan_rate=1.0)):
        t = rt.submit(Request(0, 2, seed=3))
        rt.run_until_idle()
    assert t.status == "done" and np.isfinite(t.images).all()
    h = rt.health()
    assert mon.finite_trips.value == rt.counters["finite_trips"] > 0
    assert mon.degrades.value >= 1
    assert h["n_steps_observed"] > 0 and h["compiles_post_warmup"] == 0
