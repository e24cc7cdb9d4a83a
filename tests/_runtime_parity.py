"""Shared by the port's runtime and epoch tests: one scripted scenario
run on the reference's runtime and on the port's, each with its own
package's tracer, fault injector and a fake clock, and the records
compared.  The reference's runtime draws the port's x_T, so that
their deliveries can be compared too.

The scenarios of ``SCENARIOS`` also run on the ranks of a
``ProcessMesh`` (``tests/_pmesh_ranks.py``), which import this module
without JAX: the reference's modules load on first use of ``REF``.
There ``submit`` admits on rank 0 only and a follower's clock raises
when read (``FollowerClock``)."""
import contextlib

import numpy as np

import repro_torch.launch.faults as t_faults
import repro_torch.launch.runtime as t_runtime
import repro_torch.launch.serve as t_serve
import repro_torch.obs.trace as t_trace
from repro_torch.core import sample_plan
from repro_torch.launch.serve import Request

class Pkg:
    """One package's runtime modules (hashable: a key of ``engines``)."""

    def __init__(self, **mods):
        self.__dict__.update(mods)


PORT = Pkg(faults=t_faults, runtime=t_runtime, serve=t_serve, trace=t_trace)
ENG_KW = dict(num_steps=4, max_batch=4)


def __getattr__(name):
    """``REF``, the reference's runtime modules, imported on first use."""
    if name != "REF":
        raise AttributeError(name)
    if "REF" in globals():
        return globals()["REF"]
    import repro.launch.faults as r_faults
    import repro.launch.runtime as r_runtime
    import repro.launch.serve as r_serve
    import repro.obs.trace as r_trace
    ref = Pkg(faults=r_faults, runtime=r_runtime, serve=r_serve,
              trace=r_trace)
    globals()["REF"] = ref
    return ref


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


class FollowerClock(FakeClock):
    """A rank's clock other than rank 0's: the runtime reads rank 0's
    readings, broadcast, never this one."""

    def __call__(self):
        raise AssertionError("a follower rank read its own clock")


def fresh(pkg, eng, clk, **kw):
    kw.setdefault("backoff_base_s", 0.001)
    kw.setdefault("backoff_max_s", 0.005)
    kw.setdefault("breaker_cooldown_s", 0.2)
    r = pkg.runtime.ServeRuntime(eng, pkg.runtime.RuntimeConfig(
        clock=clk, sleep=clk.sleep, **kw))
    r.warmup()
    return r


def record(rt, tickets, tr) -> dict:
    h = rt.health()
    return {"status": [t.status for t in tickets],
            "degraded": [bool(t.degraded) for t in tickets],
            "done_finite": [t.images is None or bool(np.isfinite(t.images).all())
                            for t in tickets],
            "counters": dict(rt.counters),
            "breakers": {k: h[k] for k in h if k.startswith("breaker_")},
            "epochs": (h["serving_epoch"], h["epochs_resident"]),
            "events": [(e["kind"], e["name"]) for e in tr.events()]}


@contextlib.contextmanager
def port_noise(ref_eng, port_eng):
    """The reference ServeEngine's x_T replaced by the port's
    (``_noise_rows``: torch's generator, not JAX's), each wave's own
    program lookup kept, so the fault stream is unchanged."""
    import jax.numpy as jnp
    pending = []
    row_keys, init_noise = ref_eng._row_keys, ref_eng._init_noise

    def keys(items, bucket):
        pending.append((items, bucket))
        return row_keys(items, bucket)

    def noise(k):
        init_noise(k)
        return jnp.asarray(port_eng._noise_rows(*pending.pop()).numpy())

    ref_eng._row_keys, ref_eng._init_noise = keys, noise
    try:
        yield
    finally:
        del ref_eng._row_keys, ref_eng._init_noise


def run_both(engines, scenario, faults=None, **kw):
    """``scenario(pkg, rt, clk) -> tickets`` on both runtimes, each with
    its own package's tracer (and fault injector), recorded; the
    reference draws the port's x_T."""
    out = {}
    REF = __getattr__("REF")
    for pkg in (REF, PORT):
        clk = FakeClock()
        rt = fresh(pkg, engines[pkg], clk, **kw)
        tr = pkg.trace.Tracer(capacity=1 << 14, clock=clk)
        prev = pkg.trace.set_tracer(tr)
        same_x = (port_noise(engines[REF], engines[PORT]) if pkg is REF
                  else contextlib.nullcontext())
        try:
            with same_x:
                if faults is None:
                    tickets = scenario(pkg, rt, clk)
                else:
                    with pkg.faults.injected(
                            pkg.faults.FaultConfig(**faults)):
                        tickets = scenario(pkg, rt, clk)
        finally:
            pkg.trace.set_tracer(prev)
        out[pkg] = (record(rt, tickets, tr), rt, tickets)
    return out


def assert_same(out, images=True):
    REF = __getattr__("REF")
    ref, port = out[REF][0], out[PORT][0]
    for k in ref:
        assert ref[k] == port[k], (k, ref[k], port[k])
    if images:
        assert_images_close(out)


def assert_images_close(out, atol=1e-4):
    """Every delivered image of the port within ``atol`` of the
    reference's (the same scenario's tickets, in order)."""
    pairs = list(zip(out[__getattr__("REF")][2], out[PORT][2]))
    assert pairs
    for r, p in pairs:
        assert (r.images is None) == (p.images is None)
        if p.images is not None:
            np.testing.assert_allclose(p.images, np.asarray(r.images),
                                       rtol=0, atol=atol)


def plan_alone(eng, req: Request) -> np.ndarray:
    """The port's ``sample_plan`` from the request's own row_seed x_T
    (through the engine's program cache: the runtime's programs)."""
    b = eng._bucket_for(req.num_images)
    x = eng._init_noise([(req, 0, req.num_images)], b)
    out = sample_plan(eng.denoiser.call_masked, eng.schedule,
                      tuple(x.shape), eng.plan, clip_value=eng.clip_value,
                      x_init=x, program_cache=eng.engine.program,
                      jitter=eng.engine.jitter)
    return out[:req.num_images].numpy().reshape(
        (req.num_images,) + eng.store.image_shape)


# -- scenarios that also run on the ranks of a ProcessMesh ----------------------

def submit(rt, req):
    """``rt.submit(req)`` where the runtime admits (one process; rank 0
    of a ``ProcessMesh``), else the request id, which :func:`resolve`
    turns into this rank's ticket after the run."""
    if getattr(rt, "front", True):
        return rt.submit(req)
    return req.request_id


def resolve(rt, tickets):
    return [rt.ticket(t) if isinstance(t, (int, np.integer)) else t
            for t in tickets]


def scen_clean(pkg, rt, clk):
    R = pkg.serve.Request
    ts = [submit(rt, R(0, 3, seed=7)), submit(rt, R(1, 1, seed=9))]
    rt.run_until_idle()
    return resolve(rt, ts)


def scen_deadline(pkg, rt, clk):
    R = pkg.serve.Request
    t_q = submit(rt, R(0, 1, seed=1, deadline_s=5.0))
    clk.t = 10.0
    rt.run_until_idle()
    t_a = submit(rt, R(1, 1, seed=21))
    t_b = submit(rt, R(2, 2, seed=22, deadline_s=5.0))
    assert rt.pump()
    clk.t = 20.0
    rt.run_until_idle()
    t_c = submit(rt, R(3, 1, seed=23, deadline_s=1000.0))
    rt.pump()
    clk.t = 2020.0
    rt.run_until_idle()
    return resolve(rt, [t_q, t_a, t_b, t_c])


def scen_join(pkg, rt, clk):
    R = pkg.serve.Request
    t1 = submit(rt, R(0, 1, seed=11))
    assert rt.pump()
    t2 = submit(rt, R(1, 2, seed=12))
    rt.run_until_idle()
    return resolve(rt, [t1, t2])


def scen_faults(pkg, rt, clk):
    """Waves of 1-3 images, some joining waves in flight, under
    ``FAULTS``."""
    R = pkg.serve.Request
    ts = []
    for i in range(6):
        ts.append(submit(rt, R(i, 1 + i % 3, seed=70 + i)))
        if i % 2:
            rt.pump()
    rt.run_until_idle()
    return resolve(rt, ts)


# every fault kind a sharded engine takes, at seeded rates, with the
# runtime settings that reach each rung
FAULTS = dict(seed=23, shard_drop_rate=0.15, error_rate=0.1, oom_rate=0.1,
              nan_rate=0.2, evict_rate=0.15)
FAULTS_KW = dict(max_retries=2, breaker_threshold=2)
SCENARIOS = {"clean": (scen_clean, None, {}),
             "deadline": (scen_deadline, None, {}),
             "join": (scen_join, None, {}),
             "faults": (scen_faults, FAULTS, FAULTS_KW)}


def run_one(pkg, eng, scenario, faults=None, clk=None, install=True,
            around=contextlib.nullcontext, **kw):
    """One scenario on one runtime, with its package's tracer and, when
    ``faults`` is given and ``install``, an injector, inside ``around()``
    (after the warmup): ``(record, tickets)``."""
    clk = clk or FakeClock()
    rt = fresh(pkg, eng, clk, **kw)
    # a follower's events carry a clock of their own (not compared)
    tr = pkg.trace.Tracer(capacity=1 << 14, clock=FakeClock() if isinstance(
        clk, FollowerClock) else clk)
    prev = pkg.trace.set_tracer(tr)
    try:
        with around():
            if faults is None or not install:
                tickets = scenario(pkg, rt, clk)
            else:
                with pkg.faults.injected(pkg.faults.FaultConfig(**faults)):
                    tickets = scenario(pkg, rt, clk)
    finally:
        pkg.trace.set_tracer(prev)
    return record(rt, tickets, tr), tickets
