"""The sharded GoldDiff engine on gloo ranks: one shard a rank.

Run as ``python tests/_pmesh_ranks.py OUT REF_NPZ``: eight ranks on a
``dist.FileStore`` (no port), each process group made with an explicit
timeout, run the same calls on the same inputs (SPMD) and each writes
what it returned to ``OUT_<rank>.npz``.  ``REF_NPZ`` holds the stores,
the index and the inputs the reference's sharded engine ran on
(``tests/test_torch_sharding.py``'s ``reference`` fixture), so that the
tests can hold every rank's outputs against the reference's and against
the port's ``LocalMesh`` engine, and the ranks' outputs against each
other:

* a one-axis ``ProcessMesh`` of 8 (``make_process_mesh((8,))``): the
  exact engine's ``denoise``, ``denoise_masked``, ``select`` and
  ``full_scan`` at t = 500, ``strategy="measure"``'s crossover, the
  8-step plan through ``GoldDiff`` and ``sample_plan``, and
  ``ServeEngine(mesh=...)``'s ``warmup()`` and ``serve()``;
* a (4, 2) ("data", "model") ``ProcessMesh``: the indexed engine at
  t = 500 with the model axis replicated, and every route of ``ROUTES``
  (and the indexed one) with ``batch_axis="model"`` at ``TS``;
* the serving runtime over the ranks (``ServeRuntime`` over a
  ``ServeEngine(mesh=...)`` of 8): ``tests/_runtime_parity.py``'s
  scenarios with a fake clock on rank 0 and a ``FollowerClock`` (which
  raises when read) on the others, the fault scenario with the injector
  on every rank and on rank 3 alone, each rank's records and
  deliveries; the loop on a thread (``start()`` / ``stop()``); the
  Gaussian rung's segment from the slabs' sums; the quality monitor's
  recall probes over the indexed engine, and a runtime with a monitor;
* GoldDiff over the Kamb and PCA bases on an image store (one slab a
  rank) at ``TS``: each step's output and support, and the shapes of
  every store-row tensor a rank holds; a ``ServeEngine(base="pca")``
  over a one-rank mesh of each rank (a group of its own);
* a real (not drawn) retryable error on one rank, last, in a group of
  its own with an ``ERROR_TIMEOUT_S`` limit: rank 3's segment raises a
  ``TransientExecutorError``, which no rank retries; every rank's
  ``pump()`` raises (rank 3 at once, the others when the segment's
  collective times out), and each rank records what and when;
* the refusals: ``submit`` off rank 0, ``ServeRuntime.hot_swap``, a
  batch that does not divide over the batch axis, an engine hot swap,
  the masked step over a patch base, and a mesh or engine left to its
  default device (the card, which this host lacks) or given another
  device than the mesh's, each as ``"<type>: <text>"``; and where a gloo
  mesh given no device puts a rank's shard (the caller's default).
"""
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
TIMEOUT = datetime.timedelta(seconds=120)   # every collective's limit
ERROR_TIMEOUT_S = 10     # the real-error scenario's group: its limit
REF_T = 500          # the reference runs one t: each t is a new compile
TS = (100, 500, 900)
INDEX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
                "proxy_sorted", "proxy_norms_sorted")
ROUTES = {
    "staged": dict(fused=False, screen="materialized"),
    "streamed": dict(fused=False, screen="streamed"),
    "fused": dict(fused=True),
    "auto": {},
    "bf16": dict(storage_dtype=torch.bfloat16),
    "bf16 staged": dict(storage_dtype=torch.bfloat16, fused=False),
    "dense": dict(strategy="dense", fused=False),
}
SERVE = dict(num_steps=5, max_batch=4)
SERVE_REQUESTS = ((0, 2, 100), (1, 3, 101), (2, 1, 102))
PATCH_BASES = ("kamb", "pca")
IMG_SHAPE = (16, 16, 3)            # every patch size fits (11 at most)
PCA_SERVE = dict(num_steps=3, max_batch=2)
MONITOR_TS = (300, 600, 900)


def stores(refd):
    """The reference's stores (norms and all) and its index."""
    from repro_torch.core import store_from_numpy
    from repro_torch.index import index_from_numpy
    st = [store_from_numpy(*(refd[f"{tag}_{f}"] for f in
                             ("X", "proxy", "x_norms", "proxy_norms")),
                           (16,), device="cpu") for tag in ("store", "store2")]
    ix = index_from_numpy(*(refd[f"ix_{f}"] for f in INDEX_FIELDS),
                          max_cluster=int(refd["ix_max_cluster"]),
                          device="cpu")
    return st[0], st[1], ix


def image_store(refd):
    """The reference's 16x16x3 image store (the patch bases')."""
    from repro_torch.core import store_from_numpy
    return store_from_numpy(*(refd[f"img_{f}"] for f in
                              ("X", "proxy", "x_norms", "proxy_norms")),
                            IMG_SHAPE, device="cpu")


def tickets_out(tag, tickets) -> dict:
    """A scenario's deliveries, one array a ticket (empty where none)."""
    return {f"rt_{tag}_img{i}": (np.zeros((0,), np.float32)
                                 if t.images is None else t.images)
            for i, t in enumerate(tickets)}


def runtime_runs(store, store2, ix, pm, rank: int) -> dict:
    """(d) The serving runtime over the ranks (see the module doc)."""
    from _runtime_parity import (ENG_KW, PORT, SCENARIOS, FakeClock,
                                 FollowerClock, resolve, run_one, submit)
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.obs import MetricsRegistry, QualityMonitor
    front = pm.host_rank == 0
    clock = lambda: FakeClock() if front else FollowerClock()
    out = {}
    srv = ServeEngine(store, mesh=pm, **ENG_KW)
    for name, (scen, faults, kw) in SCENARIOS.items():
        for where in ("all", "rank3") if faults else ("all",):
            tag = name if where == "all" else f"{name}_rank3"
            rec, tickets = run_one(PORT, srv, scen, faults, clock(),
                                   install=where == "all" or rank == 3,
                                   **kw)
            out[f"rt_{tag}_record"] = json.dumps(rec)
            out.update(tickets_out(tag, tickets))
    # the loop on a thread: rank 0's stop() ends every rank's loop
    rt = ServeRuntime(srv, RuntimeConfig() if front
                      else RuntimeConfig(clock=FollowerClock()))
    rt.warmup()
    rt.start()
    if front:
        t = rt.submit(Request(0, 2, seed=91))
        for _ in range(6000):
            if t.status in ("done", "expired", "failed"):
                break
            time.sleep(0.01)
    rt.stop()
    t = rt.ticket(0)
    out["bg_status"], out["bg_images"] = t.status, t.images
    # the Gaussian rung: its statistics from the slabs' sums
    w = rt._wiener_den()
    out["wiener_on"] = np.asarray([str(w.store.X.device),
                                   str(w.mu.device)])
    b, ts = 4, tuple(int(x) for x in srv.plan.ts)
    gauss_x = np.random.default_rng(5).normal(size=(b, 16)) \
        .astype(np.float32) * 3
    out["gauss_x"] = gauss_x
    out["gauss_seg"] = rt._gauss_program(b, ts, 0, len(ts) - 1)(
        torch.from_numpy(gauss_x))
    # the quality monitor over the indexed engine: the global recall
    isrv = ServeEngine(store2, index=ix, index_mode="always", mesh=pm,
                       probe_schedule=monitor_probes(), **ENG_KW)
    mon = QualityMonitor(isrv.engine, registry=MetricsRegistry(),
                         sample_rate=1.0)
    out["monitor_recall"] = np.asarray(
        [mon.probe_recall(x, t) for x in monitor_queries(store2)
         for t in MONITOR_TS])
    mon = QualityMonitor(isrv.engine, registry=MetricsRegistry(),
                         sample_rate=1.0)
    clk = FakeClock() if front else FollowerClock()
    rt = ServeRuntime(isrv, RuntimeConfig(clock=clk, sleep=clk.sleep),
                      monitor=mon)
    rt.warmup()
    tk = [submit(rt, Request(i, 1 + i % 3, seed=40 + i)) for i in range(4)]
    rt.run_until_idle()
    tk = resolve(rt, tk)
    h = rt.health()
    out["monitor_health"] = json.dumps(
        {k: h[k] for k in MONITOR_HEALTH})
    out["monitor_images"] = np.concatenate([t.images for t in tk])
    return out


def monitor_probes():
    """A probe schedule narrow enough that the recall falls below 1."""
    from repro_torch.index import ProbeSchedule
    return ProbeSchedule(f_lo=1 / 32, f_hi=0.25, safety=1.0, min_probes=1)


def monitor_queries(store2) -> list:
    """The recall probes' queries: noise, and rows near the data."""
    x = np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32)
    return [x, store2.X[:4].numpy() * 0.9 + 0.3 * x]


MONITOR_HEALTH = ("n_recall_probes", "n_steps_observed", "subset_frac_p50",
                  "probe_occupancy_p50", "screen_recall_last",
                  "screen_recall_p50")


def patch_runs(refd, pm, rank: int) -> dict:
    """GoldDiff over each patch base at ``TS``, and the PCA serve on a
    one-rank mesh of its own."""
    from repro_torch.core import GoldDiff, make_denoiser, make_schedule
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.serve import Request, ServeEngine
    sch = make_schedule("ddpm_linear", 1000)
    img = image_store(refd)
    out = {}
    for name in PATCH_BASES:
        gd = GoldDiff(make_denoiser(name, img, sch, device="cpu"), mesh=pm)
        for t in TS:
            x = torch.from_numpy(refd[f"xpatch_{t}"])
            out[f"patch_{name}_{t}"] = gd(x, t)
            out[f"patch_{name}_select_{t}"] = gd.select(x, t)
        base = gd.base
        out[f"patch_{name}_rows"] = np.asarray(
            [gd.engine.X.shape[0], base._slab.shape[0]]
            + [f.shape[0] for f in getattr(base, "_features", {}).values()])
        out[f"patch_{name}_store_on"] = np.asarray(str(base.store.X.device))
    out["err_patch_base"] = refused(lambda: gd.call_masked(
        torch.from_numpy(refd[f"xpatch_{TS[0]}"]), TS[0]))
    # every rank makes every one-rank group, in one order
    groups = [dist.new_group([r], backend="gloo") for r in range(WORLD)]
    one = ProcessMesh("data", group=groups[rank], device="cpu")
    srv = ServeEngine(img, base="pca", mesh=one, **PCA_SERVE)
    st = srv.warmup()
    built = srv.engine._builds
    (res,) = srv.serve([Request(0, 2, seed=5)])
    out["pca_serve"] = res.images
    out["pca_serve_cache"] = np.asarray(
        [st["feature_cache_bytes"], srv.engine._builds - built,
         srv.engine._layout.n_loc])
    return out


def real_error_run(rank: int) -> dict:
    """(e) A real ``TransientExecutorError`` in rank 3's segment (see the
    module doc).  Run last: the group is left broken."""
    from _runtime_parity import FakeClock, FollowerClock
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.faults import TransientExecutorError
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    g = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=ERROR_TIMEOUT_S))
    pm = ProcessMesh("data", group=g, device="cpu")
    srv = ServeEngine("gmm", {"n": 1003, "dim": 16}, mesh=pm, **SERVE)
    clk = FakeClock() if rank == 0 else FollowerClock()
    rt = ServeRuntime(srv, RuntimeConfig(clock=clk, sleep=clk.sleep))
    rt.warmup()
    if rank == 3:
        def fail(*args):
            raise TransientExecutorError("INTERNAL: a real executor failure")
        rt._segment_fn = lambda *args: fail
    if rank == 0:
        rt.submit(Request(0, 2, seed=7))
    t0 = time.perf_counter()
    err = ""
    try:
        rt.pump()
    except Exception as e:               # the test matches the type
        err = type(e).__name__
    return {"real_error": np.asarray(err),
            "real_error_s": np.asarray(time.perf_counter() - t0),
            "real_error_retries": np.asarray(rt.counters["retries"])}


def refused(fn) -> str:
    try:
        fn()
    except Exception as e:               # the test matches type and text
        return f"{type(e).__name__}: {e}"
    return ""


def run(refd) -> dict:
    from repro_torch.core import (GoldDiff, GoldDiffEngine, OptimalDenoiser,
                                  build_plan, make_schedule, sample_plan)
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.runtime import ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    sch = make_schedule("ddpm_linear", 1000)
    rank = dist.get_rank()
    store, store2, ix = stores(refd)
    out = {}

    def steps(tag, eng, x, t, full=True):
        out[f"{tag}_denoise_{t}"] = eng.denoise(x, t)
        out[f"{tag}_masked_{t}"] = eng.denoise_masked(x, t)
        out[f"{tag}_select_{t}"] = eng.select(x, t)
        if full:
            out[f"{tag}_full_{t}"] = eng.full_scan(x, t)

    # (a) one axis of 8: the exact engine, the plan, the serving engine
    pm = make_process_mesh((WORLD,), ("data",), device="cpu")
    eng = GoldDiffEngine(store, sch, mesh=pm)
    out["slab_rows"] = np.asarray(eng._layout.X.shape)
    steps("exact", eng, torch.from_numpy(refd["x_exact"]), REF_T)
    out["err_hot_swap"] = refused(lambda: eng.install_epoch(1, store))
    # one rank measures the crossover, every rank takes its value
    out["measured_frac"] = np.asarray(GoldDiffEngine(
        store, sch, mesh=pm, strategy="measure").crossover_frac)
    gd = GoldDiff(OptimalDenoiser(store, sch, device="cpu"), mesh=pm)
    plan = build_plan(gd.engine, 8)
    out["plan_out"] = sample_plan(
        gd.call_masked, sch, (4, 16), plan,
        x_init=torch.from_numpy(refd["plan_xT"]),
        program_cache=gd.engine.program, jitter=gd.engine.jitter)
    out["plan_keys"] = np.asarray([repr(k[-1]) for k in gd.engine._programs])
    srv = ServeEngine("gmm", {"n": 1003, "dim": 16}, mesh=pm, **SERVE)
    srv.warmup()
    built = srv.engine._builds
    for r in srv.serve([Request(i, n, seed=s) for i, n, s in SERVE_REQUESTS]):
        out[f"serve_{r.request_id}"] = r.images
    out["serve_builds_after_warmup"] = np.asarray(srv.engine._builds - built)
    rt = ServeRuntime(srv)
    # rank 0 admits; the others raise (rank 0 records nothing here)
    out["err_runtime"] = "" if rank == 0 else refused(
        lambda: rt.submit(Request(0, 1, seed=0)))
    out["err_runtime_hot_swap"] = refused(lambda: rt.hot_swap(store))
    out.update(runtime_runs(store, store2, ix, pm, rank))
    out.update(patch_runs(refd, pm, rank))
    # the device rule: the card unless the caller asks for the CPU (no
    # card here, so the default raises); a gloo mesh given no device
    # lays the shards out on the caller's default
    bare = ProcessMesh("data")
    out["bare_devices"] = np.asarray(
        [str(d) for d in bare.shard_devices("data", "meta")])
    out["bare_slab_device"] = np.asarray(str(GoldDiffEngine(
        store, sch, mesh=bare, device="cpu").current_operands().X.device))
    out["err_default_card"] = refused(
        lambda: make_process_mesh((WORLD,), ("data",)))
    out["err_bare_engine_card"] = refused(
        lambda: GoldDiffEngine(store, sch, mesh=bare))
    out["err_other_device"] = refused(
        lambda: GoldDiffEngine(store, sch, mesh=pm, device="meta"))

    # (b) the (4, 2) mesh: the indexed engine, the model axis replicated
    pm42 = make_process_mesh((4, 2), ("data", "model"), device="cpu")
    eng = GoldDiffEngine(store2, sch, index=ix, index_mode="always",
                         mesh=pm42)
    steps("indexed", eng, torch.from_numpy(refd["x_indexed"]), REF_T,
          full=False)

    # (c) ... with the query batch split over "model"
    for route, kw in dict(ROUTES, indexed=None).items():
        if kw is None:
            st, kw = store2, dict(index=ix, index_mode="always")
        else:
            st = store
        eng = GoldDiffEngine(st, sch, mesh=pm42, batch_axis="model", **kw)
        for t in TS:
            steps(f"batch {route}", eng, torch.from_numpy(
                refd[f"x_batch_{'indexed' if route == 'indexed' else 'exact'}"
                     f"_{t}"]), t)
    out["err_batch"] = refused(lambda: eng.denoise(torch.zeros(3, 16), 500))
    out.update(real_error_run(rank))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def rank_main(rank: int, world: int, store_path: str, out: str,
              ref_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        np.savez(f"{out}_{rank}.npz", **run(dict(np.load(ref_path))))
    except BaseException:
        # every rank's own error, not only the first one spawn reports
        import traceback
        print(f"rank {rank}:\n{traceback.format_exc()}", file=sys.stderr)
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(WORLD, os.path.join(d, "store"),
                                  sys.argv[1], sys.argv[2]),
                 nprocs=WORLD, join=True)
    print("PASS")
