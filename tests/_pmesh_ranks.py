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
* the refusals: ``ServeRuntime``, a batch that does not divide over the
  batch axis, a hot swap, a patch base, and a mesh or engine left to its
  default device (the card, which this host lacks) or given another
  device than the mesh's, each as ``"<type>: <text>"``; and where a gloo
  mesh given no device puts a rank's shard (the caller's default).
"""
import datetime
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
TIMEOUT = datetime.timedelta(seconds=120)   # every collective's limit
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


def refused(fn) -> str:
    try:
        fn()
    except Exception as e:               # the test matches type and text
        return f"{type(e).__name__}: {e}"
    return ""


def run(refd) -> dict:
    from repro_torch.core import (GoldDiff, GoldDiffEngine, OptimalDenoiser,
                                  build_plan, make_schedule, make_store,
                                  sample_plan)
    from repro_torch.core.denoisers import PatchDenoiser
    from repro_torch.distributed import ProcessMesh
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.runtime import ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    sch = make_schedule("ddpm_linear", 1000)
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
    out["err_runtime"] = refused(lambda: ServeRuntime(srv))
    img = make_store(np.zeros((8, 4, 4, 3), np.float32), (4, 4, 3),
                     device="cpu")
    out["err_patch_base"] = refused(lambda: GoldDiff(
        PatchDenoiser(img, sch, device="cpu"), mesh=pm))
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
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def rank_main(rank: int, world: int, store_path: str, out: str,
              ref_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        np.savez(f"{out}_{rank}.npz", **run(dict(np.load(ref_path))))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(WORLD, os.path.join(d, "store"),
                                  sys.argv[1], sys.argv[2]),
                 nprocs=WORLD, join=True)
    print("PASS")
