"""Ranks that hold only their slab: a committed store epoch opened by
``StoreLifecycle.open_slab`` on gloo ranks.

Run as ``python tests/_slab_ranks.py WORK``: ``WORK`` holds the epochs
(``store``: the one the ranks serve; ``flip``: the same with a byte of
the current epoch's ``X`` flipped; ``pending``: the same with journaled
appends) and ``inputs.npz`` (the queries).  One fork of ``WORLD``
ranks on a ``dist.FileStore``, every process group with ``TIMEOUT``;
each rank first runs the entry points once over a small in-memory store
(``warm``), then:

* the slab run: each rank opens the epoch by slab and reads its host memory
  (``repro_torch.utils.host_memory``) after imports and the process
  group, after ``open_slab``, after the exact and the indexed engine's
  construction, after ``ServeRuntime.warmup()`` (the Wiener rung's sums
  over the slabs) and after a GoldDiff+PCA base's feature caches
  (``build_caches``), with the terms each reading is held to; it runs
  ``select``, ``denoise``, ``denoise_masked`` and ``full_scan`` at ``TS``
  on both engines, keeps the Wiener rung's statistics and the PCA
  bases, then opens ``flip`` with and without ``fallback`` and
  ``pending``, each as what it returned or raised;
* then the whole run: each rank opens the same epoch whole
  (``StoreLifecycle.open`` and ``view("cpu")``) and builds the same
  engines, read from a reading of its own, so that the test can show
  that such a rank fails the bound the slab run passes.

Each rank writes ``WORK/rank_<rank>.npz``.
"""
import datetime
import gc
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=120)   # every collective's limit
TS = (100, 500, 900)
SERVE = dict(num_steps=4, max_batch=4)
PCA_STEPS = 1          # the timesteps whose patch sizes the PCA caches hold
IMG_SHAPE = (16, 16, 3)  # the epoch's images (every patch size fits)
WARM_N = 512           # rows of the warm-up store
# The bound on a rank's host bytes: its resident anonymous + file bytes
# (``RssAnon + RssFile``) over the first reading are at most HOST_SLACK
# times the bytes of the slabs it holds on the host, plus the small
# arrays it read whole, plus HOST_FIXED (the allocator's and the
# interpreter's growth: Python objects, pages a freed buffer leaves with
# the allocator, a first-use module), plus each point's own terms.
HOST_SLACK = 1.05
HOST_FIXED = 12 << 20


def host_bound(slab: int, small: int, extra: int = 0) -> int:
    return int(HOST_SLACK * slab) + small + HOST_FIXED + extra


def resident(m: dict) -> int:
    return m["RssAnon"] + m["RssFile"]


def host_slab(eng) -> int:
    """The bytes of a rank's slab that live on the host (all of it on a
    CPU rank)."""
    return sum(t.numel() * t.element_size() for t in eng._layout.slabs[0]
               if isinstance(t, torch.Tensor) and t.device.type == "cpu")


def opened(fn) -> str:
    """What an ``open_slab`` call returned or raised, as text."""
    try:
        res = fn()
    except Exception as e:              # the test matches type and text
        return f"{type(e).__name__}: {e}"
    return json.dumps({"epoch": res.epoch, "quarantined": res.quarantined})


def warm(pm, sch, dim_shape) -> None:
    """The same entry points once over a small in-memory store (WARM_N
    rows of the epoch's shape), before the first reading: the libraries'
    code pages that a first call faults in (tens of MB of RssFile on
    the CPU) and the interpreter's lazy state are then in the baseline,
    and the readings count what the epoch's slab brings."""
    from repro_torch.core import (GoldDiff, GoldDiffEngine, make_denoiser,
                                  make_store, sampling_timesteps)
    from repro_torch.index import build_index
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    x = np.random.default_rng(1).normal(size=(WARM_N,) + dim_shape)
    st = make_store(x.astype(np.float32), dim_shape, device="cpu")
    ix = build_index(st)
    q = torch.from_numpy(x[:4].reshape(4, -1).astype(np.float32))
    for kw in ({}, dict(index=ix, index_mode="always")):
        eng = GoldDiffEngine(st, sch, mesh=pm, device="cpu", **kw)
        for t in TS:
            eng.select(q, t), eng.denoise(q, t), eng.denoise_masked(q, t)
            if not kw:
                eng.full_scan(q, t)
    ServeRuntime(ServeEngine(st, mesh=pm, device="cpu", **SERVE),
                 RuntimeConfig()).warmup()
    gd = GoldDiff(make_denoiser("pca", st, sch, device="cpu"), mesh=pm)
    gd.base.build_caches(sampling_timesteps(sch, PCA_STEPS + 1)[:-1])


def slab_run(work: str, rank: int) -> dict:
    from repro_torch.core import (GoldDiff, GoldDiffEngine, make_denoiser,
                                  make_schedule, sampling_timesteps)
    from repro_torch.index import StoreLifecycle
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.utils import host_memory
    inp = dict(np.load(os.path.join(work, "inputs.npz")))
    sch = make_schedule("ddpm_linear", 1000)
    pm = make_process_mesh((WORLD,), ("data",), device="cpu")
    warm(pm, sch, IMG_SHAPE)
    out, mem = {}, {}
    gc.collect()
    m0 = host_memory()

    def point(name, slab, extra=0):
        gc.collect()
        m = host_memory()
        mem[name] = dict(delta=resident(m) - resident(m0),
                         bound=host_bound(slab, small, extra), slab=slab,
                         extra=extra, **{k: m[k] - m0[k] for k in m})

    res = StoreLifecycle.open_slab(os.path.join(work, "store"), pm)
    store, ix = res
    small = res.small_bytes
    point("open", 0)
    out["epoch"] = np.asarray(res.epoch)
    out["n_dim"] = np.asarray([store.n, store.dim, ix.max_cluster])
    exact = GoldDiffEngine(store, sch, mesh=pm, device="cpu")
    indexed = GoldDiffEngine(store, sch, index=ix, index_mode="always",
                             mesh=pm, device="cpu")
    point("engine", host_slab(exact) + host_slab(indexed))
    for tag, eng in (("exact", exact), ("indexed", indexed)):
        for t in TS:
            x = torch.from_numpy(inp[f"x_{t}"])
            out[f"{tag}_select_{t}"] = eng.select(x, t)
            out[f"{tag}_denoise_{t}"] = eng.denoise(x, t)
            out[f"{tag}_masked_{t}"] = eng.denoise_masked(x, t)
            if tag == "exact":
                out[f"{tag}_full_{t}"] = eng.full_scan(x, t)
    del exact, indexed, eng
    srv = ServeEngine(store, mesh=pm, device="cpu", **SERVE)
    rt = ServeRuntime(srv, RuntimeConfig())
    rt.warmup()
    w = rt._wiener
    wb = sum(t.numel() * t.element_size() for t in (w.mu, w.V, w.lam))
    point("warmup", host_slab(srv.engine), wb)
    out["wiener_mu"], out["wiener_lam"] = w.mu, w.lam
    del rt, srv, w
    gd = GoldDiff(make_denoiser("pca", store, sch, device="cpu"), mesh=pm)
    ts = sampling_timesteps(sch, PCA_STEPS + 1)[:-1]
    cache = gd.base.build_caches(ts)
    # rank 0 fits each basis from its drawn rows (read, then freed)
    draws = 0 if pm.host_rank else max(
        np.unique(gd.base.fit_draws(gd.base.patch_size(int(t)))[0]).size
        for t in ts) * store.dim * 4
    point("pca", host_slab(gd.engine),
          cache + gd.base._slots.numel() * 4 + draws)
    for p, basis in gd.base._bases.items():
        out[f"pca_basis_{p}"] = basis
    del gd
    mem["first"] = m0
    out["mem"] = json.dumps(mem)
    # the epochs that fail or wait on the journal, on every rank alike
    for fb in (False, True):
        out[f"flip_{fb}"] = opened(lambda: StoreLifecycle.open_slab(
            os.path.join(work, "flip"), pm, fallback=fb))
    out["pending"] = opened(lambda: StoreLifecycle.open_slab(
        os.path.join(work, "pending"), pm))
    return out


def whole_run(work: str) -> str:
    """The ``whole`` reading (see the module doc), after the slab run has
    freed what it held: its own first reading, then the epoch opened
    whole and the same engines."""
    from repro_torch.core import GoldDiffEngine, make_schedule
    from repro_torch.index import SlabEpoch, StoreLifecycle
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.utils import host_memory
    sch = make_schedule("ddpm_linear", 1000)
    pm = make_process_mesh((WORLD,), ("data",), device="cpu")
    gc.collect()
    m0 = host_memory()
    lc = StoreLifecycle.open(os.path.join(work, "store"))
    store, ix = lc.view("cpu")
    del lc
    # the slab run's allowance: the same small arrays, as one rank holds them
    small = SlabEpoch(store, ix, 0, []).small_bytes
    exact = GoldDiffEngine(store, sch, mesh=pm, device="cpu")
    indexed = GoldDiffEngine(store, sch, index=ix, index_mode="always",
                             mesh=pm, device="cpu")
    gc.collect()
    m = host_memory()
    slab = host_slab(exact) + host_slab(indexed)
    return json.dumps({"engine": dict(
        delta=resident(m) - resident(m0), bound=host_bound(slab, small),
        slab=slab)})


def imports() -> None:
    """Every module the runs use, before the first reading (and before
    the ranks fork, so that they inherit them)."""
    import repro_torch.core  # noqa: F401
    import repro_torch.distributed.retrieval  # noqa: F401
    import repro_torch.index.shard  # noqa: F401
    import repro_torch.launch.runtime  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401


def rank_main(rank: int, world: int, store_path: str, work: str) -> None:
    torch.set_num_threads(1)
    imports()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = slab_run(work, rank)
        gc.collect()
        out["whole_mem"] = whole_run(work)
        np.savez(os.path.join(work, f"rank_{rank}.npz"),
                 **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in out.items()})
    except BaseException:
        # every rank's own error, not only the first one the join reports
        import traceback
        print(f"rank {rank}:\n{traceback.format_exc()}", file=sys.stderr)
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    imports()
    with tempfile.TemporaryDirectory() as d:
        # forked: the ranks start with the modules imported (no thread
        # pool or process group exists yet in this process)
        mp.start_processes(rank_main, args=(WORLD, os.path.join(d, "store"),
                                            sys.argv[1]), nprocs=WORLD,
                           join=True, start_method="fork")
    print("PASS")
