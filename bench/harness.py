"""One run of one cell: set-up, the measured window, the traced
readings, and the comparison with the reference that decides
``correct``.

The program under test is ``repro_torch`` alone: its ``ServeEngine``
(``launch/serve.py``) serves every request of the window, and the
benchmark reads from it only the images, the ``plan.segment`` spans of
``obs/trace.py`` and the engine's program counters.  The store's rows
are the benchmark's input, drawn on the device from the seed
(``bench.store``); the program pools its own proxy.  The reference
(``bench.reference``) draws the rows again, after the program's state is
freed, and works out everything else itself.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from bench import manifest as mf
from bench import timing, workcount
from bench.reference import Reference, x_T
from bench.store import blockwise, procedural_rows, sq_norms

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_MIN_S = 0.5        # the profiled block's least unprofiled wall
PROFILE_MAX_REQUESTS = 64
REF_ROWS = 16              # rows the reference takes in one trajectory
ROWS_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark's process must
    not hold: the JAX package and JAX itself, compared by the whole
    name before the first dot (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_rows(cfg: dict, seed: int, device) -> torch.Tensor:
    h, w, c = cfg["image_shape"]
    return procedural_rows(cfg["n"], h, w, c, cfg["num_classes"], seed,
                           device)


def build_program(cfg: dict, mix: dict, X: torch.Tensor, device,
                  rows_dtype=None):
    """The program's ``ServeEngine`` over the rows ``X`` (the store
    assembled from them with the program's own proxy); ``rows_dtype``
    switches on the program's lower-precision store rows (the control)."""
    from repro_torch.core import GoldDiff, GoldDiffConfig, build_plan
    from repro_torch.core.dataset import DatasetStore, downsample_proxy
    from repro_torch.launch.serve import ServeEngine

    shape = tuple(cfg["image_shape"])
    f = cfg["proxy_factor"]
    proxy = blockwise(lambda b: downsample_proxy(b.reshape((-1,) + shape),
                                                 f), X)
    store = DatasetStore(X=X, proxy=proxy, x_norms=sq_norms(X),
                         proxy_norms=sq_norms(proxy), image_shape=shape)
    gd = GoldDiffConfig(**cfg["golddiff"], proxy_factor=f)
    eng = ServeEngine(store, base=cfg["base"], schedule=cfg["schedule"],
                      num_steps=cfg["steps"], gd_cfg=gd,
                      max_batch=mix["max_batch"], mode=cfg["serve_mode"],
                      plan_threshold=cfg["plan_threshold"],
                      clip_value=cfg["clip"], device=device)
    if rows_dtype is not None:
        eng.denoiser = GoldDiff(eng.denoiser.base, gd,
                                storage_dtype=rows_dtype)
        eng.plan = build_plan(eng.engine, cfg["steps"],
                              threshold=cfg["plan_threshold"])
    return eng


def programs_built(eng) -> int:
    return eng.engine._captures + eng.engine._builds


class Served:
    """One request as the window saw it."""

    __slots__ = ("rid", "images", "seed", "latency_s", "segments_s", "out")

    def __init__(self, rid, images, seed):
        self.rid, self.images, self.seed = rid, images, seed
        self.latency_s, self.segments_s, self.out = None, [], None


def serve_group(eng, group, tracer=None) -> list[Served]:
    """Hand ``group`` to ``ServeEngine.serve``; each request's latency is
    the call's wall, from the hand-over to the return of its images."""
    from repro_torch.launch.serve import Request
    reqs = [Request(rid, n, seed) for rid, n, seed in group]
    t0 = time.perf_counter()
    res = eng.serve(reqs)
    dt = time.perf_counter() - t0
    segs = []
    if tracer is not None:
        segs = [e["tags"]["dur"] for e in tracer.events()
                if e["kind"] == "end" and e["name"] == "plan.segment"]
        tracer.clear()
    out = []
    for (rid, n, seed), r in zip(group, res):
        s = Served(rid, n, seed)
        s.latency_s, s.segments_s, s.out = dt, segs, r.images
        out.append(s)
    return out


def delivered(s: Served, image_shape) -> bool:
    return (s.out is not None
            and tuple(s.out.shape) == (s.images,) + tuple(image_shape))


def check_requests(cfg: dict, ref: Reference, served: list[Served],
                   keep_ids: bool = False, log=None, label: str = ""):
    """Each served image's widest gap to the reference's (+inf where the
    image is not finite), over ``served``; with ``keep_ids`` also each
    request's per-step counts of distinct candidate and golden rows.
    ``log`` gets the ``label``ed set's widest and median gap, its worst
    request, and the first images off by more than the limits'
    ``image_tol``."""
    gaps, counts, worst, off = [], [], None, []
    tol = cfg["limits"]["image_tol"]
    mask = torch.zeros(ref.X.shape[0], dtype=torch.bool, device=ref.X.device)
    for s in served:
        rows = [(s.seed, i) for i in range(s.images)]
        imgs, ids = [], []
        for r0 in range(0, len(rows), REF_ROWS):
            x, step_ids = ref.trajectory(x_T(cfg, rows[r0:r0 + REF_ROWS]),
                                         keep_ids)
            imgs.append(x.cpu())
            ids.append(step_ids)
        want = torch.cat(imgs).numpy()
        got = np.asarray(s.out, np.float32).reshape(want.shape)
        diff = np.abs(got - want).reshape(len(rows), -1)
        per_image = [float(d.max()) if np.isfinite(d).all() else float("inf")
                     for d in diff]
        if worst is None or max(per_image) > max(worst[2]):
            worst = (s.rid, s.seed, per_image)
        off += [(s.rid, s.seed, i, g) for i, g in enumerate(per_image)
                if not g <= tol]
        gaps += per_image
        if keep_ids:
            per_step = []
            for si in range(len(ref.steps)):
                pair = []
                for which in (0, 1):
                    mask.zero_()
                    for chunk in ids:
                        mask[chunk[si][which].reshape(-1)] = True
                    pair.append(int(mask.sum()))
                per_step.append(tuple(pair))
            counts.append(per_step)
    if log is not None and worst is not None:
        print(f"gap {label}: widest {max(gaps)!r}, median "
              f"{float(np.median(gaps))!r} over {len(gaps)} images, "
              f"{len(off)} off; worst request {worst[0]} (seed {worst[1]}): "
              f"per image {[float('%.3g' % v) for v in worst[2]]}", file=log)
        for rid, seed, i, g in off[:16]:
            print(f"off image: request {rid} (seed {seed}) image {i} "
                  f"gap {g!r}", file=log)
    return gaps, counts


def compare(gaps: list[float], failed: int, limits: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit: the
    median image's widest gap to the reference, the share of images
    whose widest gap passes ``image_tol`` (the trajectory ended
    elsewhere), and the failed requests."""
    arr = np.asarray(gaps, np.float64)
    return {
        "gap_median": {"value": float(np.median(arr)) if arr.size
                       else float("inf"), "limit": limits["gap_median"]},
        "off_share": {"value": float((arr > limits["image_tol"]).mean())
                      if arr.size else 1.0, "limit": limits["off_share"]},
        "failed": {"value": failed, "limit": 0},
    }


def work_of(cfg: dict, ref: Reference, served: list[Served],
            counts) -> dict:
    """Per request, the summed bound seconds of each count
    (``workcount.step_work``) and the terms that bound them."""
    h, w, c = cfg["image_shape"]
    d = h * w * c
    f = cfg["proxy_factor"]
    dp = (h // f) * (w // f) * c
    out = {"select": [], "aggregate": [], "request": [], "terms": set()}
    for s, per_step in zip(served, counts):
        tot = {"select": 0.0, "aggregate": 0.0, "request": 0.0}
        for st, (uc, ug) in zip(ref.steps, per_step):
            wk = workcount.step_work(s.images, cfg["n"], dp, d, st.m, st.k,
                                     uc, ug)
            for name, (byts, flops) in wk.items():
                sec, term = workcount.bound_s(byts, flops)
                tot[name] += sec
                out["terms"].add(f"{name}:{term}")
        for name in tot:
            out[name].append(tot[name])
    out["terms"] = sorted(out["terms"])
    return out


def profile_block(eng, gen: mf.Traffic, device, stages) -> dict:
    """A block of fresh requests served once unprofiled (its wall) and
    once more under the profiler (its device events, each with its stage
    by ``stages``, the kernel files')."""
    groups, wall = [], 0.0
    while wall < PROFILE_MIN_S and sum(map(len, groups)) < \
            PROFILE_MAX_REQUESTS:
        g = gen.next_group()
        sync(device)
        t0 = time.perf_counter()
        serve_group(eng, g)
        sync(device)
        wall += time.perf_counter() - t0
        groups.append(g)
    with timing.device_profile(device) as prof:
        t0 = time.perf_counter()
        served = [s for g in groups for s in serve_group(eng, g)]
        sync(device)
        window = time.perf_counter() - t0
    events = timing.device_events(prof)
    return {"served": served, "wall_s": wall, "window_s": window,
            "events": events, "stages": timing.event_stages(events, stages)}


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start_process: float, device="cuda", cfg=None, mix=None,
        rows_dtype=None, log=sys.stderr) -> dict:
    """One run; returns the result object the last line prints.
    ``cfg``/``mix`` replace the files of the cell's names (tests);
    ``rows_dtype`` serves from store rows of a lower precision than the
    configuration's (the control)."""
    man = mf.manifest()
    cl = mf.cell(cell_name, man)
    cfg = cfg or mf.config(cl["config"], man)
    mix = mix or mf.traffic(cl["traffic"])
    metrics = [(m["name"], m["unit"], mf.reader(m["name"]))
               for m in mf.metrics_for(cell_name, trace, man)]
    stages = mf.kernel_stages()
    dev = torch.device(device)
    shape = tuple(cfg["image_shape"])

    # -- set-up: the store from the seed, the engine, its programs warmed
    marks = [("imports", time.perf_counter())]
    X = make_rows(cfg, seed, dev)
    sync(dev)
    marks.append(("store", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = build_program(cfg, mix, X, dev,
                        rows_dtype or ROWS_DTYPES[cfg["rows_dtype"]])
    sync(dev)
    marks.append(("engine", time.perf_counter()))
    gen = mf.Traffic(mix, seed)
    warm = gen.warmup_requests()
    for i in range(0, len(warm), mix["in_flight"]):
        serve_group(eng, warm[i:i + mix["in_flight"]])
    sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    t = t_start_process
    print("set-up: " + ", ".join(f"{k} {v - t0!r} s" for (k, v), t0 in
                                 zip(marks, [t] + [m[1] for m in marks])),
          file=log)
    built0 = programs_built(eng)
    tracer = None
    if trace:
        from repro_torch.obs import trace as obs_trace
        tracer = obs_trace.Tracer(capacity=1 << 12)
        obs_trace.set_tracer(tracer)

    # -- the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start_process
    served, failed, attempted, t_end = [], 0, 0, t0
    while time.perf_counter() - t0 < seconds:
        g = gen.next_group()
        attempted += len(g)
        try:
            got = serve_group(eng, g, tracer)
        except Exception:                          # counted, then reported
            failed += len(g)
            traceback.print_exc(file=log)
            if failed > 8:
                break
            continue
        t_end = time.perf_counter()
        for s in got:
            if delivered(s, shape):
                served.append(s)
            else:
                failed += 1
    window_s = t_end - t0
    lat = sorted(s.latency_s for s in served)
    if lat:
        q = [lat[min(len(lat) - 1, int(f * len(lat)))] * 1e3
             for f in (0.5, 0.9, 0.95, 0.99)]
        print(f"window: {len(served)} requests in {window_s!r} s; latency "
              f"ms p50 {q[0]:.3f} p90 {q[1]:.3f} p95 {q[2]:.3f} p99 "
              f"{q[3]:.3f} max {lat[-1] * 1e3:.3f}; gc collections "
              f"{[g['collections'] for g in gc.get_stats()]}", file=log)
    if tracer is not None:
        from repro_torch.obs import trace as obs_trace
        obs_trace.set_tracer(None)
    prof = profile_block(eng, gen, dev, stages) if trace else None
    built1 = programs_built(eng)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)

    # -- the reference, once the program's state is freed
    del eng, X
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4]))
    n_check = max(1, -(-mix["check_images"] // max(
        mix["images_per_request"])))
    pick = sorted(rng.choice(len(served), size=min(n_check, len(served)),
                             replace=False)) if served else []
    ref = Reference(cfg, make_rows(cfg, seed, dev))
    t_ref = time.perf_counter()
    gaps, _ = check_requests(cfg, ref, [served[i] for i in pick], log=log,
                             label="window sample")
    work = None
    if prof is not None:
        gaps_p, counts = check_requests(cfg, ref, prof["served"],
                                        keep_ids=True, log=log,
                                        label="profiled block")
        gaps += gaps_p
        work = work_of(cfg, ref, prof["served"], counts)
    ref_s = time.perf_counter() - t_ref
    del ref
    print(f"reference: {len(pick)} window requests"
          f"{'' if prof is None else ' + %d profiled' % len(prof['served'])}"
          f" checked in {ref_s:.3f} s", file=log)

    compared = compare(gaps, failed, cfg["limits"])
    correct = bool(pick) and all(c["value"] <= c["limit"]
                                 for c in compared.values())

    # -- the metrics, each from its reader
    rec = {"setup_s": setup_s, "window_s": window_s, "served": served,
           "failed": failed, "built_after_warmup": built1 - built0,
           "profile": prof, "work": work}
    out_metrics = {}
    for name, unit, read in metrics:
        v = read(rec)
        if v is not None:
            out_metrics[name] = {"value": v, "unit": unit}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": out_metrics,
              "device": device_info(dev, peak, prof)}
    if prof is not None:
        result["breakdown"] = breakdown(prof, work, log)
    result["compared"] = compared
    return result


def device_info(dev, peak: int, prof) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if prof is not None:
        info["busy_s"] = timing.union_s(prof["events"])
        info["window_s"] = prof["window_s"]
    return info


def kernel_table(prof) -> dict:
    """``{(key, stage): [count, seconds]}`` of the profiled block."""
    table = {}
    for (name, s, e), stage in zip(prof["events"], prof["stages"]):
        row = table.setdefault((timing.kernel_key(name), stage), [0, 0.0])
        row[0] += 1
        row[1] += e - s
    return table


def breakdown(prof, work, log) -> dict:
    """The top device operations and the longest idle gaps of the
    profiled block; the whole kernel table, the unfiled kernels and the
    work bound's terms go to earlier lines."""
    table = kernel_table(prof)
    print(f"profiled block: {len(prof['served'])} requests, unprofiled "
          f"wall {prof['wall_s']:.6f} s, profiled window "
          f"{prof['window_s']:.6f} s, busy "
          f"{timing.union_s(prof['events']):.6f} s", file=log)
    for (key, stage), (n, sec) in sorted(table.items(),
                                         key=lambda kv: -kv[1][1]):
        print(f"kernel {key} count={n} seconds={sec!r} stage={stage}",
              file=log)
    unfiled = {k: v[1] for k, v in table.items() if k[1] is None}
    print(f"unfiled device time: {sum(unfiled.values())!r} s over "
          f"{len(unfiled)} names", file=log)
    if work is not None:
        print(f"work bound: terms {work['terms']}; card "
              f"{timing.card() if torch.cuda.is_available() else 'cpu'}",
              file=log)
    by_key = {}
    for (key, _), (_, sec) in table.items():
        by_key[key] = by_key.get(key, 0.0) + sec
    ops = sorted(by_key.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in
                          timing.idle_gaps(prof["events"])[:10]]}
