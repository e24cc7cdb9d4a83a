#!/usr/bin/env python3
"""Time the port's indexed GoldDiff route of one tree on the card.

  python3 scripts/torch_index_times.py [--src DIR] [--tag NAME]
                                       [--cache PATH]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``) and
prints one JSON line: the card's name and power limit; the indexed
cifar_like trajectory (N=50000, D=3072, B=16, 10 DDIM steps, the
reference's indexed configuration and probe schedule, as
``chip_smoke.py`` runs it): its wall (host clock, synchronized; the
best and the median of 5 runs), its device busy time (``torch.profiler``)
and idle share, the launches and device ms of one indexed step's level
1 (its selection's less those of the re-rank alone on the same
candidates), the device ms of kernel 7's probe launch alone where the
tree has one (``engine.probe``), and the launches of the whole step; on the gmm scale store
(N=65536, d=64, C=512), the indexed and the exact coarse screen at
t=900 (device: CUDA events with the L2 flushed; wall: back to back
calls), the indexed and exact denoise step at t=20, and the wave
latency of 3 served waves with every step indexed.  The sizes, the
configuration and the timing (``time_ms``, ``wall_ms``,
``device_kernels``) are ``scripts/card_timing.py``'s, which
``chip_smoke.py`` shares.

The cifar_like store takes minutes of numpy generation: the first run
saves it to PATH (default ``build/index_times_store.pt``, git-ignored)
and later runs load it.  To compare two trees on one card, run them in
turns in one call (parent, change, change, parent), each in its own
process.  Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from card_timing import (B, GMM_C, GMM_DIM, GMM_MODES, GMM_N, GMM_SPREAD,
                         INDEXED_FRACS, N, SCALE_PROBES, STEPS, T_BUCKETS,
                         card, device_kernels, time_ms, wall_ms)

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cache", default=str(ROOT / "build"
                                           / "index_times_store.pt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_index_times: no CUDA card")
    sys.path.insert(0, args.src)
    from repro_torch.core import (DatasetStore, GoldDiff, GoldDiffConfig,
                                  GoldDiffEngine, OptimalDenoiser,
                                  make_schedule, sample, sampling_timesteps)
    from repro_torch.data import make_dataset
    from repro_torch.index import (ProbeSchedule, build_index,
                                   default_num_clusters)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tag": args.tag, "src": args.src, "card": card()}
    cache = Path(args.cache)
    if cache.exists():
        st = DatasetStore(**{k: (v.cuda() if isinstance(v, torch.Tensor)
                                 else v)
                             for k, v in torch.load(cache).items()})
    else:
        st = make_dataset("cifar_like", n=N, seed=0, device="cuda")
        cache.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"X": st.X.cpu(), "proxy": st.proxy.cpu(),
                    "x_norms": st.x_norms.cpu(),
                    "proxy_norms": st.proxy_norms.cpu(),
                    "image_shape": st.image_shape}, cache)
    gst = make_dataset("gmm", n=GMM_N, dim=GMM_DIM, num_modes=GMM_MODES,
                       spread=GMM_SPREAD, seed=0, device="cuda")

    def index(store, c):
        return build_index(store, c, generator=torch.Generator(
            device="cuda").manual_seed(0))

    cix, gix = index(st, default_num_clusters(N)), index(gst, GMM_C)
    sched = make_schedule("ddpm_linear", 1000)
    cfg = GoldDiffConfig(**INDEXED_FRACS)
    probes = ProbeSchedule(**SCALE_PROBES)

    # the indexed cifar_like trajectory
    den = GoldDiff(OptimalDenoiser(st, sched), cfg, index=cix,
                   probe_schedule=probes)
    x_T = float(sched.b[1000]) * torch.randn(
        B, st.dim, generator=torch.Generator().manual_seed(5)).cuda()

    def traj():
        return sample(den, sched, (B, st.dim), num_steps=STEPS, x_init=x_T)

    for _ in range(2):
        traj()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy, _ = device_kernels(traj)
    eng = den.engine
    steps = [int(t) for t in sampling_timesteps(sched, STEPS)[:-1]]
    t1 = steps[0]
    q1 = x_T / float(sched.a[t1])
    mp = eng.padded_m(t1)
    pos, pd2 = eng.coarse_indexed(q1, mp, eng.nprobe(t1))
    ids, valid = cix.perm[pos], torch.isfinite(pd2)

    def rerank_call():
        return ops.golden_rerank(q1, st.X, ids, min(eng.sizes(t1)[1], mp),
                                 x_norms=st.x_norms, valid=valid)

    _, rerank = device_kernels(rerank_call)
    _, sel = device_kernels(lambda: eng._select_body(q1, t1))
    sel_ms = time_ms(lambda: eng._select_body(q1, t1))
    rerank_ms = time_ms(rerank_call)
    probe_ms = (time_ms(lambda: eng.probe(q1, eng.nprobe(t1)))
                if hasattr(eng, "probe") else None)     # kernel 7's launch
    _, step = device_kernels(lambda: eng.denoise(x_T, t1))
    out.update({
        "indexed trajectory wall ms (best, median, runs)": [
            min(walls), statistics.median(walls), walls],
        "indexed trajectory device busy ms": busy,
        "indexed trajectory idle share (best wall)": 1 - busy / min(walls),
        "indexed step level-1 launches (selection minus re-rank)":
            len(sel) - len(rerank),
        "indexed step level-1 device ms (selection minus re-rank)":
            sel_ms - rerank_ms,
        "indexed step probe launch device ms (null without engine.probe)":
            probe_ms,
        "indexed step launches": len(step),
        "use_index per step": [eng.use_index(t) for t in steps]})

    # the gmm scale store
    geng = GoldDiffEngine(gst, sched, cfg, index=gix, probe_schedule=probes)
    gexact = GoldDiffEngine(gst, sched, cfg)
    x0 = gst.X[:B]
    t = T_BUCKETS[0]
    m_t = geng.sizes(t)[0]
    q_t = (float(sched.a[t]) * x0 + float(sched.b[t]) * torch.randn(
        B, GMM_DIM, generator=torch.Generator().manual_seed(t)).cuda()
           ) / float(sched.a[t])
    mp, p_t = geng.padded_m(t), geng.nprobe(t)
    out.update({
        f"gmm t={t} indexed coarse device ms": time_ms(
            lambda: geng.coarse_indexed(q_t, mp, p_t), iters=20),
        f"gmm t={t} indexed coarse wall ms": wall_ms(
            lambda: geng.coarse_indexed(q_t, mp, p_t), iters=20),
        f"gmm t={t} exact coarse device ms": time_ms(
            lambda: geng.coarse(q_t, m_t)),
        f"gmm t={t} exact coarse wall ms": wall_ms(
            lambda: geng.coarse(q_t, m_t))})
    t = T_BUCKETS[-1]
    x_t = float(sched.a[t]) * x0 + float(sched.b[t]) * torch.randn(
        B, GMM_DIM, generator=torch.Generator().manual_seed(77)).cuda()
    out.update({
        f"gmm t={t} indexed denoise device ms": time_ms(
            lambda: geng.denoise(x_t, t)),
        f"gmm t={t} indexed denoise wall ms": wall_ms(
            lambda: geng.denoise(x_t, t)),
        f"gmm t={t} exact denoise device ms": time_ms(
            lambda: gexact.denoise(x_t, t)),
        f"gmm t={t} exact denoise wall ms": wall_ms(
            lambda: gexact.denoise(x_t, t))})
    srv = ServeEngine(gst, num_steps=STEPS, max_batch=B, gd_cfg=cfg,
                      index=gix, index_mode="always")
    srv.serve([Request(99, B, seed=99)])
    served = srv.serve([Request(i, B, seed=100 + i) for i in range(3)])
    out["serve_gmm_indexed wave latency ms"] = [r.latency_s * 1e3
                                                for r in served]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
