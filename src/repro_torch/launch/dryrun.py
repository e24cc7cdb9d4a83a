"""The dry run: per-card memory, FLOPs and collective bytes of every
(arch x input shape x mesh), without a cluster (counterpart of
``repro.launch.dryrun``).

The step of each combination runs once, in this process, on fake tensors
(``FakeTensorMode``) under a fake process group of 256 ranks (the 16 x
16 ("data", "model") mesh) or 512 (2 x 16 x 16, with "pod"): nothing is
allocated and nothing is sent.  The parameters are ``abstract_params``,
the AdamW state ``optimizer.init_state`` of them (on ZeRO-1's placements
with ``zero1``), the inputs ``input_specs``; a train step takes the
reference's microbatch counts (``TRAIN_MICROBATCHES`` 4, dbrx and jamba
8).  ``hlo_analysis.DeviceCostMode`` records what rank 0 runs: FLOPs,
bytes, collectives by kind and the peak of live memory.

As the reference does, the step is traced at 1 and 2 layer periods and
the full depth is extrapolated:

    value(repeats) = probe1 + (repeats - 1) x (probe2 - probe1)

A train step of n >= 3 microbatches is traced at 2 and 3 microbatches of
its B / n rows as well (``probe_points``; from the second microbatch on,
each adds the same work, gathers and memory: its gradients, its input
rows; one microbatch has no gradient sum), and every quantity is
bilinear in both:

    value(r, n) = v12 + (r - 1) (v22 - v12) + (n - 2) (v13 - v12)
                  + (r - 1) (n - 2) (v23 - v22 - v13 + v12)

for the FLOPs, the bytes, the collective bytes of every kind, the
argument bytes and the peak of live memory of each phase of the step
(its gradients, its AdamW update, the rest).  The peak is the largest of
the phases' extrapolated peaks: which phase holds it can change with
the depth (the update's grows faster than the gradients' where the
parameters outweigh the remat-saved activations).  All of these are
extrapolated; the probes are full width.  ``tests/test_torch_mesh.py``
traces reduced configs at 3 periods and 4 microbatches and holds the
extrapolation to them: the FLOPs, the collectives, the argument bytes
and the peak exactly, and the bytes within 1e-4.  Under ZeRO-1 two gaps
remain: DTensor redistributes a stacked leaf of one period without the
copy it makes at two or more, so the bytes count that copy (repeats - 2)
times too often (+0.58% at 3 periods), and the gradient phase's peak
grows faster from 3 periods on than from 1 to 2 (its extrapolation
0.81% short at 3 periods, where the update phase holds the peak).
``fits_hbm`` holds the extrapolated peak against the card's 80 GB.

Usage (one process a mesh; it creates the fake group itself):

  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-3b dbrx-132b  # 4 shapes
  python -m repro_torch.launch.dryrun --all                # 10 x 4, 16x16
  python -m repro_torch.launch.dryrun --all --multi-pod    # 2 x 16 x 16
  python -m repro_torch.launch.dryrun --all --device cpu   # fake CPU tensors

On the machine with the card the fake tensors are CUDA tensors (the
default); ``--device cpu`` runs them on the CPU (a CPU-only build cannot
distribute fake CUDA tensors).  Each combination writes
``artifacts/dryrun/<arch>_<shape>_<mesh>.json`` (git-ignored) and prints
one line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import hlo_analysis as H
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import steps
from repro_torch.launch.inputs import SHAPES, input_specs
from repro_torch.launch.mesh import HBM_PER_CHIP
from repro_torch.models.module import abstract_params, param_shardings
from repro_torch.models.transformer import model_specs
from repro_torch.training import optimizer as opt

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"

_RULE_MODE = {"train_4k": "train", "prefill_32k": "prefill",
              "decode_32k": "decode", "long_500k": "decode_long"}

TRAIN_MICROBATCHES = 4     # grad accumulation: activation memory / 4
# per-arch overrides (production tunes accumulation per model size)
TRAIN_MICROBATCHES_BY_ARCH = {"dbrx-132b": 8, "jamba-v0.1-52b": 8}


def fake_world(world: int) -> None:
    """Start a fake default process group of ``world`` ranks (this
    process is rank 0), or check the one already started."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"the dry run needs a world of {world}; this "
                             f"process has one of {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(multi_pod: bool, device: str, mesh_shape=None):
    """The production mesh on a fake world, or a ("data", "model") mesh of
    ``mesh_shape`` (a small one for tests)."""
    from repro_torch.launch.mesh import (make_debug_device_mesh,
                                         make_production_mesh)
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod, device_type=device)
    fake_world(mesh_shape[0] * mesh_shape[1])
    return make_debug_device_mesh(*mesh_shape, device_type=device)


def trace_step(cfg, shape, rules, device: str, num_microbatches: int = 1,
               zero1_rules=None) -> H.DeviceCostMode:
    """Run the step of (cfg, shape) once on fake tensors under ``rules``
    and return the mode that recorded rank 0's work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    specs = model_specs(cfg)
    with FakeTensorMode():
        aparams = abstract_params(specs, rules, device)
        ins = input_specs(cfg, shape, rules, device)
        mode = H.DeviceCostMode()
        if shape.kind == "train":
            zp = (param_shardings(specs, zero1_rules) if zero1_rules
                  is not None else None)
            astate = opt.init_state(aparams, zp)
            mode.track(aparams, astate, ins)
            step = steps.make_train_step(cfg, rules,
                                         num_microbatches=num_microbatches,
                                         zero1_rules=zero1_rules)
            with mode:
                step(aparams, astate, ins)
        elif shape.kind == "prefill":
            mode.track(aparams, ins)
            with mode:
                steps.make_prefill_step(cfg, rules)(aparams, ins)
        else:
            mode.track(aparams, ins)
            with mode:
                steps.make_decode_step(cfg, rules)(
                    aparams, ins["cache"], ins["token"], ins["pos"])
    return mode


def probe_points(shape, n_micro: int) -> list[tuple[int, int]]:
    """The (layer periods, microbatches) probes of a step: 1 and 2
    periods, at 2 and 3 microbatches when the step takes 3 or more (a
    step of one microbatch has no gradient sum and gathers no batch, so
    the microbatch slope is taken from 2 on), else at its own count."""
    n = n_micro if shape.kind == "train" else 1
    micro = (2, 3) if n >= 3 else (n,)
    return [(reps, nm) for reps in (1, 2) for nm in micro]


def probe_grid(cfg, shape, rules, device: str, n_micro: int,
               zero1_rules=None, points=None) -> dict:
    """Trace (cfg, shape) at each (layer periods, microbatches) point,
    ``probe_points`` unless given, and return ``{(reps, nm):
    (cost_summary, collective_bytes, memory_summary)}``.  A train probe
    of nm microbatches takes nm of the step's ``B / n_micro`` rows."""
    points = probe_points(shape, n_micro) if points is None else points
    rows = shape.global_batch // n_micro
    grid = {}
    for reps, nm in points:
        pcfg = dataclasses.replace(cfg, num_layers=cfg.period * reps)
        pshape = (dataclasses.replace(shape, global_batch=rows * nm)
                  if shape.kind == "train" else shape)
        m = trace_step(pcfg, pshape, rules, device, nm, zero1_rules)
        grid[reps, nm] = (H.cost_summary(m), H.collective_bytes(m.records),
                          H.memory_summary(m))
    return grid


def extrapolate(grid: dict, repeats: int, n_micro: int) -> dict:
    """The full step's FLOPs, bytes, collective bytes by kind and memory
    from ``probe_grid``'s probes (module note): each bilinear in the
    repeats and the microbatches, the peak the largest of the phases'
    peaks, each extrapolated on its own.  A value below zero means the
    probes broke the linearity the method rests on, and raises
    ``ValueError``."""
    a = min(nm for _, nm in grid)
    b = a + 1 if (1, a + 1) in grid else None

    def bilinear(name, get):
        v11, v21 = get(grid[1, a]), get(grid[2, a])
        out = v11 + (repeats - 1) * (v21 - v11)
        if b is not None:
            v12, v22 = get(grid[1, b]), get(grid[2, b])
            out += (n_micro - a) * (v12 - v11) \
                + (repeats - 1) * (n_micro - a) * (v22 - v21 - v12 + v11)
        if out < 0:
            raise ValueError(f"{name} extrapolates to {out} at {repeats} "
                             f"repeats and {n_micro} microbatches: the "
                             f"probes are not linear in them")
        return out

    phases = set(grid[1, a][2]["phase_peak_bytes"])
    if any(set(g[2]["phase_peak_bytes"]) != phases for g in grid.values()):
        raise ValueError("the probes ran different phases")
    peaks = {ph: bilinear(ph, lambda g, ph=ph: g[2]["phase_peak_bytes"][ph])
             for ph in sorted(phases)}
    peak = max(peaks.values())
    return {"flops": bilinear("flops", lambda g: g[0]["flops"]),
            "bytes": bilinear("bytes", lambda g: g[0]["bytes"]),
            "collectives": {k: bilinear(k, lambda g, k=k: g[1][k])
                            for k in grid[1, a][1]},
            "memory": {"argument_size_in_bytes": bilinear(
                "argument_size_in_bytes",
                lambda g: g[2]["argument_size_in_bytes"]),
                "peak_bytes": peak, "total_hbm_bytes": peak,
                "phase_peak_bytes": peaks}}


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            save: bool = True, zero1: bool = False,
            num_microbatches: int | None = None, device: str = "cuda",
            mesh_shape=None, cfg=None, shape=None) -> dict:
    """Trace (arch, shape) at 1 and 2 layer periods on the mesh and
    extrapolate to the full depth (module note).  ``cfg`` / ``shape`` /
    ``mesh_shape`` replace the arch's config, the named shape and the
    production mesh (tests run a reduced config on a (2, 2) mesh)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    mesh = make_mesh(multi_pod, device, mesh_shape)
    mode = _RULE_MODE.get(shape_name, shape.kind)
    zrules = make_rules(mode, mesh) if zero1 else None  # opt state FSDP
    # ZeRO-1: the parameters whole over "data"
    rules = make_rules(mode, mesh, overrides={"embed": None} if zero1
                       else None)
    chips = mesh.size()
    n_micro = (num_microbatches if num_microbatches is not None else
               TRAIN_MICROBATCHES_BY_ARCH.get(arch, TRAIN_MICROBATCHES))
    if shape.kind != "train":
        n_micro = 1

    t0 = time.time()
    grid = probe_grid(cfg, shape, rules, device, n_micro, zrules)
    t_trace = time.time() - t0
    full = extrapolate(grid, cfg.repeats, n_micro)
    flops, nbytes = full["flops"], full["bytes"]
    coll, mem = full["collectives"], full["memory"]
    terms = H.roofline_terms(flops, nbytes, coll["total"], chips)
    mflops = H.model_flops(cfg, shape)
    rec = {
        "arch": arch, "shape": shape.name,
        "mesh": ("x".join(str(s) for s in mesh_shape) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16"),
        "chips": chips, "device": device, "microbatches": n_micro,
        "trace_s": round(t_trace, 2),
        "probe_costs": {f"p{a}_mb{b}": g[0] for (a, b), g in grid.items()},
        "probe_memory": {f"p{a}_mb{b}": g[2] for (a, b), g in grid.items()},
        "memory": mem,
        "collectives": coll,
        "flops_corrected": flops, "bytes_corrected": nbytes,
        "extrapolated": ["flops", "bytes", "collectives", "memory"],
        "roofline": terms,
        "model_flops_global": mflops,
        "model_flops_per_chip": mflops / chips,
        # the traced FLOPs are one rank's
        "useful_flops_ratio": (mflops / chips) / flops if flops else None,
        "fits_hbm": mem["total_hbm_bytes"] <= HBM_PER_CHIP,
    }
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        name = f"{arch}_{shape.name}_{rec['mesh']}.json"
        (ART_DIR / name).write_text(json.dumps(rec, indent=1))
    return rec


def line(rec: dict) -> str:
    """The one-line summary of a record (the reference's format)."""
    return (f"OK   {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"trace={rec['trace_s']:7.1f}s "
            f"flops/chip={rec['flops_corrected']:.3e} "
            f"coll={rec['collectives']['total']:.3e}B "
            f"hbm={rec['memory']['total_hbm_bytes'] / 2**30:.2f}GiB "
            f"bottleneck={rec['roofline']['bottleneck']} "
            f"fits={rec['fits_hbm']}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda, or cpu)")
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or not args.arch) else args.arch
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    combos = [(a, s) for a in archs for s in shapes]
    failures = []
    t_all = time.time()
    for a, s in combos:
        t0 = time.time()
        try:
            print(line(run_one(a, s, args.multi_pod, device=args.device)),
                  flush=True)
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"FAIL {a:24s} {s:12s} ({time.time() - t0:.0f}s): {e}",
                  flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(combos)} combinations traced in "
          f"{time.time() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
