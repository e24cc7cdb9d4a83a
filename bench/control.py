"""Read the two ends of a cell's correctness limit on the card, in one
process: the program's compared numbers over many seeds (the lower
reading) and the control's, the program serving from its bf16 store
rows, over a few (the upper reading).  Each seed is a whole run of the
cell (its own store, engine, warm-up and a short window at the cell's
load), so the numbers are those a run of ``run.py`` compares.

  python3 bench/control.py --workload <cell> --seeds 1,2,... \
      --control-seeds 7,8,9 [--seconds 2] [--out readings.json]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def ints(s: str) -> list[int]:
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, required=True)
    ap.add_argument("--control-seeds", type=ints, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("USE_FLAX", "0")
    from bench import manifest
    threads = manifest.host_threads(args.workload)
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(threads)
    import torch

    from bench import harness

    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for kind, seeds, dtype in (("program", args.seeds, None),
                               ("control", args.control_seeds,
                                torch.bfloat16)):
        for seed in seeds:
            t0 = time.perf_counter()
            r = harness.run(args.workload, seed, args.seconds, False,
                            t0, rows_dtype=dtype)
            row = {"kind": kind, "seed": seed, "correct": r["correct"],
                   "attempted": r["attempted"], "failed": r["failed"],
                   "compared": {k: v["value"]
                                for k, v in r["compared"].items()},
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    readings = {}
    for name in rows[0]["compared"]:
        prog = [r["compared"][name] for r in rows if r["kind"] == "program"]
        ctrl = [r["compared"][name] for r in rows if r["kind"] == "control"]
        readings[name] = {"lower": max(prog), "upper": min(ctrl),
                          "program": prog, "control": ctrl}
    summary = {"workload": args.workload, "readings": readings,
               "card": harness.timing.card()}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
