"""What the benchmark finds by name: the manifest (``BENCHMARK.json``),
each configuration's file, each traffic mix (``traffic/<mix>.json``),
each metric's reader (``metrics/<metric>.py``) and each device kernel's
stage (``kernels/<kernel>.json``).  A later change adds a cell, a mix,
a metric or a kernel by adding a file; none of this code changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell(name: str, man: dict | None = None) -> dict:
    """The workload ``name`` of the manifest."""
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, man: dict | None = None) -> dict:
    """The configuration ``name``: its file, as the manifest names it."""
    man = man or manifest()
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((REPO / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def host_threads(cell_name: str) -> int | None:
    """The host threads the cell's configuration serves with (its
    ``host_threads``, a setting of the serving process's deployment), or
    ``None`` for PyTorch's default pool."""
    return config(cell(cell_name)["config"]).get("host_threads")


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def metrics_for(cell_name: str, trace: bool, man: dict | None = None
                ) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    without ``--trace``, its per-layer metrics with it; a metric with a
    ``workloads`` list only in the cells it names."""
    man = man or manifest()
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_stages() -> dict[str, str]:
    """``{kernel key: stage}`` of every ``kernels/<key>.json``."""
    return {p.stem: json.loads(p.read_text())["stage"]
            for p in sorted((BENCH / "kernels").glob("*.json"))}


class Traffic:
    """The general generator of a closed loop: ``in_flight`` requests
    handed to the server together, each next group once the last one
    has returned.  A request's image count follows the mix's
    ``images_per_request`` cycle, each cycle in an order drawn from the
    run's seed, so that every seed sends the same sizes; its seed is
    drawn from the run's seed and its place in the run."""

    def __init__(self, mix: dict, seed: int):
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.mix = mix
        self.seed = int(seed)
        self._order = np.random.default_rng(
            np.random.SeedSequence([self.seed, 1]))
        self._cycle: list[int] = []
        self.sent = 0

    def request_seed(self, i: int) -> int:
        return int(np.random.SeedSequence([self.seed, 2, i]).generate_state(
            1, np.uint32)[0])

    def _size(self) -> int:
        if not self._cycle:
            self._cycle = list(self._order.permutation(
                self.mix["images_per_request"]))
        return int(self._cycle.pop())

    def next_group(self) -> list[tuple[int, int, int]]:
        """The next ``in_flight`` requests as ``(id, images, seed)``."""
        out = []
        for _ in range(self.mix["in_flight"]):
            i = self.sent
            out.append((i, self._size(), self.request_seed(i)))
            self.sent += 1
        return out

    def warmup_requests(self) -> list[tuple[int, int, int]]:
        """Two requests of each size the mix sends, with seeds of their
        own: served before the window, they build every program the
        window's traffic uses."""
        sizes = sorted(set(self.mix["images_per_request"]))
        seeds = np.random.SeedSequence([self.seed, 3]).generate_state(
            2 * len(sizes), np.uint32)
        return [(-1 - j, s, int(seeds[j]))
                for j, s in enumerate(s for s in sizes for _ in range(2))]
