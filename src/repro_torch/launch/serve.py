"""Batched analytical-diffusion sampling engine (the paper's serving kind).

Counterpart of ``repro.launch.serve``.  A request is (num_images,
seed); ``ServeEngine`` packs requests into waves of at most
``max_batch`` rows, pads each wave to a power-of-two batch bucket,
chunks oversized requests across waves, and runs GoldDiff DDIM
sampling in one of three modes (``mode=``, "auto" by default):

* ``"plan"`` -- the default with the Optimal base: ``sample_plan`` over a
  ``repro_torch.core.plan.TrajectoryPlan``, one segment per shape
  bucket, each padded only to its bucket's (m_cap, k_cap, nprobe_cap);
* ``"scan"`` -- one masked body padded to (m_max, k_max) at every step;
* ``"static"`` -- per-step static steps, eager.

On the card every plan and scan segment is one captured CUDA graph per
batch bucket (``GoldDiffEngine.jitter``), the port's form of the
reference's compiled programs; ``warmup()`` captures them all before
traffic.

Every request owns its noise: row i of a request draws x_T from a CPU
``torch.Generator`` seeded from ``(request.seed, i)`` alone, so its
images depend neither on the wave that co-batched it nor on the device.

``fused`` forwards to the engine (``GoldDiffEngine(fused=...)``): True
runs every step through the single-pass fused kernel, "auto" where the
engine's crossover says it pays.  ``index``/``index_mode`` forward
too: a ``repro_torch.index.GoldenIndex`` of the store routes the coarse
screen of the steps ``index_mode`` picks through the index.

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset cifar_like \
      --n 50000 --requests 3 --batch 16 --steps 10 [--buckets 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import (GoldDiff, GoldDiffConfig, build_plan,
                              make_denoiser, make_schedule, sample,
                              sample_plan, sample_scan, sampling_timesteps)
from repro_torch.core.dataset import DatasetStore
from repro_torch.data import make_dataset
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class Request:
    request_id: int
    num_images: int
    seed: int


@dataclasses.dataclass
class Result:
    request_id: int
    images: np.ndarray
    latency_s: float


def row_seed(seed: int, row: int) -> int:
    """The generator seed of row ``row`` of a request seeded ``seed``."""
    return int(np.random.SeedSequence([seed, row]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class ServeEngine:
    """Training-free generation service over a fixed dataset store, on
    ``device`` (the CUDA card unless the caller passes another; raises
    when there is none).

    * **batch buckets** -- waves are padded to the next power-of-two
      batch size, so the set of batch shapes is logarithmic in
      ``max_batch``;
    * **per-request noise** -- every row draws x_T from a generator
      seeded by ``(request.seed, row)``, so outputs do not depend on how
      requests are packed into waves;
    * **warmup** -- ``warmup()`` builds every (batch bucket x plan
      bucket) segment before traffic (on the card: captures its CUDA
      graph), so serving any request mix afterwards builds nothing.

    ``plan_threshold`` / ``max_buckets`` forward to ``build_plan``:
    lower thresholds give more, tighter buckets, at the cost of more
    graphs to capture.  The graphs of one engine share a memory pool
    and are replayed one at a time: ``serve`` is sequential, and no two
    threads may serve one engine at once."""

    def __init__(self, dataset: str | DatasetStore,
                 dataset_kw: dict | None = None, base: str = "optimal",
                 schedule: str = "ddpm_linear", num_steps: int = 10,
                 gd_cfg: GoldDiffConfig | None = None, max_batch: int = 16,
                 mode: str = "auto", plan_threshold: float = 0.15,
                 max_buckets: int | None = None,
                 clip_value: float | None = 3.0, device=None,
                 fused: str | bool = "auto", index=None,
                 index_mode: str = "auto"):
        if mode not in ("auto", "plan", "scan", "static"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self.device = resolve_device(device)
        self.store = (dataset.to(self.device)
                      if isinstance(dataset, DatasetStore)
                      else make_dataset(dataset, device=self.device,
                                        **(dataset_kw or {})))
        self.schedule = make_schedule(schedule, 1000)
        self.num_steps = num_steps
        self.max_batch = max_batch
        self.clip_value = clip_value
        base_den = make_denoiser(base, self.store, self.schedule,
                                 device=self.device)
        self.denoiser = GoldDiff(base_den, gd_cfg or GoldDiffConfig(),
                                 fused=fused, index=index,
                                 index_mode=index_mode)
        # auto is plan mode: the Optimal base, the only one ported, serves
        # the masked body (the reference falls back to static for others)
        self.mode = "plan" if mode == "auto" else mode
        self.plan = (build_plan(self.engine, num_steps,
                                threshold=plan_threshold,
                                max_buckets=max_buckets)
                     if self.mode == "plan" else None)

    @property
    def engine(self):
        """The program cache's owner (``core.GoldDiffEngine``)."""
        return self.denoiser.engine

    # -- batch buckets -------------------------------------------------------
    def batch_buckets(self) -> list[int]:
        """Power-of-two batch sizes served, ascending (max_batch last
        even when it is not itself a power of two)."""
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def _bucket_for(self, n: int) -> int:
        """Smallest batch bucket holding ``n`` rows."""
        for b in self.batch_buckets():
            if b >= n:
                return b
        return self.max_batch

    # -- per-request noise ----------------------------------------------------
    def _init_noise(self, wave: list, bucket: int) -> torch.Tensor:
        """x_T = b_T * eps for a wave of ``(request, ofs, n)`` chunks:
        row i of a chunk draws from ``row_seed(request.seed, ofs + i)``;
        padding rows (sliced off) draw from seed 0."""
        ts = sampling_timesteps(self.schedule, self.num_steps)
        b_t0 = float(self.schedule.b[int(ts[0])])
        seeds = [row_seed(r.seed, ofs + i) for r, ofs, n in wave
                 for i in range(n)]
        seeds += [row_seed(0, i) for i in range(bucket - len(seeds))]
        gen = torch.Generator()
        rows = []
        for s in seeds:
            gen.manual_seed(s)
            rows.append(torch.randn(self.store.dim, generator=gen))
        return (b_t0 * torch.stack(rows)).to(self.device)

    # -- sampling ------------------------------------------------------------
    def _scan_program(self, shape: tuple):
        """The cached one-masked-body trajectory for a batch shape (on
        the card one CUDA graph of every step)."""
        key = ("serve_scan", tuple(shape), self.num_steps,
               None if self.clip_value is None else float(self.clip_value))

        def body(x_init):
            return sample_scan(self.denoiser.call_masked, self.schedule,
                               shape, num_steps=self.num_steps,
                               clip_value=self.clip_value, x_init=x_init)

        return self.engine.program(key, lambda: self.engine.jitter(
            body, tuple(shape), label=f"scan trajectory at shape {shape}"))

    def _sample_bucket(self, x_init: torch.Tensor) -> np.ndarray:
        """Run one wave at a (padded) batch-bucket size."""
        shape = tuple(x_init.shape)
        if self.mode == "plan":
            x = sample_plan(self.denoiser.call_masked, self.schedule, shape,
                            self.plan, clip_value=self.clip_value,
                            x_init=x_init, program_cache=self.engine.program,
                            jitter=self.engine.jitter)
        elif self.mode == "scan":
            x = self._scan_program(shape)(x_init)
        else:
            x = sample(self.denoiser, self.schedule, shape,
                       num_steps=self.num_steps, clip_value=self.clip_value,
                       x_init=x_init)
        return x.cpu().numpy().reshape((x.shape[0],) + self.store.image_shape)

    def warmup(self) -> dict:
        """Build every (batch bucket x shape bucket) program before
        traffic; a warm engine builds nothing more.  Plan and scan
        segments are built without sampling (on the card: captured, each
        run once on zeros first); static mode has no programs and warms
        its kernels with one trajectory a batch bucket.

        ``programs_compiled`` is batch buckets x plan buckets in plan
        mode: the reference's count less its two programs a batch bucket
        that derive the row keys and draw x_T, since the port draws the
        noise on the host."""
        n0 = len(self.engine._programs)
        t0 = time.perf_counter()
        for b in self.batch_buckets():
            shape = (b, self.store.dim)
            if self.mode == "plan":
                sample_plan(self.denoiser.call_masked, self.schedule, shape,
                            self.plan, clip_value=self.clip_value,
                            program_cache=self.engine.program,
                            compile_only=True, jitter=self.engine.jitter)
            elif self.mode == "scan":
                self._scan_program(shape)
            else:
                self._sample_bucket(self._init_noise([], b))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"programs_compiled": len(self.engine._programs) - n0,
                "batch_buckets": self.batch_buckets(),
                "shape_buckets": (self.plan.num_buckets if self.plan
                                  else (1 if self.mode == "scan"
                                        else self.num_steps)),
                "warmup_s": time.perf_counter() - t0}

    def serve(self, requests: Iterable[Request]) -> list[Result]:
        """Greedy batching: requests are packed up to max_batch per wave,
        each wave padded up to its power-of-two batch bucket.  Oversized
        requests are chunked across as many waves as they need, each
        row's noise tied to ``(seed, global row index)``, so chunking
        never changes a request's images."""
        reqs = list(requests)
        queue = []                               # (req index, ofs, n)
        for ri, r in enumerate(reqs):
            ofs = 0
            while True:
                n = min(r.num_images - ofs, self.max_batch)
                queue.append((ri, ofs, n))
                ofs += n
                if ofs >= r.num_images:
                    break
        parts = [[] for _ in reqs]
        lat = [0.0 for _ in reqs]
        while queue:
            wave, used = [], 0
            while queue and used + queue[0][2] <= self.max_batch:
                c = queue.pop(0)
                wave.append(c)
                used += c[2]
            if used == 0:        # only zero-image chunks: nothing to run
                continue
            bucket = self._bucket_for(used)
            t0 = time.perf_counter()
            x_init = self._init_noise([(reqs[ri], ofs, n)
                                       for ri, ofs, n in wave], bucket)
            imgs = self._sample_bucket(x_init)[:used]
            dt = time.perf_counter() - t0
            at = 0
            for ri, ofs, n in wave:
                parts[ri].append(imgs[at: at + n])
                lat[ri] += dt
                at += n
        return [Result(r.request_id,
                       np.concatenate(parts[ri]) if parts[ri] else
                       np.zeros((0,) + self.store.image_shape, np.float32),
                       lat[ri])
                for ri, r in enumerate(reqs)]


FUSED_FLAG = {"auto": "auto", "on": True, "off": False}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="cifar_like")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--fused", choices=sorted(FUSED_FLAG), default="auto",
                    help="single-pass fused step: on, off, or auto (the "
                         "engine's crossover decides)")
    ap.add_argument("--plan", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="bucketed trajectory plan (default); --no-plan "
                         "serves one worst-case-padded masked body (scan)")
    ap.add_argument("--buckets", type=int, default=None,
                    help="at most this many shape buckets (floor: one per "
                         "indexed/exact routing region; default: greedy "
                         "merge under --threshold)")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="max padded-FLOP overhead per bucket")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip building the (batch x shape) buckets first")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    eng = ServeEngine(args.dataset, {"n": args.n}, num_steps=args.steps,
                      max_batch=args.batch, device=args.device,
                      fused=FUSED_FLAG[args.fused],
                      mode="plan" if args.plan else "scan",
                      plan_threshold=args.threshold,
                      max_buckets=args.buckets)
    print(f"store: {args.dataset} N={eng.store.n} D={eng.store.dim} on "
          f"{eng.device} in {time.perf_counter() - t0:.2f}s; fused steps: "
          f"{eng.engine.use_fused(0)}; mode {eng.mode}")
    if eng.plan is not None:
        print(eng.plan.describe())
    if not args.no_warmup:
        stats = eng.warmup()
        print(f"warmup: {stats['programs_compiled']} programs (batch "
              f"buckets {stats['batch_buckets']} x {stats['shape_buckets']} "
              f"shape buckets) in {stats['warmup_s']:.2f}s")
    reqs = [Request(i, args.batch, seed=100 + i) for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    total = time.perf_counter() - t0
    for r in results:
        print(f"request {r.request_id}: {r.images.shape} "
              f"batch-latency={r.latency_s:.3f}s "
              f"finite={np.isfinite(r.images).all()}")
    n_img = sum(r.images.shape[0] for r in results)
    print(f"served {n_img} images in {total:.3f}s "
          f"({n_img / max(total, 1e-9):.1f} images/s, {args.steps} steps)")


if __name__ == "__main__":
    main()
