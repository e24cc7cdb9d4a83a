"""Batched analytical-diffusion sampling engine (the paper's serving kind).

Counterpart of ``repro.launch.serve`` in static mode.  A request is
(num_images, seed); ``ServeEngine`` packs requests into waves of at
most ``max_batch`` rows, pads each wave to a power-of-two batch bucket,
chunks oversized requests across waves, and runs GoldDiff DDIM sampling
with per-step static (m_t, k_t).  The reference picks its ``plan``
mode for the Optimal base because plans bound XLA compiles; eager
PyTorch compiles nothing, so static mode keeps the exact per-step FLOPs
at no cost.

Every request owns its noise: row i of a request draws x_T from a CPU
``torch.Generator`` seeded from ``(request.seed, i)`` alone, so its
images depend neither on the wave that co-batched it nor on the device.

``fused`` forwards to the engine (``GoldDiffEngine(fused=...)``): True
runs every step through the single-pass fused kernel, "auto" where the
engine's crossover says it pays.  ``index``/``index_mode`` forward
too: a ``repro_torch.index.GoldenIndex`` of the store routes the coarse
screen of the steps ``index_mode`` picks through the index.

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset cifar_like \
      --n 50000 --requests 3 --batch 16 --steps 10 [--fused on]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import (GoldDiff, GoldDiffConfig, make_denoiser,
                              make_schedule, sample, sampling_timesteps)
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
    when there is none)."""

    def __init__(self, dataset: str | DatasetStore,
                 dataset_kw: dict | None = None, base: str = "optimal",
                 schedule: str = "ddpm_linear", num_steps: int = 10,
                 gd_cfg: GoldDiffConfig | None = None, max_batch: int = 16,
                 mode: str = "auto", clip_value: float | None = 3.0,
                 device=None, fused: str | bool = "auto", index=None,
                 index_mode: str = "auto"):
        if mode not in ("auto", "static"):
            raise NotImplementedError(
                f"serve mode {mode!r} is not ported yet (ROADMAP Queue 1: "
                f"serving runtime); the port serves mode='static'")
        self.mode = "static"
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

    @property
    def engine(self):
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
    def _sample_bucket(self, x_init: torch.Tensor) -> np.ndarray:
        """Run one wave at a (padded) batch-bucket size."""
        x = sample(self.denoiser, self.schedule, tuple(x_init.shape),
                   num_steps=self.num_steps, clip_value=self.clip_value,
                   x_init=x_init)
        return x.cpu().numpy().reshape((x.shape[0],) + self.store.image_shape)

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
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    eng = ServeEngine(args.dataset, {"n": args.n}, num_steps=args.steps,
                      max_batch=args.batch, device=args.device,
                      fused=FUSED_FLAG[args.fused])
    print(f"store: {args.dataset} N={eng.store.n} D={eng.store.dim} on "
          f"{eng.device} in {time.perf_counter() - t0:.2f}s; fused steps: "
          f"{eng.engine.use_fused(0)}")
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
