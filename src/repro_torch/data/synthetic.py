"""Procedural datasets standing in for the paper's benchmarks.

Counterpart of ``repro.data.synthetic``.  Generation stays in numpy, a
copy of the reference's code, so that the same seed gives bit-identical
rows in both packages; only the finished store moves to a device.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.dataset import DatasetStore, make_store
from repro_torch.utils import resolve_device


def moons(n: int = 2000, noise: float = 0.08, seed: int = 0,
          device=None) -> DatasetStore:
    """Two interleaved half-circles (the Fig. 1 toy), standardized."""
    rng = np.random.default_rng(seed)
    n2 = n // 2
    th1 = rng.uniform(0, np.pi, n2)
    th2 = rng.uniform(0, np.pi, n - n2)
    a = np.stack([np.cos(th1), np.sin(th1)], -1)
    b = np.stack([1 - np.cos(th2), -np.sin(th2) + 0.5], -1)
    x = np.concatenate([a, b]) + rng.normal(0, noise, (n, 2))
    y = np.concatenate([np.zeros(n2, int), np.ones(n - n2, int)])
    x = (x - x.mean(0)) / x.std(0)
    return make_store(x.astype(np.float32), (2,), labels=y, proxy_factor=1,
                      device=device)


def gmm(n: int = 4096, dim: int = 16, num_modes: int = 8,
        spread: float = 0.15, seed: int = 0, device=None) -> DatasetStore:
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (num_modes, dim))
    y = rng.integers(0, num_modes, n)
    x = centers[y] + rng.normal(0, spread, (n, dim))
    x = (x - x.mean(0)) / (x.std() + 1e-8)
    return make_store(x.astype(np.float32), (dim,), labels=y, proxy_factor=1,
                      device=device)


def _fourier_draws(rng, c: int, max_freq: int, count: int) -> list:
    """The random phases and amplitudes of ``_fourier_field``, drawn from
    ``rng`` in its order: ``(gy, gx, phase, amp)`` a mode."""
    draws = []
    for f in range(1, max_freq + 1):
        for (gy, gx) in ((f, 0), (0, f), (f, f)):
            phase = rng.uniform(0, 2 * np.pi, (count, 1, 1, c))
            amp = rng.normal(0, 1.0 / f, (count, 1, 1, c))
            draws.append((gy, gx, phase, amp))
    return draws


def _fourier_eval(draws: list, h: int, w: int, c: int,
                  rows: slice) -> np.ndarray:
    """Rows ``rows`` of the field the ``draws`` define; each element is
    the same sum in the same order for any slice of rows.  A mode with
    ``gx == 0`` (``gy == 0``) has the same phase argument along every
    column (row): its cosine is taken on one and broadcast, the same
    values as taken on all."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    n = len(range(*rows.indices(len(draws[0][2]))))
    out = np.zeros((n, h, w, c), np.float32)
    for gy, gx, phase, amp in draws:
        base = 2 * np.pi * (gy * yy + gx * xx)
        if gx == 0:
            base = base[:, :1]
        elif gy == 0:
            base = base[:1]
        out += amp[rows] * np.cos(base[None, :, :, None] + phase[rows])
    return out


def _fourier_field(rng, h, w, c, max_freq: int, count: int) -> np.ndarray:
    """[count, h, w, c] smooth random fields from low-frequency Fourier modes."""
    return _fourier_eval(_fourier_draws(rng, c, max_freq, count), h, w, c,
                         slice(None))


def procedural_images(n: int, h: int, w: int, c: int = 3,
                      num_classes: int = 10, seed: int = 0,
                      deform: float = 1.5, texture: float = 0.35,
                      pixel_noise: float = 0.05,
                      batch: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Raw arrays (x [n,h,w,c] float32 standardized, labels [n]).

    The random draws of a batch are made in the reference's order; the
    fields they define are then evaluated in slices of rows on a thread
    pool (numpy's elementwise kernels release the interpreter lock).
    Every element is computed by the same operations as in one piece, so
    the rows are bit-equal to the reference's."""
    rng = np.random.default_rng(seed)
    xs = np.empty((n, h, w, c), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    workers = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:

        def in_slices(fill, m: int) -> None:
            step = -(-m // (2 * workers))
            for f in [pool.submit(fill, r0, min(r0 + step, m))
                      for r0 in range(0, m, step)]:
                f.result()

        proto_d = _fourier_draws(rng, c, 3, num_classes)
        protos = np.empty((num_classes, h, w, c), np.float32)

        def fill_protos(r0: int, r1: int) -> None:
            protos[r0:r1] = _fourier_eval(proto_d, h, w, c, slice(r0, r1))

        in_slices(fill_protos, num_classes)
        protos /= (np.abs(protos).max(axis=(1, 2, 3), keepdims=True) + 1e-6)
        labels = rng.integers(0, num_classes, n)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            m = e - s
            lab = labels[s:e]
            # smooth per-sample deformation of the prototype (shift field)
            dy_d = _fourier_draws(rng, 1, 2, m)
            dx_d = _fourier_draws(rng, 1, 2, m)
            tex_d = _fourier_draws(rng, c, 6, m)
            noise = rng.normal(0, pixel_noise, (m, h, w, c))

            def fill(r0: int, r1: int) -> None:
                rows = slice(r0, r1)
                dy = _fourier_eval(dy_d, h, w, 1, rows)[..., 0] * deform
                dx = _fourier_eval(dx_d, h, w, 1, rows)[..., 0] * deform
                iy = np.clip((yy[None] + dy).round().astype(int), 0, h - 1)
                ix = np.clip((xx[None] + dx).round().astype(int), 0, w - 1)
                base = protos[lab[rows]]                         # [r,h,w,c]
                warped = base[np.arange(r1 - r0)[:, None, None], iy, ix, :]
                tex = _fourier_eval(tex_d, h, w, c, rows) * texture * 0.3
                xs[s + r0:s + r1] = warped + tex + noise[rows]

            in_slices(fill, m)
    xs -= xs.mean()
    xs /= (xs.std() + 1e-8)
    return xs, labels


def image_store(n: int, h: int, w: int, c: int = 3, num_classes: int = 10,
                seed: int = 0, device=None, **kw) -> DatasetStore:
    x, y = procedural_images(n, h, w, c, num_classes, seed, **kw)
    return make_store(x.reshape(n, -1), (h, w, c), labels=y, device=device)


# Named dataset registry mirroring the paper's benchmark suite ---------------

def mnist_like(n=4096, seed=0, device=None):
    return image_store(n, 28, 28, 1, num_classes=10, seed=seed, device=device)


def cifar_like(n=8192, seed=0, device=None):
    return image_store(n, 32, 32, 3, num_classes=10, seed=seed, device=device)


def celeba_like(n=4096, seed=0, device=None):
    return image_store(n, 64, 64, 3, num_classes=2, seed=seed, device=device)


def afhq_like(n=4096, seed=0, device=None):
    return image_store(n, 64, 64, 3, num_classes=3, seed=seed, device=device)


def imagenet_like(n=20000, seed=0, num_classes=1000, device=None):
    return image_store(n, 64, 64, 3, num_classes=num_classes, seed=seed,
                       device=device)


DATASETS = {
    "moons": moons,
    "gmm": gmm,
    "mnist_like": mnist_like,
    "cifar_like": cifar_like,
    "celeba_like": celeba_like,
    "afhq_like": afhq_like,
    "imagenet_like": imagenet_like,
}


def make_dataset(name: str, device=None, **kw) -> DatasetStore:
    """A named store on ``device`` (the CUDA card unless the caller
    passes another; raises when there is none, before generating)."""
    return DATASETS[name](device=resolve_device(device), **kw)
