"""The benchmark's procedural image store, drawn on the device from a seed.

A frozen PyTorch rewrite of ``repro_torch.data.synthetic.procedural_images``
(kept here so that the yardstick does not move with the program): every
row is a class prototype (a smooth field of low-frequency Fourier modes)
warped by a smooth per-row shift field, plus a Fourier texture and pixel
noise, and the whole store is standardized to mean 0 and variance 1.
The draws come from one ``torch.Generator`` on the store's device, in
blocks of ``BLOCK`` rows, so that a seed gives the same rows on the same
device, and a store of a million rows is made in a few large calls.

``pool_proxy`` is the paper's proxy, the image average-pooled by a
factor, computed by the benchmark for its reference (the program pools
its own).
"""
from __future__ import annotations

import math

import torch

BLOCK = 1 << 16            # rows drawn per call
DEFORM, TEXTURE, PIXEL_NOISE = 1.5, 0.35, 0.05
PROTO_FREQ, SHIFT_FREQ, TEXTURE_FREQ = 3, 2, 6


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _mode_basis(h: int, w: int, max_freq: int, device) -> torch.Tensor:
    """[2M, h*w]: cos and sin of each mode's phase-free argument
    2 pi (gy y + gx x) on the unit grid; modes (f, 0), (0, f), (f, f)
    for f = 1..max_freq."""
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=device),
                            torch.linspace(0, 1, w, device=device),
                            indexing="ij")
    args = []
    for f in range(1, max_freq + 1):
        for gy, gx in ((f, 0), (0, f), (f, f)):
            args.append(2 * math.pi * (gy * yy + gx * xx))
    base = torch.stack(args).reshape(len(args), h * w)
    return torch.cat([torch.cos(base), torch.sin(base)])


def _fourier(g: torch.Generator, rows: int, c: int, basis: torch.Tensor,
             h: int, w: int) -> torch.Tensor:
    """[rows, h, w, c] fields sum_m amp * cos(arg_m + phase), amp ~
    N(0, 1/f), phase ~ U(0, 2 pi): cos(a + p) = cos a cos p - sin a sin p,
    so a block of fields is one product with the mode basis."""
    modes = basis.shape[0] // 2
    dev = basis.device
    freq = torch.arange(1, modes // 3 + 1, device=dev,
                        dtype=torch.float32).repeat_interleave(3)
    phase = torch.rand((rows, modes, c), generator=g, device=dev) * (
        2 * math.pi)
    amp = torch.randn((rows, modes, c), generator=g, device=dev) / freq[
        None, :, None]
    coef = torch.cat([amp * torch.cos(phase), -amp * torch.sin(phase)], 1)
    out = torch.einsum("rmc,mp->rpc", coef, basis)
    return out.reshape(rows, h, w, c)


def procedural_rows(n: int, h: int, w: int, c: int, num_classes: int,
                    seed: int, device) -> torch.Tensor:
    """[n, h*w*c] fp32 standardized rows on ``device`` from ``seed``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _procedural_rows(n, h, w, c, num_classes, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _procedural_rows(n, h, w, c, num_classes, seed, device) -> torch.Tensor:
    dev = torch.device(device)
    g = generator(seed, dev)
    proto_b = _mode_basis(h, w, PROTO_FREQ, dev)
    shift_b = _mode_basis(h, w, SHIFT_FREQ, dev)
    tex_b = _mode_basis(h, w, TEXTURE_FREQ, dev)
    protos = _fourier(g, num_classes, c, proto_b, h, w)
    protos = protos / (protos.abs().amax(dim=(1, 2, 3), keepdim=True) + 1e-6)
    labels = torch.randint(0, num_classes, (n,), generator=g, device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    x = torch.empty((n, h * w * c), dtype=torch.float32, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    total_sq = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        m = e - s
        dy = _fourier(g, m, 1, shift_b, h, w)[..., 0] * DEFORM
        dx = _fourier(g, m, 1, shift_b, h, w)[..., 0] * DEFORM
        iy = torch.clamp(torch.round(yy + dy), 0, h - 1).long()
        ix = torch.clamp(torch.round(xx + dx), 0, w - 1).long()
        warped = protos[labels[s:e, None, None], iy, ix]       # [m,h,w,c]
        tex = _fourier(g, m, c, tex_b, h, w) * (TEXTURE * 0.3)
        noise = torch.randn((m, h, w, c), generator=g, device=dev) * (
            PIXEL_NOISE)
        blk = (warped + tex + noise).reshape(m, -1)
        x[s:e] = blk
        total += blk.sum(dtype=torch.float64)
        total_sq += (blk.double() ** 2).sum()
    count = float(n) * h * w * c
    mean = total / count
    std = torch.sqrt(torch.clamp_min(total_sq / count - mean * mean, 0.0))
    mean32, scale32 = mean.float(), (1.0 / (std + 1e-8)).float()
    for s in range(0, n, BLOCK):
        blk = x[s:s + BLOCK]
        blk.sub_(mean32).mul_(scale32)
    return x


def pool_proxy(rows: torch.Tensor, image_shape: tuple,
               factor: int) -> torch.Tensor:
    """The proxy of flat rows [n, h*w*c]: each image average-pooled over
    ``factor`` x ``factor`` windows (the window summed in row-major
    order, then divided by its size), flattened as (h', w', c)."""
    h, w, c = image_shape
    hh, ww = h // factor, w // factor
    v = rows.reshape(-1, h, w, c)[:, :hh * factor, :ww * factor, :]
    v = v.reshape(-1, hh, factor, ww, factor, c)
    acc = None
    for i in range(factor):
        for j in range(factor):
            s = v[:, :, i, :, j, :]
            acc = s.clone() if acc is None else acc + s
    return (acc / (factor * factor)).reshape(rows.shape[0], hh * ww * c)


def blockwise(fn, rows: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """``fn`` over row blocks of ``rows``, concatenated: large stores
    without a store-sized temporary."""
    return torch.cat([fn(rows[s:s + block])
                      for s in range(0, rows.shape[0], block)])


def sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """[n] fp32 squared norms, by row blocks."""
    return blockwise(lambda b: (b * b).sum(-1), rows)
