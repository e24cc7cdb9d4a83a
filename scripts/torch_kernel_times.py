#!/usr/bin/env python3
"""Time the port's kernels 1 (pdist) and 4 (golden_aggregate), and the
bf16 attention backward, of one tree.

  python3 scripts/torch_kernel_times.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds that tree's kernel sources, and prints one JSON line: the
card's name and power limit, and ms per launch (CUDA events, the 50 MB
L2 flushed and a ~2 ms spin before each launch: ``time_ms`` of
``scripts/card_timing.py``, which ``chip_smoke.py`` shares) of kernel 4
at B=16 and B=1 over N=50000 x D=3072 and at B=16 over N=16384 x
D=12288, of kernel 1 at B=16 and B=1 over N=50000 x d=192, and of a
plain read of each store (``X.sum(0)`` and ``X.sum()``); and
of ``flash_attention_bwd`` at llama3.2-3b's train-step shape [2, 8, 3,
4096, 128] in bf16, causal, and of each of its launches by the profiler
(``card_timing.device_events`` over 20 calls in one session, averaged
over the events kept).  The stores and the attention's
inputs are random, drawn on the card from seed 0.
To compare two trees on one card, run them in turns in one call
(parent, change, change, parent), each in its own process.  Needs a
CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch

from card_timing import card, device_events, launch_name, time_ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: no CUDA card")
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "src": args.src, "card": card()}
    full_scan_times(g, out)
    attention_bwd_times(g, out)
    print(json.dumps(out))


def attention_bwd_times(g: torch.Generator, out: dict) -> None:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    b, hkv, gq, s, dh = 2, 8, 3, 4096, 128
    q = torch.randn((b, hkv, gq, s, dh), generator=g,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, dh), generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    do = torch.randn(o.shape, generator=g, device="cuda").to(torch.bfloat16)
    shape = f"[{b}, {hkv}, {gq}, {s}, {dh}] bf16 causal"
    out[f"flash_attention_bwd {shape}"] = time_ms(
        lambda: flash_attention_bwd(q, k, v, o, do, lse, True))
    ms, kept = Counter(), Counter()
    for e in device_events(lambda: [flash_attention_bwd(
            q, k, v, o, do, lse, True) for _ in range(20)]):
        ms[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
        kept[launch_name(e.name)] += 1
    for name, total in ms.items():
        out[f"{name} {shape} (profiler, {kept[name]} kept)"] = (
            total / kept[name])


def full_scan_times(g: torch.Generator, out: dict) -> None:
    from repro_torch.kernels.golden_aggregate import golden_aggregate
    from repro_torch.kernels.pdist import pdist

    for b, n, d in ((16, 50000, 3072), (1, 50000, 3072), (16, 16384, 12288)):
        x = 0.3 * torch.randn(n, d, generator=g, device="cuda")
        q = x[:b] + 0.1 * torch.randn(b, d, generator=g, device="cuda")
        xn = (x * x).sum(-1)
        out[f"golden_aggregate B={b} N={n} D={d}"] = time_ms(
            lambda: golden_aggregate(q, x, 0.5, xn))
        if b == 16:
            out[f"X.sum(0) N={n} D={d}"] = time_ms(lambda: x.sum(0))
        del x, q, xn
    n, d = 50000, 192
    x = torch.randn(n, d, generator=g, device="cuda")
    xn = (x * x).sum(-1)
    for b in (16, 1):
        q = torch.randn(b, d, generator=g, device="cuda")
        qn = (q * q).sum(-1)
        out[f"pdist B={b} N={n} d={d}"] = time_ms(lambda: pdist(q, x, qn, xn))
    out[f"X.sum() N={n} d={d}"] = time_ms(lambda: x.sum())


if __name__ == "__main__":
    main()
