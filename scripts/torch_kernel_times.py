#!/usr/bin/env python3
"""Time the port's kernels 1 (pdist) and 4 (golden_aggregate) of one tree.

  python3 scripts/torch_kernel_times.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds that tree's two kernel sources, and prints one JSON line: the
card's name and power limit, and ms per launch (CUDA events, the 50 MB
L2 flushed and a ~2 ms spin before each launch: ``time_ms`` of
``scripts/card_timing.py``, which ``chip_smoke.py`` shares) of kernel 4
at B=16 and B=1 over N=50000 x D=3072 and at B=16 over N=16384 x
D=12288, of kernel 1 at B=16 and B=1 over N=50000 x d=192, and of a
plain read of each store (``X.sum(0)`` and ``X.sum()``).  The stores are random, drawn on the card from seed 0.
To compare two trees on one card, run them in turns in one call
(parent, change, change, parent), each in its own process.  Needs a
CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from card_timing import card, time_ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: no CUDA card")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.golden_aggregate import golden_aggregate
    from repro_torch.kernels.pdist import pdist

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "src": args.src, "card": card()}
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
