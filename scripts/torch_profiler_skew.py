"""How far ``torch.profiler``'s device times stray from the host's clock,
and how often a short session loses device events, with and without
``card_timing.device_profile``'s pauses.

For each session it profiles a short call (one launch, or a few
elementwise ops, a sort, copies and a scan) with the card's and the host's
activity, and reads each kernel's start less its launch call's start
(``kineto_results``, matched by correlation id): a kernel cannot start
before it is launched, so a negative value is skew between the two
clocks.  It prints, per case, how many device events each session kept
and the quantiles of that difference in microseconds.  Run on a CUDA
card, from the repository root::

  python3 scripts/torch_profiler_skew.py [--sessions 150]
"""
from __future__ import annotations

import argparse
import contextlib
import time
from collections import Counter

import torch
from torch.autograd import DeviceType

from card_timing import card, device_profile


@contextlib.contextmanager
def bare_profile():
    """The session ``device_profile`` replaces: no pauses."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        yield prof
        torch.cuda.synchronize()


def session(fn, opener) -> tuple[int, list[float]]:
    """The device events one profiled call of ``fn`` kept, and each
    kernel's start less its launch's, in microseconds."""
    with opener() as prof:
        fn()
    kept = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    ev = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in ev
              if e.device_type() == DeviceType.CPU and "Launch" in e.name()}
    skew = [(e.start_ns() - launch[e.correlation_id()]) / 1e3 for e in ev
            if e.device_type() == DeviceType.CUDA
            and e.correlation_id() in launch]
    return kept, skew


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=150)
    args = ap.parse_args()
    x = torch.randn(1 << 16, device="cuda")
    y = torch.randn(1 << 16, device="cuda")

    def one():
        x.add_(1.0)

    def many():
        z = torch.sort(x * 2 + y).values
        w = z.clone()
        w.copy_(z)
        torch.cumsum(w, 0)

    print(card())
    for name, fn in (("1 launch", one), ("sort and copies", many)):
        for label, opener in (("no pauses", bare_profile),
                              ("device_profile", lambda: device_profile(
                                  cpu=True))):
            for _ in range(3):
                fn()
            kept, skews = Counter(), []
            t0 = time.perf_counter()
            for _ in range(args.sessions):
                n, s = session(fn, opener)
                kept[n] += 1
                skews += s
            q = sorted(skews)
            qs = ", ".join(f"{q[int(f * (len(q) - 1))]:.1f}"
                           for f in (0, 0.01, 0.5, 0.99, 1)) if q else "none"
            print(f"{name}, {label}: device events kept per session "
                  f"{dict(sorted(kept.items()))} in {args.sessions} sessions; "
                  f"kernel start less launch start (us) min, 1%, median, "
                  f"99%, max: {qs}; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
