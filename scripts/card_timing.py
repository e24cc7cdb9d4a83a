"""Timing and profiler helpers of the port's card scripts, and the
configuration they share.

``chip_smoke.py``, ``scripts/torch_index_times.py`` and
``scripts/torch_kernel_times.py`` import this module, so their times
are taken one way and their indexed route is one configuration.  It
imports torch alone (never ``repro_torch``): a script may time another
tree's package with it.  Every function here needs a CUDA card.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import torch

B, N, STEPS = 16, 50000, 10    # the main path: queries, store rows, DDIM steps
# The reference's indexed configuration (benchmarks/index_speedup.py:49,
# :59): m_t in [N/128, N/64], k_t in [N/256, N/128], probes 1/64-1/32
# of the windows with a capacity floor of 2 m_t; and the Golden Index's
# scale store, gmm N=65536 x 64 with 256 modes and 512 windows.
INDEXED_FRACS = dict(m_min_frac=1 / 128, m_max_frac=1 / 64,
                     k_min_frac=1 / 256, k_max_frac=1 / 128)
SCALE_PROBES = dict(f_lo=1 / 64, f_hi=1 / 32, safety=2.0)
GMM_N, GMM_DIM, GMM_MODES, GMM_SPREAD, GMM_C = 65536, 64, 256, 0.10, 512
T_BUCKETS = (900, 300, 100, 20)
SPIN_CYCLES = 4_000_000        # ~2 ms at the H100's clock (time_ms): more
                               # than a GoldDiff step's host enqueue
PROFILE_PAD_S = 0.05           # device_profile's pauses: nine times the worst
                               # clock skew scripts/torch_profiler_skew.py saw


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` with CUDA events, after warm-up, with
    the 50 MB L2 cache flushed before each launch (the main path reaches
    every kernel after gigabytes of other traffic).  A spin kernel of
    about two milliseconds after the flush lets the host enqueue all of
    ``fn`` before the device reaches the start event, so a call's time
    is its own and not its wrapper's host overhead (a GoldDiff step
    enqueues for up to about a millisecond)."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def wall_ms(fn, iters: int = 20) -> float:
    """Mean host wall time of ``fn`` per call over back-to-back calls,
    synchronized at both ends: what a caller pays, host launches
    included."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def short(name: str) -> str:
    """A kernel's name as the profiler gives it, without the return type
    and the anonymous namespace, cut to 48 characters."""
    return name.replace("void ", "").replace("(anonymous namespace)::",
                                             "")[:48]


def launch_name(name: str) -> str:
    """``short(name)`` without its template and parameter lists."""
    return short(name).split("(")[0].split("<")[0].strip()


@contextlib.contextmanager
def device_profile(cpu: bool = False):
    """A ``torch.profiler`` session over the card's activity (and the
    host's, with ``cpu``) that opens and closes with a host pause of
    ``PROFILE_PAD_S``.  The profiler keeps only the device events whose
    times, moved onto the host's clock, fall inside its session, and on
    the H100 hosts that move is off by milliseconds either way
    (``scripts/torch_profiler_skew.py``): without the pauses a short
    call's kernels can fall outside, some or all of them.  The pauses
    lie outside what the caller times inside the session."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_events(fn, tries: int = 3) -> list:
    """The device events of one call of ``fn`` in launch order, from a
    ``device_profile`` session.  Every caller's ``fn`` launches work, so
    a session that kept no device event lost them: it is read again,
    at most ``tries`` times in all, and ``fn`` runs once a try."""
    from torch.autograd import DeviceType
    for _ in range(tries):
        with device_profile() as prof:
            fn()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ev:
            break
    return sorted(ev, key=lambda e: e.time_range.start)


def device_kernels(fn) -> tuple[float, list[str]]:
    """The device busy ms of one call of ``fn`` and the kernels it
    launches, in launch order (``launch_name``), from ``device_events``."""
    ev = device_events(fn)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return busy, [launch_name(e.name) for e in ev]


def kernel_names(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, in launch order."""
    return device_kernels(fn)[1]
