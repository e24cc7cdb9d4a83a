"""Timing and profiler helpers of the benchmark.

``device_profile``, ``device_events`` and the profiler pad are frozen
copies of the port's card-timing helpers; the rest reads a
profiler's device events: a kernel's name as the benchmark files it
(``kernel_key``), the union of the kernels' intervals (the device's busy
time) and the idle gaps between them.
"""
from __future__ import annotations

import contextlib
import re
import subprocess
import time

import torch

PROFILE_PAD_S = 0.05    # host pauses that open and close a profiled session:
                        # the profiler keeps only device events whose times,
                        # moved onto the host's clock, fall inside it, and on
                        # H100 hosts that move is off by milliseconds


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True,
                              capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


@contextlib.contextmanager
def device_profile(device="cuda"):
    """A ``torch.profiler`` session over the card's activity (the host's,
    on a CPU device, which has no device events) that opens and closes
    with a host pause of ``PROFILE_PAD_S``, outside what the caller
    times inside it."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of every device event of a finished
    session, in start order."""
    from torch.autograd import DeviceType
    ev = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
          for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(ev, key=lambda e: e[1])


_KEY_BAD = re.compile(r"[^A-Za-z0-9_.-]+")


def kernel_key(name: str) -> str:
    """The name a device event is filed under in ``bench/kernels/``: a
    kernel's function name without its return type, namespaces,
    template and parameter lists (``void cub::X::Onesweep<...>(...)`` is
    ``Onesweep``), any other event's name up to its first parenthesis
    (``Memcpy HtoD (Pageable -> Device)`` is ``Memcpy_HtoD``), with every
    run of other characters than letters, digits, ``_``, ``.`` and ``-``
    made one ``_``; at most 64 characters."""
    s = name.replace("(anonymous namespace)::", "").strip()
    s = s.removeprefix("void ").split("(")[0].split("<")[0]
    s = _KEY_BAD.sub("_", s.split("::")[-1]).strip("_")
    return s[:64] or "unnamed"


def event_stages(events, stages: dict[str, str]) -> list[str | None]:
    """The stage of each of ``(name, start, end)``, in start order: the
    one its kernel's file names, or for a file whose stage is
    ``previous`` (a pass that several stages' kernels launch, as the row
    union) the stage of the nearest earlier event that has one of its
    own; ``None`` where no file names the kernel."""
    out, last = [], None
    for name, _, _ in events:
        st = stages.get(kernel_key(name))
        if st == "previous":
            st = last
        elif st is not None:
            last = st
        out.append(st)
    return out


def union_s(events) -> float:
    """Seconds covered by at least one of ``(name, start, end)``."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(events, key=lambda v: v[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(events) -> list[tuple[str, float]]:
    """The idle gaps between device events, each named by the events on
    its two sides (``prev -> next``), summed by that name, longest
    first."""
    out: dict[str, float] = {}
    last_name, last_end = None, None
    for name, s, e in sorted(events, key=lambda v: v[1]):
        if last_end is not None and s > last_end:
            key = f"{kernel_key(last_name)} -> {kernel_key(name)}"
            out[key] = out.get(key, 0.0) + (s - last_end)
        if last_end is None or e >= last_end:
            last_name, last_end = name, e
    return sorted(out.items(), key=lambda kv: -kv[1])
