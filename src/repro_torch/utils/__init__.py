"""Small helpers shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller names another.  There is no silent CPU path: with no card,
    ``device=None`` (or an explicit CUDA device) raises."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


_STATUS_FIELDS = ("VmRSS", "RssAnon", "RssFile", "VmHWM")


def host_memory() -> dict[str, int]:
    """This process's host memory in bytes, from ``/proc/self/status``
    (Linux): ``VmRSS`` (resident), ``RssAnon`` (resident anonymous:
    heap, numpy and CPU tensors), ``RssFile`` (resident pages of mapped
    files: libraries' code, and an epoch file's mapped rows where they
    were touched) and ``VmHWM`` (the resident peak).  It first hands the
    C allocator's free pages back (glibc's ``malloc_trim(0)``; nothing
    elsewhere), so that ``RssAnon`` counts live buffers rather than
    pages kept for reuse after a large temporary was freed.  Where
    the status has no ``RssAnon`` / ``RssFile`` (a sandbox's ``/proc``),
    they come from ``/proc/self/statm``: shared pages as ``RssFile``, the
    rest of the resident ones as ``RssAnon``; ``VmHWM`` is then missing
    where the status lacks it."""
    import ctypes
    import ctypes.util
    try:
        ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    except (OSError, AttributeError):         # not glibc: nothing to trim
        pass
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in _STATUS_FIELDS:
                out[key] = int(rest.split()[0]) * 1024      # kB
    if "RssAnon" not in out or "RssFile" not in out:
        # a kernel whose status has no split (a sandbox's /proc): statm's
        # resident and shared (file-backed) pages
        import os
        with open("/proc/self/statm") as f:
            _, resident, shared = (int(v) for v in f.read().split()[:3])
        page = os.sysconf("SC_PAGE_SIZE")
        out["RssFile"] = shared * page
        out["RssAnon"] = (resident - shared) * page
    out.setdefault("VmRSS", out["RssAnon"] + out["RssFile"])
    return out


__all__ = ["resolve_device", "host_memory"]
