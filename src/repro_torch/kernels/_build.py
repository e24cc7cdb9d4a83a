"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/lib<name>.so`` at the repository
root and is loaded with ``ctypes``: a plain C interface, with
``c_void_p`` for every pointer and for the stream.  This builds in
seconds, where a source that includes PyTorch's headers takes minutes.
Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names) -> dict[str, str]:
    """Compile the named sources that are missing or older than their
    source, one ``nvcc`` process each, all started together.  Returns
    the compiler's report (``-Xptxas -v``) of each library it built;
    raises with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed, reports = [], {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _lib_path(name))     # atomic: no half-written .so
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


# template arguments in a mangled kernel name: integer and bool values,
# and the store rows' types (fp32 and bf16 instances)
_TEMPLATE_ARG = r"L[ib](\d+)E|(f)|(13__nv_bfloat16)"


def instances(report: str, entry: str):
    """(instance, registers, shared memory, spills) of each kernel whose
    name starts with ``entry`` in a ``-Xptxas -v`` report, template
    arguments written out (``flash_sm90_kernel<3,128>``,
    ``radix_pass<bf16,1>``)."""
    out, cur, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            k = re.search(rf"({entry}\w*?)(?:I((?:{_TEMPLATE_ARG})+)E|E)",
                          m.group(1))
            cur, spill = k and k.group(1), ""
            if k and k.group(2):
                args = [v or ("float" if f else "bf16") for v, f, _ in
                        re.findall(_TEMPLATE_ARG, k.group(2))]
                cur += "<" + ",".join(args) + ">"
            continue
        if cur and "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if cur and m:
            out.append((cur, int(m.group(1)),
                        f"{m.group(2) or 0} bytes static smem", spill))
            cur = None
    return out


def load(name: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``fn`` of ``lib<name>.so``, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        lib = _LIBS[name]
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def error_string(name: str, code: int) -> str:
    f = _LIBS[name].rt_error_string
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_char_p
    return f(code).decode()


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{error_string(name, code)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(name: str, device: torch.device, **tensors) -> None:
    """Every tensor on the same CUDA device, contiguous; raises
    ``ValueError`` naming the kernel and the argument otherwise."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{device}; CPU tensors take the plain version "
                         f"through repro_torch.kernels.ops")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_dtype(name: str, dtype: torch.dtype, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")


# the store rows' types a kernel has an instance for: fp32, and bf16 (the
# engine's storage_dtype; every kernel widens it to fp32 as it loads it)
ROW_DTYPES = (torch.float32, torch.bfloat16)


def require_rows(name: str, **rows) -> bool:
    """The store-row operands: all fp32, or all bf16.  Returns True for
    bf16 (the kernel's bf16-row instance); raises ``ValueError`` naming
    the kernel otherwise.  Queries, norms and logits stay fp32
    (``require_dtype``)."""
    dtypes = {t.dtype for t in rows.values()}
    if len(dtypes) != 1 or not dtypes <= set(ROW_DTYPES):
        got = ", ".join(f"{k} {t.dtype}" for k, t in rows.items())
        raise ValueError(f"{name}: store rows must be all float32 or all "
                         f"bfloat16, got {got}")
    return dtypes.pop() == torch.bfloat16


def vec4(t: torch.Tensor) -> int:
    """1 when the rows of t can be read four values a load: its last
    dimension a multiple of 4 and its start aligned to four elements (16
    bytes of fp32, 8 of bf16)."""
    return int(t.shape[-1] % 4 == 0
               and t.data_ptr() % (4 * t.element_size()) == 0)


def count(fn, bf16: bool) -> None:
    """One launch of ``fn``'s kernel: the fp32 instance counts in
    ``fn.launches``, the bf16-row instance in ``fn.launches_bf16``."""
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def require_shape(name: str, arg: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
