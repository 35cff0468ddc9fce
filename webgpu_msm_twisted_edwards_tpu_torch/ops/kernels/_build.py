"""Build, load and launch the CUDA kernels in csrc/.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes.  Libraries go into
`build/` beside this package (git-ignored) under a name carrying a hash of
its source, the headers that source includes, and the flags, so an edited
source is rebuilt at its next use.  The first use builds every missing
library at once, one nvcc process per source, all running in parallel.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); :func:`launch` raises if that is not 0 and counts the
launch in :data:`launches`.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from functools import lru_cache

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

#: Sources, one library each (probe_*: the kernels of experiments/).
SOURCES = ("convert", "digits", "hist", "gather", "scan", "scan_variants", "ec", "bpr",
           "precompute", "probe_scan", "probe_move")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches by kernel name, counted by :func:`launch`.
launches: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launches.clear()


#: None, or a dict in which every wrapper keeps the arguments of its largest
#: call (by tensor elements) under its kernel's name, for replaying the
#: kernel on the inputs a real run gave it (chip_smoke.py).
captures: dict | None = None


def capture(kernel: str, *args) -> None:
    if captures is None:
        return
    size = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
    if kernel not in captures or size > captures[kernel][0]:
        captures[kernel] = (size, args)


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return exe


def _sources(name: str) -> list[str]:
    """`csrc/<name>.cu` and the csrc headers it includes, directly or not."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        src = todo.pop()
        if src in seen:
            continue
        seen.append(src)
        with open(os.path.join(SRC_DIR, src)) as f:
            todo += re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    return seen


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every library that is missing, in parallel.  Returns the
    seconds spent.  The ptxas report (registers, spills) of each library is
    kept beside it as `<library>.ptxas.txt`."""
    todo = [(n, _lib_path(n)) for n in SOURCES if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        with open(path + ".ptxas.txt", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.time() - t0


def ptxas_report() -> dict[str, list[str]]:
    """Library name -> for each of its functions, one line with its
    registers, stack frame and spills from the last build's ptxas report."""
    out = {}
    for name in SOURCES:
        path = _lib_path(name) + ".ptxas.txt"
        if not os.path.exists(path):
            continue
        lines, fn = [], None
        with open(path) as f:
            for ln in f:
                if "Function properties for" in ln:
                    fn = ln.split("for")[-1].strip()
                elif "spill" in ln and fn:
                    lines.append(f"{fn}: {ln.strip()}")
                elif "Used" in ln and "registers" in ln and lines:
                    lines[-1] += "; " + ln.split(":", 1)[1].strip()
        out[name] = lines
    return out


@lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(_lib_path(name))


def clear() -> None:
    """Forget the loaded libraries and delete the built ones, so the next
    launch rebuilds every kernel from source."""
    library.cache_clear()
    for path in glob.glob(os.path.join(BUILD_DIR, "lib*.so*")):
        os.remove(path)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one lies
    on the CPU (where the wrappers run the plain versions)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> torch.Tensor:
    """Validate a kernel argument and return it contiguous; -1 in `shape`
    matches any size."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s not in (-1, d) for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def launch(kernel: str, lib: str, fn: str, *args) -> None:
    """Call C entry point `fn` of library `lib` with tensors (passed as device
    pointers) and ints, then the current stream; raise on a CUDA error and
    count one launch of `kernel`."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cfn = getattr(library(lib), fn)
    if cfn.restype is not ctypes.c_int or cfn.argtypes is None:
        cfn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor) else ctypes.c_longlong
                        for a in args] + [ctypes.c_void_p]
        cfn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = cfn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args],
                  stream)
    if err != 0:
        raise RuntimeError(f"{fn} ({kernel}) failed: CUDA error {err}")
    launches[kernel] += 1
