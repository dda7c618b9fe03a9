"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so` beside this
file at first use, and loaded with ctypes. The hash covers the source and
the flags, so an edited source builds anew. `build()` compiles several
sources in parallel, one `nvcc` process each.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas resource lines (registers, shared memory, spills) per built source
PTXAS_INFO: Dict[str, str] = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every listed source that has no current library, all
    `nvcc` processes started together; returns build seconds per name
    (0.0 for a library that was already built). Raises with the
    compiler's output when a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    seconds = {n: 0.0 for n in names}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp-{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        PTXAS_INFO[name] = "\n".join(
            ln for ln in log.splitlines() if "ptxas info" in ln)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def declare(lib: ctypes.CDLL, fn: str, argtypes, restype=ctypes.c_int):
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def check(fn_name: str, err: int) -> None:
    """Raise when a C entry point reported a CUDA error (its return value
    is `cudaGetLastError()` right after the launch)."""
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed with cudaError_t {err}")
