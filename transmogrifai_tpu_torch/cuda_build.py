"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so` beside this
file at first use, and loaded with ctypes. The hash covers the source, the
headers of `csrc/` it includes and the flags, so an edited source or
header builds anew. `build()` compiles several
sources in parallel, one `nvcc` process each.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of single sources: the split search must not contract a*b+c into
# fused multiply-adds, so that it rounds as its plain version does
EXTRA_FLAGS: Dict[str, tuple] = {"split_search": ("--fmad=false",)}
# every kernel the port builds, in the order `chip_smoke.py` lists them
SOURCES = ("bin_features", "tree_walk", "histograms", "split_search",
           "route_leaves", "binned_aupr", "sibling_subtract", "eval_metrics",
           "wire_dequant", "write_rows", "corr_hits")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# launches per kernel, counted by each wrapper where it launches its kernel
# (a CUDA graph's replay adds the launches its capture recorded)
LAUNCHES: Dict[str, int] = {
    "bin_features": 0, "bin_features_f16": 0, "tree_walk": 0,
    "tree_walk_narrow": 0, "tree_walk_classes": 0,
    "histograms": 0, "split_search": 0, "split_search_live": 0,
    "route_level": 0, "leaf_values": 0, "binned_aupr": 0,
    "sibling_subtract": 0, "confusion_counts": 0, "regression_moments": 0,
    "wire_dequant": 0, "write_rows": 0, "corr_hits": 0,
    **{f"dequant_{entry}write_rows_int{bits}": 0
       for entry in ("", "bin_", "dual_") for bits in (8, 4)}}
_launch_lock = threading.Lock()
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


def count(name: str) -> None:
    """One more launch of kernel `name` (called by its wrapper only)."""
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches_snapshot() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def add_launches(delta: Dict[str, int]) -> None:
    """Add `delta` to the counts: a graph replay launches the kernels its
    capture recorded, without calling their wrappers."""
    with _launch_lock:
        for k, v in delta.items():
            LAUNCHES[k] += v


def set_launches(counts: Dict[str, int]) -> None:
    with _launch_lock:
        LAUNCHES.update(counts)


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in sorted(set(re.findall(rb'#include "([\w.]+)"', src))):
        h.update((SRC_DIR / header.decode()).read_bytes())
    h.update(" ".join(flags(name)).encode())
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
        cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
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


# the ctypes argument types of every C entry point, {(source, function):
# argtypes}, registered where the wrapper is defined; each names every C
# parameter, the stream included (ctypes passes an undeclared int as a
# 32-bit C int), and a CPU test holds each to its C signature
ARGTYPES: Dict[Tuple[str, str], tuple] = {}


def register(name: str, fns, argtypes) -> tuple:
    """Record `argtypes` as those of the entry point(s) `fns` (a name or
    several) of `csrc/<name>.cu`; returns them."""
    argtypes = tuple(argtypes)
    for fn in ([fns] if isinstance(fns, str) else fns):
        ARGTYPES[(name, fn)] = argtypes
    return argtypes


_entries: Dict[tuple, object] = {}


def entry(name: str, fn: str, restype=ctypes.c_int):
    """The C entry point `fn` of `csrc/<name>.cu`, built, loaded and
    declared with its registered argtypes at its first call; later calls
    are one dict lookup."""
    f = _entries.get((name, fn))
    if f is None:
        f = declare(load(name), fn, ARGTYPES[(name, fn)], restype)
        _entries[(name, fn)] = f
    return f


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# the current device without `torch.cuda.current_device()`'s lazy-init
# check: a launch follows tensors already on the card
_current_device = getattr(torch._C, "_cuda_getDevice",
                          lambda: torch.cuda.current_device())


def launch(index: int, fn, *args) -> int:
    """`fn(*args, stream)` on CUDA device `index` and its current stream,
    entering the device's context only when it is not the current
    device; returns the entry point's error code."""
    if index != _current_device():
        with torch.cuda.device(index):
            return launch(index, fn, *args)
    stream = (_raw_stream(index) if _raw_stream is not None
              else torch.cuda.current_stream(index).cuda_stream)
    return fn(*args, stream)


def check(fn_name: str, err: int) -> None:
    """Raise when a C entry point reported a CUDA error (its return value
    is `cudaGetLastError()` right after the launch)."""
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed with cudaError_t {err}")
