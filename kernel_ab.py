"""Time K12's and K4's entry points built from two copies of their CUDA
sources side by side on one card: a parent's `csrc/` directory against
this checkout's.

    python3 kernel_ab.py PARENT_CSRC_DIR [--out FILE]

Both builds take the same `nvcc` flags (`cuda_build.flags`). Each case
runs both builds on the same inputs, checks their outputs equal bit for
bit, and times them with CUDA events in turns (parent, change, change,
parent, six times, 20 calls a run): the median and the least of each.
The cases: K12 `dual_write_rows` and K12-dequant `dequant_dual_write_rows`
/ `dequant_bin_write_rows` at 8 and 4 bits on a 262,144 x 500 chunk and
on 65,536-row chunks of 1100 and 2100 features (31 sorted edges a
feature), and K4 `bin_features_i8` at 891 and 65,536 rows of 496
features. Prints the card's name and power limit, then one JSON object a
case; exits 1 if any case differs.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch.models import trees  # noqa: F401 (argtypes)
from transmogrifai_tpu_torch.parallel import bigdata  # noqa: F401

SOURCES = ("write_rows", "bin_features")
EDGES = 31


def build_parent(csrc: str, out_dir: str) -> dict:
    """The parent's libraries, built together."""
    procs = {}
    for name in SOURCES:
        so = os.path.join(out_dir, f"parent_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.flags(name), "-o", so,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def entry(lib, source: str, fn: str):
    f = getattr(lib, fn)
    f.argtypes = list(cuda_build.ARGTYPES[(source, fn)])
    f.restype = ctypes.c_int
    return f


def cuda_ms(call, iters: int) -> float:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def run_case(libs, label, source, fn, make) -> dict:
    """make() -> (the entry's arguments before the stream, outputs)"""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls, outs = {}, {}
    for tag in ("parent", "change"):
        args, outs[tag] = make()
        f = entry(libs[tag][source], source, fn)
        err = f(*args, stream)
        if err != 0:
            raise RuntimeError(f"{label}: the {tag}'s {fn} returned {err}")
        calls[tag] = (lambda f=f, args=args: f(*args, stream))
    torch.cuda.synchronize()
    equal = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in zip(outs["parent"], outs["change"]))
    runs = {"parent": [], "change": []}
    for _ in range(6):
        for tag in ("parent", "change", "change", "parent"):
            runs[tag].append(cuda_ms(calls[tag], 20))
    return {"case": label, "equal": equal,
            **{f"{t}_ms": statistics.median(v) for t, v in runs.items()},
            **{f"{t}_least_ms": min(v) for t, v in runs.items()}}


def cases(dev, rng):
    """(label, source, entry, make) for every case."""
    def sorted_edges(d):
        return torch.from_numpy(np.sort(rng.normal(size=(d, EDGES)), 1)
                                .astype(np.float32)).to(dev)

    def empty(c, d, dtype):
        return torch.empty((c, d), dtype=dtype, device=dev)

    out = []
    for c, d in ((262144, 500), (65536, 1100), (65536, 2100)):
        e = sorted_edges(d)
        chunk = torch.from_numpy(rng.normal(size=(c, d)).astype(
            np.float16)).to(dev)

        def dual(c=c, d=d, e=e, chunk=chunk):
            o16, ob = empty(c, d, torch.bfloat16), empty(c, d, torch.int8)
            return ((chunk.data_ptr(), e.data_ptr(), o16.data_ptr(),
                     ob.data_ptr(), 0, c, d, EDGES), (o16, ob))
        out.append((f"dual_write_rows {c}x{d}", "write_rows",
                    "dual_write_rows", dual))
        for bits in (8, 4):
            q = torch.from_numpy(rng.integers(
                0, 256, (c, d if bits == 8 else (d + 1) // 2)).astype(
                    np.uint8)).to(dev)
            scale = torch.from_numpy(rng.uniform(0.01, 0.1, d).astype(
                np.float32)).to(dev)
            lo = torch.from_numpy((rng.normal(size=d) - 4).astype(
                np.float32)).to(dev)
            consts = (q.data_ptr(), scale.data_ptr(), lo.data_ptr(),
                      e.data_ptr())

            def ddual(c=c, d=d, bits=bits, consts=consts, keep=(q, scale,
                                                                lo)):
                o16, ob = empty(c, d, torch.bfloat16), empty(c, d, torch.int8)
                return ((*consts, o16.data_ptr(), ob.data_ptr(), 0, c, d,
                         EDGES, bits), (o16, ob))

            def dbins(c=c, d=d, bits=bits, consts=consts, keep=(q, scale,
                                                                lo)):
                ob = empty(c, d, torch.int8)
                return ((*consts, ob.data_ptr(), 0, c, d, EDGES, bits),
                        (ob,))
            out.append((f"dequant_dual_write_rows int{bits} {c}x{d}",
                        "write_rows", "dequant_dual_write_rows", ddual))
            out.append((f"dequant_bin_write_rows int{bits} {c}x{d}",
                        "write_rows", "dequant_bin_write_rows", dbins))
    for n in (891, 65536):
        d = 496
        e = sorted_edges(d)
        X = torch.from_numpy(rng.normal(size=(n, d)).astype(
            np.float32)).to(dev)

        def k4(n=n, d=d, e=e, X=X):
            o = empty(n, d, torch.int8)
            return ((X.data_ptr(), e.data_ptr(), o.data_ptr(), n, d, EDGES),
                    (o,))
        out.append((f"bin_features_i8 {n}x{d}", "bin_features",
                    "bin_features_i8", k4))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_csrc")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"parent": build_parent(args.parent_csrc, tmp)}
        cuda_build.build(SOURCES)
        libs["change"] = {name: cuda_build.load(name) for name in SOURCES}
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        rows = [run_case(libs, *case) for case in cases(
            torch.device("cuda"), np.random.default_rng(0))]
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(row["equal"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
