"""Time kernels' C entry points built from two copies of their CUDA
sources side by side on one card: a parent's `csrc/` directory against
this checkout's; and, with --wrappers, the eager and graph-replayed
Python wrappers of K8-mc, K8-reg and K10 of a parent checkout against
this one's.

    python3 kernel_ab.py PARENT_CSRC_DIR [--cases SUBSTR ...] [--out FILE]
    python3 kernel_ab.py --wrappers PARENT_ROOT [--out FILE]

Both builds take the same `nvcc` flags (`cuda_build.flags`). Each case
runs both builds on the same inputs, checks their outputs equal bit for
bit (K8-reg: within 1e-6 relative, since the redesign sums in another
order), and times them with CUDA events in turns (parent, change, change,
parent, six times, 20 calls a run): the median and the least of each.
Entry points whose C signature changed take the parent's argument types
from `PARENT_ARGTYPES`. The cases: K12 `dual_write_rows` and K12-dequant
`dequant_dual_write_rows` / `dequant_bin_write_rows` at 8 and 4 bits on a
262,144 x 500 chunk and on 65,536-row chunks of 1100 and 2100 features
(31 sorted edges a feature); K4 `bin_features_i8` at 891 and 65,536 rows
of 496 features; K8-mc `confusion_counts` at 8 x 135 (k 3) and 18 x
65,536 (k 3, 32); K8-reg `regression_moments` at 8 x 300 and 18 x
65,536; K10 `wire_dequant` on a 20-leaf wire at n 64, 891 and 65,536,
int8 and int4; K1 `histograms_i8` and K2 `split_search` at m = 1 to 4 (a forest
chunk's level 10 and boosting's level 9). `--cases` keeps
the cases whose label holds one of the substrings.

--wrappers runs a child process a tree (PYTHONPATH at the tree's root) in
turns, parent, change, change, parent, twice; each child times the
public calls (`confusion_counts`, `regression_moments`,
`dequantize_wire`) eagerly and as CUDA-graph replays, medians of five
runs of 50 calls. Prints the card's name and power limit, then one JSON
object a case; exits 1 if any case differs.
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
from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
from transmogrifai_tpu_torch.models import trees
from transmogrifai_tpu_torch.parallel import bigdata  # noqa: F401
from transmogrifai_tpu_torch.workflow import compiled  # noqa: F401

SOURCES = ("write_rows", "bin_features", "eval_metrics", "wire_dequant",
           "histograms", "split_search")
EDGES = 31
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the C signatures of the parent's entry points that this tree changed
PARENT_ARGTYPES = {
    ("eval_metrics", "confusion_counts"): (_P,) * 3 + (_I,) * 3 + (_P,) * 2,
    ("eval_metrics", "regression_moments"): (_P,) * 3 + (_I,) * 2
    + (_P,) * 2,
    ("wire_dequant", "wire_dequant"): (_P,) * 7 + (_I, _P),
    ("histograms", "histograms_i8"): (_P,) * 10 + (_I64,) + (_I,) * 11
    + (_P,),
}


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


def entry(lib, source: str, fn: str, tag: str = "change"):
    f = getattr(lib, fn)
    f.argtypes = list(PARENT_ARGTYPES.get((source, fn),
                                          cuda_build.ARGTYPES[(source, fn)])
                      if tag == "parent" else
                      cuda_build.ARGTYPES[(source, fn)])
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


def run_case(libs, label, source, fn, make, rtol=None) -> dict:
    """make(tag) -> (the entry's arguments before the stream, outputs) for
    the parent's or this tree's build; `rtol`: outputs compared within it
    (relative), not bit for bit"""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls, outs = {}, {}
    for tag in ("parent", "change"):
        args, outs[tag] = make(tag)
        f = entry(libs[tag][source], source, fn, tag)
        err = f(*args, stream)
        if err != 0:
            raise RuntimeError(f"{label}: the {tag}'s {fn} returned {err}")
        calls[tag] = (lambda f=f, args=args: f(*args, stream))
    torch.cuda.synchronize()
    if rtol is None:
        equal = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(outs["parent"], outs["change"]))
    else:
        equal = all(bool(((a - b).abs() <= rtol * b.abs()).all())
                    for a, b in zip(outs["parent"], outs["change"]))
    runs = {"parent": [], "change": []}
    for _ in range(6):
        for tag in ("parent", "change", "change", "parent"):
            runs[tag].append(cuda_ms(calls[tag], 20))
    return {"case": label, "equal": equal,
            "compared": "bits" if rtol is None else f"rtol {rtol}",
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

        def dual(tag, c=c, d=d, e=e, chunk=chunk):
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

            def ddual(tag, c=c, d=d, bits=bits, consts=consts,
                      keep=(q, scale, lo)):
                o16, ob = empty(c, d, torch.bfloat16), empty(c, d, torch.int8)
                return ((*consts, o16.data_ptr(), ob.data_ptr(), 0, c, d,
                         EDGES, bits), (o16, ob))

            def dbins(tag, c=c, d=d, bits=bits, consts=consts,
                      keep=(q, scale, lo)):
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

        def k4(tag, n=n, d=d, e=e, X=X):
            o = empty(n, d, torch.int8)
            return ((X.data_ptr(), e.data_ptr(), o.data_ptr(), n, d, EDGES),
                    (o,))
        out.append((f"bin_features_i8 {n}x{d}", "bin_features",
                    "bin_features_i8", k4))
    out += eval_cases(dev, rng) + k10_cases(dev, rng) + fit_cases(dev, rng)
    return out


def eval_cases(dev, rng):
    """K8-mc and K8-reg at the Iris / Boston sweeps' shapes and at 18 x
    65,536 (0/1 weights: counts exact in both; the regression sums
    compared within 1e-6 relative)."""
    out = []
    for P, n, k in ((8, 135, 3), (18, 65536, 3), (18, 65536, 32)):
        y = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)
        pred = torch.from_numpy(rng.integers(0, k, (P, n)).astype(
            np.int32)).to(dev)
        mask = torch.from_numpy((rng.random((P, n)) < 0.25).astype(
            np.float32)).to(dev)

        def mc(tag, P=P, n=n, k=k, y=y, pred=pred, mask=mask):
            o = torch.empty((P, k, k), dtype=torch.float32, device=dev)
            head = (y.data_ptr(), pred.data_ptr(), mask.data_ptr(), P, n, k)
            if tag == "parent":
                return head + (o.data_ptr(),), (o,)
            G, chunk, warps, shared = pdm.confusion_plan(P, n, k)
            part = torch.empty(P * G * k * k if G > 1 or not shared else 1,
                               dtype=torch.float64, device=dev)
            return (head + (G, chunk, warps, int(shared), part.data_ptr(),
                            o.data_ptr()), (o,))
        out.append((f"confusion_counts {P}x{n} k{k}", "eval_metrics",
                    "confusion_counts", mc))
    for P, n in ((8, 300), (18, 65536)):
        y = torch.from_numpy((rng.normal(size=n) * 9 + 22).astype(
            np.float32)).to(dev)
        pred = y + torch.from_numpy(rng.normal(size=(P, n)).astype(
            np.float32)).to(dev) * 3
        mask = torch.from_numpy((rng.random((P, n)) < 0.25).astype(
            np.float32)).to(dev)

        def reg(tag, P=P, n=n, y=y, pred=pred, mask=mask):
            o = torch.empty((P, 5), dtype=torch.float32, device=dev)
            head = (pred.data_ptr(), y.data_ptr(), mask.data_ptr(), P, n)
            if tag == "parent":
                return head + (o.data_ptr(),), (o,)
            G, chunk = pdm.moments_row_blocks(P, n)
            part = torch.empty(5 * P * G + P, dtype=torch.float64,
                               device=dev)
            return head + (G, chunk, part.data_ptr(), o.data_ptr()), (o,)
        out.append((f"regression_moments {P}x{n}", "eval_metrics",
                    "regression_moments", reg, 1e-6))
    return out


def k10_wire(dev, rng, n, bits, leaves=20):
    """A wire like a served model's raw columns: `leaves` // 2 scalar
    value leaves (width 1) and as many masks."""
    wire = []
    for j in range(leaves):
        if j % 2:
            wire.append((torch.from_numpy((rng.random(n) < 0.8).astype(
                np.uint8)).to(dev), None, None, 8))
        else:
            q = torch.from_numpy(rng.integers(
                0, 16 if bits == 4 else 256, (n, 1)).astype(np.uint8)).to(dev)
            wire.append((q, torch.from_numpy(rng.uniform(
                0.1, 2, 1).astype(np.float32)).to(dev), torch.from_numpy(
                rng.normal(size=1).astype(np.float32)).to(dev), bits))
    return wire


def k10_cases(dev, rng):
    """K10 over a 20-leaf wire at n = 64, 891 and 65,536, int8 and int4:
    the parent's pointer arrays against this tree's table, one buffer of
    16-byte aligned views."""
    out = []
    for n in (64, 891, 65536):
        for bits in (8, 4):
            wire = k10_wire(dev, rng, n, bits)

            def k10(tag, n=n, wire=wire):
                k = len(wire)
                if tag == "parent":
                    outs = [torch.empty(n, dtype=torch.float32, device=dev)
                            for _ in wire]
                    arrs = [(ctypes.c_void_p * k)(*[
                        None if w[i] is None else w[i].data_ptr()
                        for w in wire]) for i in range(3)]
                    return ((*arrs, (ctypes.c_void_p * k)(*[
                        o.data_ptr() for o in outs]),
                        (ctypes.c_int64 * k)(*[n] * k),
                        (ctypes.c_int * k)(*[1] * k),
                        (ctypes.c_int * k)(*[w[3] for w in wire]), k),
                        tuple(outs))
                width = -(-n // 4) * 4
                buf = torch.empty(k * width, dtype=torch.float32, device=dev)
                table = np.zeros((k, 7), np.int64)
                for i, w in enumerate(wire):
                    table[i] = (w[0].data_ptr(),
                                0 if w[1] is None else w[1].data_ptr(),
                                0 if w[2] is None else w[2].data_ptr(),
                                buf.data_ptr() + 4 * i * width, n, 1, w[3])
                outs = tuple(buf[i * width:i * width + n] for i in range(k))
                return (table.ctypes.data, k), outs + (table,)
            out.append((f"wire_dequant {n} int{bits}", "wire_dequant",
                        "wire_dequant", k10))
    return out


def fit_cases(dev, rng):
    """K1 (`histograms_i8`) and K2 (`split_search`, every node) at m = 1
    to 4: a forest chunk's level 10 (12 trees x 802 rows, 1024 nodes,
    integer class counts, feature masks of 5 %) and boosting's level 9 (6
    pairs, 512 nodes) at 802 and 65,536 rows, 496 features, 32 bins."""
    out = []
    shapes = [("xgb level 9", 6, 802, 512, 1), ("xgb level 9", 6, 65536,
                                                 512, 1)]
    shapes += [("forest level 10", 12, 802, 1024, m) for m in (2, 3, 4)]
    for label, P, n, nodes, m in shapes:
        d, B = 496, 32
        Xb = torch.from_numpy(rng.integers(0, B, (n, d)).astype(
            np.int8)).to(dev)
        node = torch.from_numpy(rng.integers(0, nodes, (P, n)).astype(
            np.int32)).to(dev)
        H = torch.from_numpy(rng.poisson(1.0, (P, n)).astype(
            np.float32)).to(dev)
        G = (torch.from_numpy(rng.integers(0, 2, (P, m, n)).astype(
            np.float32)).to(dev) * H[:, None]).contiguous()
        order, seg = trees.node_segments(node, nodes)
        grid, n_slots = trees.hist_plan_bounds(n, nodes)
        feats, lanes = trees._hist_layout(B, m, True, n / nodes)

        def k1(tag, P=P, n=n, m=m, nodes=nodes, Xb=Xb, G=G, H=H,
               order=order, seg=seg, grid=grid, n_slots=n_slots,
               feats=feats, lanes=lanes):
            hg = torch.empty((P, m, nodes, 496, 32), device=dev)
            hh = torch.empty((P, nodes, 496, 32), device=dev)
            first = torch.empty((P, nodes + 1), dtype=torch.int32,
                                device=dev)
            slot = torch.empty_like(first)
            sc = torch.empty(max(P * n_slots * (m + 1) * 496 * 32, 1),
                             device=dev)
            args = (Xb.data_ptr(), G.data_ptr(), H.data_ptr(),
                    order.data_ptr(), seg.data_ptr(), first.data_ptr(),
                    slot.data_ptr(), hg.data_ptr(), hh.data_ptr(),
                    sc.data_ptr(), n_slots, P, n, 496, nodes, 32, m, lanes,
                    feats, trees.HIST_PIECE_ROWS, trees.HIST_FEW_ROWS, grid)
            return (args if tag == "parent" else args + (m, 1)), (hg, hh)
        out.append((f"histograms_i8 {label} m{m} {P}x{n}", "histograms",
                    "histograms_i8", k1))
        hg, hh = trees.histograms(Xb, node, G, H, nodes, B)
        lam = torch.full((P,), 1e-6 if m > 1 else 1.0, device=dev)
        mcw = torch.ones(P, device=dev)
        zero = torch.zeros(P, device=dev)
        fm = torch.from_numpy(rng.random((P, d)) < (0.05 if m > 1 else 1.0)
                              ).to(dev, torch.uint8)

        def k2(tag, P=P, nodes=nodes, m=m, hg=hg, hh=hh, lam=lam, mcw=mcw,
               zero=zero, fm=fm):
            f = torch.empty((P, nodes), dtype=torch.int32, device=dev)
            b = torch.empty_like(f)
            return ((hg.data_ptr(), hh.data_ptr(), lam.data_ptr(),
                     mcw.data_ptr(), zero.data_ptr(), zero.data_ptr(),
                     fm.data_ptr(), None, None, 0, None, 0, P, 9, nodes, 496,
                     32, m, f.data_ptr(), b.data_ptr(), nodes), (f, b))
        out.append((f"split_search {label} m{m} {P}x{n}", "split_search",
                    "split_search", k2))
    return out


def wrapper_child() -> None:
    """In a child process with one tree's package on PYTHONPATH: the eager
    and graph-replayed public calls of K8-mc, K8-reg and K10 (medians of
    five runs of 50 calls), one JSON line."""
    from transmogrifai_tpu_torch.workflow import compiled as pc
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    calls = {}
    for P, n, k in ((8, 135, 3), (18, 65536, 3), (18, 65536, 32)):
        y = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(dev)
        pred = torch.from_numpy(rng.integers(0, k, (P, n)).astype(
            np.int32)).to(dev)
        mask = torch.from_numpy((rng.random((P, n)) < 0.25).astype(
            np.float32)).to(dev)
        calls[f"confusion_counts {P}x{n} k{k}"] = (
            lambda y=y, pred=pred, mask=mask, k=k:
            pdm.confusion_counts(y, pred, mask, k))
    for P, n in ((8, 300), (18, 65536)):
        y = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
        pred = torch.from_numpy(rng.normal(size=(P, n)).astype(
            np.float32)).to(dev)
        mask = torch.from_numpy((rng.random((P, n)) < 0.25).astype(
            np.float32)).to(dev)
        calls[f"regression_moments {P}x{n}"] = (
            lambda y=y, pred=pred, mask=mask:
            pdm.regression_moments(pred, y, mask))
    for n in (64, 891, 65536):
        for bits in (8, 4):
            wire = {}
            for j, (q, scale, lo, _) in enumerate(k10_wire(dev, rng, n,
                                                           bits)):
                wire[f"F{j:02d}"] = (q if scale is None else
                                     {"q1": q, "scale": scale, "lo": lo})
            calls[f"dequantize_wire {n} int{bits}"] = (
                lambda wire=wire, bits=bits: pc.dequantize_wire(wire, bits))
    out = {}
    for label, fn in calls.items():
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        eager = [cuda_ms(fn, 50) for _ in range(5)]
        graph = [cuda_ms(g.replay, 50) for _ in range(5)]
        out[label] = {"eager_ms": statistics.median(eager),
                      "graph_ms": statistics.median(graph)}
    print(json.dumps(out), flush=True)


def wrappers(parent_root: str) -> list:
    """Child processes over the parent's tree and this one in turns
    (parent, change, change, parent, twice): per call, the median of each
    tree's runs and the least."""
    roots = {"parent": os.path.abspath(parent_root),
             "change": os.path.dirname(os.path.abspath(__file__))}
    runs = {"parent": [], "change": []}
    for _ in range(2):
        for tag in ("parent", "change", "change", "parent"):
            env = dict(os.environ, PYTHONPATH=roots[tag])
            res = subprocess.run(
                # -P: the tree's package from PYTHONPATH, not this
                # script's directory
                [sys.executable, "-P", os.path.abspath(__file__), "--child"],
                cwd=roots[tag], env=env, capture_output=True, text=True,
                timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"the {tag} child failed:\n"
                                   f"{res.stderr[-4000:]}")
            runs[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
    rows = []
    for label in runs["change"][0]:
        row = {"case": label, "equal": True}
        for tag in ("parent", "change"):
            for key in ("eager_ms", "graph_ms"):
                v = [r[label][key] for r in runs[tag]]
                row[f"{tag}_{key}"] = statistics.median(v)
                row[f"{tag}_{key}_least"] = min(v)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?",
                    help="the parent's csrc/ directory (or, with "
                         "--wrappers, its checkout's root)")
    ap.add_argument("--wrappers", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        wrapper_child()
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if args.wrappers:
        print(card)
        rows = wrappers(args.parent)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            libs = {"parent": build_parent(args.parent, tmp)}
            cuda_build.build(SOURCES)
            libs["change"] = {name: cuda_build.load(name)
                              for name in SOURCES}
            print(card)
            rows = [run_case(libs, *case) for case in cases(
                torch.device("cuda"), np.random.default_rng(0))
                if args.cases is None or any(c in case[0]
                                             for c in args.cases)]
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(row["equal"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
