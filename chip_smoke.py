"""Smoke run of the PyTorch port on an NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port (`transmogrifai_tpu_torch`) only: it imports neither jax
nor the JAX package. Phases, one JSON line each; any failure exits
non-zero:

1. the card's name and power limit (from nvidia-smi), then the build of
   every CUDA kernel of the served path from `transmogrifai_tpu_torch/csrc`
   with nvcc, all sources in parallel;
2. K4 `bin_features` against its plain PyTorch version at n in
   {1, 64, 891, 65536} x 496 features with the Titanic model's 31 edges
   per feature, with NaN cells and values exactly on edges: bin ids equal;
3. K5 `tree_walk` against its plain version at the same n, on the Titanic
   model's tables (m = 1) and on a seeded synthetic 50-tree depth-12 forest
   (m = 2): sums equal (the same f32 leaf values added in tree order);
4. the main path: `load_model(fixture, device="cuda")` and
   `score_compiled` on all 891 rows of examples/data/titanic.csv, against
   the JAX package's scores committed beside the fixture
   (`expected_scores.npz`): rawPrediction atol 2e-5, probability atol
   1e-5, prediction equal where |margin| > 1e-4;
5. `ScoringService.from_path(fixture, device="cuda")`: start, requests of
   1, 3, 17 and 64 Titanic rows, stop; every answer equals phase 4's.
   The kernels' launch counters are set to 0 before phase 4 and read
   after phase 5: both kernels must have launched;
6. timings with CUDA events after warmup (kernels, plain versions, the
   bound from bytes and operations, `torch.searchsorted` as K4's one-call
   yardstick) at n = 891 and 65536; end-to-end `score_padded`
   milliseconds per batch for ladder buckets 1, 8 and 64; and, for
   buckets 1 and 64, the split of a batch's wall time into host phase and
   device segment, with the device's busy share from `torch.profiler`;
7. the `kernels` line; then the card's line and the result line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                       "titanic_quickstart_gbt")
TITANIC = os.path.join(HERE, "examples", "data", "titanic.csv")
SIZES = (1, 64, 891, 65536)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 outside the
# tensor cores, the rate for the compares, index updates and adds here
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_bytes(Xb, feat, bins, leaf) -> int:
    """Bytes K5 must move for these rows: the table slots, leaves and Xb
    cells the walk actually reads (each once; level l of a tree reaches at
    most 2^l of its slots), plus the (n, m) f32 output."""
    n_trees, depth, width = feat.shape
    n, m = Xb.shape[0], leaf.shape[-1]
    trees = torch.arange(n_trees, device=Xb.device)[:, None]
    rows = torch.arange(n, device=Xb.device)[None, :]
    slots = torch.zeros(feat.shape, dtype=torch.bool, device=Xb.device)
    cells = torch.zeros(Xb.shape, dtype=torch.bool, device=Xb.device)
    leaves = torch.zeros(leaf.shape[:2], dtype=torch.bool, device=Xb.device)
    node = torch.zeros((n_trees, n), dtype=torch.long, device=Xb.device)
    for level in range(depth):
        slots[trees, level, node] = True
        f = torch.gather(feat[:, level, :].long(), 1, node)
        b = torch.gather(bins[:, level, :].long(), 1, node)
        cells[rows.expand_as(f), f] = True
        node = node * 2 + (Xb[rows, f].long() > b).long()
    leaves[trees, node] = True
    return int(slots.sum()) * (feat.element_size() + bins.element_size()) \
        + int(leaves.sum()) * m * leaf.element_size() \
        + int(cells.sum()) * Xb.element_size() + n * m * 4


def binning_input(rng, n: int, edges: np.ndarray) -> np.ndarray:
    """(n, d) f32 around the edges' range, with values exactly on edges
    and NaN cells."""
    d, n_edges = edges.shape
    lo, hi = edges.min(axis=1), edges.max(axis=1)
    span = np.maximum(hi - lo, 1.0)
    X = (lo + (rng.random((n, d)) * 1.4 - 0.2) * span).astype(np.float32)
    k = max(1, n * d // 8)
    r, f = rng.integers(0, n, k), rng.integers(0, d, k)
    X[r, f] = edges[f, rng.integers(0, n_edges, k)]
    X[rng.integers(0, n, max(1, k // 4)),
      rng.integers(0, d, max(1, k // 4))] = np.nan
    return X


def synthetic_forest(rng, d: int, n_trees=50, depth=12, m=2, n_bins=32):
    width = 2 ** depth
    return {
        "feat": torch.from_numpy(rng.integers(
            0, d, (n_trees, depth, width)).astype(np.int32)),
        "bin": torch.from_numpy(rng.integers(
            0, n_bins + 1, (n_trees, depth, width)).astype(np.int32)),
        "leaf": torch.from_numpy(rng.random(
            (n_trees, width, m)).astype(np.float32)),
    }


def prediction_of(scores):
    name = next(k for k, v in scores.items()
                if isinstance(v, dict) and "probability" in v)
    return {k: v.cpu().numpy() for k, v in scores[name].items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch import Dataset, cuda_build, load_model
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.serving import ScoringService, ServingConfig
    from transmogrifai_tpu_torch.workflow.compiled import pad_dataset

    dev = torch.device("cuda")
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # 1. build ------------------------------------------------------------- #
    t0 = time.perf_counter()
    secs = cuda_build.build(["bin_features", "tree_walk"])
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": cuda_build.PTXAS_INFO})

    model = load_model(FIXTURE, device="cuda")
    gbt = next(s for s in model.fitted.values()
               if type(s).__name__ == "GBTClassificationModel")
    edges = torch.from_numpy(gbt.edges).to(dev)
    tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in gbt.trees.items()}
    rng = np.random.default_rng(0)
    forest = {k: v.to(dev) for k, v in
              synthetic_forest(rng, edges.shape[0]).items()}

    # 2. K4 against its plain version -------------------------------------- #
    inputs, binned = {}, {}
    k4_err = 0
    for n in SIZES:
        X = torch.from_numpy(binning_input(rng, n, gbt.edges)).to(dev)
        got = pt.bin_features(X, edges)
        want = pt.bin_features_plain(X, edges)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max().item())
        k4_err = max(k4_err, err)
        if got.dtype != want.dtype or err != 0:
            raise AssertionError(f"K4 disagrees at n={n}: max err {err}")
        inputs[n], binned[n] = X, got
    emit({"phase": "k4_check", "sizes": list(SIZES), "d": 496,
          "n_edges": int(edges.shape[1]), "max_abs_err": k4_err,
          "tolerance": "equal"})

    # 3. K5 against its plain version -------------------------------------- #
    k5_err = 0.0
    for label, t in (("gbt_m1", tables), ("forest_m2_depth12", forest)):
        for n in SIZES:
            args = (binned[n], t["feat"], t["bin"], t["leaf"])
            got = pt.tree_walk(*args)
            want = pt.tree_walk_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            k5_err = max(k5_err, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K5 disagrees on {label} at n={n}: max err {err}")
    emit({"phase": "k5_check", "sizes": list(SIZES),
          "tables": {"gbt_m1": list(tables["feat"].shape),
                     "forest_m2_depth12": list(forest["feat"].shape)},
          "max_abs_err": k5_err, "tolerance": "equal"})

    # 4. the main path: load + score_compiled on all 891 rows --------------- #
    ds = Dataset.from_csv(TITANIC)
    with np.load(os.path.join(FIXTURE, "expected_scores.npz")) as z:
        want = {k: z[k] for k in z.files}
    pt.reset_launches()
    main_model = load_model(FIXTURE, device="cuda")
    got = prediction_of(main_model.score_compiled(ds))
    torch.cuda.synchronize()
    per_batch = dict(pt.LAUNCHES)
    raw_err = float(np.abs(got["rawPrediction"] - want["rawPrediction"]).max())
    prob_err = float(np.abs(got["probability"] - want["probability"]).max())
    decided = np.abs(want["rawPrediction"][:, 1]) > 1e-4
    pred_diff = int((got["prediction"][decided]
                     != want["prediction"][decided]).sum())
    ok = (got["probability"].shape == (891, 2)
          and np.isfinite(got["probability"]).all()
          and raw_err <= 2e-5 and prob_err <= 1e-5 and pred_diff == 0
          and all(v >= 1 for v in per_batch.values()))
    emit({"phase": "score_compiled", "rows": 891,
          "raw_max_abs_err": raw_err, "prob_max_abs_err": prob_err,
          "prediction_mismatches": pred_diff,
          "tolerance": {"rawPrediction": 2e-5, "probability": 1e-5},
          "launches_per_batch": per_batch, "ok": bool(ok)})
    if not ok:
        raise AssertionError("score_compiled disagrees with the JAX scores")

    # 5. the scoring service ------------------------------------------------ #
    svc = ScoringService.from_path(FIXTURE, ServingConfig(max_batch=64),
                                   device="cuda").start()
    rows = ds.to_rows()
    off, answered = 0, []
    try:
        for size in (1, 3, 17, 64):
            res = svc.score([dict(r) for r in rows[off:off + size]])
            pred = res.outputs[next(
                k for k, v in res.outputs.items()
                if isinstance(v, dict) and "probability" in v)]
            for k in ("prediction", "rawPrediction", "probability"):
                if not np.array_equal(pred[k], got[k][off:off + size]):
                    raise AssertionError(
                        f"service answer for rows {off}..{off + size} "
                        f"differs from score_compiled in {k}")
            answered.append(size)
            off += size
        health = svc.health()
    finally:
        svc.stop()
    launches = dict(pt.LAUNCHES)
    if not all(v >= 1 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    emit({"phase": "service", "requests": answered, "equal": True,
          "health": health, "launches_main_path": launches})

    # 6. timings ------------------------------------------------------------ #
    timing = {}
    for n in (891, 65536):
        X, Xb = inputs[n], binned[n]
        d, n_edges = edges.shape
        k4_bytes = X.numel() * 4 + edges.numel() * 4 + Xb.numel()
        k4_bound, k4_by = bound(k4_bytes, n * d * n_edges)
        et = edges.contiguous()
        Xt = X.T.contiguous()
        k4 = {"ms": cuda_ms(lambda: pt.bin_features(X, edges), 50),
              "plain_ms": cuda_ms(lambda: pt.bin_features_plain(X, edges),
                                  10),
              "library_ms": cuda_ms(
                  lambda: torch.searchsorted(et, Xt, right=True), 50),
              "bound_ms": k4_bound, "bound_by": k4_by, "bytes": k4_bytes}
        T_, depth, _ = tables["feat"].shape
        m = tables["leaf"].shape[-1]
        k5_bytes = walk_bytes(Xb, tables["feat"], tables["bin"],
                              tables["leaf"])
        k5_bound, k5_by = bound(k5_bytes, n * T_ * (2 * depth + m))
        args = (Xb, tables["feat"], tables["bin"], tables["leaf"])
        k5 = {"ms": cuda_ms(lambda: pt.tree_walk(*args), 20),
              "plain_ms": cuda_ms(lambda: pt.tree_walk_plain(*args), 3),
              "library_ms": None, "bound_ms": k5_bound, "bound_by": k5_by,
              "bytes": k5_bytes}
        timing[n] = {"bin_features": k4, "tree_walk": k5}
        emit({"phase": "timing", "n": n, "bin_features": k4,
              "tree_walk": k5})
    scorer = main_model.compiled()
    e2e = {}
    for bucket in (1, 8, 64):
        sample = ds.take(np.arange(bucket))
        for _ in range(3):
            scorer.score_padded(sample, bucket)
        torch.cuda.synchronize()
        walls = []
        for _ in range(50):
            t = time.perf_counter()
            scorer.score_padded(sample, bucket)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        e2e[str(bucket)] = {"median_ms": float(np.median(walls)),
                            "p90_ms": float(np.percentile(walls, 90)),
                            "min_ms": float(np.min(walls))}
    emit({"phase": "e2e_score_padded", "buckets": e2e})

    # where a served batch's time goes: host phase vs device segment, and
    # the device's busy share from the profiler's kernel and copy times
    fi = scorer._fused_index()
    for bucket in (1, 64):
        sample = ds.take(np.arange(bucket))
        host, seg = [], []
        for _ in range(10):
            t = time.perf_counter()
            encs, raw_dev, _ = scorer.host_phase(
                pad_dataset(sample, bucket))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            scorer._run_segment(fi, encs, raw_dev)
            torch.cuda.synchronize()
            host.append((t1 - t) * 1e3)
            seg.append((time.perf_counter() - t1) * 1e3)
        reps = 10
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                scorer.score_padded(sample, bucket)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / reps
        # device-side entries only (kernels, copies): the op-level CPU
        # entries carry the same device time again
        dev_items = sorted(
            ((e.key, e.self_device_time_total / 1e3 / reps)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0),
            key=lambda kv: -kv[1])
        busy = sum(v for _, v in dev_items)
        # the idle share is taken against the unprofiled median wall of
        # the same bucket: the profiler's own cost stretches `wall`
        plain_wall = e2e[str(bucket)]["median_ms"]
        emit({"phase": "breakdown", "bucket": bucket,
              "wall_ms_profiled": wall, "wall_ms": plain_wall,
              "host_phase_ms": float(np.median(host)),
              "device_segment_ms": float(np.median(seg)),
              "device_busy_ms": busy if dev_items else "not measured",
              "device_idle_share": (1 - busy / plain_wall) if dev_items
              else "not measured",
              "top_device_items_ms": dev_items[:6]})

    # 7. the kernels line, the card, the result ----------------------------- #
    main_n = timing[891]
    emit({"kernels": [
        {"name": "bin_features", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/bin_features.cu",
         "replaces": "transmogrifai_tpu/models/trees.py:63",
         "launches": launches["bin_features"], "max_abs_err": k4_err,
         **{k: main_n["bin_features"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "tree_walk", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/tree_walk.cu",
         "replaces": "transmogrifai_tpu/models/trees.py:334",
         "launches": launches["tree_walk"], "max_abs_err": k5_err,
         **{k: main_n["tree_walk"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
