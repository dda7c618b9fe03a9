"""Smoke run of the PyTorch port on an NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port (`transmogrifai_tpu_torch`) only: it imports neither jax
nor the JAX package. Without a CUDA device, or as a copy alone in a
directory without the port's package beside it, it prints one JSON line
naming what is missing (`{"phase": "preflight", "ok": false, "missing":
[...]}`) and exits 2, with no result line. Phases, one JSON line each;
any failure exits non-zero:

1. the card's name and power limit (from nvidia-smi), then the build of
   every CUDA kernel of the port (eleven sources) from
   `transmogrifai_tpu_torch/csrc` with nvcc, all sources in parallel;
2. K4 `bin_features` against its plain PyTorch version at n in
   {1, 64, 891, 65536} x 496 features with the Titanic model's 31 edges
   per feature, with NaN cells and values exactly on edges: bin ids equal;
3. K5 `tree_walk` against its plain version at the same n, on the Titanic
   model's tables (m = 1) and on a seeded synthetic 50-tree depth-12 forest
   (m = 2), then at its tile and chunk boundaries (`walk_boundary_cases`:
   R rows a block forced to 1, 8 and 64 and the plan's own, n around R,
   tree counts around a chunk's K5_CHUNK_PAIRS / R, m = 1 to 11 channels,
   int8 and int32 Xb, split bins that never fire): sums equal (the same f32
   leaf values added in tree order), and the kernel's plan gives R at
   n = 1, 64, 891, 65,536 and the out-of-core shape;
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
   yardstick) at n = 64, 891 and 65536, K5 also at n = 1 and on phase 3's
   depth-12 forest at 891 (`k5_timing`: at n <= 891 the eager call and
   the plain version as medians of eight runs in turns, and a CUDA-graph
   replay); then served batches (phase
   `serving_timing`, after phase 20): `score_padded` at buckets 1, 8 and
   64 with one CUDA graph per bucket and, as a measurement only, eagerly,
   in f32 and int8, for the quickstart GBT and the script's models (the JAX
   package's from phase 20, the port's from phase 19): wall ms per batch,
   the part of it inside device segments and the rest on the host, and
   the device's busy share from `torch.profiler`;
7. the training kernels against their plain versions at the training
   path's shapes (P = 6 pairs, n = 802 rows, d = 496 features, 32 bins,
   levels 0, 5 and 9) and at n = 65536: K1 histograms within the f32
   summation bound of the plain version (per cell 2·(m − 1)·2^-24·Σ|v|,
   m the node's rows: both sum the same values in different orders) and
   bit-equal run to run; K2 split features and bins equal
   from the same histograms, dense and over the live set (the nodes that
   hold rows); K3 node ids and flags (routing out of place, the next
   level's live set) equal, leaf values bit-equal to
   the CPU's row-order sums and within atol 1e-6 of the card's
   `index_add_`; K8 binned AuPR equal at 512 and 4096 buckets. Then the
   skewed cases (`skew_check`): K1 on one node of 2^20 + 12345 rows cut
   into 32+ pieces of HIST_PIECE_ROWS and on 2048 mostly-empty nodes, rows
   left out and bin ids dropped across the piece edges (equal to the plain
   version on class counts, bit-equal run to run), and K3's leaf pass at
   LEAF_SCAN_MAX_ROWS ± 1 rows in both designs and the wrapper's choice
   (bit-equal to the CPU's row-order sums); and K3's leaf pass in both
   designs across rows a pair (`leaf_regime_timing`), the timings the
   wrapper's switch between them is chosen from;
8. the training path: the README quickstart's XGBoost family trained by
   `Workflow.train(device="cuda")` at full width (891 rows, 1048 → 496
   columns, min_child_weight {1, 10} x 3 folds, 200 rounds at depth 10,
   early stopping 20), held to the JAX package's f32-mode results
   committed in `testdata/titanic_quickstart_train_f32` (kept columns and
   winner equal, fold and holdout AuPR within 1e-2), then
   saved, reloaded with `load_model(device="cuda")` and scored on all 891
   rows: equal to the in-memory model's scores. The launch counters are
   set to 0 before the train and read after the reload's scores: K1, K2
   (dense at the root, over the live set below), K3, K8 and K4 must all
   have launched;
9. training timings: each training kernel at the path's shapes and at
   n = 65536 beside its bound, its plain version and its one-call
   yardstick (`index_add_` for K1, `bincount` for K8); K2 over the live
   set and dense, beside a bound of live-cell bytes and one of dense
   bytes; K3's routing eager and as a CUDA-graph replay; the training wall
   split into feature fit, sanity checker, sweep and refit; the device's
   busy share of the XGBoost sweep and of the default sweep from
   `torch.profiler`;
10. the `kernels` line (forest kernels timed at level 11 of the depth-12
   bucket, launches counted over phase 12); then the card's line and the
   result line;
11. the forest kernels at level 11 of the depth-12 bucket, on one chunk of
   trees as `fit_forest` sizes it (its byte budget from the card's free
   memory): K1 with m = 2 class channels over the rows routed right,
   grouped by their 1024 parents, K1-sub (sibling subtraction, level 10 ->
   11), K2 with m = 2 over 2048 nodes, K3 routing and K3 leaves with m = 2
   over 4096 leaves, each against its plain version on the chunk's first
   pairs: equal (integer sums). Then the chunk's depth-12 trees grown
   level by level (`live_levels_check`), for both child-weight grids of
   the bucket, and the same at P = 6 over float gradients (min_child_weight
   1 / gamma 0, and 0 / -1, where an empty left child carries parent −
   right's rounding residue): at every level K2 over the live set (K3's
   flags and K2's marks of left children) equal to the dense kernel on
   every pair and to the plain version on the checked pairs, every node
   with a row or a non-zero cell in the live set, K3's node ids and flags
   equal to the plain version, and the tables equal to `grow_trees`'; the
   live nodes a level recorded. Then each kernel timed on the whole chunk
   beside its bound, its plain version and `index_add_` (K1) as a
   yardstick (K1-sub has none: it writes both children, `torch.sub` the
   left ones only); K2 dense and over level 11's live set, K3 eager and
   replayed;
12. the README quickstart verbatim — `with_cross_validation()` with no
   `models=`, so LR (8 configs) + RF (18 configs of 50 trees, depth
   buckets 4, 6 and 12) + XGB (2 configs), 3 folds — trained by
   `Workflow.train(device="cuda")` with the JAX package's forest draws
   injected from `testdata/titanic_quickstart_default_f32` and held to
   the JAX package's f32-mode default sweep there: winner equal, LR fold
   AuPR within 1e-4, RF and XGB fold AuPR and holdout AuPR within 1e-2;
   then saved, reloaded and scored (equal to the in-memory model). TF32
   must be off. The launch counters are set to 0 before the train and read
   after the reload's scores: every kernel must have launched. The sweep
   is timed per family and per static group (the RF depth buckets), the
   refit apart;
13. the evaluation kernels (csrc/eval_metrics.cu): K8-mc
   `confusion_counts` and K8-reg `regression_moments` against their plain
   versions at the Iris and Boston sweeps' shapes (8 pairs of 135 / 300
   rows) and at n = 65536, P = 18 (counts equal, sums within 1e-6
   relative), timed beside the byte bound, the plain version and (K8-mc)
   one `torch.bincount`; and K1, K1-sub, K2, K3 routing and K3 leaves with
   m = 3 class channels at level 11 of the Iris depth-12 bucket, each
   equal to its plain version;
14. the Iris example verbatim (`examples/op_iris_simple.py` with the
   port's entry points: `.indexed()` label,
   `MultiClassificationModelSelector.with_train_validation_split()`, LR 8
   + RF 18 configs) trained on the card with the JAX package's forest
   draws injected, held to `testdata/iris_default_f32`: kept columns,
   label order and winner equal, validation F1 within 1e-6, holdout F1 >=
   0.80; saved, reloaded and scored (equal);
15. the Boston example verbatim (`RegressionModelSelector`, linear 8 + RF
   18 + GBT 18 configs) held to `testdata/boston_default_f32`: kept
   columns and winner equal, validation RMSE within 1e-4 (linear) / 1e-2
   (RF, GBT) relative, holdout RMSE <= 6.0 and R2 >= 0.6 and within 1e-2
   relative; saved, reloaded and scored (equal). Each example's launch
   counters cover exactly its run; its kernels must all have launched;
16. K5-mc (`tree_walk_classes`, the class-tree walk of softmax boosting)
   against its plain version on the JAX package's Iris model (200 rounds x
   3 classes at depth 10) at n = 150 and 65536 with int8 and int32 bins,
   on a 12-class ensemble and at K = 3 and 12 across its tile and chunk
   boundaries (`k5mc_boundary_check`) (equal), and its margins against the
   JAX package's on the fixture's rows (2e-5); then timed beside its bound
   and its plain version;
17. the three selector runs over the other families (L-BFGS logistic
   regression, linear SVC, naive Bayes, decision trees, MLP, multiclass
   XGBoost, GLM) on the Titanic, Iris and Boston pipelines, every config,
   the JAX package's MLP initial weights injected, held to
   `testdata/families_{binary,iris,boston}_f32`: configs equal, each
   validation metric within its family's tolerance (naive Bayes and trees
   on classes 1e-5, trees on Boston and multiclass XGBoost 1e-2, the
   optimizer-path families max(5e-3, twice that family's own largest
   move in the JAX package under one ulp of input noise, over the
   fixture's 16 noise runs)); the winner the fixture's, or its second
   where the top two lie within tolerance; the holdout metrics in the
   tests/test_examples.py bands. A winner or band rule that the JAX
   package itself breaks in one of its noise runs is reported, not
   enforced (`winner_check`, `band_check`). Saved, reloaded and scored
   (equal); sweep seconds per family and static group and every kernel's
   launches printed;
18. each new model class fitted at its family's first grid point (a
   one-config selector), saved, reloaded and scored through
   `score_compiled` on the card: reload equal, holdout metric within the
   family's tolerance of the JAX package's, scores as close as the family
   allows; K5-mc must launch (the multiclass XGBoost model's scores);
19. examples/op_titanic_simple.py verbatim (its derived features through
   the math, scaler and row ops, its lambda `age_group`, the default
   LR + RF + XGB selector over a train/validation split) trained on the
   card with the JAX package's forest draws injected, held to
   `testdata/titanic_simple_f32`: configs, kept columns and winner equal,
   validation AuPR within 1e-4 (LR) / 1e-2 (RF, XGB), holdout AuPR >= 0.78
   and within 1e-2, AuROC >= 0.80, Error <= 0.25, the three default
   families swept, a sex, fare or family feature in the top six insights;
   its save refused (the lambda); the train wall split into feature fit,
   sanity checker, sweep and refit; its kernels must all have launched;
20. quantized serving: K10 `wire_dequant` (csrc/wire_dequant.cu), K4's
   f16-edge variant and K5 over narrowed tables (int16 features, uint8
   bins) against their plain versions at n in {1, 64, 891, 65536}, K5's
   narrowed tables also at phase 3's boundary cases (equal);
   then the script's JAX-trained model and the quickstart GBT, each loaded
   on the card and served in int8, int4 and int8-calibrated modes through
   `score_padded` with CUDA graphs, the 891 rows in batches of 64: each
   batch's wire equal to the JAX package's (sha256), rawPrediction within
   2e-5 and probability 1e-5 of the JAX package's quantized scores, graph
   replay equal to eager scoring; the launch counters are set to 0 before
   and read after, and the three kernels must have launched (counted per
   replay); then each timed beside its bound and plain version at n = 64,
   891 and 65536. The `kernels` line lists them with the launches of this
   run;
21. the out-of-core path (`big_path`, BASELINE target 4's machinery at
   4,456,448 × 500: 17 upload chunks of 262,144 rows, n·d past 2^31): first
   the 16384 × 500 fixture `testdata/big_synth_16384x500` (the JAX
   package's, chunk 4096) rebuilt on the card: store and binned-matrix
   sha256 equal, the LR grid within twice the JAX package's own
   row-permutation move, the lockstep GBT's and the injected-draw forest's
   trees equal, GBT leaves within 1e-5 and margins 2e-6, forest leaves
   equal; then a synthetic store (seed 11) generated in a temporary
   directory, `dual_device_matrices` through K12 (`csrc/write_rows.cu`)
   with its upload seconds, GB/s and overlap, K12 held bit for bit to its
   plain version on the first and the last chunk; the LR grid (8 (l1, l2)
   pairs × 3 folds × 200 FISTA steps, bf16 × bf16 → f32 products) with
   seconds per fold and holdout AuPR per grid through K8-binned; the RF
   (16 trees at depth 6 in one lockstep batch, and one depth-12 tree),
   the lockstep GBT (6 pairs × 2 rounds at depth 6, one round at depth
   10) with the K1/K2/K3 times of every level; `predict_forest_big` over
   all rows (K5); the device's busy share over one RF batch and one LR
   fold (`torch.profiler`). The launch counters are set to 0 before the
   upload and read after the prediction: K12, K1, K2, K3, K5 and K8 must
   have launched. Then each kernel at these shapes beside its bound, its
   plain version and a library call (K5 as `predict_forest_big` runs it,
   beside the bound of the cells it reads and that of all of Xb), and
   K12's four entries on hostile edges and values at odd, narrow and
   misaligned shapes (`k12_hostile_check`, bit-equal); the `kernels` line
   adds them (`write_rows`, `*_big`). `big_path(rows=10_000_000)` is the
   same phase at BASELINE target 4's shape (39 chunks);
22. the feature cache and the quantized wire (`big_cache`), on phase 21's
   store in the same temporary root, each build `dual_device_matrices`
   with `cache=FeatureCacheParams(dir=<root>/cache, policy="readwrite",
   wire=..., verify="size")` as bench.py passes it: for the int8, int4 and
   f16 wires a cold miss that writes the artifact (the int8 and int4 quant
   plans from 200,000 sampled rows, seed 0), K12-dequant's dual entry held
   bit for bit to its plain version on the first and the last (padded)
   chunk and the tape to the host quantization of the store's rows; then a
   warm hit bit-equal to the cold build with zero store reads and
   `cache_bytes` the artifact's size; the f16 replay bit-equal to phase
   21's uncached build. On the int8 wire also: `resident=True` (a second
   build returns the same tensors, no IO; `resident_release` frees them);
   one byte of the tape flipped with `verify=True` (rejected, counted in
   `feature_cache_corrupt_total`, rebuilt cold and bit-equal); and one LR
   fold and one 16-tree depth-6 RF batch on the warm matrices, their
   holdout AuPR beside phase 21's (a reading, not a gate). Each wire's
   artifacts are deleted after its checks (the phase raises if the disk
   lacks room for the largest twice). Then the 16384 × 500 fixture store
   through int8 and int4, all three builders, held to the JAX package's
   digests (`testdata/big_synth_16384x500/quant_digests.json`: quant plan,
   wire tape, both matrices). The launch counters are set to 0 before the
   phase and read after the fixture: every K12-dequant entry at both
   widths, K12 and the downstream kernels must have launched. Each build's
   wall, wire GB/s, overlap and stage seconds are printed; then each
   K12-dequant entry at 8 and 4 bits on a 262,144-row chunk beside its
   bound, its plain version and the library composition, and every entry
   on hostile edges at odd, narrow and misaligned shapes
   (`k12_dequant_hostile_check`, bit-equal); the `kernels` line adds them
   (`dequant_*_int8`, `dequant_*_int4`);
23. any class count (`many_class_phase`): the default
   `MultiClassificationModelSelector` (LR 8 + RF 18 configs) trained by
   `Workflow.train(device="cuda")` over a seeded 7-class synthetic of
   4,000 rows x 20 features with numpy forest draws injected: K1 and K2
   reach m = 7 class channels and K8-mc k = 7 (`ChannelLog`), every
   kernel of the Iris path launched (counters set to 0 before the train,
   read after the reload), every `fit_forest` call's tables equal to the
   port's CPU refit of the same call, scores equal after save and
   reload; a 7-class `OpDecisionTreeClassifier` fitted on the card and on
   the CPU (tables equal); the multinomial LR family alone over a 40-class
   synthetic of 20,000 x 48 (K8-mc at k = 40, its call held to the plain
   version, validation F1 finite). Beside phases 13 and 20: K8-mc and
   K8-reg on their hostile cases (`K8MC_HOSTILE_CASES`,
   `K8REG_HOSTILE_CASES`: k = 1 to 300, n = 0 and 1, rows the plan's
   ranges do not divide), K1 and K2 at m = 5, 7 and 12
   (`MANY_CHANNEL_CASES`), K10 at 1, 48, 49 and 97 leaves
   (`K10_HOSTILE_CASES`: width 1, masks, odd widths at 4 bits, empty
   leaves, unaligned views), each against its plain version with its
   launches counted and the same bits twice; K8-mc (k = 3 to 300) and
   K8-reg timed eagerly and as CUDA-graph replays, K10 at int8 and int4
   with its eager wrapper's host time split by function (`wrapper_host`);
24. feature validation at full scope (`feature_validation_phase`): the
   repo's Titanic rows split by a seeded permutation into 600 training
   and 291 score rows; `Workflow.train` with `with_raw_feature_filter(
   score_dataset=...)` (min scoring rows 100, min fill 0.25: cabin drops),
   `with_workflow_cv()`, `auto_bucketize` on age, transmogrify,
   `label.sanity_check(..., correlation_type="spearman")` and the default
   LR family alone, on the card and on the CPU: the filter's drops, map
   keys and metrics, the checker's kept columns and drop reasons, the
   bucketizer's thresholds, the configs and the winner equal, the fold
   AuPRs within 1e-4 relative (the L-BFGS card-to-CPU tolerance of
   tests/test_torch_cuda.py); then the default selector (LR + RF + XGB)
   under workflow CV on the card (its forests held at the metric level,
   F3: holdout AuPR >= 0.70, AuROC >= 0.75), K1-K5 and K8 launched in its
   train (counters set to 0 before the train, read just after it), then
   saved, reloaded and served through `score_compiled` (the bucketizer and
   the Spearman-checked vector; equal to the in-memory model), the
   serving launches counted apart;
25. the wide sanity check (`wide_sanity_phase`): K9-hits
   (csrc/corr_hits.cu) against `corr_hits_plain` on the hostile blocks of
   `K9_HITS_CASES` (none, all, truncated, first and ragged last blocks,
   rows past d, cells exactly at the threshold, 40 identical columns past a
   cap of 512: bit-equal, twice); then a seeded synthetic of 50,000 rows
   x 16,384 columns (`wide_synthetic`: the width of 32 text columns at 512
   hash buckets; 3.3 GB on the card) with planted duplicates and
   anti-duplicates, a leak column, constant columns, 40 identical columns
   and a group of 513 identical columns that passes the first block's cap
   of 131,072 hits; `SanityChecker()` and `correlation_type="spearman"`
   trained through `Workflow.train` on the card: every planted column
   dropped for its reason, the truncation logged, K9-hits launched, the
   kept indices equal to a fit that extracts with `corr_hits_plain` while
   K9-hits' outputs are held to it bit for bit on every block; one Gram
   block, K9-hits (beside its bound, its plain version and
   `torch.nonzero` + gather), the rank transform, each fit's wall and
   `torch.cuda.max_memory_allocated` over the train and over the fit
   alone recorded. The `kernels` line adds
   `corr_hits`.
"""

import contextlib
import ctypes
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                       "titanic_quickstart_gbt")
TRAIN_FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                             "titanic_quickstart_train_f32")
TITANIC = os.path.join(HERE, "examples", "data", "titanic.csv")
SIZES = (1, 64, 891, 65536)
SERVING_KERNELS = ("bin_features", "tree_walk")
TRAINING_KERNELS = ("histograms", "split_search", "split_search_live",
                    "route_level",
                    "leaf_values", "binned_aupr", "bin_features")
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


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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


def graph_ms(fn, iters: int) -> float:
    """CUDA-event ms per replay of a CUDA graph that holds `fn`'s launches
    (the way a served batch runs them: no wrapper on the host); the
    launch counters are left as they were."""
    from transmogrifai_tpu_torch import cuda_build
    before = cuda_build.launches_snapshot()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    cuda_build.set_launches(before)
    return cuda_ms(g.replay, iters)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def count_ops(edges, rows: int) -> int:
    """The compares that counting `rows` values of every feature against
    its row of `edges` (d, n_edges) needs by K4's rule
    (csrc/edge_count.cuh), on these edges: ceil(log2(n_edges + 1)) a value
    of a non-decreasing feature (the binary search), n_edges a value of
    any other (the linear count)."""
    e = edges.float()
    n_edges = e.shape[1]
    mono = (e[:, :-1] <= e[:, 1:]).all(1)
    per = torch.where(mono, n_edges.bit_length(), n_edges)
    return rows * int(per.sum())


def in_turns(calls: dict, rounds: int = 8) -> dict:
    """{name: (median, least)} CUDA-event ms a call over `rounds` runs of
    each (fn, iters) in `calls`, the runs taken in turns, so that a shared
    host's noise falls on every name alike."""
    runs = {k: [] for k in calls}
    for _ in range(rounds):
        for k, (fn, iters) in calls.items():
            runs[k].append(cuda_ms(fn, iters))
    return {k: (statistics.median(v), min(v)) for k, v in runs.items()}


def k4_timing(pt, X, e, X1) -> dict:
    """K4 (f32 or f16 edges) on X: eager ms a call (at small n the
    wrapper's host work), `graph_ms` a CUDA-graph replay (the device time,
    as a served batch runs it) and `floor_ms` the eager call on the one
    row X1 (the ctypes floor), beside the bound, the plain version and
    `torch.searchsorted` on the widened edges. The eager, floor, plain and
    library times are each the median of eight runs taken in turns (50
    calls a run, the plain version 10), the least of the eight beside it
    as `*_least`."""
    n, d = X.shape
    n_edges = e.shape[1]
    nbytes = X.numel() * 4 + e.numel() * e.element_size() \
        + n * d * pt.bin_dtype(n_edges).itemsize
    b_ms, b_by = bound(nbytes, count_ops(e, n))
    ef, Xt = e.float().contiguous(), X.T.contiguous()
    t = in_turns({
        "floor_ms": (lambda: pt.bin_features(X1, e), 50),
        "ms": (lambda: pt.bin_features(X, e), 50),
        "library_ms": (lambda: torch.searchsorted(ef, Xt, right=True), 50),
        "plain_ms": (lambda: pt.bin_features_plain(X, e), 10)})
    rec = {k: v[0] for k, v in t.items()}
    rec.update({f"{k}_least": v[1] for k, v in t.items()})
    rec.update({"graph_ms": graph_ms(lambda: pt.bin_features(X, e), 50),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes})
    return rec


def launch_idiom_floor(pt, X1, e) -> dict:
    """K4's f32-edge entry point on the one row X1, launched straight
    through ctypes in the two ways the port's wrappers use: `entry` +
    `launch` (declared once, the raw current stream, no device context on
    the current device) and `load` + `declare` + a `torch.cuda.device`
    context + the current stream's handle (every call). Median and least
    ms a call of eight runs of 50 in turns; the output is allocated once,
    so the two differ only in the launch's host work. These launches
    bypass the wrapper and count nothing."""
    from transmogrifai_tpu_torch import cuda_build
    d, n_edges = e.shape
    out = X1.new_empty(X1.shape, dtype=pt.bin_dtype(n_edges))
    name = pt._BIN_ENTRIES[False, out.dtype]
    args = (X1.data_ptr(), e.data_ptr(), out.data_ptr(), 1, d, n_edges)
    idx = X1.get_device()

    def entry_launch():
        cuda_build.check(name, cuda_build.launch(
            idx, cuda_build.entry("bin_features", name), *args))

    def declare_device():  # the wrappers' idiom before `entry` + `launch`
        fn = cuda_build.declare(cuda_build.load("bin_features"), name,
                                pt._BIN_ARGS)
        with torch.cuda.device(X1.device):
            stream = ctypes.c_void_p(
                torch.cuda.current_stream(X1.device).cuda_stream)
            cuda_build.check(name, fn(*args, stream))
    entry_launch()
    if not torch.equal(out, pt.bin_features_plain(X1, e)):
        raise AssertionError("K4 launched through `cuda_build.launch` "
                             "disagrees with its plain version")
    t = in_turns({"entry_launch": (entry_launch, 50),
                  "declare_device": (declare_device, 50)})
    return {f"{k}_ms": v[0] for k, v in t.items()} | {
        f"{k}_ms_least": v[1] for k, v in t.items()}


def k8_timing(pdm, m, y, w, nb: int, from_margin: bool, iters: int,
              warmup: int = 3) -> dict:
    """K8 on P score rows m (P, n): CUDA-event ms, the bound, the plain
    version and `bincount` x 2 (the two histograms alone, no curve) as the
    yardstick; its blocks a pair (`aupr_row_blocks`), its error against
    the plain version and whether two runs give the same bits."""
    P, n = m.shape
    nbytes = 2 * P * n * 4 + n * 4 + P * 4
    b_ms, b_by = bound(nbytes, (10 if from_margin else 4) * P * n
                       + 8 * P * nb)
    cell = (pdm.score_bins(m, nb, from_margin).long()
            + torch.arange(P, device=m.device)[:, None] * nb).reshape(-1)
    wy, wf = (w * y).reshape(-1), w.reshape(-1)

    def library():
        torch.bincount(cell, weights=wy, minlength=P * nb)
        torch.bincount(cell, weights=wf, minlength=P * nb)
    got = pdm.binned_aupr(m, y, w, nb, from_margin)
    again = pdm.binned_aupr(m, y, w, nb, from_margin)
    want = pdm.binned_aupr_plain(m, y, w, nb, from_margin)
    rec = {"ms": cuda_ms(lambda: pdm.binned_aupr(m, y, w, nb, from_margin),
                         iters, warmup),
           "plain_ms": cuda_ms(lambda: pdm.binned_aupr_plain(
               m, y, w, nb, from_margin), max(iters // 5, 2), 1),
           "library_ms": cuda_ms(library, max(iters // 5, 2), 1),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "pairs": P, "rows": n, "buckets": nb,
           "blocks": pdm.aupr_row_blocks(P, n, nb)[0],
           "max_abs_err": max_err(got, want),
           "run_to_run_equal": torch.equal(got.view(torch.int32),
                                           again.view(torch.int32))}
    if rec["max_abs_err"] != 0.0 or not rec["run_to_run_equal"]:
        raise AssertionError(f"K8 disagrees with its plain version or "
                             f"between runs: {rec}")
    return rec


def leaf_designs_ms(pt, node, G, H, L, lam, iters: int, warmup: int = 3):
    """K3's leaf pass in each of its two designs on the same inputs,
    which must give the same bits: the scan design (no sort), the segment
    design (its `node_segments` included) and `node_segments` alone."""
    def run(regime):
        return pt._leaf_values_cuda(node, G, H, L, lam, 0.0, regime)
    if not torch.equal(run("scan"), run("segments")):
        raise AssertionError(f"K3's leaf designs differ (P={node.shape[0]}, "
                             f"n={node.shape[1]}, L={L})")
    return {"design": pt.leaf_regime(node.shape[1]),
            "scan_ms": cuda_ms(lambda: run("scan"), iters, warmup),
            "segments_ms": cuda_ms(lambda: run("segments"), iters, warmup),
            "node_segments_ms": cuda_ms(
                lambda: pt.node_segments(node, L), iters, warmup)}


def leaf_library_ms(node, G, H, L, iters: int, warmup: int = 3) -> float:
    """One `index_add_` per channel (the m values and the weights): the
    leaf sums by a library call."""
    P = node.shape[0]
    slot = (node.long() + torch.arange(P, device=node.device)[:, None]
            * L).reshape(-1)
    srcs = [G[:, j].reshape(-1) for j in range(G.shape[1])] + [H.reshape(-1)]

    def library():
        for src in srcs:
            torch.zeros(P * L, device=src.device).index_add_(0, slot, src)
    return cuda_ms(library, iters, warmup)


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


def hostile_edges(rng, d: int, n_edges: int) -> np.ndarray:
    """(d, n_edges) f32 edges of six kinds by feature (f % 6): sorted;
    shuffled; sorted with one NaN; sorted with runs of duplicates; sorted
    with -inf, +inf, -0.0 and +0.0 among them; one value repeated.
    K4 must count each exactly as the broadcast compare does."""
    e = np.sort(rng.normal(size=(d, n_edges)), axis=1).astype(np.float32)
    for f in range(d):
        kind = f % 6
        if kind == 1:
            e[f] = rng.permutation(e[f])
        elif kind == 2:
            e[f, rng.integers(0, n_edges)] = np.nan
        elif kind == 3:
            e[f] = np.sort(e[f, rng.integers(0, n_edges, n_edges)])
        elif kind == 4:
            k = min(4, n_edges)
            e[f, rng.choice(n_edges, k, replace=False)] = np.array(
                [-np.inf, np.inf, -0.0, 0.0], np.float32)[:k]
            e[f] = np.sort(e[f])
        elif kind == 5:
            e[f] = e[f, 0]
    return e


def hostile_values(rng, n: int, edges: np.ndarray) -> np.ndarray:
    """(n, d) f32 values for `edges`: normal, an eighth of the cells
    exactly on one of the feature's edges, and a thirty-second NaN, +-inf
    or +-0."""
    d, n_edges = edges.shape
    X = (rng.normal(size=(n, d)) * 1.5).astype(np.float32)
    k = max(1, n * d // 8)
    r, f = rng.integers(0, n, k), rng.integers(0, d, k)
    X[r, f] = edges[f, rng.integers(0, n_edges, k)]
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
    k //= 4
    X[rng.integers(0, n, k), rng.integers(0, d, k)] = \
        specials[rng.integers(0, 5, k)]
    return X


def walk_inputs(rng, n, d, n_trees, depth, m, bin_dtype):
    """(Xb, feat, bins, leaf) on the CPU: random tables of `depth` levels
    (width 2^depth), bins over 32 (int8 Xb) or 201 (int32 Xb) values and
    split bins up to n_bins (which never fire)."""
    width = 2 ** depth
    n_bins = 32 if bin_dtype == torch.int8 else 201
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d))).to(bin_dtype)
    feat = torch.from_numpy(
        rng.integers(0, d, (n_trees, depth, width)).astype(np.int32))
    bins = torch.from_numpy(
        rng.integers(0, n_bins + 1, (n_trees, depth, width)).astype(np.int32))
    leaf = torch.from_numpy(
        rng.normal(size=(n_trees, width, m)).astype(np.float32))
    return Xb, feat, bins, leaf


# the (row, tree) pairs a K5 chunk walks (csrc/tree_walk.cu: 256 threads,
# 4 trees each): a tile of R rows walks K5_CHUNK_PAIRS / R trees at once
K5_CHUNK_PAIRS = 1024


def walk_boundary_cases():
    """K5's boundaries as (R, n, T, m, bin dtype): for R rows a block
    (forced; the plan's own R where None), a chunk holds TC =
    K5_CHUNK_PAIRS / R trees; n around R and tree counts around TC, channel
    counts around a pass's 4 and two passes' 8, int8 and int32 Xb."""
    cases = []
    for R in (1, 8, 64):
        TC = K5_CHUNK_PAIRS // R
        for n in sorted({max(R - 1, 1), R, R + 1, 891}):
            for T in sorted({1, max(TC - 1, 1), TC, TC + 1, 200}):
                cases.append((R, n, T, 1, torch.int8))
        for m in (2, 4, 5, 8, 9, 11):
            cases.append((R, R + 1, TC + 1, m, torch.int8))
        cases.append((R, 891, 200, 2, torch.int32))
    return cases + [(None, n, 200, 1, torch.int8)
                    for n in (1, 64, 891, 65536)]


# K5's plan at the main path's shapes: (n, trees, d, Xb bytes, columns, m)
K5_PLAN_SHAPES = {"titanic_n1": (1, 200, 496, 1, 1, 1),
                  "titanic_n64": (64, 200, 496, 1, 1, 1),
                  "titanic_n891": (891, 200, 496, 1, 1, 1),
                  "titanic_n65536": (65536, 200, 496, 1, 1, 1),
                  "out_of_core": (4_456_448, 16, 500, 1, 2, 2)}


def walk_boundary_check(pt, rng, dev, narrow: bool) -> dict:
    """K5 (int32 tables, or K5-narrow's int16 / uint8) at every case of
    `walk_boundary_cases`, a level of split bins of n_bins (never fire)
    in each: equal to the plain version. Also the kernel's plan: a forced
    R walks K5_CHUNK_PAIRS / R trees a chunk, and (R, staged) at
    `K5_PLAN_SHAPES`."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for R in (1, 2, 4, 8, 16, 32, 64):
        plan = pt.walk_plan(1, 1, 37, 1, 1, 1, sms, rows=R)
        if plan[0] != R or plan[2] * R != K5_CHUNK_PAIRS:
            raise AssertionError(f"K5's plan at rows={R}: {plan}")
    plans = {k: list(pt.walk_plan(*v, sms)[:2])
             for k, v in K5_PLAN_SHAPES.items()}
    for R, n, T, m, dt in walk_boundary_cases():
        Xb, feat, bins, leaf = (t.to(dev) for t in walk_inputs(
            rng, n, 37, T, 5, m, dt))
        bins[:, 2] = 32 if dt == torch.int8 else 201
        if narrow:
            feat, bins = feat.to(torch.int16), bins.to(torch.uint8)
        got = pt._tree_walk_cuda(Xb, feat, bins, leaf, rows=R)
        if not torch.equal(got, pt.tree_walk_plain(Xb, feat, bins, leaf)):
            raise AssertionError(f"K5{'-narrow' if narrow else ''} "
                                 f"disagrees at R={R} n={n} T={T} m={m} "
                                 f"{dt}")
    return {"cases": len(walk_boundary_cases()), "equal": True,
            "plans": plans}


def k5mc_boundary_check(pt, rng, dev) -> dict:
    """K5-mc at K = 3 and 12 classes, R in {plan, 1, 4, 64} rows a block,
    n in {1, 63, 64, 65, 891}: rounds that a chunk of 1024 flat trees cuts
    apart; equal to the plain version."""
    count = 0
    for K, T in ((3, 171), (12, 45)):
        width = 2 ** 6
        tables = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(0, 9, (T, K, 6, width)).astype(np.int32),
            rng.integers(0, 34, (T, K, 6, width)).astype(np.int32),
            rng.normal(size=(T, K, width, 1)).astype(np.float32))]
        for R in (None, 1, 4, 64):
            for n in (1, 63, 64, 65, 891):
                Xb = torch.from_numpy(rng.integers(0, 33, (n, 9)).astype(
                    np.int8)).to(dev)
                got = pt._tree_walk_classes_cuda(Xb, *tables, rows=R)
                if not torch.equal(got, pt.tree_walk_classes_plain(
                        Xb, *tables)):
                    raise AssertionError(f"K5-mc disagrees at K={K} R={R} "
                                         f"n={n}")
                count += 1
    return {"cases": count, "equal": True}


# K12's hostile cases, (d, r0, n_edges, misaligned chunk): d odd, d % 8 !=
# 0, d < 8 (a group spans several rows), r0 with r0 * d not a multiple of 8
# (the scalar path), 126 edges at d = 500 (127 staged rows), a chunk one
# element past an aligned address (scalar path); 1100 and 2100 features
# span many of K12's 256-feature windows
K12_HOSTILE_CASES = ((500, 8, 31, False), (500, 41, 31, False),
                     (501, 16, 31, False), (7, 8, 31, False),
                     (12, 2, 15, False), (500, 8, 126, False),
                     (12, 8, 126, False), (500, 8, 31, True),
                     (1, 3, 31, False), (1100, 8, 31, False),
                     (2100, 8, 31, False))
# (d, r0, misaligned view) at 8 and 4 bits; 1100 to 2101 features span
# many windows, 2101 is odd (4 bits: the scalar path)
K12_DEQUANT_CASES = ((500, 8, False), (501, 16, False), (12, 2, False),
                     (7, 41, False), (500, 8, True), (1100, 8, False),
                     (2100, 8, False), (2101, 8, False))


def misaligned(t):
    """A contiguous copy of `t` that starts one element past an aligned
    address."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def writes_equal(n, d, dev, entries) -> None:
    """Each (name, buffer dtypes, kernel call, plain call) on buffers of n
    rows prefilled with a sentinel: bit-equal buffers, or raise."""
    for name, dtypes, kernel, plain in entries:
        got = [torch.full((n, d), 3, dtype=dt, device=dev) for dt in dtypes]
        want = [b.clone() for b in got]
        kernel(*got)
        plain(*want)
        if not all(bits_equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(n={n}, d={d})")


def k12_hostile_check(pbd, dev) -> dict:
    """K12's four entries on `hostile_edges` (f16-exact, so values fall on
    them) and `hostile_values` at every `K12_HOSTILE_CASES` case: bit-equal
    to their plain versions, rows outside the chunk untouched."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for d, r0, n_edges, view in K12_HOSTILE_CASES:
        rng = np.random.default_rng(d * 1000 + r0 + n_edges)
        e = hostile_edges(rng, d, n_edges).astype(np.float16).astype(
            np.float32)
        chunk = torch.from_numpy(hostile_values(rng, 3000, e).astype(
            np.float16)).to(dev)
        if view:
            chunk = misaligned(chunk)
        edges = torch.from_numpy(e).to(dev)
        writes_equal(3100, d, dev, [
            ("write_cast_rows bf16", (bf,),
             lambda b: pbd.write_cast_rows(b, chunk, r0),
             lambda b: pbd.write_cast_rows_plain(b, chunk, r0)),
            ("write_cast_rows f32", (f32,),
             lambda b: pbd.write_cast_rows(b, chunk, r0),
             lambda b: pbd.write_cast_rows_plain(b, chunk, r0)),
            ("bin_write_rows", (i8,),
             lambda b: pbd.bin_write_rows(b, chunk, edges, r0),
             lambda b: pbd.bin_write_rows_plain(b, chunk, edges, r0)),
            ("dual_write_rows", (bf, i8),
             lambda a, b: pbd.dual_write_rows(a, b, chunk, edges, r0),
             lambda a, b: pbd.dual_write_rows_plain(a, b, chunk, edges,
                                                    r0))])
    return {"cases": len(K12_HOSTILE_CASES), "tolerance": "bit-equal"}


def k12_dequant_hostile_check(pbd, dev) -> dict:
    """Every K12-dequant entry at 8 and 4 bits at every
    `K12_DEQUANT_CASES` case: hostile edges (a sorted feature in six with
    a dequantized value on one of its edges), codes over the whole range;
    bit-equal to the plain versions."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for bits in (8, 4):
        for d, r0, view in K12_DEQUANT_CASES:
            rng = np.random.default_rng(bits * 7 + d + r0)
            c = 3000
            q = rng.integers(0, 1 << bits, (c, d)).astype(np.uint8)
            scale = rng.uniform(0.01, 2.0, d).astype(np.float32)
            lo = (rng.normal(size=d) * 4.0).astype(np.float32)
            x = (q * scale.astype(np.float64) + lo).astype(np.float32)
            e = hostile_edges(rng, d, 31)
            e[0::6, 5] = x[3, 0::6]
            e[0::6] = np.sort(e[0::6], axis=1)
            if bits == 4:
                p = np.concatenate([q, np.zeros((c, d % 2), np.uint8)], 1)
                q = (p[:, 0::2] | (p[:, 1::2] << 4)).astype(np.uint8)
            q, scale, lo, edges = (torch.from_numpy(a).to(dev)
                                   for a in (q, scale, lo, e))
            if view:
                q = misaligned(q)
            writes_equal(c + 100, d, dev, [
                ("dequant_write_rows bf16", (bf,),
                 lambda b: pbd.dequant_write_rows(b, q, scale, lo, r0, bits),
                 lambda b: pbd.dequant_write_rows_plain(b, q, scale, lo, r0,
                                                        bits)),
                ("dequant_write_rows f32", (f32,),
                 lambda b: pbd.dequant_write_rows(b, q, scale, lo, r0, bits),
                 lambda b: pbd.dequant_write_rows_plain(b, q, scale, lo, r0,
                                                        bits)),
                ("dequant_bin_write_rows", (i8,),
                 lambda b: pbd.dequant_bin_write_rows(b, q, scale, lo, edges,
                                                      r0, bits),
                 lambda b: pbd.dequant_bin_write_rows_plain(
                     b, q, scale, lo, edges, r0, bits)),
                ("dequant_dual_write_rows", (bf, i8),
                 lambda a, b: pbd.dequant_dual_write_rows(
                     a, b, q, scale, lo, edges, r0, bits),
                 lambda a, b: pbd.dequant_dual_write_rows_plain(
                     a, b, q, scale, lo, edges, r0, bits))])
    return {"cases": 2 * len(K12_DEQUANT_CASES), "tolerance": "bit-equal"}


def k5_timing(pt, Xb, feat, bins, leaf, m_ops=None) -> dict:
    """K5 (or K5-narrow) on Xb: at n <= 891 the eager call and the plain
    version as medians of eight runs in turns (`in_turns`, 50 and 5 calls
    a run; `*_least` the least) and `graph_ms`, a CUDA-graph replay (as a
    served batch runs it); above, CUDA-event means. Beside the bound of
    the bytes the walk reads (`walk_bytes`) and its compares."""
    args = (Xb, feat, bins, leaf)
    n = Xb.shape[0]
    T_, depth, _ = feat.shape
    m = leaf.shape[-1]
    nbytes = walk_bytes(*args)
    b_ms, b_by = bound(nbytes, n * T_ * (2 * depth + (m_ops or m)))
    rec = {"library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes}
    if n <= 891:
        t = in_turns({"ms": (lambda: pt.tree_walk(*args), 50),
                      "plain_ms": (lambda: pt.tree_walk_plain(*args), 5)})
        rec.update({k: v[0] for k, v in t.items()})
        rec.update({f"{k}_least": v[1] for k, v in t.items()})
        rec["graph_ms"] = graph_ms(lambda: pt.tree_walk(*args), 50)
    else:
        rec.update({"ms": cuda_ms(lambda: pt.tree_walk(*args), 20),
                    "plain_ms": cuda_ms(lambda: pt.tree_walk_plain(*args),
                                        3)})
    return rec


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


# --------------------------------------------------------------------------- #
# training kernels                                                            #
# --------------------------------------------------------------------------- #

FIT_P, FIT_N, FIT_D, FIT_BINS = 6, 802, 496, 32
FIT_LEVELS = (0, 5, 9)


def occupancy(node, n_nodes: int):
    """(P, n_nodes) uint8 flags of the nodes that hold a row: the live set
    K3's routing writes for the next level's split search."""
    occ = torch.zeros((node.shape[0], n_nodes), dtype=torch.uint8,
                      device=node.device)
    return occ.scatter_(1, node.long(), 1)


def k2_cells(P, m, nodes, d, n_bins, live=None, fmask=None) -> int:
    """The histogram cells K2 must read: of every node (dense) or of the
    live ones, and of each pair's features in its mask (feature 0's
    weights also when it is masked: they give the node's total)."""
    per_pair = torch.full((P,), nodes, dtype=torch.float64) if live is None \
        else live.sum(1).double().cpu()
    if fmask is None:
        feats = torch.full((P,), float(d * (m + 1)), dtype=torch.float64)
    else:
        fm = fmask.bool().cpu()
        feats = fm.sum(1).double() * (m + 1) + (~fm[:, 0]).double()
    return int((per_pair * feats).sum()) * n_bins


def k2_bytes(P, m, nodes, d, n_bins, live=None, fmask=None) -> int:
    """K2's least traffic: its cells (`k2_cells`) read once, the two
    tables written once, the flags of a live set and a mask read once."""
    return k2_cells(P, m, nodes, d, n_bins, live, fmask) * 4 \
        + 2 * P * nodes * 4 + (0 if live is None else P * nodes) \
        + (0 if fmask is None else P * d)


def device_kw(kw, P, dev):
    """Split-search keywords with each hyperparameter a (P,) tensor on the
    card, as the learners pass them (a Python value becomes a tensor by a
    host copy that waits for the card, once a tree in the learners)."""
    from transmogrifai_tpu_torch.models.base import per_pair
    out = dict(kw)
    for k in ("reg_lambda", "min_child_weight", "min_gain", "min_gain_norm"):
        out[k] = per_pair(kw[k], P, dev)
    if kw.get("active_depth") is not None:
        out["active_depth"] = per_pair(kw["active_depth"], P, dev,
                                       torch.int32)
    return out


def k2_timing(pt, hg, hh, n_bins, kw, live, iters, plain_iters=3):
    """K2 dense (every node) and over the live set, with the keywords as
    the learners pass them (`device_kw`): CUDA-event ms, the plain
    version, and each beside its bound (dense bytes, live-cell bytes)."""
    P, m, nodes, d, _ = hg.shape
    kw = device_kw(kw, P, hg.device)
    live_nodes = int(live.sum())
    fm = kw.get("feature_mask")
    dense_b = k2_bytes(P, m, nodes, d, n_bins, None, fm)
    live_b = k2_bytes(P, m, nodes, d, n_bins, live, fm)
    # 12 operations a cell scanned (two running sums, the gain, the test)
    d_ms, d_by = bound(dense_b, 12 * k2_cells(P, m, nodes, d, n_bins, None,
                                              fm))
    l_ms, l_by = bound(live_b, 12 * k2_cells(P, m, nodes, d, n_bins, live,
                                             fm))
    return {"dense_ms": cuda_ms(lambda: pt.split_search(hg, hh, n_bins, **kw),
                                iters),
            "ms": cuda_ms(lambda: pt.split_search(hg, hh, n_bins, live=live,
                                                  **kw), iters),
            "plain_ms": cuda_ms(lambda: pt.split_search_plain(
                hg, hh, n_bins, **kw), plain_iters, warmup=1),
            "library_ms": None, "bound_ms": l_ms, "bound_by": l_by,
            "bytes": live_b, "dense_bound_ms": d_ms, "dense_bound_by": d_by,
            "dense_bytes": dense_b, "live_nodes": live_nodes,
            "nodes": P * nodes}


def k3_route_timing(pt, Xb, node, f, b, iters, plain_iters=10):
    """K3's routing as the learner calls it (out of place into a buffer it
    keeps, flags written):
    eager CUDA-event ms a call (at small shapes the wrapper's host work)
    and `graph_ms` a CUDA-graph replay (the device time), beside the
    bound (node ids read and written once, the rows' cells of Xb the
    routing reads once, the tables read and the flags set once) and the
    plain version. The eager time is the median of eight runs of `iters`
    calls (`in_turns`), the least beside it."""
    P, n = node.shape
    nodes = f.shape[1]
    occ = torch.zeros((P, 2 * nodes), dtype=torch.uint8, device=node.device)
    d = Xb.shape[1]
    cells = int(torch.unique(
        torch.arange(n, device=Xb.device)[None] * d
        + torch.gather(f.long(), 1, node.long())).numel())
    children = int(occupancy(pt.route_level(Xb, node, f, b), 2 * nodes)
                   .sum())
    nbytes = 2 * P * n * 4 + cells * Xb.element_size() + 2 * P * nodes * 4 \
        + children
    b_ms, b_by = bound(nbytes, 3 * P * n)
    out = torch.empty_like(node)
    eager = in_turns({"ms": (lambda: pt.route_level(
        Xb, node, f, b, occupied=occ, out=out), iters)})["ms"]
    return {"ms": eager[0], "ms_least": eager[1],
            "graph_ms": graph_ms(lambda: pt.route_level(
                Xb, node, f, b, occupied=occ, out=out), iters),
            "plain_ms": cuda_ms(lambda: pt.route_level_plain(
                Xb, node, f, b, occupied=occ), plain_iters),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes}


def fit_inputs(rng, n: int, level: int, dev):
    """Binned rows (n, 496) int8 with a duplicate column, node ids (6, n)
    over the level's 2^level nodes, G and H (6, n)."""
    Xb = rng.integers(0, FIT_BINS, (n, FIT_D)).astype(np.int8)
    Xb[:, 7] = Xb[:, 3]
    node = rng.integers(0, 2 ** level, (FIT_P, n)).astype(np.int32)
    G = rng.normal(size=(FIT_P, 1, n)).astype(np.float32)  # m = 1
    H = rng.uniform(0.05, 1.0, (FIT_P, n)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (Xb, node, G, H)]


SPLIT_KW = dict(reg_lambda=1.0, min_child_weight=[1.0, 10.0] * 3,
                min_gain=0.8, min_gain_norm=0.0, feature_mask=None,
                active_depth=[10] * FIT_P)


def check_training_kernels(pt, pdm, rng, dev):
    """Each training kernel against its plain version; returns the phase's
    record and the inputs for the timings."""
    worst = {"histograms": 0.0, "split_search": 0, "split_search_live": 0,
             "route_level": 0, "leaf_values": 0.0, "binned_aupr": 0.0}
    cases = {}
    for n in (FIT_N, 65536):
        for level in FIT_LEVELS:
            Xb, node, G, H = fit_inputs(rng, n, level, dev)
            n_nodes = 2 ** level
            hg, hh = pt.histograms(Xb, node, G, H, n_nodes, FIT_BINS)
            hg2, hh2 = pt.histograms(Xb, node, G, H, n_nodes, FIT_BINS)
            wg, wh = pt.histograms_plain(Xb, node, G, H, n_nodes, FIT_BINS)
            torch.cuda.synchronize()
            if not (torch.equal(hg, hg2) and torch.equal(hh, hh2)):
                raise AssertionError(f"K1 differs run to run (n={n}, "
                                     f"level {level})")
            err = max(float((hg - wg).abs().max()),
                      float((hh - wh).abs().max()))
            worst["histograms"] = max(worst["histograms"], err)
            # two f32 summation orders of m values each stay within
            # (m - 1) * 2^-24 * sum|v| of the exact sum (m: rows of the node)
            m = int(torch.bincount(node.reshape(-1).long()).max())
            mags = pt.histograms_plain(Xb, node, G.abs(), H.abs(), n_nodes,
                                       FIT_BINS)
            for got, want, mag in zip((hg, hh), (wg, wh), mags):
                tol = 2 * max(m - 1, 1) * 2.0 ** -24 * mag
                if bool(((got - want).abs() > tol).any()):
                    raise AssertionError(f"K1 disagrees beyond the f32 "
                                         f"summation bound (n={n}, level "
                                         f"{level})")
            del wg, wh, hg2, hh2, mags, tol
            f, b = pt.split_search(hg, hh, FIT_BINS, level=level, **SPLIT_KW)
            wf, wb = pt.split_search_plain(hg, hh, FIT_BINS, level=level,
                                           **SPLIT_KW)
            diff = int((f != wf).sum() + (b != wb).sum())
            worst["split_search"] = max(worst["split_search"], diff)
            if diff:
                raise AssertionError(f"K2 disagrees (n={n}, level {level})")
            # the live set: the nodes that hold rows
            live = occupancy(node, n_nodes)
            lf, lb = pt.split_search(hg, hh, FIT_BINS, level=level,
                                     live=live, **SPLIT_KW)
            diff = int((lf != wf).sum() + (lb != wb).sum())
            worst["split_search_live"] = max(worst["split_search_live"],
                                             diff)
            if diff:
                raise AssertionError(f"K2 over the live set disagrees "
                                     f"(n={n}, level {level})")
            occ = torch.zeros((FIT_P, 2 * n_nodes), dtype=torch.uint8,
                              device=dev)
            wocc = torch.zeros_like(occ)
            out = pt.route_level(Xb, node, f, b, occupied=occ)
            diff = int((out != pt.route_level_plain(
                Xb, node, f, b, occupied=wocc)).sum()
                + (occ != wocc).sum())
            worst["route_level"] = max(worst["route_level"], diff)
            if diff:
                raise AssertionError(f"K3 route disagrees (n={n}, level "
                                     f"{level})")
            leaf = pt.leaf_values(out, G, H, 2 * n_nodes, 1.0, 0.0)
            cpu = pt.leaf_values_plain(out.cpu(), G.cpu(), H.cpu(),
                                       2 * n_nodes, 1.0, 0.0)
            card = pt.leaf_values_plain(out, G, H, 2 * n_nodes, 1.0, 0.0)
            if not torch.equal(leaf.cpu(), cpu):
                raise AssertionError(f"K3 leaves differ from row-order sums "
                                     f"(n={n}, level {level})")
            err = float((leaf - card).abs().max())
            worst["leaf_values"] = max(worst["leaf_values"], err)
            torch.testing.assert_close(leaf, card, rtol=0, atol=1e-6)
            cases[(n, level)] = (Xb, node, G, H, hg, hh, f, b, out, live)
    for n in (FIT_N, 65536):
        m = torch.from_numpy((rng.normal(size=(FIT_P, n)) * 2)
                             .astype(np.float32)).to(dev)
        y = torch.from_numpy((rng.random(n) < 0.38)
                             .astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.random((FIT_P, n)) < 0.33)
                             .astype(np.float32)).to(dev)
        for n_bins, from_margin in ((512, True), (4096, False)):
            s = m if from_margin else torch.sigmoid(m)
            got = pdm.binned_aupr(s, y, w, n_bins, from_margin)
            want = pdm.binned_aupr_plain(s, y, w, n_bins, from_margin)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["binned_aupr"] = max(worst["binned_aupr"], err)
            if not torch.equal(got, want):
                raise AssertionError(f"K8 disagrees (n={n}, {n_bins} "
                                     "buckets)")
        cases[("aupr", n)] = (m, y, w)
    record = {"phase": "training_kernel_check", "pairs": FIT_P,
              "rows": [FIT_N, 65536], "d": FIT_D, "bins": FIT_BINS,
              "levels": list(FIT_LEVELS), "max_abs_err": worst,
              "tolerance": {"histograms": "per cell 2(m-1) 2^-24 sum|v| "
                            "(m: the node's rows); bit-equal run to run",
                            "split_search": "equal",
                            "split_search_live": "equal",
                            "route_level": "equal (node ids and flags)",
                            "leaf_values": "bit-equal to row-order sums; "
                            "atol 1e-6 to index_add_",
                            "binned_aupr": "equal"}}
    return record, cases


def time_training_kernels(pt, pdm, cases):
    """CUDA-event times of each training kernel at the training path's
    shapes and at n = 65536, beside its bound, plain version and one-call
    yardstick."""
    out = {}
    for (key, val) in cases.items():
        if key[0] == "aupr":
            continue
        n, level = key
        Xb, node, G, H, hg, hh, f, b, routed, live = val
        P, d, B = FIT_P, FIT_D, FIT_BINS
        n_nodes = 2 ** level
        k1_bytes = n * d + 2 * P * n * 4 + P * n * 4 \
            + 2 * P * n_nodes * d * B * 4
        k1_bound, k1_by = bound(k1_bytes, 2 * P * n * d)
        cell = (((node.long() + torch.arange(P, device=node.device)[:, None]
                  * n_nodes)[:, :, None] * d
                 + torch.arange(d, device=node.device)) * B
                + Xb.long()[None]).reshape(-1)
        srcg = G[:, 0, :, None].expand(P, n, d).reshape(-1)
        srch = H[:, :, None].expand(P, n, d).reshape(-1)
        size = P * n_nodes * d * B

        def library():
            torch.zeros(size, device=G.device).index_add_(0, cell, srcg)
            torch.zeros(size, device=G.device).index_add_(0, cell, srch)
        k1 = {"ms": cuda_ms(lambda: pt.histograms(Xb, node, G, H, n_nodes,
                                                  B), 20),
              "segments_ms": cuda_ms(lambda: pt.node_segments(node, n_nodes),
                                     20),
              "plain_ms": cuda_ms(lambda: pt.histograms_plain(
                  Xb, node, G, H, n_nodes, B), 3),
              "library_ms": cuda_ms(library, 5),
              "bound_ms": k1_bound, "bound_by": k1_by, "bytes": k1_bytes,
              "scratch_bytes": pt.hist_scratch_bytes(P, n, n_nodes, 1, d, B)}
        del cell, srcg, srch
        k2 = k2_timing(pt, hg, hh, B, dict(level=level, **SPLIT_KW), live,
                       20)
        k3r = k3_route_timing(pt, Xb, node, f, b, 50)
        L = 2 * n_nodes
        k3l_bytes = 3 * P * n * 4 + P * (L + 1) * 4 + P * L * 4
        k3l_bound, k3l_by = bound(k3l_bytes, 2 * P * n + 5 * P * L)
        k3l = {"ms": cuda_ms(lambda: pt.leaf_values(routed, G, H, L, 1.0,
                                                    0.0), 50),
               "plain_ms": cuda_ms(lambda: pt.leaf_values_plain(
                   routed, G, H, L, 1.0, 0.0), 10),
               "library_ms": leaf_library_ms(routed, G, H, L, 50),
               "bound_ms": k3l_bound, "bound_by": k3l_by,
               "bytes": k3l_bytes,
               **leaf_designs_ms(pt, routed, G, H, L, 1.0, 50)}
        out[f"n{n}_level{level}"] = {
            "histograms": k1, "split_search": k2, "route_level": k3r,
            "leaf_values": k3l}
        emit({"phase": "training_timing", "n": n, "level": level,
              **out[f"n{n}_level{level}"]})
    for n in (FIT_N, 65536):
        m, y, w = cases[("aupr", n)]
        nb = 512
        k8 = k8_timing(pdm, m, y, w, nb, True, 50)
        k8["graph_ms"] = graph_ms(lambda: pdm.binned_aupr(m, y, w, nb, True),
                                  50)
        out[f"n{n}_aupr512"] = {"binned_aupr": k8}
        emit({"phase": "training_timing", "n": n, "buckets": nb,
              "binned_aupr": k8})
    return out


# --------------------------------------------------------------------------- #
# K1's pieces and few-row nodes, K3's two leaf designs: skewed cases          #
# --------------------------------------------------------------------------- #

SKEW_ROWS = (1 << 20) + 12345   # one node cut into 32+ pieces of R rows
# K3's leaf pass in both designs across rows a pair, at the pairs and
# leaves of the out-of-core, XGB and forest shapes; LEAF_SCAN_MAX_ROWS in
# models/trees.py is chosen from these
LEAF_SWEEP = ((16, 64), (6, 1024), (54, 4096))
LEAF_SWEEP_ROWS = (802, 2048, 4096, 16384, 65536, 262144)


def skew_inputs(rng, P, n, d, n_nodes, dev, skew, left_out, dropped):
    """Binned rows with bin ids outside [0, 32) at rate `dropped`, node
    ids with node 0 taking the share `skew` and rows left out (id n_nodes)
    at rate `left_out`, and class-count values (integer sums)."""
    Xb = rng.integers(0, 32, (n, d))
    bad = rng.random((n, d)) < dropped
    Xb[bad] = rng.choice(np.array([-2, -1, 32, 33, 100]), int(bad.sum()))
    node = np.where(rng.random((P, n)) < skew, 0,
                    rng.integers(0, n_nodes, (P, n)))
    node = np.where(rng.random((P, n)) < left_out, n_nodes, node)
    H = rng.poisson(1.0, (P, n)).astype(np.float32)
    G = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)].T[None] \
        * H[:, None, :]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        Xb.astype(np.int8), node.astype(np.int32), G, H)]


def plain_dropping(pt, Xb, node, G, H, n_nodes, n_bins):
    """`histograms_plain` with K1's rule for bin ids outside [0, n_bins):
    dropped (they go to a spare bin that is cut off)."""
    spare = torch.where((Xb.long() < 0) | (Xb.long() >= n_bins),
                        torch.full_like(Xb.long(), n_bins), Xb.long())
    hg, hh = pt.histograms_plain(spare, node, G, H, n_nodes, n_bins + 1)
    return hg[..., :n_bins], hh[..., :n_bins]


def skew_check(pt, rng, dev):
    """K1 on one node of SKEW_ROWS rows (most rows in node 0 of 3, so cut
    into 32+ pieces, rows left out and bin ids dropped across the piece
    edges) and on 2048 mostly-empty nodes: equal to the plain version on
    class counts and bit-equal run to run. K3's leaf pass at
    LEAF_SCAN_MAX_ROWS ± 1 rows, both designs and the wrapper's choice,
    for skewed leaves with every odd leaf empty and for one leaf holding
    every row: bit-equal to the CPU's row-order sums."""
    cases = {}
    for name, (P, n, d, n_nodes, skew) in {
            "pieces": (2, SKEW_ROWS, 500, 3, 0.9),
            "empty_nodes": (16, 1500, 496, 2048, 0.0)}.items():
        Xb, node, G, H = skew_inputs(rng, P, n, d, n_nodes, dev, skew, 0.1,
                                     0.01)
        hg, hh = pt.histograms(Xb, node, G, H, n_nodes, FIT_BINS)
        hg2, hh2 = pt.histograms(Xb, node, G, H, n_nodes, FIT_BINS)
        wg, wh = plain_dropping(pt, Xb, node, G, H, n_nodes, FIT_BINS)
        torch.cuda.synchronize()
        if not (torch.equal(hg, hg2) and torch.equal(hh, hh2)):
            raise AssertionError(f"K1 differs run to run ({name})")
        err = max(float((hg - wg).abs().max()), float((hh - wh).abs().max()))
        if err != 0.0:
            raise AssertionError(f"K1 disagrees with its plain version "
                                 f"({name}): {err}")
        counts = torch.bincount(node[0].long(), minlength=n_nodes + 1)
        cases[name] = {"pairs": P, "rows": n, "d": d, "nodes": n_nodes,
                       "largest_node_rows": int(counts[:n_nodes].max()),
                       "empty_nodes": int((counts[:n_nodes] == 0).sum()),
                       "pieces_bound": pt.hist_plan_bounds(n, n_nodes)[0],
                       "max_abs_err": err}
        del Xb, node, G, H, hg, hh, hg2, hh2, wg, wh
    t = pt.LEAF_SCAN_MAX_ROWS
    for n in (t - 1, t, t + 1):
        for one_leaf in (False, True):
            P, L = 3, 64
            node = (np.full((P, n), L - 1) if one_leaf else np.minimum(
                rng.geometric(0.05, (P, n)) - 1, L // 2 - 1) * 2)
            node = torch.from_numpy(node.astype(np.int32))
            G = torch.from_numpy(rng.normal(size=(P, 2, n)).astype(np.float32))
            H = torch.from_numpy(rng.uniform(0.05, 1, (P, n))
                                 .astype(np.float32))
            want = pt.leaf_values_plain(node, G, H, L, [1.0, 0.5, 2.0], 0.1)
            nc, Gc, Hc = node.to(dev), G.to(dev), H.to(dev)
            for regime in ("scan", "segments", None):
                got = pt._leaf_values_cuda(nc, Gc, Hc, L, [1.0, 0.5, 2.0],
                                           0.1, regime)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"K3 leaves ({regime}, n={n}, one "
                                         f"leaf {one_leaf}) differ from "
                                         f"row-order sums")
    cases["leaf_threshold"] = {"rows": [t - 1, t, t + 1],
                               "designs": ["scan", "segments", "wrapper"],
                               "equal": True}
    record = {"phase": "skew_kernel_check", "cases": cases,
              "piece_rows": pt.HIST_PIECE_ROWS,
              "few_rows": pt.HIST_FEW_ROWS,
              "tolerance": "K1 equal (class counts) and bit-equal run to "
                           "run; K3 leaves bit-equal to row-order sums"}
    emit(record)
    return record


def leaf_regime_timings(pt, rng, dev):
    """K3's leaf pass in both designs across LEAF_SWEEP_ROWS rows a pair
    (`leaf_designs_ms`, which also holds them to the same bits)."""
    rows = []
    for P, L in LEAF_SWEEP:
        for n in LEAF_SWEEP_ROWS:
            node = torch.from_numpy(rng.integers(0, L, (P, n))
                                    .astype(np.int32)).to(dev)
            G = torch.from_numpy(rng.normal(size=(P, 2, n))
                                 .astype(np.float32)).to(dev)
            H = torch.from_numpy(rng.uniform(0.05, 1, (P, n))
                                 .astype(np.float32)).to(dev)
            rows.append({"pairs": P, "leaves": L, "rows": n,
                         **leaf_designs_ms(pt, node, G, H, L, 1.0, 10)})
    record = {"phase": "leaf_regime_timing",
              "scan_max_rows": pt.LEAF_SCAN_MAX_ROWS, "cases": rows}
    emit(record)
    return record


# --------------------------------------------------------------------------- #
# forest kernels at level 11 of the depth-12 bucket                           #
# --------------------------------------------------------------------------- #

RF_DEPTH, RF_TREES_BUCKET, RF_M = 12, 900, 2
RF_PLAIN_PAIRS = 4  # pairs held to the plain versions one by one


def forest_level11_inputs(pt, rng, dev):
    """A chunk of the depth-12 bucket's trees as `fit_forest` sizes
    it (900 trees: 6 configs x 3 folds x 50), grown by the port to depth
    11 on a seeded 802 x 496 binned matrix with Titanic-like labels, fold
    weights and Poisson bootstraps: the level-11 node ids of real trees
    (most of the 2048 nodes empty), and the values of 2 class channels."""
    n, d = FIT_N, FIT_D
    Pc, budget, per_tree = pt.forest_chunk(RF_TREES_BUCKET, RF_DEPTH, RF_M,
                                           n, d, FIT_BINS, dev)
    Xb = torch.from_numpy(rng.integers(0, FIT_BINS, (n, d))
                          .astype(np.int8)).to(dev)
    y = ((Xb[:, 0].float() + Xb[:, 1].float()
          + torch.from_numpy(rng.normal(size=n) * 8).float().to(dev))
         > 38).long()
    Y = torch.nn.functional.one_hot(y, 2).float()
    fold = torch.from_numpy(rng.integers(0, 3, n)).to(dev)
    w = (fold[None, :] != torch.arange(Pc, device=dev)[:, None] % 3).float()
    boot, fmask = pt.forest_draws(Pc, n, d, seed=11, device=dev)
    H = (boot * w).contiguous()
    G = (Y.T[None] * H[:, None, :]).contiguous()
    mcw = torch.tensor([10.0, 100.0] * (Pc // 2) + [10.0] * (Pc % 2),
                       device=dev)
    _, node11 = pt.grow_trees(Xb, G, H, 11, FIT_BINS, reg_lambda=1e-6,
                              min_child_weight=mcw, feature_mask=fmask,
                              min_gain_norm=0.001)
    torch.cuda.synchronize()
    plan = {"pairs": Pc, "budget_bytes": budget, "bytes_per_tree": per_tree,
            "live_nodes_level11": float(
                (torch.nn.functional.one_hot(node11.long(), 2048).sum(1) > 0)
                .sum(1).float().mean())}
    return Xb, G, H, fmask, mcw, node11, plan


def check_forest_kernels(pt, rng, dev):
    """K1 (m = 2, the rows routed right grouped by their level-10 parent),
    K1-sub (level 10 -> 11), K2 (m = 2) at level 11, K3 routing and K3
    leaves (m = 2, 4096 leaves) on one chunk of the depth-12 bucket; the
    kernels run on the whole chunk, the plain versions on its first pairs
    one by one (the plain K1-sub and K2 of the whole chunk would not fit
    beside it). Forest values are small integers, so every histogram sum
    is exact and kernel and plain version agree bit for bit."""
    Xb, G, H, fmask, mcw, node11, plan = forest_level11_inputs(pt, rng, dev)
    Pc = plan["pairs"]
    parent = torch.where((node11 & 1).bool(), node11 >> 1,
                         torch.full_like(node11, 1024))
    hg_r, hh_r = pt.histograms(Xb, parent, G, H, 1024, FIT_BINS)
    hg10, hh10 = pt.histograms(Xb, node11 >> 1, G, H, 1024, FIT_BINS)
    cg, ch = pt.sibling_subtract(hg10, hh10, hg_r, hh_r)
    kw = dict(reg_lambda=1e-6, min_child_weight=mcw, min_gain=0.0,
              min_gain_norm=0.001, feature_mask=fmask, level=11,
              active_depth=RF_DEPTH)
    f, b = pt.split_search(cg, ch, FIT_BINS, **kw)
    # the grid's child weights (10, 100) split few level-11 nodes; a
    # second search with weight 1 holds the kernel to many more splits
    kw1 = dict(kw, min_child_weight=1.0, min_gain_norm=0.0)
    f1, b1 = pt.split_search(cg, ch, FIT_BINS, **kw1)
    node12 = pt.route_level(Xb, node11, f, b)
    leaf = pt.leaf_values(node12, G, H, 4096, 1e-6, 0.0)
    torch.cuda.synchronize()
    worst = {k: 0.0 for k in ("histograms", "sibling_subtract",
                              "split_search", "route_level", "leaf_values")}
    checked = sorted(set(range(min(RF_PLAIN_PAIRS - 1, Pc))) | {Pc - 1})
    for p in checked:
        sl = slice(p, p + 1)
        wg, wh = pt.histograms_plain(Xb, parent[sl], G[sl], H[sl], 1024,
                                     FIT_BINS)
        err = max(float((hg_r[sl] - wg).abs().max()),
                  float((hh_r[sl] - wh).abs().max()))
        worst["histograms"] = max(worst["histograms"], err)
        if not (torch.equal(hg_r[sl], wg) and torch.equal(hh_r[sl], wh)):
            raise AssertionError(f"forest K1 disagrees (pair {p})")
        del wg, wh
        wg, wh = pt.sibling_subtract_plain(hg10[sl], hh10[sl], hg_r[sl],
                                           hh_r[sl])
        if not (torch.equal(cg[sl], wg) and torch.equal(ch[sl], wh)):
            raise AssertionError(f"K1-sub disagrees (pair {p})")
        del wg, wh
        pkw = dict(kw, min_child_weight=mcw[sl], feature_mask=fmask[sl])
        wf, wb = pt.split_search_plain(cg[sl], ch[sl], FIT_BINS, **pkw)
        wf1, wb1 = pt.split_search_plain(cg[sl], ch[sl], FIT_BINS,
                                         **dict(kw1, feature_mask=fmask[sl]))
        diff = int((f[sl] != wf).sum() + (b[sl] != wb).sum()
                   + (f1[sl] != wf1).sum() + (b1[sl] != wb1).sum())
        worst["split_search"] = max(worst["split_search"], diff)
        if diff:
            raise AssertionError(f"forest K2 disagrees (pair {p})")
        wn = pt.route_level_plain(Xb, node11[sl], f[sl], b[sl])
        if not torch.equal(wn, node12[sl]):
            raise AssertionError(f"forest K3 route disagrees (pair {p})")
        wl = pt.leaf_values_plain(node12[sl].cpu(), G[sl].cpu(),
                                  H[sl].cpu(), 4096, 1e-6, 0.0)
        err = float((leaf[sl].cpu() - wl).abs().max())
        worst["leaf_values"] = max(worst["leaf_values"], err)
        if not torch.equal(leaf[sl].cpu(), wl):
            raise AssertionError(f"forest K3 leaves differ from row-order "
                                 f"sums (pair {p})")
    record = {"phase": "forest_kernel_check", "shape": {
        "pairs": Pc, "rows": FIT_N, "d": FIT_D, "bins": FIT_BINS,
        "channels": RF_M, "parents_level10": 1024, "nodes_level11": 2048,
        "leaves": 4096}, "chunk": plan,
        "checked_pairs": checked, "max_abs_err": worst,
        "splits_level11": int((b < FIT_BINS).sum()),
        "splits_level11_weight1": int((b1 < FIT_BINS).sum()),
        "tolerance": "equal (integer histogram sums; leaves bit-equal to "
                     "the CPU's row-order sums)"}
    cases = dict(Xb=Xb, G=G, H=H, parent=parent, node11=node11,
                 node12=node12, hg_r=hg_r, hh_r=hh_r, hg10=hg10, hh10=hh10,
                 cg=cg, ch=ch, f=f, b=b, kw=kw, Pc=Pc)
    return record, cases


def time_forest_kernels(pt, c):
    """CUDA-event times at level 11 of the depth-12 bucket, kernel and
    plain version on the same whole chunk, beside the bound and (K1, K1-sub)
    one-call yardsticks. The level-11 histograms are dropped before the
    histogram kernels are timed, so the plain versions' outputs fit."""
    Pc, n, d, B, m = c["Pc"], FIT_N, FIT_D, FIT_BINS, RF_M
    out = {}
    k2 = k2_timing(pt, c["cg"], c["ch"], B, c["kw"], c["live11"], 10,
                   plain_iters=2)
    # the dense search: every node (the yardstick), its bound every cell's
    out["split_search"] = {
        "ms": k2["dense_ms"], "plain_ms": k2["plain_ms"],
        "library_ms": None, "bound_ms": k2["dense_bound_ms"],
        "bound_by": k2["dense_bound_by"], "bytes": k2["dense_bytes"]}
    out["split_search_live"] = k2
    Xb, node11, f, b = c["Xb"], c["node11"], c["f"], c["b"]
    out["route_level"] = k3_route_timing(pt, Xb, node11, f, b, 50)
    G, H, node12 = c["G"], c["H"], c["node12"]
    k3l_bytes = (m + 2) * Pc * n * 4 + Pc * 4097 * 4 + Pc * 4096 * m * 4
    k3l_bound, k3l_by = bound(k3l_bytes, (m + 1) * Pc * n + 5 * Pc * 4096 * m)
    slot = (node12.long() + torch.arange(Pc, device=G.device)[:, None]
            * 4097).reshape(-1)
    leaf_srcs = [G[:, j].reshape(-1) for j in range(m)] + [H.reshape(-1)]

    def leaf_library():  # index_add_ per channel: the leaves' sums
        for src in leaf_srcs:
            torch.zeros(Pc * 4097, device=src.device).index_add_(
                0, slot, src)
    out["leaf_values"] = {
        "ms": cuda_ms(lambda: pt.leaf_values(node12, G, H, 4096, 1e-6, 0.0),
                      20),
        "plain_ms": cuda_ms(lambda: pt.leaf_values_plain(
            node12, G, H, 4096, 1e-6, 0.0), 10),
        "library_ms": cuda_ms(leaf_library, 10), "bound_ms": k3l_bound,
        "bound_by": k3l_by, "bytes": k3l_bytes,
        **leaf_designs_ms(pt, node12, G, H, 4096, 1e-6, 20)}
    del slot, leaf_srcs
    for k in ("cg", "ch", "f", "b", "live11"):
        del c[k]
    torch.cuda.empty_cache()
    hg10, hh10, hg_r, hh_r = c["hg10"], c["hh10"], c["hg_r"], c["hh_r"]
    cells10 = Pc * (m + 1) * 1024 * d * B
    sub_bytes = 2 * cells10 * 4 + 2 * cells10 * 4
    sub_bound, sub_by = bound(sub_bytes, cells10)
    out["sibling_subtract"] = {
        "ms": cuda_ms(lambda: pt.sibling_subtract(hg10, hh10, hg_r, hh_r),
                      10),
        "plain_ms": cuda_ms(lambda: pt.sibling_subtract_plain(
            hg10, hh10, hg_r, hh_r), 3, warmup=1),
        # no one PyTorch call computes it: the kernel writes both children
        # (left = parent - right, and right copied), `torch.sub` x 2 only
        # the left ones
        "library_ms": None,
        "bound_ms": sub_bound, "bound_by": sub_by, "bytes": sub_bytes}
    del hg10, hh10
    for k in ("hg10", "hh10"):
        del c[k]
    torch.cuda.empty_cache()
    parent = c["parent"]
    n_right = int((parent < 1024).sum())
    k1_bytes = n * d + Pc * (m + 1) * n * 4 + 2 * Pc * n * 4 + cells10 * 4
    k1_bound, k1_by = bound(k1_bytes, (m + 1) * n_right * d)
    cell = (((parent.long() + torch.arange(Pc, device=G.device)[:, None]
              * 1025)[:, :, None] * d + torch.arange(d, device=G.device))
            * B + Xb.long()[None]).reshape(-1)
    srcs = [v[:, :, None].expand(Pc, n, d).reshape(-1)
            for v in (G[:, 0], G[:, 1], H)]

    def library():  # index_add_ per channel, the left-out rows' slot too
        for src in srcs:
            torch.zeros(Pc * 1025 * d * B, device=src.device).index_add_(
                0, cell, src)
    out["histograms"] = {
        "ms": cuda_ms(lambda: pt.histograms(Xb, parent, G, H, 1024, B), 10),
        "segments_ms": cuda_ms(lambda: pt.node_segments(parent, 1024), 10),
        "plain_ms": cuda_ms(lambda: pt.histograms_plain(
            Xb, parent, G, H, 1024, B), 2, warmup=1),
        "library_ms": cuda_ms(library, 3, warmup=1), "bound_ms": k1_bound,
        "bound_by": k1_by, "bytes": k1_bytes, "rows_right": n_right,
        "scratch_bytes": pt.hist_scratch_bytes(Pc, n, 1024, m, d, B)}
    del cell, srcs
    emit({"phase": "forest_timing", "pairs": Pc, "level": 11, **out})
    return out


def pair_kw(kw, sl, P):
    """The split-search keywords of pairs `sl`: per-pair tensors sliced."""
    return {k: (v[sl] if torch.is_tensor(v) and v.dim() and v.shape[0] == P
                else v) for k, v in kw.items()}


def nonzero_nodes(hg, hh, step: int = 4):
    """(P, nodes) bool: the nodes with a non-zero cell, a few pairs at a
    time (a whole level's bool temporaries would not fit beside it)."""
    out = []
    for p0 in range(0, hh.shape[0], step):
        g, h = hg[p0:p0 + step], hh[p0:p0 + step]
        out.append((h != 0).flatten(2).any(2)
                   | (g != 0).transpose(1, 2).flatten(2).any(2))
    return torch.cat(out)


def grow_checked(pt, Xb, G, H, depth, kw, checked):
    """`grow_trees`' levels one by one on the card (sibling subtraction
    from depth 12), holding each level's K2 over the live set (the flags
    K3 and K2's marks wrote) to the dense kernel on every pair and to the
    plain version on the pairs `checked`, the live set to every node with
    a non-zero cell or a row, and K3's node ids and flags to the plain
    version; then the tables to `grow_trees`' (the main path). Returns
    the record, the flags, the final node ids and the histograms of the
    last level."""
    P, n = H.shape
    dev = Xb.device
    max_nodes = 2 ** depth
    flags = torch.zeros((P, depth, max_nodes), dtype=torch.uint8, device=dev)
    feats = torch.zeros((P, depth, max_nodes), dtype=torch.int32, device=dev)
    bins = torch.full((P, depth, max_nodes), FIT_BINS, dtype=torch.int32,
                      device=dev)
    node = torch.zeros((P, n), dtype=torch.int32, device=dev)
    subtract = depth >= 12
    rec = {"live_nodes_mean": [], "live_nodes_max": [],
           "nodes_with_rows_mean": [], "residue_nodes": 0, "diff": 0,
           "first_residue": None}
    if subtract:
        hg, hh = pt.histograms(Xb, node, G, H, 1, FIT_BINS)
    for level in range(depth):
        n_nodes = 2 ** level
        if not subtract:
            hg, hh = pt.histograms(Xb, node, G, H, n_nodes, FIT_BINS)
        live = flags[:, level, :n_nodes] if level else None
        nxt = flags[:, level + 1, :2 * n_nodes] if level + 1 < depth \
            else None
        here = (feats[:, level, :n_nodes], bins[:, level, :n_nodes])
        pt.split_search(hg, hh, FIT_BINS, level=level, live=live, out=here,
                        mark=nxt if subtract else None, **kw)
        df, db = pt.split_search(hg, hh, FIT_BINS, level=level, **kw)
        diff = int((here[0] != df).sum() + (here[1] != db).sum())
        for p in checked:
            sl = slice(p, p + 1)
            wf, wb = pt.split_search_plain(hg[sl], hh[sl], FIT_BINS,
                                           level=level,
                                           **pair_kw(kw, sl, P))
            diff += int((here[0][sl] != wf).sum() + (here[1][sl] != wb)
                        .sum())
        rows = occupancy(node, n_nodes).bool()
        on = torch.ones_like(rows) if live is None else live.bool()
        nz = nonzero_nodes(hg, hh)
        if bool((nz & ~on).any()) or bool((rows & ~on).any()):
            raise AssertionError(f"a node outside the live set holds rows "
                                 f"or a non-zero cell (level {level})")
        residue = (on & ~rows & nz).nonzero()
        if residue.shape[0] and rec["first_residue"] is None:
            p, k = residue[0].tolist()
            rec["first_residue"] = {"level": level, "pair": p, "node": k,
                                    "max_abs_cell": float(
                                        hh[p, k].abs().max())}
        rec["residue_nodes"] += int(residue.shape[0])
        rec["live_nodes_mean"].append(float(on.sum(1).float().mean()))
        rec["live_nodes_max"].append(int(on.sum(1).max()))
        rec["nodes_with_rows_mean"].append(float(rows.sum(1).float().mean()))
        del nz, df, db
        prev = node
        node = pt.route_level(Xb, node, *here, occupied=nxt)
        if nxt is not None:
            for p in checked:
                sl = slice(p, p + 1)
                wocc = torch.zeros((1, 2 * n_nodes), dtype=torch.uint8,
                                   device=dev)
                if subtract:  # K2's marks: the left child of a searched node
                    wocc[:, 0::2] = on[sl].to(torch.uint8)
                wn = pt.route_level_plain(Xb, prev[sl], here[0][sl],
                                          here[1][sl], occupied=wocc)
                diff += int((wn != node[sl]).sum() + (wocc != nxt[sl]).sum())
        if subtract and level + 1 < depth:
            parent = torch.where((node & 1).bool(), node >> 1,
                                 torch.full_like(node, n_nodes))
            hg_r, hh_r = pt.histograms(Xb, parent, G, H, n_nodes, FIT_BINS)
            hg, hh = pt.sibling_subtract(hg, hh, hg_r, hh_r)
            del hg_r, hh_r
        rec["diff"] = max(rec["diff"], diff)
        if diff:
            raise AssertionError(f"K2 over the live set or K3's flags "
                                 f"disagree (level {level})")
    del hg, hh
    torch.cuda.empty_cache()
    tree, main_node = pt.grow_trees(Xb, G, H, depth, FIT_BINS, **kw)
    if not (torch.equal(tree["feat"], feats) and torch.equal(tree["bin"], bins)
            and torch.equal(main_node, node)):
        raise AssertionError("grow_trees' tables differ from the checked "
                             "levels'")
    rec["splits"] = int((bins < FIT_BINS).sum())
    return rec, flags, node


def live_levels_check(pt, rng, c, dev):
    """K2 over the live set against the dense kernel and the plain version
    at levels 0-11 of the forest chunk's depth-12 trees, for the depth-12
    bucket's two child-weight grids (10 / 100 with min_gain_norm 0.001,
    and 1 with 0), recording the live nodes a level; then the same at P =
    6 over float gradients (a GBT round's shape: normal G, uniform H), at
    min_child_weight 1 / gamma 0 and at min_child_weight 0 / gamma -1,
    where a split may leave its left side empty and the empty left child
    carries parent − right's rounding residue. Returns the record and the
    level-11 live set of the first grid (the node ids equal `node11`)."""
    Xb, G, H, Pc = c["Xb"], c["G"], c["H"], c["Pc"]
    kw = {k: v for k, v in c["kw"].items() if k != "level"}
    checked = sorted(set(range(min(RF_PLAIN_PAIRS - 1, Pc))) | {Pc - 1})
    out = {"pairs": Pc, "checked_pairs": checked}
    live11 = None
    for name, kwg in (("grid_10_100", kw),
                      ("grid_1", dict(kw, min_child_weight=1.0,
                                      min_gain_norm=0.0))):
        rec, flags, node = grow_checked(pt, Xb, G, H, RF_DEPTH, kwg, checked)
        if live11 is None:
            if not torch.equal(node, pt.route_level(
                    Xb, c["node11"], c["f"], c["b"])):
                raise AssertionError("the checked levels' trees differ from "
                                     "the forest chunk's")
            live11 = flags[:, 11, :2048].clone()
        out[name] = rec
        del flags, node
        torch.cuda.empty_cache()
    n, P = FIT_N, FIT_P
    Gf = torch.from_numpy(rng.normal(size=(P, 1, n)).astype(np.float32)) \
        .to(dev)
    Hf = torch.from_numpy(rng.uniform(0.05, 1.0, (P, n)).astype(np.float32)) \
        .to(dev)
    for name, (mcw, gamma) in (("float_mcw1", (1.0, 0.0)),
                               ("float_mcw0_gamma_neg", (0.0, -1.0))):
        fkw = dict(reg_lambda=1.0, min_child_weight=mcw, min_gain=gamma,
                   min_gain_norm=0.0, feature_mask=None, active_depth=None)
        rec, _, _ = grow_checked(pt, Xb, Gf, Hf, RF_DEPTH, fkw,
                                 [0, P - 1])
        out[name] = rec
        torch.cuda.empty_cache()
    emit({"phase": "live_levels_check", **out,
          "tolerance": "equal (tables, node ids and flags); every node "
                       "with a row or a non-zero cell live"})
    return out, live11


# --------------------------------------------------------------------------- #
# the training path                                                           #
# --------------------------------------------------------------------------- #

XGB = dict(n_estimators=200, eta=0.02, max_depth=10, gamma=0.8,
           early_stopping_rounds=20)
GRID = [{"min_child_weight": 1.0}, {"min_child_weight": 10.0}]
# near-tie splits (f32 histogram sums in another order than XLA's) change
# single trees and so the round where a fold's early stopping lands
# (tests/test_torch_train.py docstring)
FOLD_AUPR_ATOL = 1e-2
HOLDOUT_AUPR_ATOL = 1e-2


def quickstart_selector(port, ds):
    preds, label = port.FeatureBuilder.from_dataset(ds, response="survived")
    checked = label.sanity_check(port.transmogrify(preds),
                                 remove_bad_features=True)
    pred = port.BinaryClassificationModelSelector.with_cross_validation(
        models=[(port.OpXGBoostClassifier(**XGB), GRID)]
    ).set_input(label, checked).get_output()
    return pred, label


def fitted_of(model, name):
    return next(s for s in model.fitted.values()
                if type(s).__name__ == name)


def train_path(port, pt, device="cuda"):
    """Train, hold to the JAX fixture, save, reload, score; the launch
    counters cover exactly this run."""
    import tempfile

    ds = port.Dataset.from_csv(TITANIC)
    with open(os.path.join(TRAIN_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(TRAIN_FIXTURE, "scores.npz")) as z:
        want_arr = {k: z[k] for k in z.files}
    pt.reset_launches()
    t0 = time.perf_counter()
    pred, label = quickstart_selector(port, ds)
    model = port.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device=device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    path = tempfile.mkdtemp(prefix="port_model_")
    model.save(path)
    again = prediction_of(port.load_model(path, device=device)
                          .score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in TRAINING_KERNELS + ("tree_walk",)}

    gbt = fitted_of(model, "GBTClassificationModel")
    checker = fitted_of(model, "SanityCheckerModel")
    summ = gbt.summary
    folds = np.array([r.fold_metrics for r in summ.validation_results])
    fold_err = float(np.abs(folds - np.array(want["fold_metrics"])).max())
    hold_err = abs(summ.holdout_metrics["AuPR"]
                   - want["holdout_metrics"]["AuPR"])
    train_err = abs(summ.train_metrics["AuPR"]
                    - want["train_metrics"]["AuPR"])
    kept_equal = checker.indices == want_arr["kept_indices"].tolist()
    reload_equal = all(np.array_equal(scores[k], again[k])
                       for k in ("prediction", "rawPrediction",
                                 "probability"))
    score_err = {k: float(np.abs(scores[k] - want_arr[k]).max())
                 for k in ("rawPrediction", "probability")}
    stage = dict(model.stage_seconds)
    feature_fit = sum(v for k, v in model.stage_seconds
                      if k not in ("SanityChecker", "ModelSelector"))
    ok = (kept_equal and len(checker.indices) == 496
          and summ.best_grid == want["best_grid"]
          and fold_err <= FOLD_AUPR_ATOL and hold_err <= HOLDOUT_AUPR_ATOL
          and reload_equal and np.isfinite(scores["probability"]).all()
          and scores["probability"].shape == (891, 2)
          and all(launches[k] >= 1 for k in TRAINING_KERNELS))
    record = {
        "phase": "train", "rows": 891,
        "columns": {"combined": 1048, "kept": len(checker.indices)},
        "kept_equal": kept_equal, "best_grid": summ.best_grid,
        "best_grid_equal": summ.best_grid == want["best_grid"],
        "fold_aupr": folds.tolist(), "fold_aupr_max_abs_err": fold_err,
        "holdout_aupr": summ.holdout_metrics["AuPR"],
        "holdout_aupr_abs_err": hold_err, "train_aupr_abs_err": train_err,
        "refit_rounds": gbt.refit_rounds,
        "refit_rounds_jax": want["refit_rounds"],
        "scores_max_abs_err_vs_jax": score_err,
        "reload_scores_equal": reload_equal,
        "tolerance": {"fold_aupr": FOLD_AUPR_ATOL,
                      "holdout_aupr": HOLDOUT_AUPR_ATOL},
        "launches_main_path": launches,
        "wall_s": {"train": train_s, "feature_fit": feature_fit,
                   "sanity_checker": stage.get("SanityChecker"),
                   "selector": stage.get("ModelSelector"),
                   "sweep": summ.timings["sweep_s"],
                   "refit": summ.timings["refit_s"]},
        "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError("the training path disagrees with the JAX "
                             "package's f32 fixture")
    return model, ds, record


def sweep_busy_share(port, model, ds, models, label, device="cuda",
                     draws=None):
    """The sweep of the trained selector over `models` ((estimator,
    grids) pairs) run again under torch.profiler: the device's busy and
    idle share of its wall time."""
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.selector.splitters import DataBalancer
    from transmogrifai_tpu_torch.selector.validators import OpCrossValidation
    from transmogrifai_tpu_torch.stages.base import FitContext
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator)

    cols = model.score(ds, keep_intermediate=True)
    checker = fitted_of(model, "SanityCheckerModel")
    X_all = torch.as_tensor(cols[checker.get_output().uid].data,
                            device=device)
    y = np.asarray(ds.column("survived"), dtype=np.float64)
    bal = DataBalancer(seed=42)
    tr, _, _ = bal.split(y)
    tr, _ = bal.prepare(y, tr)
    X = X_all[torch.as_tensor(tr, device=device)]
    yd = torch.as_tensor(y[tr].astype(np.float32), device=device)
    folds = OpCrossValidation(n_folds=3, seed=42).splits(y[tr])
    ev = BinaryClassificationEvaluator()

    def sweep():
        ctx = FitContext(n_rows=891, seed=42 * 1000003 + 4, device=device)
        with (pt.injected_forest_draws(draws) if draws is not None
              else contextlib.nullcontext()):
            for est, grids in models:
                run_sweep(est, grids, X, yd, folds, ev, ctx)
        sync(device)

    sweep()  # warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        sweep()
        wall = (time.perf_counter() - t) * 1e3
    items = sorted(((e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(v for _, v in items)
    t = time.perf_counter()
    sweep()
    plain_wall = (time.perf_counter() - t) * 1e3
    record = {"phase": "sweep_breakdown", "sweep": label,
              "wall_ms": plain_wall,
              "wall_ms_profiled": wall,
              "device_busy_ms": busy if items else "not measured",
              "device_busy_share": busy / plain_wall if items
              else "not measured",
              "device_idle_share": 1 - busy / plain_wall if items
              else "not measured",
              "top_device_items_ms": items[:8]}
    emit(record)
    return record


class ForestPlans(logging.Handler):
    """Within a `with` block, `fit_forest`'s log lines: the chunks it
    cut each bucket's trees into and the byte budget it used."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []
        self._logger = logging.getLogger(
            "transmogrifai_tpu_torch.models.trees")

    def emit(self, record):
        if record.getMessage().startswith("fit_forest:"):
            self.messages.append(record.getMessage())

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


# --------------------------------------------------------------------------- #
# the README quickstart: the default LR + RF + XGB sweep                      #
# --------------------------------------------------------------------------- #

DEFAULT_FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                               "titanic_quickstart_default_f32")
DEFAULT_KERNELS = TRAINING_KERNELS + ("sibling_subtract", "tree_walk")
# LR: the same FISTA steps, products summed in another order (the CPU
# tests hold the weights within 1e-4 of max|W|); RF: equal trees from the
# JAX draws, probabilities summed in another order; XGB: near-tie splits
# at depth 10 (see XGB's tolerance above)
DEFAULT_FOLD_ATOL = {"OpLogisticRegression": 1e-4,
                     "OpRandomForestClassifier": 1e-2,
                     "OpXGBoostClassifier": 1e-2}
DEFAULT_HOLDOUT_ATOL = 1e-2


def readme_quickstart(port, ds, models=None):
    """The README quickstart verbatim: with no `models=`, LR + RF + XGB."""
    predictors, label = port.FeatureBuilder.from_dataset(
        ds, response="survived")
    checked = label.sanity_check(port.transmogrify(predictors),
                                 remove_bad_features=True)
    pred = port.BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, checked).get_output()
    return pred, label


def default_train_path(port, pt, device="cuda"):
    """Train the README quickstart with the JAX package's forest draws
    injected, hold it to the JAX package's f32-mode default sweep, save,
    reload, score; the launch counters cover exactly this run."""
    import tempfile

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 reference is "
                             "exact f32")
    ds = port.Dataset.from_csv(TITANIC)
    with open(os.path.join(DEFAULT_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(DEFAULT_FIXTURE, "scores.npz")) as z:
        want_arr = {k: z[k] for k in z.files}
    draws = (want_arr["forest_boot"], want_arr["forest_mask"])
    plans = ForestPlans()
    pt.reset_launches()
    t0 = time.perf_counter()
    pred, label = readme_quickstart(port, ds)
    with pt.injected_forest_draws(draws), plans:
        model = port.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device=device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    path = tempfile.mkdtemp(prefix="port_default_model_")
    model.save(path)
    again = prediction_of(port.load_model(path, device=device)
                          .score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in DEFAULT_KERNELS}

    best = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = best.summary
    results = [{"model": r.model, "grid": r.grid}
               for r in summ.validation_results]
    if results != want["results"]:
        raise AssertionError("the default sweep ran other configs than the "
                             "fixture's")
    folds = np.array([r.fold_metrics for r in summ.validation_results])
    err = np.abs(folds - np.array(want["fold_metrics"])).max(axis=1)
    fold_err = {fam: float(max(e for e, r in zip(err, results)
                               if r["model"] == fam))
                for fam in DEFAULT_FOLD_ATOL}
    hold_err = abs(summ.holdout_metrics["AuPR"]
                   - want["holdout_metrics"]["AuPR"])
    reload_equal = all(np.array_equal(scores[k], again[k])
                       for k in ("prediction", "rawPrediction",
                                 "probability"))
    winner_equal = (summ.best_model == want["best_model"]
                    and summ.best_grid == want["best_grid"])
    feature_fit = sum(v for k, v in model.stage_seconds
                      if k not in ("SanityChecker", "ModelSelector"))
    stage = dict(model.stage_seconds)
    ok = (winner_equal
          and all(fold_err[f] <= DEFAULT_FOLD_ATOL[f] for f in fold_err)
          and hold_err <= DEFAULT_HOLDOUT_ATOL and reload_equal
          and np.isfinite(scores["probability"]).all()
          and scores["probability"].shape == (891, 2)
          and all(launches[k] >= 1 for k in DEFAULT_KERNELS))
    record = {
        "phase": "default_train", "rows": 891, "configs": len(results),
        "best_model": summ.best_model, "best_grid": summ.best_grid,
        "winner_equal": winner_equal,
        "fold_aupr_max_abs_err": fold_err, "tolerance": {
            "fold_aupr": DEFAULT_FOLD_ATOL,
            "holdout_aupr": DEFAULT_HOLDOUT_ATOL},
        "holdout_aupr": summ.holdout_metrics["AuPR"],
        "holdout_aupr_jax": want["holdout_metrics"]["AuPR"],
        "holdout_aupr_abs_err": hold_err,
        "train_aupr_abs_err": abs(summ.train_metrics["AuPR"]
                                  - want["train_metrics"]["AuPR"]),
        "scores_max_abs_err_vs_jax": {
            k: float(np.abs(scores[k] - want_arr[k]).max())
            for k in ("rawPrediction", "probability")},
        "reload_scores_equal": reload_equal,
        "launches_main_path": launches, "forest_chunks": plans.messages,
        "wall_s": {"train": train_s, "feature_fit": feature_fit,
                   "sanity_checker": stage.get("SanityChecker"),
                   "selector": stage.get("ModelSelector"),
                   "sweep": summ.timings["sweep_s"],
                   "sweep_by_family": summ.timings["families"],
                   "sweep_by_group": summ.timings["groups"],
                   "refit": summ.timings["refit_s"]},
        "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError("the default sweep disagrees with the JAX "
                             "package's f32 fixture")
    return model, ds, record, draws


def default_train_walls(port, pt, ds, draws, first, runs: int = 2) -> dict:
    """The README quickstart trained `runs` more times as phase 12 trained
    it (the same draws, no checks): the train wall and the sweep's static
    groups of each run beside phase 12's, so the run-to-run spread is on
    record."""
    walls = [first["wall_s"]]
    for _ in range(runs):
        t0 = time.perf_counter()
        pred, label = readme_quickstart(port, ds)
        with pt.injected_forest_draws(draws):
            model = port.Workflow().set_result_features(pred, label) \
                .set_input_dataset(ds).train(device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        summ = next(s for s in model.fitted.values() if hasattr(
            getattr(s, "summary", None), "validation_results")).summary
        walls.append({"train": train_s, "sweep": summ.timings["sweep_s"],
                      "sweep_by_group": summ.timings["groups"],
                      "refit": summ.timings["refit_s"]})
    rec = {"phase": "default_train_walls",
           "train_s": [w["train"] for w in walls],
           "sweep_s": [w["sweep"] for w in walls],
           "refit_s": [w["refit"] for w in walls],
           "sweep_by_group_s": {g: [w["sweep_by_group"][g] for w in walls]
                                for g in walls[0]["sweep_by_group"]}}
    emit(rec)
    return rec


# --------------------------------------------------------------------------- #
# the Iris and Boston examples: evaluation kernels, m = 3, training           #
# --------------------------------------------------------------------------- #

EXAMPLES = os.path.join(HERE, "examples", "data")
EXAMPLE_FIXTURE = {ex: os.path.join(HERE, "transmogrifai_tpu_torch",
                                    "testdata", f"{ex}_default_f32")
                   for ex in ("iris", "boston")}
# the kernels each example's train must launch
EXAMPLE_KERNELS = {
    "iris": ("bin_features", "histograms", "sibling_subtract",
             "split_search", "split_search_live", "route_level",
             "leaf_values", "tree_walk", "confusion_counts"),
    "boston": ("bin_features", "histograms", "sibling_subtract",
               "split_search", "split_search_live", "route_level",
               "leaf_values", "tree_walk", "regression_moments")}
# validation-metric tolerance per family: Iris's F1 comes from equal class
# predictions (f32 rounding of the weighted average); Boston's linear fit
# runs the same FISTA steps, its forests and GBT sum float labels in
# another order, so near-tie splits may go either way (relative)
IRIS_F1_ATOL = 1e-6
BOSTON_RMSE_RTOL = {"OpLinearRegression": 1e-4,
                    "OpRandomForestRegressor": 1e-2, "OpGBTRegressor": 1e-2}
BOSTON_HOLDOUT_RTOL = 1e-2
# the evaluation kernels' shapes: each example's largest metric call (its
# LR / linear group: 8 configs x 1 fold, on the validation split of the
# training rows) and a synthetic one
EVAL_SHAPES = {"iris": (8, 135, 3), "boston": (8, 300, None),
               "synthetic": (18, 65536, 3), "synthetic_k32": (18, 65536, 32),
               "synthetic_k100": (18, 65536, 100),
               "synthetic_k300": (18, 65536, 300)}


def eval_inputs(rng, P, n, k, dev):
    y = rng.integers(0, k or 3, n)
    pred = np.where(rng.random((P, n)) < 0.8, y,
                    rng.integers(0, k or 3, (P, n)))
    mask = (rng.random((P, n)) < 0.25).astype(np.float32)
    if k is None:  # regression: Boston-like labels
        y = rng.normal(size=n) * 9 + 22
        pred = y + rng.normal(size=(P, n)) * 3
    dt = np.int32 if k else np.float32
    return [torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)
            for a in (y, pred)] + [torch.from_numpy(mask).to(dev)]


def eval_kernels(pdm, rng, dev):
    """K8-mc and K8-reg against their plain versions at each example's
    shape and at n = 65536, P = 18 (K8-mc also at k = 32, 100 and 300; 0/1
    masks: counts equal; regression sums within 1e-6 relative), then
    timed eagerly (`ms`) and as a CUDA-graph replay (`graph_ms`, as a
    captured sweep would run it) beside the bound of the bytes the
    function must move (each input read once, each output written once),
    `design_bytes` (what this design moves: K8-mc's f64 partials written
    and read where G > 1 or the cells live in global scratch, K8-reg's
    second read of the labels and weights where G > 1) and, for the
    confusion counts, the one `torch.bincount` call that computes them
    (index precomputed)."""
    out = {}
    for label, (P, n, k) in EVAL_SHAPES.items():
        for kind in (("confusion_counts", "regression_moments")
                     if label == "synthetic" else
                     (("confusion_counts",) if k else
                      ("regression_moments",))):
            kk = k or 3
            if kind == "confusion_counts":
                y, pred, mask = eval_inputs(rng, P, n, kk, dev)
                got = pdm.confusion_counts(y, pred, mask, kk)
                want = pdm.confusion_counts_plain(y, pred, mask, kk)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"K8-mc disagrees at {label}")
                idx = (torch.arange(P, device=dev)[:, None] * kk * kk
                       + y.long()[None] * kk + pred.long()).reshape(-1)
                flat = mask.reshape(-1)
                nbytes = n * 4 + 2 * P * n * 4 + P * kk * kk * 4
                b, by = bound(nbytes, 2 * P * n)
                G, _, warps, shared = pdm.confusion_plan(P, n, kk)
                part = (2 * 8 * P * G * kk * kk
                        if G > 1 or not shared else 0)
                rec = {"ms": cuda_ms(lambda: pdm.confusion_counts(
                           y, pred, mask, kk), 50),
                       "graph_ms": graph_ms(lambda: pdm.confusion_counts(
                           y, pred, mask, kk), 50),
                       "plan": {"G": G, "warps": warps, "shared": shared},
                       "design_bytes": nbytes + part,
                       "design_bound_ms": bound(nbytes + part, 0)[0],
                       "plain_ms": cuda_ms(lambda: pdm.confusion_counts_plain(
                           y, pred, mask, kk), 20),
                       "library_ms": cuda_ms(lambda: torch.bincount(
                           idx, weights=flat, minlength=P * kk * kk), 50),
                       "bound_ms": b, "bound_by": by, "bytes": nbytes,
                       "max_abs_err": err, "tolerance": "equal"}
            else:
                y, pred, mask = eval_inputs(rng, P, n, None, dev)
                got = pdm.regression_moments(pred, y, mask)
                want = pdm.regression_moments_plain(pred, y, mask)
                torch.cuda.synchronize()
                err = float(((got - want).abs()
                             / want.abs().clamp(min=1e-30)).max())
                if err > 1e-6:
                    raise AssertionError(f"K8-reg disagrees at {label}: "
                                         f"{err}")
                nbytes = n * 4 + 2 * P * n * 4 + P * 5 * 4
                b, by = bound(nbytes, 14 * P * n)
                G, _ = pdm.moments_row_blocks(P, n)
                again = (n * 4 + P * n * 4 if G > 1 else 0)
                rec = {"ms": cuda_ms(lambda: pdm.regression_moments(
                           pred, y, mask), 50),
                       "graph_ms": graph_ms(lambda: pdm.regression_moments(
                           pred, y, mask), 50),
                       "plan": {"G": G},
                       "design_bytes": nbytes + again,
                       "design_bound_ms": bound(nbytes + again, 0)[0],
                       "plain_ms": cuda_ms(
                           lambda: pdm.regression_moments_plain(
                               pred, y, mask), 20),
                       "library_ms": None, "bound_ms": b, "bound_by": by,
                       "bytes": nbytes, "max_abs_err": err,
                       "tolerance": "1e-6 relative"}
            out[f"{label}:{kind}"] = dict(rec, pairs=P, rows=n)
    return out


# --------------------------------------------------------------------------- #
# any class count (F15, F16); K8-mc, K8-reg and K10's hostile cases          #
# --------------------------------------------------------------------------- #

# K8-mc's hostile cases (P, n, k): class counts on both sides of a warp's
# histogram (k = 32, 33) and of shared memory (k = 100 shared, 300 in
# global scratch), no row, one row, and rows that the plan's G ranges do not
# divide (100,003 a pair)
K8MC_HOSTILE_CASES = tuple((P, n, k) for k in (1, 2, 32, 33, 100, 300)
                           for P, n in ((3, 0), (2, 1), (3, 100_003)))
# K8-reg's (P, n): no row, one row, one block's rows and one more, and rows
# the plan's G ranges do not divide
K8REG_HOSTILE_CASES = ((3, 0), (2, 1), (1, 4096), (18, 8193), (3, 100_003),
                       (18, 65_537))
# K1 and K2 at more channels than one K1 launch takes, (P, n, d, n_bins,
# n_nodes, m): few-row nodes, one-piece nodes, and nodes cut into pieces
# (40,000 rows over 2 nodes: the scratch and its reduce)
MANY_CHANNEL_CASES = tuple((P, n, d, b, nodes, m) for m in (5, 7, 12)
                           for P, n, d, b, nodes in (
                               (3, 257, 7, 8, 4), (4, 802, 496, 32, 64),
                               (2, 40_000, 40, 32, 2)))
# K10's hostile wires (leaves, rows): one leaf, one launch's 48, one past,
# two launches and one past; at 8 and 4 bits
K10_HOSTILE_CASES = tuple((L, n) for L in (1, 48, 49, 97) for n in (1, 37))


def eval_hostile_inputs(rng, P, n, k, weights):
    """CPU tensors: labels (n,) and predictions (P, n) int32 in [-1, k]
    (the kernels clip them), and 0/1 or fractional weights (P, n)."""
    y = rng.integers(-1, k + 1, n).astype(np.int32)
    pred = np.where(rng.random((P, n)) < 0.5, y,
                    rng.integers(-1, k + 1, (P, n))).astype(np.int32)
    mask = ((rng.random((P, n)) < 0.4).astype(np.float32) if weights == "01"
            else rng.uniform(0, 2, (P, n)).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, pred, mask)]


def regression_hostile_inputs(rng, P, n, weights):
    y = (rng.normal(size=n) * 9 + 22).astype(np.float32)
    pred = (y + rng.normal(size=(P, n)) * 3).astype(np.float32)
    mask = ((rng.random((P, n)) < 0.3).astype(np.float32) if weights == "01"
            else rng.uniform(0, 2, (P, n)).astype(np.float32))
    return [torch.from_numpy(a) for a in (pred, y, mask)]


def launched(pt, name, fn):
    """(fn()'s result, the launches of `name` it made), synchronized."""
    before = pt.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    return out, pt.LAUNCHES[name] - before


def k8_hostile_check(pdm, pt, dev) -> dict:
    """K8-mc at every `K8MC_HOSTILE_CASES` case and K8-reg at every
    `K8REG_HOSTILE_CASES` case, 0/1 and fractional weights, against their
    plain versions on the CPU: confusion counts equal (0/1) or within 1e-6
    relative (fractional; both sum in f64 and round once, in other
    orders), regression sums within 1e-6 relative; one launch a call and
    the same bits on a second call."""
    worst = {"confusion_counts": 0.0, "regression_moments": 0.0}
    for P, n, k in K8MC_HOSTILE_CASES:
        for weights in ("01", "frac"):
            cpu = eval_hostile_inputs(np.random.default_rng(P + n + k), P, n,
                                      k, weights)
            args = [t.to(dev) for t in cpu]
            got, nl = launched(pt, "confusion_counts",
                               lambda: pdm.confusion_counts(*args, k))
            want = pdm.confusion_counts_plain(*cpu, k)
            err = float(((got.cpu() - want).abs()
                         / want.abs().clamp(min=1e-30)).max()) if n else 0.0
            ok = (nl == 1 and got.shape == (P, k, k)
                  and (torch.equal(got.cpu(), want) if weights == "01"
                       else err <= 1e-6)
                  and torch.equal(got, pdm.confusion_counts(*args, k)))
            if not ok:
                raise AssertionError(f"K8-mc disagrees at P={P} n={n} k={k} "
                                     f"({weights}): launches {nl}, err {err}")
            worst["confusion_counts"] = max(worst["confusion_counts"], err)
    for P, n in K8REG_HOSTILE_CASES:
        for weights in ("01", "frac"):
            cpu = regression_hostile_inputs(np.random.default_rng(P * 7 + n),
                                            P, n, weights)
            args = [t.to(dev) for t in cpu]
            got, nl = launched(pt, "regression_moments",
                               lambda: pdm.regression_moments(*args))
            want = pdm.regression_moments_plain(*cpu)
            err = float(((got.cpu() - want).abs()
                         / want.abs().clamp(min=1e-30)).max())
            if not (nl == 1 and err <= 1e-6 and torch.equal(
                    got, pdm.regression_moments(*args))):
                raise AssertionError(f"K8-reg disagrees at P={P} n={n} "
                                     f"({weights}): launches {nl}, err {err}")
            worst["regression_moments"] = max(worst["regression_moments"],
                                              err)
    return {"confusion_counts_cases": 2 * len(K8MC_HOSTILE_CASES),
            "regression_moments_cases": 2 * len(K8REG_HOSTILE_CASES),
            "max_rel_err": worst,
            "plans": {f"{P}x{n}:k{k}": pdm.confusion_plan(P, n, k)
                      for P, n, k in K8MC_HOSTILE_CASES},
            "tolerance": "counts equal at 0/1 weights, else 1e-6 relative; "
                         "one launch; the same bits twice"}


def many_channel_inputs(rng, P, n, d, n_bins, n_nodes, m):
    """CPU tensors of a forest level at m class channels: bins, node ids
    (n_nodes: left out), one-hot classes times Poisson bootstrap counts
    (integer sums, exact in any order)."""
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d)).astype(np.int8))
    node = torch.from_numpy(
        rng.integers(0, n_nodes + 1, (P, n)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, m, n))
    H = torch.from_numpy(rng.poisson(1.0, (P, n)).astype(np.float32))
    G = (torch.nn.functional.one_hot(y, m).float().T[None]
         * H[:, None, :]).contiguous()
    return Xb, node, G, H


def many_channel_check(pt, dev) -> dict:
    """K1 and K2 at every `MANY_CHANNEL_CASES` case against their plain
    versions: histograms equal (integer sums) in one launch a channel
    group (`hist_channel_groups`), K2's split tables equal from the same
    histograms, dense and over the live set, with and without a feature
    mask, in one launch; each the same bits on a second call."""
    for P, n, d, b, nodes, m in MANY_CHANNEL_CASES:
        rng = np.random.default_rng(P * n + m)
        cpu = many_channel_inputs(rng, P, n, d, b, nodes, m)
        args = [t.to(dev) for t in cpu]
        groups = len(pt.hist_channel_groups(m, 4))
        (hg, hh), nl = launched(pt, "histograms",
                                lambda: pt.histograms(*args, nodes, b))
        want = pt.histograms_plain(*cpu, nodes, b)
        again = pt.histograms(*args, nodes, b)
        if not (nl == groups and hg.shape == (P, m, nodes, d, b)
                and torch.equal(hg.cpu(), want[0])
                and torch.equal(hh.cpu(), want[1])
                and torch.equal(hg, again[0]) and torch.equal(hh, again[1])):
            raise AssertionError(f"K1 disagrees at m={m} P={P} n={n} "
                                 f"nodes={nodes} (launches {nl}/{groups})")
        live = torch.zeros((P, nodes), dtype=torch.uint8, device=dev)
        live.scatter_(1, args[1].long().clamp(max=nodes - 1), 1)
        for masked in (False, True):
            fm = (torch.from_numpy(rng.random((P, d)) < 0.5).to(dev)
                  if masked else None)
            kw = dict(reg_lambda=1e-6, min_child_weight=2.0, min_gain=0.0,
                      min_gain_norm=0.001, feature_mask=fm, level=3,
                      active_depth=[12] * P)
            for lv, name in ((None, "split_search"),
                             (live, "split_search_live")):
                (f, bb), nl = launched(pt, name, lambda: pt.split_search(
                    hg, hh, b, live=lv, **kw))
                wf, wb = pt.split_search_plain(hg, hh, b, live=lv, **kw)
                f2, b2 = pt.split_search(hg, hh, b, live=lv, **kw)
                if not (nl == 1 and torch.equal(f, wf) and torch.equal(bb, wb)
                        and torch.equal(f, f2) and torch.equal(bb, b2)):
                    raise AssertionError(f"K2 disagrees at m={m} P={P} n={n} "
                                         f"masked={masked} live={lv is not None}")
    return {"cases": len(MANY_CHANNEL_CASES), "channels": [5, 7, 12],
            "tolerance": "equal"}


def k10_hostile_wire(rng, leaves, n, bits, dev):
    """A wire tree of `leaves` jobs on the card, cycling through: a 1-D
    leaf (d = 1), a mask, widths 2, 5 and 33 (odd: the 4-bit scalar
    path), an empty leaf (d = 0), and unaligned views (q one byte past an
    aligned address, scale and lo one float past)."""
    def wire(d, one_d=False, unaligned=False):
        width = (d + 1) // 2 if bits == 4 else d
        q = torch.from_numpy(rng.integers(0, 256, (n, width)).astype(
            np.uint8)).to(dev)
        if bits == 4 and d % 2:  # the padding nibble of an odd row is 0
            q[:, -1] &= 0x0F
        scale = torch.from_numpy(rng.uniform(0.01, 3, d).astype(
            np.float32)).to(dev)
        lo = torch.from_numpy((rng.normal(size=d) * 40).astype(
            np.float32)).to(dev)
        if unaligned:
            q, scale, lo = misaligned(q), misaligned(scale), misaligned(lo)
        return {("q1" if one_d else "q"): q, "scale": scale, "lo": lo}

    kinds = [lambda: wire(1, one_d=True),
             lambda: torch.from_numpy((rng.random(n) < 0.5).astype(
                 np.uint8)).to(dev),
             lambda: wire(2), lambda: wire(5), lambda: wire(33),
             lambda: wire(0), lambda: wire(7, unaligned=True),
             lambda: wire(1, one_d=True, unaligned=True)]
    return {f"L{i:03d}": kinds[i % len(kinds)]() for i in range(leaves)}


def k10_hostile_check(pc, pt, dev) -> dict:
    """K10 on every `K10_HOSTILE_CASES` wire at 8 and 4 bits: equal to its
    plain version, one launch a 48 leaves with work, the same bits on a
    second call."""
    max_leaves = 48
    for L, n in K10_HOSTILE_CASES:
        for bits in (8, 4):
            wire = k10_hostile_wire(np.random.default_rng(L * 10 + n + bits),
                                    L, n, bits, dev)
            work = sum(1 for v in wire.values()
                       if (v.numel() if isinstance(v, torch.Tensor)
                           else v["scale"].numel()) * n > 0)
            got, nl = launched(pt, "wire_dequant",
                               lambda: pc.dequantize_wire(wire, bits))
            want = pc.dequantize_wire_plain(wire, bits)
            if not (nl == -(-work // max_leaves) and tree_equal(got, want)
                    and tree_equal(got, pc.dequantize_wire(wire, bits))):
                raise AssertionError(f"K10 disagrees at {L} leaves, n={n}, "
                                     f"{bits} bits (launches {nl})")
    return {"cases": 2 * len(K10_HOSTILE_CASES), "tolerance": "equal"}


class ChannelLog:
    """Within a `with` block, the channel counts that reach K1 and K2 (m)
    and the class counts that reach K8-mc (k), and K8-mc's inputs, by
    wrapping the port's public entry points (the wrappers count the
    launches as before)."""

    def __init__(self, keep_confusion: int = 0):
        self.m_hist, self.m_split, self.k_conf = set(), set(), set()
        self.confusion = []
        self._keep = keep_confusion

    def __enter__(self):
        from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
        from transmogrifai_tpu_torch.models import trees as ptr
        self._saved = [(ptr, "histograms", ptr.histograms),
                       (ptr, "split_search", ptr.split_search),
                       (pdm, "confusion_counts", pdm.confusion_counts)]

        def hist(Xb, node, G, H, *a, **k):
            self.m_hist.add(int(G.shape[1]))
            return self._saved[0][2](Xb, node, G, H, *a, **k)

        def split(hg, *a, **k):
            self.m_split.add(int(hg.shape[1]))
            return self._saved[1][2](hg, *a, **k)

        def conf(y, pred, mask, k):
            self.k_conf.add(int(k))
            if len(self.confusion) < self._keep:
                self.confusion.append((y, pred, mask, k))
            return self._saved[2][2](y, pred, mask, k)
        ptr.histograms, ptr.split_search, pdm.confusion_counts = \
            hist, split, conf
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class ForestCalls:
    """Within a `with` block, every `fit_forest` call of the sweep and of
    the estimators, its arguments and its tables, kept on the host."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from transmogrifai_tpu_torch.models import trees as ptr
        from transmogrifai_tpu_torch.parallel import sweep as psw
        self._orig = ptr.fit_forest

        def record(*args, **kw):
            out = self._orig(*args, **kw)
            self.calls.append((
                [a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in args],
                {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in kw.items()},
                {k: v.cpu() for k, v in out.items()}))
            return out
        self._mods = (ptr, psw)
        for mod in self._mods:
            mod.fit_forest = record
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.fit_forest = self._orig


def numpy_forest_draws(seed: int, n_trees: int, n: int, d: int):
    """Forest draws from numpy alone, a function of (seed, n_trees, n, d):
    Poisson(1) bootstrap counts and ⌊√d⌋ features a tree, the same on the
    card and on the CPU."""
    rng = np.random.default_rng([seed, n_trees, n, d])
    boot = rng.poisson(1.0, (n_trees, n)).astype(np.uint8)
    scores = rng.random((n_trees, d))
    k = max(int(np.sqrt(d)), 1)
    mask = scores <= np.sort(scores, axis=1)[:, k - 1:k]
    return boot, mask


def class_synthetic(port, seed: int, rows: int, d: int, k: int):
    """A seeded k-class table: d real features, the class the argmax of
    a random linear score plus noise, as text labels "c0".."c{k-1}" (the
    examples' `.indexed()` label); (dataset, label, predictors)."""
    import transmogrifai_tpu_torch.types as t
    X, y = class_arrays(seed, rows, d, k)
    cols = {f"x{j:02d}": X[:, j].astype(np.float64) for j in range(d)}
    cols["label"] = np.array([f"c{int(v)}" for v in y], dtype=object)
    schema = {c: t.Real for c in cols}
    schema["label"] = t.Text
    ds = port.Dataset.from_columns(cols, schema=schema)
    FB = port.FeatureBuilder
    preds = [FB.Real(c).from_column(c).as_predictor() for c in cols
             if c != "label"]
    label = FB.Text("label").from_column("label").as_response().indexed()
    return ds, label, preds


def class_selector_train(port, ds, label, preds, models, device):
    """The multiclass selector (train/validation split) over `models`
    (its default with None), trained with `Workflow.train`."""
    checked = label.sanity_check(port.transmogrify(preds),
                                 remove_bad_features=True)
    pred = port.MultiClassificationModelSelector.with_train_validation_split(
        models=models).set_input(label, checked).get_output()
    return port.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device=device)


# the many-class phases' sizes: the default selector at 7 classes (every
# forest table replayed on the host CPU, which bounds the rows), the
# multinomial LR alone at 40 classes
SEVEN_CLASS = {"rows": 4000, "d": 20, "k": 7}
FORTY_CLASS = {"rows": 20000, "d": 48, "k": 40}


def forest_tables_equal(calls):
    """Each recorded `fit_forest` call refitted on the host CPU with the
    same (numpy) draws: {"calls", "trees", "equal"}."""
    from transmogrifai_tpu_torch.models import trees as ptr
    equal, trees = True, 0
    with ptr.injected_forest_draws(numpy_forest_draws):
        for args, kw, out in calls:
            again = ptr.fit_forest(*args, **kw)
            trees += int(out["feat"].shape[0] * out["feat"].shape[1])
            equal = equal and all(torch.equal(out[k], again[k])
                                  for k in ("feat", "bin", "leaf"))
    return {"calls": len(calls), "trees": trees, "equal": bool(equal)}


def many_class_phase(port, pt, device="cuda", seven=None,
                     forty=None) -> dict:
    """F15 and F16 on the main path. (1) The default
    `MultiClassificationModelSelector` (LR 8 + RF 18 configs) trained over
    a seeded 7-class synthetic with numpy forest draws injected: K1 and K2
    reach m = 7 and K8-mc k = 7, every kernel of the path launched, and
    every forest table of the sweep and the refit equal to the port's own
    CPU refit of the same call; scored, saved, reloaded (equal). (2) A
    7-class `OpDecisionTreeClassifier` fitted on the card and on the CPU:
    trees equal. (3) The multinomial LR family alone over a 40-class
    synthetic: K8-mc reaches k = 40, its first calls held to the plain
    version (equal, 0/1 masks), validation F1 finite, holdout F1 printed.
    The launch counters are set to 0 before (1) and read after its
    reload."""
    import tempfile
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
    from transmogrifai_tpu_torch.stages.base import FitContext
    seven = seven or SEVEN_CLASS
    forty = forty or FORTY_CLASS
    ds, label, preds = class_synthetic(port, 70, seven["rows"], seven["d"],
                                       seven["k"])
    pt.reset_launches()
    t0 = time.perf_counter()
    with ChannelLog() as log7, ForestCalls() as fc, \
            pt.injected_forest_draws(numpy_forest_draws):
        model = class_selector_train(port, ds, label, preds, None, device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    path = tempfile.mkdtemp(prefix="port_seven_class_")
    model.save(path)
    again = prediction_of(port.load_model(path, device=device)
                          .score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}
    summ = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results")).summary
    t1 = time.perf_counter()
    tables = forest_tables_equal(fc.calls)
    replay_s = time.perf_counter() - t1
    needed = EXAMPLE_KERNELS["iris"]
    missing = [k for k in needed if launches.get(k, 0) < 1] \
        if device == "cuda" else []
    reload_equal = all(np.array_equal(scores[k], again[k])
                       for k in ("prediction", "rawPrediction",
                                 "probability"))
    # (2) a 7-class decision tree, card against CPU
    X, y = class_arrays(70, seven["rows"], seven["d"], seven["k"])
    dt = dict(max_depth=10, min_info_gain=0.001, min_instances_per_node=5.0)
    fits = {}
    for dev_ in dict.fromkeys((device, "cpu")):
        with ChannelLog() as log_dt:
            fits[dev_] = port.OpDecisionTreeClassifier(**dt).fit_arrays(
                torch.from_numpy(X).to(dev_), torch.from_numpy(y).to(dev_),
                torch.ones(len(y), device=dev_),
                FitContext(n_rows=len(y), seed=3, device=dev_))
    tree_equal_ = all(np.array_equal(fits[device].trees[k],
                                     fits["cpu"].trees[k])
                      for k in ("feat", "bin", "leaf"))
    rec7 = {"rows": seven["rows"], "d": seven["d"], "classes": seven["k"],
            "configs": len(summ.validation_results),
            "best_model": summ.best_model, "best_grid": summ.best_grid,
            "validation_f1": [r.fold_metrics[0]
                              for r in summ.validation_results],
            "holdout_metrics": summ.holdout_metrics,
            "channels_k1": sorted(log7.m_hist),
            "channels_k2": sorted(log7.m_split),
            "classes_k8mc": sorted(log7.k_conf),
            "forest_tables": tables, "replay_s": replay_s,
            "reload_scores_equal": reload_equal,
            "decision_tree": {"params": dt, "tables_equal_cpu": tree_equal_,
                              "channels": sorted(log_dt.m_hist)},
            "launches_main_path": launches, "missing_kernels": missing,
            "wall_s": {"train": train_s, "sweep": summ.timings["sweep_s"],
                       "sweep_by_family": summ.timings["families"],
                       "refit": summ.timings["refit_s"]}}
    ok7 = (7 in log7.m_hist and 7 in log7.m_split and 7 in log7.k_conf
           and tables["equal"] and tables["calls"] >= 1
           and reload_equal and tree_equal_ and not missing
           and all(np.isfinite(scores[k]).all() for k in scores))
    # (3) the multinomial LR alone at 40 classes
    from transmogrifai_tpu_torch.selector.model_selector import _lr_grid
    ds40, label40, preds40 = class_synthetic(port, 40, forty["rows"],
                                             forty["d"], forty["k"])
    t0 = time.perf_counter()
    with ChannelLog(keep_confusion=2) as log40:
        m40 = class_selector_train(
            port, ds40, label40, preds40,
            [(port.OpLogisticRegression(max_iter=50), _lr_grid())], device)
    sync(device)
    s40 = next(s for s in m40.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results")).summary
    conf_equal = all(torch.equal(pdm.confusion_counts(*c),
                                 pdm.confusion_counts_plain(*c))
                     for c in log40.confusion)
    f1 = [r.fold_metrics[0] for r in s40.validation_results]
    rec40 = {"rows": forty["rows"], "d": forty["d"], "classes": forty["k"],
             "classes_k8mc": sorted(log40.k_conf),
             "confusion_calls_checked": len(log40.confusion),
             "confusion_equal_plain": conf_equal, "validation_f1": f1,
             "holdout_metrics": s40.holdout_metrics,
             "train_s": time.perf_counter() - t0}
    ok40 = (log40.k_conf == {forty["k"]} and conf_equal
            and len(log40.confusion) >= 1
            and all(np.isfinite(v) and 0 <= v <= 1 for v in f1))
    record = {"phase": "many_classes", "seven_classes": rec7,
              "forty_classes_lr": rec40, "ok": bool(ok7 and ok40)}
    emit(record)
    if not record["ok"]:
        raise AssertionError("the many-class phase failed")
    return record


def class_arrays(seed: int, rows: int, d: int, k: int):
    """`class_synthetic`'s features and classes as arrays (f32 X, f32 y
    in 0..k-1, as the estimators take them)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    W = rng.normal(size=(d, k)).astype(np.float32)
    score = X @ W + rng.gumbel(size=(rows, k)).astype(np.float32) * 0.5
    return X, np.argmax(score, axis=1).astype(np.float32)


def three_class_level(pt, rng, dev):
    """K1 (m = 3, the rows routed right grouped by their 1024 level-10
    parents), K1-sub, K2 (m = 3) over 2048 nodes and K3 routing and leaves
    (m = 3, 4096 leaves) at level 11 of the Iris depth-12 bucket: one
    chunk of its 300 trees (6 configs x 50 trees) as `fit_forest` sizes
    it, grown by the port to depth 11 on a seeded 135 x 3 binned matrix
    with three classes; each kernel against its plain version on the whole
    chunk (class counts: equal)."""
    n, d, B = 135, 3, FIT_BINS
    Pc, budget, per_tree = pt.forest_chunk(300, 12, 3, n, d, B, dev)
    Xb = torch.from_numpy(rng.integers(0, B, (n, d)).astype(np.int8)).to(dev)
    y = torch.clamp((Xb[:, 0].long() + torch.from_numpy(
        rng.integers(0, B, n)).to(dev)) * 3 // (2 * B), max=2)
    Y = torch.nn.functional.one_hot(y, 3).float()
    boot, fmask = pt.forest_draws(Pc, n, d, seed=12, device=dev)
    H = boot.contiguous()
    G = (Y.T[None] * H[:, None, :]).contiguous()
    _, node11 = pt.grow_trees(Xb, G, H, 11, B, reg_lambda=1e-6,
                              min_child_weight=1.0, feature_mask=fmask)
    parent = torch.where((node11 & 1).bool(), node11 >> 1,
                         torch.full_like(node11, 1024))
    hg_r, hh_r = pt.histograms(Xb, parent, G, H, 1024, B)
    hg10, hh10 = pt.histograms(Xb, node11 >> 1, G, H, 1024, B)
    want_hist = (*pt.histograms_plain(Xb, parent, G, H, 1024, B),
                 *pt.histograms_plain(Xb, node11 >> 1, G, H, 1024, B))
    cg, ch = pt.sibling_subtract(hg10, hh10, hg_r, hh_r)
    kw = dict(reg_lambda=1e-6, min_child_weight=1.0, min_gain=0.0,
              min_gain_norm=0.0, feature_mask=fmask, level=11,
              active_depth=12)
    f, b = pt.split_search(cg, ch, B, **kw)
    node12 = pt.route_level(Xb, node11, f, b)
    leaf = pt.leaf_values(node12, G, H, 4096, 1e-6, 0.0)
    torch.cuda.synchronize()
    checks = {
        "histograms": all(torch.equal(a, c) for a, c in zip(
            (hg_r, hh_r, hg10, hh10), want_hist)),
        "sibling_subtract": all(torch.equal(a, c) for a, c in zip(
            (cg, ch), pt.sibling_subtract_plain(hg10, hh10, hg_r, hh_r))),
        "split_search": all(torch.equal(a, c) for a, c in zip(
            (f, b), pt.split_search_plain(cg, ch, B, **kw))),
        "route_level": torch.equal(node12, pt.route_level_plain(
            Xb, node11, f, b)),
        "leaf_values": torch.equal(leaf.cpu(), pt.leaf_values_plain(
            node12.cpu(), G.cpu(), H.cpu(), 4096, 1e-6, 0.0))}
    record = {"shape": {"pairs": Pc, "rows": n, "d": d, "bins": B,
                        "channels": 3, "parents_level10": 1024,
                        "nodes_level11": 2048, "leaves": 4096},
              "chunk": {"budget_bytes": budget, "bytes_per_tree": per_tree,
                        "k1_features_lanes": pt._hist_layout(
                            B, 3, d % 4 == 0, n / 1024)},
              "splits_level11": int((b < B).sum()), "equal": checks,
              "tolerance": "equal (class counts; leaves bit-equal to the "
                           "CPU's row-order sums)"}
    if not all(checks.values()):
        raise AssertionError(f"a kernel at m = 3 disagrees: {checks}")
    return record


def example_pipeline(port, example: str, models=None):
    """The example's program (examples/op_iris_simple.py,
    examples/op_boston_simple.py) with the port's entry points and the
    selector over `models` (its default with None): (dataset, label,
    prediction)."""
    import transmogrifai_tpu_torch.types as t
    FB = port.FeatureBuilder
    if example == "iris":
        schema = {"id": t.Integral, "sepalLength": t.Real,
                  "sepalWidth": t.Real, "petalLength": t.Real,
                  "petalWidth": t.Real, "irisClass": t.Text}
        preds = [FB.Real(c).from_column(c).as_predictor() for c in (
            "sepalLength", "sepalWidth", "petalLength", "petalWidth")]
        label = FB.Text("irisClass").from_column("irisClass") \
            .as_response().indexed()
        selector = port.MultiClassificationModelSelector
    else:
        schema = {c: t.RealNN for c in (
            "crim", "zn", "indus", "nox", "rm", "age", "dis", "tax",
            "ptratio", "b", "lstat", "medv")}
        schema.update(rowId=t.Integral, chas=t.PickList, rad=t.Integral)
        kinds = {"chas": "PickList", "rad": "Integral"}
        preds = [getattr(FB, kinds.get(c, "RealNN"))(c).from_column(c)
                 .as_predictor() for c in (
                     "crim", "zn", "indus", "chas", "nox", "rm", "age",
                     "dis", "rad", "tax", "ptratio", "b", "lstat")]
        label = FB.RealNN("medv").from_column("medv").as_response()
        selector = port.RegressionModelSelector
    ds = port.Dataset.from_csv(os.path.join(EXAMPLES, f"{example}.csv"),
                               schema=schema)
    checked = label.sanity_check(port.transmogrify(preds),
                                 remove_bad_features=True)
    pred = selector.with_train_validation_split(models=models) \
        .set_input(label, checked).get_output()
    return ds, label, pred


def titanic_age_group(v):
    """`age_group`'s function in examples/op_titanic_simple.py, at module
    level so that a model using it can be saved: registered as
    "titanic_age_group" with each package's `extract_fn`."""
    return None if v is None else ("adult" if v > 18 else "child")


def titanic_simple_schema(t):
    """examples/op_titanic_simple.py's SCHEMA over the types module `t`."""
    return {
        "id": t.Integral, "survived": t.Integral, "pClass": t.PickList,
        "name": t.Text, "sex": t.PickList, "age": t.Real,
        "sibSp": t.Integral, "parCh": t.Integral, "ticket": t.PickList,
        "fare": t.Real, "cabin": t.PickList, "embarked": t.PickList}


def wire_digest(trees) -> str:
    """sha256 over the host leaves of quantized wire trees (the values
    `quantize_wire` returned, in call order): each numpy leaf's key path,
    dtype, shape and bytes, keys in sorted order. Leaves already on the
    device pass through the wire and are not part of it."""
    import hashlib
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, np.ndarray):
            h.update(f"{path}:{node.dtype}:{node.shape}".encode())
            h.update(np.ascontiguousarray(node).tobytes())
    for tree in trees:
        walk(tree, "")
    return h.hexdigest()


def titanic_simple_pipeline(ns, models=None, age_group=None):
    """examples/op_titanic_simple.py's `build_pipeline` and schema over the
    package namespace `ns` (t, FeatureBuilder, transmogrify, Dataset, ms):
    the same raw features, derived features and selector, with `models`
    in place of the default grids when given and `age_group` in place of
    the example's lambda when given. Returns (dataset, survived,
    prediction)."""
    t = ns.t
    ds = ns.Dataset.from_csv(TITANIC, schema=titanic_simple_schema(t))
    FB = ns.FeatureBuilder
    survived = FB.RealNN("survived").from_column("survived").as_response()
    pclass = FB.PickList("pClass").from_column("pClass").as_predictor()
    name = FB.Text("name").from_column("name").as_predictor()
    sex = FB.PickList("sex").from_column("sex").as_predictor()
    age = FB.Real("age").from_column("age").as_predictor()
    sibsp = FB.Integral("sibSp").from_column("sibSp").as_predictor()
    parch = FB.Integral("parCh").from_column("parCh").as_predictor()
    ticket = FB.PickList("ticket").from_column("ticket").as_predictor()
    fare = FB.Real("fare").from_column("fare").as_predictor()
    cabin = FB.PickList("cabin").from_column("cabin").as_predictor()
    embarked = FB.PickList("embarked").from_column("embarked") \
        .as_predictor()
    family_size = (sibsp + parch + 1).alias("familySize")
    estimated_cost = (family_size * fare).alias("estimatedCostOfTickets")
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    age_group = age.map_values(
        age_group if age_group is not None else
        (lambda v: None if v is None else ("adult" if v > 18 else "child")),
        t.PickList)
    features = ns.transmogrify([
        pclass, name, age, sibsp, parch, ticket, cabin, embarked,
        family_size, estimated_cost, pivoted_sex, age_group, normed_age])
    checked = survived.sanity_check(features, remove_bad_features=True)
    prediction = ns.ms.BinaryClassificationModelSelector \
        .with_train_validation_split(models=models) \
        .set_input(survived, checked).get_output()
    return ds, survived, prediction


SIMPLE_FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                              "titanic_simple_f32")
# the families the script's default selector must sweep, and the raw
# features of which one must rank in the model's top six insights
SIMPLE_FAMILIES = ("OpLogisticRegression", "OpRandomForestClassifier",
                   "OpXGBoostClassifier")
SIMPLE_INSIGHTS = ("sex", "estimatedCostOfTickets", "familySize")
# tests/test_examples.py's bands for the script's holdout
SIMPLE_BANDS = (("AuPR", 0.78, True), ("AuROC", 0.80, True),
                ("Error", 0.25, False))
SIMPLE_KERNELS = DEFAULT_KERNELS


def port_namespace(port):
    """The package namespace `titanic_simple_pipeline` reads, of the
    port."""
    from types import SimpleNamespace

    import transmogrifai_tpu_torch.types as t
    from transmogrifai_tpu_torch.selector import model_selector as ms
    return SimpleNamespace(t=t, FeatureBuilder=port.FeatureBuilder,
                           transmogrify=port.transmogrify,
                           Dataset=port.Dataset, ms=ms)


def judge_titanic_simple(model, want, want_arr):
    """The script's run held to the JAX package's fixture: (record, ok).
    The same configs; kept columns and winner equal; validation AuPR
    within DEFAULT_FOLD_ATOL of its family; the holdout in SIMPLE_BANDS
    and its AuPR within DEFAULT_HOLDOUT_ATOL;
    the three default families swept; a sex, fare or family feature in
    the top six insights."""
    best = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = best.summary
    checker = fitted_of(model, "SanityCheckerModel")
    results = [{"model": r.model, "grid": r.grid}
               for r in summ.validation_results]
    fam = [r["model"] for r in results]
    got_m = np.array([r.fold_metrics[0] for r in summ.validation_results])
    want_m = np.array([f[0] for f in want["fold_metrics"]])
    err = (np.abs(got_m - want_m) if results == want["results"]
           else np.full(len(fam), np.inf))
    err_by_family = {f: float(max(e for e, g in zip(err, fam) if g == f))
                     for f in dict.fromkeys(fam)}
    hold = summ.holdout_metrics
    bands = {m: {"value": hold[m], "bound": b, "ok": bool(
        hold[m] >= b if up else hold[m] <= b)} for m, b, up in SIMPLE_BANDS}
    ranked = sorted(model.model_insights().features,
                    key=lambda f: -f.importance)
    top6 = [f.name for f in ranked[:6]]
    checks = {
        "configs_equal": results == want["results"],
        "kept_equal": checker.indices == want_arr["kept_indices"].tolist(),
        "winner_equal": (summ.best_model == want["best_model"]
                         and summ.best_grid == want["best_grid"]),
        "fold_metrics_within_tolerance": all(
            e <= DEFAULT_FOLD_ATOL[f] for e, f in zip(err, fam)),
        "holdout_aupr_within_tolerance": abs(
            hold["AuPR"] - want["holdout_metrics"]["AuPR"])
        <= DEFAULT_HOLDOUT_ATOL,
        "holdout_bands": all(b["ok"] for b in bands.values()),
        "default_families_swept": set(fam) == set(SIMPLE_FAMILIES),
        "insight_in_top6": any(n in top6 for n in SIMPLE_INSIGHTS)}
    record = {
        "configs": len(results), "kept_columns": len(checker.indices),
        "best_model": summ.best_model, "best_grid": summ.best_grid,
        "validation_aupr_err_by_family": err_by_family,
        "tolerance": {"fold_aupr_atol": DEFAULT_FOLD_ATOL,
                      "holdout_aupr_atol": DEFAULT_HOLDOUT_ATOL,
                      "bands": {m: b for m, b, _ in SIMPLE_BANDS}},
        "holdout_metrics": hold, "holdout_metrics_jax":
        want["holdout_metrics"], "bands": bands, "insights_top6": top6,
        "insights_top6_jax": [n for n, _ in want["insights_top"][:6]],
        **checks}
    return record, all(checks.values())


def titanic_simple_train(port, pt, device="cuda"):
    """Phase 19: examples/op_titanic_simple.py through the port's entry
    points (its lambda `age_group` included) with the JAX package's forest
    draws injected, held to `testdata/titanic_simple_f32`
    (`judge_titanic_simple`); then scored, and its save refused (the
    lambda, F8). The launch counters cover exactly this run."""
    import tempfile

    with open(os.path.join(SIMPLE_FIXTURE, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(SIMPLE_FIXTURE, "scores.npz")) as z:
        want_arr = {k: z[k] for k in z.files}
    plans = ForestPlans()
    pt.reset_launches()
    t0 = time.perf_counter()
    ds, label, pred = titanic_simple_pipeline(port_namespace(port))
    with pt.injected_forest_draws((want_arr["forest_boot"],
                                   want_arr["forest_mask"])), plans:
        model = port.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device=device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}
    try:
        model.save(os.path.join(tempfile.mkdtemp(prefix="port_simple_"),
                                "model"))
        save_refused = False
    except ValueError:
        save_refused = True
    record, ok = judge_titanic_simple(model, want, want_arr)
    summ = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results")).summary
    stage = dict(model.stage_seconds)
    missing = [k for k in SIMPLE_KERNELS if launches[k] < 1]
    shape_ok = (scores["probability"].shape == (len(ds), 2)
                and all(np.isfinite(scores[k]).all() for k in scores))
    ok = ok and save_refused and shape_ok and not missing
    record = {
        "phase": "titanic_simple_train", "rows": len(ds), **record,
        "save_refused_lambda": save_refused,
        "launches_main_path": launches, "missing_kernels": missing,
        "forest_chunks": plans.messages,
        "wall_s": {"train": train_s,
                   "feature_fit": sum(
                       v for k, v in model.stage_seconds
                       if k not in ("SanityChecker", "ModelSelector")),
                   "sanity_checker": stage.get("SanityChecker"),
                   "selector": stage.get("ModelSelector"),
                   "sweep": summ.timings["sweep_s"],
                   "sweep_by_family": summ.timings["families"],
                   "refit": summ.timings["refit_s"]},
        "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError("examples/op_titanic_simple.py disagrees with "
                             "the JAX package's f32 fixture")
    return model, ds, record


# --------------------------------------------------------------------------- #
# quantized serving and CUDA graphs (K10, K4-f16, K5-narrow)                  #
# --------------------------------------------------------------------------- #

QUANT_MODES = ("int8", "int4", "int8-calibrated")
QUANT_BATCH = 64
QUANT_KERNELS = ("wire_dequant", "bin_features_f16", "tree_walk_narrow")
# the JAX package's quantized scores of the same saved model: both
# dequantize to the same values (K10 rounds as XLA's program does) and
# narrow the tables alike, so each mode is held to the serving tolerances
QUANT_TOL = {mode: {"rawPrediction": 2e-5, "probability": 1e-5}
             for mode in QUANT_MODES}
SERVE_BUCKETS = (1, 8, 64)


def register_age_group():
    """`titanic_age_group` in the port's `extract_fn` registry, so the
    script's saved model loads."""
    from transmogrifai_tpu_torch.utils import fnser
    if "titanic_age_group" not in fnser._EXTRACT_REGISTRY:
        fnser.extract_fn("titanic_age_group")(titanic_age_group)


def quant_fixture(port, which):
    """(saved model dir, quant_scores.npz, scoring dataset) of the
    script's JAX-trained model ("simple") or the quickstart GBT ("gbt")."""
    if which == "simple":
        ns = port_namespace(port)
        return (os.path.join(SIMPLE_FIXTURE, "model"),
                os.path.join(SIMPLE_FIXTURE, "quant_scores.npz"),
                port.Dataset.from_csv(TITANIC,
                                      schema=titanic_simple_schema(ns.t)))
    return (FIXTURE, os.path.join(FIXTURE, "quant_scores.npz"),
            port.Dataset.from_csv(TITANIC))


def raw_host_tree(model, ds, n):
    """The host values of the model's raw numeric columns, rows tiled to
    n: the leaves the quantized wire carries."""
    scorer = model._ensure_compiled()
    tree = {}
    for gen in scorer.generators:
        c = gen.materialize(ds, allow_missing_response=True)
        hv = c.host_value() if c.kind not in ("text", "list", "map") \
            else None
        if hv is not None:
            idx = np.arange(n) % len(ds)
            tree[gen.get_output().uid] = {k: v[idx] for k, v in hv.items()}
    return tree


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def wire_bytes(tree) -> int:
    """Bytes K10 must move for a wire tree: each wire byte, scale and lo
    read once, each f32 output written once."""
    if isinstance(tree, dict):
        if "scale" in tree:
            q = tree["q1"] if "q1" in tree else tree["q"]
            n, d = q.shape[0], tree["scale"].numel()
            return q.numel() + 8 * d + 4 * n * d
        return sum(wire_bytes(v) for v in tree.values())
    return tree.numel() * 5 if isinstance(tree, torch.Tensor) else 0


def wire_elements(tree) -> int:
    if isinstance(tree, dict):
        if "scale" in tree:
            q = tree["q1"] if "q1" in tree else tree["q"]
            return q.shape[0] * tree["scale"].numel()
        return sum(wire_elements(v) for v in tree.values())
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


def quant_kernel_check(port, pt, pc, rng, dev):
    """K10 on the script's raw columns (int8 and int4), K4-f16 on the
    Titanic GBT's edges and K5-narrow on its narrowed tables and on a
    narrowed depth-12 forest, each against its plain version on the card
    at n in SIZES: equal. Returns (record, cases for the timing)."""
    register_age_group()
    model_dir, _, ds = quant_fixture(port, "simple")
    simple = port.load_model(model_dir, device="cpu")
    gbt = next(s for s in port.load_model(FIXTURE, device="cpu")
               .fitted.values()
               if type(s).__name__ == "GBTClassificationModel")
    e16 = torch.from_numpy(gbt.edges).to(dev).half()
    tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in gbt.trees.items()}
    narrow = {"feat": tables["feat"].to(torch.int16),
              "bin": tables["bin"].to(torch.uint8), "leaf": tables["leaf"]}
    forest = {k: v.to(dev) for k, v in
              synthetic_forest(rng, gbt.edges.shape[0]).items()}
    forest_n = {"feat": forest["feat"].to(torch.int16),
                "bin": forest["bin"].to(torch.uint8), "leaf": forest["leaf"]}
    cases, checks = {}, {}
    for n in SIZES:
        for bits in (8, 4):
            wire = pc.to_device(pc.quantize_wire(
                raw_host_tree(simple, ds, n), bits), dev)
            got = pc.dequantize_wire(wire, bits)
            want = pc.dequantize_wire_plain(wire, bits)
            sync(dev)
            checks[f"wire_dequant:n{n}:int{bits}"] = tree_equal(got, want)
            cases[("wire_dequant", n, bits)] = wire
        X = torch.from_numpy(binning_input(rng, n, gbt.edges)).to(dev)
        Xb = pt.bin_features(X, e16)
        checks[f"bin_features_f16:n{n}"] = torch.equal(
            Xb, pt.bin_features_plain(X, e16))
        for label, t, tn in (("gbt_m1", tables, narrow),
                             ("forest_m2_depth12", forest, forest_n)):
            args = (Xb, tn["feat"], tn["bin"], tn["leaf"])
            got = pt.tree_walk(*args)
            checks[f"tree_walk_narrow:{label}:n{n}"] = torch.equal(
                got, pt.tree_walk_plain(*args)) and torch.equal(
                got, pt.tree_walk(Xb, t["feat"], t["bin"], t["leaf"]))
        sync(dev)
        cases[("bin_features_f16", n)] = (X, e16, Xb)
    cases["narrow"] = narrow
    bad = [k for k, v in checks.items() if not v]
    record = {"phase": "quant_kernels_check", "sizes": list(SIZES),
              "leaves": len(pc._flatten(cases[("wire_dequant", 1, 8)])),
              "tolerance": "equal", "failed": bad, "ok": not bad,
              "max_abs_err": 0.0 if not bad else None,
              "narrow_boundaries": walk_boundary_check(
                  pt, np.random.default_rng(20), dev, narrow=True)}
    emit(record)
    if bad:
        raise AssertionError(f"quantized-path kernels disagree: {bad}")
    return record, cases


def wrapper_host(fn, calls: int = 200) -> dict:
    """Where an eager wrapper's time goes: host ms a call (`calls` calls
    back to back, then one synchronize), and the functions that take most
    of it (cProfile, own time, ms a call)."""
    import cProfile
    import pstats
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:8]
    return {"host_ms": host, "top_own_ms": {
        f"{os.path.basename(k[0])}:{k[1]}:{k[2]}": v[2] / calls * 1e3
        for k, v in top}}


def time_quant_kernels(pt, pc, cases):
    """CUDA-event times of K10, K4-f16 and K5-narrow beside their bound,
    plain version and one-call yardstick, at n = 64 (a served bucket), 891
    and 65536. K10 and its plain version are timed as replays of a CUDA
    graph, as a served batch runs them (the eager wrapper's host work,
    `wrapper_ms`, dwarfs the launch); K4-f16 both ways (`k4_timing`)."""
    out = {}
    narrow = cases["narrow"]
    X1 = cases[("bin_features_f16", 1)][0]
    for n in (64, 891, 65536):
        k10 = {}
        for bits in (8, 4):
            wire = cases[("wire_dequant", n, bits)]
            nb = wire_bytes(wire)
            k10_bound, k10_by = bound(nb, 2 * wire_elements(wire))
            k10[bits] = {
                "ms": graph_ms(lambda: pc.dequantize_wire(wire, bits), 50),
                "plain_ms": graph_ms(
                    lambda: pc.dequantize_wire_plain(wire, bits), 20),
                "wrapper_ms": cuda_ms(
                    lambda: pc.dequantize_wire(wire, bits), 50),
                "wrapper_host": wrapper_host(
                    lambda: pc.dequantize_wire(wire, bits)),
                "library_ms": None, "bound_ms": k10_bound,
                "bound_by": k10_by, "bytes": nb}
        X, e16, Xb = cases[("bin_features_f16", n)]
        k4 = k4_timing(pt, X, e16, X1)
        k5 = k5_timing(pt, Xb, narrow["feat"], narrow["bin"],
                       narrow["leaf"])
        out[n] = {"wire_dequant": k10[8], "wire_dequant_int4": k10[4],
                  "bin_features_f16": k4, "tree_walk_narrow": k5}
        emit({"phase": "quant_timing", "n": n, **out[n]})
    return out


def quant_serving(port, pt, pc, device="cuda"):
    """Phase 20's main path: each fixture (the script's JAX-trained model,
    the quickstart GBT) loaded on the card and served in each quantized mode
    through `score_padded` with CUDA graphs, the 891 rows in batches of
    64: each batch's wire equal to the JAX package's (sha256), scores
    within QUANT_TOL, graph replay equal to eager scoring. The launch
    counters are set to 0 before and read after; K10, K4-f16 and
    K5-narrow must have launched (counted per replay)."""
    register_age_group()
    runs, eager = {}, {}
    loaded = {}
    for which in ("simple", "gbt"):
        model_dir, qpath, ds = quant_fixture(port, which)
        loaded[which] = (port.load_model(model_dir, device=device), ds,
                         qpath)
    seen, inner = [], pc.quantize_wire

    def recording(tree, bits, ranges=None):
        out = inner(tree, bits, ranges=ranges)
        seen.append(out)
        return out

    pt.reset_launches()
    pc.quantize_wire = recording
    try:
        for which, (model, ds, qpath) in loaded.items():
            with np.load(qpath) as z:
                want = {k: z[k] for k in z.files}
            for mode in QUANT_MODES:
                scorer = pc.CompiledScorer(model, quant=mode)
                parts, digests = [], []
                for s in range(0, len(ds), QUANT_BATCH):
                    seen.clear()
                    parts.append(prediction_of(scorer.score_padded(
                        ds.take(np.arange(s, min(s + QUANT_BATCH, len(ds)))),
                        QUANT_BATCH)))
                    digests.append(wire_digest(seen))
                got = {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]}
                tol = QUANT_TOL[mode]
                raw_err = float(np.abs(got["rawPrediction"] - want[
                    f"{mode}:rawPrediction"]).max())
                prob_err = float(np.abs(got["probability"] - want[
                    f"{mode}:probability"]).max())
                decided = np.abs(want[f"{mode}:rawPrediction"][:, -1]) > 1e-4
                runs[f"{which}:{mode}"] = {
                    "wire_equal": digests == list(want[f"{mode}:wire_sha256"]),
                    "raw_max_abs_err": raw_err, "prob_max_abs_err": prob_err,
                    "prediction_mismatches": int((got["prediction"][decided]
                                                  != want[f"{mode}:prediction"]
                                                  [decided]).sum()),
                    "graphs": len(scorer._graph_cache),
                    "segments": sum(k == "device"
                                    for k, _ in scorer.segments),
                    "scores": got, "scorer": scorer}
                runs[f"{which}:{mode}"]["ok"] = bool(
                    runs[f"{which}:{mode}"]["wire_equal"]
                    and raw_err <= tol["rawPrediction"]
                    and prob_err <= tol["probability"]
                    and runs[f"{which}:{mode}"]["prediction_mismatches"] == 0
                    and np.isfinite(got["probability"]).all())
    finally:
        pc.quantize_wire = inner
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}
    # graph replay against eager scoring of the same batches (outside the
    # main path's counts)
    for key, r in runs.items():
        which, mode = key.split(":")
        model, ds, _ = loaded[which]
        e = pc.CompiledScorer(model, quant=mode, graphs=False)
        parts = [prediction_of(e.score_padded(
            ds.take(np.arange(s, min(s + QUANT_BATCH, len(ds)))),
            QUANT_BATCH)) for s in range(0, len(ds), QUANT_BATCH)]
        eager[key] = all(np.array_equal(
            np.concatenate([p[k] for p in parts]), r["scores"][k])
            for k in r["scores"])
        r["graph_equals_eager"] = eager[key]
        r["ok"] = r["ok"] and eager[key]
    missing = [k for k in QUANT_KERNELS if launches[k] < 1]
    ok = all(r["ok"] for r in runs.values()) and not missing
    emit({"phase": "quant_serving", "batch": QUANT_BATCH,
          "tolerance": QUANT_TOL,
          "runs": {k: {kk: v for kk, v in r.items()
                       if kk not in ("scores", "scorer")}
                   for k, r in runs.items()},
          "launches_main_path": launches, "missing_kernels": missing,
          "ok": bool(ok)})
    if not ok:
        raise AssertionError("quantized serving disagrees with the JAX "
                             "package's quantized scores")
    return launches, loaded


def serving_timing(port, pc, served):
    """`score_padded` at buckets 1, 8 and 64, with CUDA graphs and eagerly
    (a measurement only), f32 and int8, for each served model: wall ms per
    batch, the share of it inside device segments (`_dispatch`: the
    host→device copy, the replay or the eager launches, the output copies)
    and the device's busy share from `torch.profiler` over 10 batches."""
    out = {}
    for name, (model, ds) in served.items():
        for quant in (None, "int8"):
            for graphs in (True, False):
                scorer = pc.CompiledScorer(model, quant=quant, graphs=graphs)
                spent = []
                inner = scorer._dispatch

                def timed(*a, _inner=inner, **kw):
                    t = time.perf_counter()
                    r = _inner(*a, **kw)
                    torch.cuda.synchronize()
                    spent.append(time.perf_counter() - t)
                    return r
                for bucket in SERVE_BUCKETS:
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
                    scorer._dispatch = timed
                    spent.clear()
                    split = []
                    for _ in range(20):
                        t = time.perf_counter()
                        scorer.score_padded(sample, bucket)
                        torch.cuda.synchronize()
                        split.append(((time.perf_counter() - t) * 1e3,
                                      sum(spent) * 1e3))
                        spent.clear()
                    scorer._dispatch = inner
                    acts = [torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]
                    with torch.profiler.profile(activities=acts) as prof:
                        for _ in range(10):
                            scorer.score_padded(sample, bucket)
                        torch.cuda.synchronize()
                    dev_items = sorted(
                        ((e.key, e.self_device_time_total / 1e3 / 10)
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.self_device_time_total > 0),
                        key=lambda kv: -kv[1])
                    busy = sum(v for _, v in dev_items)
                    med = float(np.median(walls))
                    dev_ms = float(np.median([d for _, d in split]))
                    key = f"{name}:{quant or 'f32'}:" \
                          f"{'graph' if graphs else 'eager'}:{bucket}"
                    out[key] = {
                        "median_ms": med,
                        "p90_ms": float(np.percentile(walls, 90)),
                        "min_ms": float(np.min(walls)),
                        "device_segments_ms": dev_ms,
                        "host_ms": float(np.median([w - d
                                                    for w, d in split])),
                        "device_busy_ms": busy if dev_items
                        else "not measured",
                        "device_idle_share": (1 - busy / med) if dev_items
                        else "not measured",
                        "top_device_items_ms": dev_items[:5]}
                    emit({"phase": "serving_timing", "run": key,
                          **out[key]})
    return out


def example_train(port, pt, example: str, device="cuda"):
    """Train the example verbatim (the default selector) on the card with
    the JAX package's forest draws injected, hold it to the JAX package's
    f32-mode default sweep, save, reload, score; the launch counters cover
    exactly this run."""
    import tempfile

    fixture = EXAMPLE_FIXTURE[example]
    with open(os.path.join(fixture, "results.json")) as fh:
        want = json.load(fh)
    with np.load(os.path.join(fixture, "scores.npz")) as z:
        want_arr = {k: z[k] for k in z.files}
    plans = ForestPlans()
    pt.reset_launches()
    t0 = time.perf_counter()
    ds, label, pred = example_pipeline(port, example)
    with pt.injected_forest_draws((want_arr["forest_boot"],
                                   want_arr["forest_mask"])), plans:
        model = port.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device=device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    path = tempfile.mkdtemp(prefix=f"port_{example}_model_")
    model.save(path)
    again = prediction_of(port.load_model(path, device=device)
                          .score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}

    best = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = best.summary
    checker = fitted_of(model, "SanityCheckerModel")
    results = [{"model": r.model, "grid": r.grid}
               for r in summ.validation_results]
    if results != want["results"]:
        raise AssertionError(f"the {example} sweep ran other configs than "
                             "the fixture's")
    got_m = np.array([r.fold_metrics[0] for r in summ.validation_results])
    want_m = np.array([f[0] for f in want["fold_metrics"]])
    fam = [r["model"] for r in results]
    hold, hold_w = summ.holdout_metrics, want["holdout_metrics"]
    if example == "iris":
        err = np.abs(got_m - want_m)
        metric_ok = bool((err <= IRIS_F1_ATOL).all())
        band_ok = hold["F1"] >= 0.80
        extra = {"labels_equal": fitted_of(model, "StringIndexerModel")
                 .labels == want["labels"],
                 "probability_max_abs_err_vs_jax": float(np.abs(
                     scores["probability"] - want_arr["probability"]).max()),
                 "prediction_mismatches_vs_jax": int(
                     (scores["prediction"] != want_arr["prediction"]).sum())}
        band_ok = band_ok and extra["labels_equal"]
        shape_ok = scores["probability"].shape == (150, 3)
        tol = {"validation_f1_atol": IRIS_F1_ATOL, "holdout_f1_min": 0.80}
    else:
        err = np.abs(got_m - want_m) / np.abs(want_m)
        metric_ok = all(e <= BOSTON_RMSE_RTOL[f] for e, f in zip(err, fam))
        hold_err = abs(hold["RMSE"] - hold_w["RMSE"]) / hold_w["RMSE"]
        band_ok = (hold["RMSE"] <= 6.0 and hold["R2"] >= 0.6
                   and hold_err <= BOSTON_HOLDOUT_RTOL)
        extra = {"holdout_rmse_rel_err": hold_err,
                 "prediction_max_rel_err_vs_jax": float(np.abs(
                     scores["prediction"] - want_arr["prediction"]).max()
                     / np.abs(want_arr["prediction"]).max())}
        shape_ok = (scores["prediction"].shape == (333,)
                    and scores["probability"].shape == (333, 0))
        tol = {"validation_rmse_rtol": BOSTON_RMSE_RTOL,
               "holdout_rmse_rtol": BOSTON_HOLDOUT_RTOL,
               "holdout_rmse_max": 6.0, "holdout_r2_min": 0.6}
    err_by_family = {f: float(max(e for e, g in zip(err, fam) if g == f))
                     for f in dict.fromkeys(fam)}
    winner_equal = (summ.best_model == want["best_model"]
                    and summ.best_grid == want["best_grid"])
    reload_equal = all(np.array_equal(scores[k], again[k])
                       for k in ("prediction", "rawPrediction",
                                 "probability"))
    kept_equal = checker.indices == want_arr["kept_indices"].tolist()
    stage = dict(model.stage_seconds)
    feature_fit = sum(v for k, v in model.stage_seconds
                      if k not in ("SanityChecker", "ModelSelector"))
    missing = [k for k in EXAMPLE_KERNELS[example] if launches[k] < 1]
    ok = (winner_equal and metric_ok and band_ok and reload_equal
          and kept_equal and shape_ok and not missing
          and all(np.isfinite(scores[k]).all() for k in scores)
          and summ.problem_type == want["problem_type"])
    record = {
        "phase": f"{example}_train", "rows": len(ds),
        "configs": len(results), "kept_columns": len(checker.indices),
        "kept_equal": kept_equal, "best_model": summ.best_model,
        "best_grid": summ.best_grid, "winner_equal": winner_equal,
        "validation_metric": summ.metric_name,
        "validation_err_by_family": err_by_family,
        "holdout_metrics": hold, "holdout_metrics_jax": hold_w,
        **extra, "tolerance": tol, "reload_scores_equal": reload_equal,
        "launches_main_path": launches, "missing_kernels": missing,
        "forest_chunks": plans.messages,
        "wall_s": {"train": train_s, "feature_fit": feature_fit,
                   "sanity_checker": stage.get("SanityChecker"),
                   "selector": stage.get("ModelSelector"),
                   "sweep": summ.timings["sweep_s"],
                   "sweep_by_family": summ.timings["families"],
                   "sweep_by_group": summ.timings["groups"],
                   "refit": summ.timings["refit_s"]},
        "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError(f"the {example} example disagrees with the JAX "
                             "package's f32 fixture")
    return record



# --------------------------------------------------------------------------- #
# the selectors' other families: K5-mc, three selector runs, serving          #
# --------------------------------------------------------------------------- #

RUNS = ("binary", "iris", "boston")
FAMILIES_FIXTURE = {run: os.path.join(HERE, "transmogrifai_tpu_torch",
                                      "testdata", f"families_{run}_f32")
                    for run in RUNS}
# families fitted along an f32 optimizer path (L-BFGS, Adam): their fits
# have not converged at 50-200 steps on these runs, and one ulp of input
# noise moves their metrics in the JAX package itself (the fixture's noise
# runs, one per seed); each family is held to the larger of 5e-3 and twice
# its own largest move
OPTIMIZER_PATH = ("OpLogisticRegression", "OpLinearSVC",
                  "OpGeneralizedLinearRegression",
                  "OpMultilayerPerceptronClassifier")
OPTIMIZER_FLOOR = 5e-3
# the other families: equal predictions (naive Bayes, trees on classes),
# or float label sums / softmax gradients in another order (relative for
# RMSE)
EXACT_TOL = {"OpNaiveBayes": 1e-5, "OpDecisionTreeClassifier": 1e-5,
             "OpDecisionTreeRegressor": 1e-2, "OpXGBoostClassifier": 1e-2}
# tests/test_examples.py's holdout bands: (metric, bound, larger is better)
FAMILY_BANDS = {"binary": (("AuPR", 0.70, True), ("AuROC", 0.75, True)),
                "iris": (("F1", 0.80, True),),
                "boston": (("RMSE", 6.0, False), ("R2", 0.6, True))}
TREE_KERNELS = ("bin_features", "histograms", "sibling_subtract",
                "split_search", "split_search_live", "route_level",
                "leaf_values", "tree_walk")
FAMILY_KERNELS = {"binary": TREE_KERNELS,
                  "iris": TREE_KERNELS + ("confusion_counts",),
                  "boston": TREE_KERNELS + ("regression_moments",)}
K5MC_SHAPES = ((150, "int8"), (150, "int32"), (65536, "int8"),
               (65536, "int32"))


def family_models(models, ms, run):
    """The run's (estimator, grids) list, the selector's `models=`, from
    either package: `models` holds its estimator classes and `ms` is its
    `selector.model_selector` module (the grids `_REGULARIZATION` and
    `_rf_grid()` are its own)."""
    reg = ms._REGULARIZATION
    l2 = [{"reg_param": r, "elastic_net_param": 0.0} for r in reg]
    mlp_lr = [{"learning_rate": lr} for lr in (0.01, 0.05)]
    if run == "binary":
        return [(models.OpLogisticRegression(max_iter=50), l2),
                (models.OpLinearSVC(max_iter=50),
                 [{"reg_param": r} for r in reg]),
                (models.OpNaiveBayes(), [{"smoothing": 1.0}]),
                (models.OpDecisionTreeClassifier(), ms._rf_grid()),
                (models.OpMultilayerPerceptronClassifier(
                    hidden_layers=(10,), max_iter=100), mlp_lr)]
    if run == "iris":
        return [(models.OpLogisticRegression(max_iter=50), l2),
                (models.OpNaiveBayes(), [{"smoothing": 1.0}]),
                (models.OpDecisionTreeClassifier(), ms._rf_grid()),
                (models.OpMultilayerPerceptronClassifier(
                    hidden_layers=(10,), max_iter=200), mlp_lr),
                (models.OpXGBoostClassifier(**XGB),
                 [{"min_child_weight": c} for c in (1.0, 10.0)])]
    glm = [{"family": f, "link": ln, "reg_param": r}
           for f, ln in (("gaussian", "identity"), ("poisson", "log"),
                         ("gamma", "log"), ("tweedie", "power"))
           for r in reg]
    return [(models.OpGeneralizedLinearRegression(max_iter=100), glm),
            (models.OpDecisionTreeRegressor(), ms._rf_grid())]


def families_pipeline(port, run, models):
    """(dataset, label, prediction) of the run over `models`."""
    if run == "binary":
        ds = port.Dataset.from_csv(TITANIC)
        pred, label = readme_quickstart(port, ds, models)
        return ds, label, pred
    return example_pipeline(port, run, models)


def load_fixture(run):
    with open(os.path.join(FAMILIES_FIXTURE[run], "results.json")) as fh:
        res = json.load(fh)
    with np.load(os.path.join(FAMILIES_FIXTURE[run], "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    return res, arr


def fixture_mlp_init(arr, seed_of_run):
    """An `injected_mlp_init` function serving the JAX package's initial
    MLP weights that a fixture holds (`mlp_init_W<i>`) for its run's seed
    and layer shapes, raising on any other."""
    Ws = [arr[f"mlp_init_W{i}"] for i in range(
        sum(k.startswith("mlp_init_W") for k in arr))]

    def init(seed, layers):
        if int(seed) != int(seed_of_run) or [tuple(W.shape) for W in Ws] \
                != list(zip(layers[:-1], layers[1:])):
            raise AssertionError(f"no fixture MLP weights for seed {seed}, "
                                 f"layers {tuple(layers)}")
        return [W.copy() for W in Ws]
    return init


def metric_move(a, b, relative):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b) if relative else np.abs(a - b)


def family_tolerances(res):
    """Per config of a fixture: its tolerance (relative for RMSE); and per
    optimizer-path family, its own largest move under one ulp of input
    noise in the JAX package (over the fixture's noise runs of that
    family)."""
    relative = res["metric"] == "RMSE"
    noise = {}
    for fam, rec in res["noise"].items():
        ours = [f for r, f in zip(res["results"], res["fold_metrics"])
                if r["model"] == fam]
        noise[fam] = max(float(metric_move(fm, ours, relative).max())
                         for fm in rec["fold_metrics"])
    tol = [max(OPTIMIZER_FLOOR, 2.0 * noise[r["model"]])
           if r["model"] in OPTIMIZER_PATH else EXACT_TOL[r["model"]]
           for r in res["results"]]
    return tol, relative, noise


def _selector_winner(res, fold_metrics):
    """The selector's rule over one fold-metric list per fixture config:
    the first best mean (largest AuPR / F1, smallest RMSE)."""
    sign = -1.0 if res["metric"] == "RMSE" else 1.0
    means = [sign * float(np.mean(f)) for f in fold_metrics]
    return max(range(len(means)), key=lambda i: means[i])


def winner_check(res, tol, winner):
    """The port's winner ({"model", "grid"}) against the fixture: it is
    the fixture's winner, or, when the fixture's top two validation
    metrics lie within tolerance of each other, the second of them.

    The JAX package's own winner is put to the same rule in each of its
    noise runs of the winning family (that family's fold metrics moved by
    one ulp of input noise, the other families' kept). The rule is
    enforced where the reference meets it in every noise run; where the
    reference itself breaks it, the rule cannot tell a right port from a
    wrong one and its result is reported, not enforced."""
    results, folds = res["results"], res["fold_metrics"]
    sign = -1.0 if res["metric"] == "RMSE" else 1.0
    order = sorted(range(len(folds)),
                   key=lambda i: -sign * float(np.mean(folds[i])))
    first, second = order[0], order[1]
    close = float(metric_move(np.mean(folds[first]), np.mean(folds[second]),
                              res["metric"] == "RMSE")) \
        <= max(tol[first], tol[second])
    allowed = [results[first]] + ([results[second]] if close else [])
    fam = results[first]["model"]
    reference = []
    for fm in res["noise"].get(fam, {}).get("fold_metrics", []):
        moved = iter(fm)
        runs = [next(moved) if r["model"] == fam else f
                for r, f in zip(results, folds)]
        reference.append(results[_selector_winner(res, runs)])
    enforced = all(w in allowed for w in reference)
    rule_ok = winner in allowed
    return {"winner_equal": winner == results[first], "allowed": allowed,
            "top_two_within_tolerance": bool(close), "rule_ok": rule_ok,
            "reference_winners_under_noise": reference,
            "enforced": enforced, "ok": rule_ok or not enforced}


def band_check(res, run, winner_model, holdout):
    """Each holdout band of the run for the port's winner: enforced when
    the winner's family is deterministic (no noise runs) or when the JAX
    package's refits of that family meet the band in each of its noise
    runs; where the reference itself breaks the band, its result is
    reported, not enforced."""
    rec = res["noise"].get(winner_model)
    seen_runs = rec["holdout_metrics"] if rec else []
    out = {}
    for key, edge, larger in FAMILY_BANDS[run]:
        seen = [h[key] for h in seen_runs]
        meets = [v >= edge if larger else v <= edge
                 for v in [holdout[key]] + seen]
        out[key] = {"value": holdout[key], "bound": edge,
                    "larger_is_better": larger, "ok": meets[0],
                    "reference_worst_under_noise": (
                        (min(seen) if larger else max(seen))
                        if seen else None),
                    "enforced": all(meets[1:])}
    return out


def judge_families_run(res, run, configs, fold_metrics, winner, holdout):
    """A selector run over the families against its fixture: each
    config's validation metric within its tolerance, the winner by
    `winner_check`, the holdout bands by `band_check`. Returns the checks
    and `ok`."""
    if list(configs) != res["results"]:
        raise AssertionError(f"the families_{run} sweep ran other configs "
                             "than the fixture's")
    tol, relative, noise = family_tolerances(res)
    moves = [float(metric_move(f, g, relative).max())
             for f, g in zip(fold_metrics, res["fold_metrics"])]
    outside = [{"config": c, "move": m, "tolerance": t}
               for c, m, t in zip(configs, moves, tol) if m > t]
    fam = [c["model"] for c in configs]
    by_family = {f: {"max_move": max(m for m, g in zip(moves, fam)
                                     if g == f),
                     "tolerance": max(t for t, g in zip(tol, fam) if g == f),
                     "jax_noise_move": noise.get(f)}
                 for f in dict.fromkeys(fam)}
    win = winner_check(res, tol, winner)
    bands = band_check(res, run, winner["model"], holdout)
    ok = (not outside and win["ok"]
          and all(b["ok"] or not b["enforced"] for b in bands.values()))
    return {"moves": moves, "tolerances": tol, "outside_tolerance": outside,
            "by_family": by_family,
            "noise_runs": {f: len(r["fold_metrics"])
                           for f, r in res["noise"].items()},
            "winner": win, "bands": bands, "ok": bool(ok)}


def k5mc_check(pt, rng, dev):
    """K5-mc against its plain version (both add rounds in index order in
    f32: equal) on the JAX package's Iris model (200 rounds x 3 classes at
    depth 10) at n = 150 and 65536 with int8 and int32 bins, and on a
    12-class ensemble; and its margins against the JAX package's on the
    fixture's rows (2e-5)."""
    _, arr = load_fixture("iris")
    trees = {k: torch.from_numpy(arr[f"xgb_{k}"].astype(
        np.float32 if k == "leaf" else np.int32)).to(dev)
        for k in ("feat", "bin", "leaf")}
    lr = float(arr["xgb_learning_rate"])
    Xb150 = torch.from_numpy(arr["xgb_Xb"]).to(dev)
    n_bins = int(arr["xgb_edges"].shape[1]) + 1
    Xb_big = torch.from_numpy(rng.integers(
        0, n_bins, (65536, Xb150.shape[1])).astype(np.int8)).to(dev)
    cases, err = {}, 0.0
    for n, dtype in K5MC_SHAPES:
        Xb = (Xb150 if n == 150 else Xb_big).to(getattr(torch, dtype))
        args = (Xb, trees["feat"], trees["bin"], trees["leaf"])
        got = pt.tree_walk_classes(*args)
        want = pt.tree_walk_classes_plain(*args)
        torch.cuda.synchronize()
        e = float((got - want).abs().max().item())
        err = max(err, e)
        cases[f"n{n}_{dtype}"] = {"max_abs_err": e,
                                  "equal": bool(torch.equal(got, want))}
        if not torch.equal(got, want):
            raise AssertionError(f"K5-mc disagrees at n={n} {dtype}: {e}")
    wide = {k: v.to(dev) for k, v in synthetic_forest(
        rng, 5, n_trees=12 * 40, depth=6, m=1).items()}
    wide = {k: v.reshape((40, 12) + v.shape[1:]) for k, v in wide.items()}
    Xw = torch.from_numpy(rng.integers(0, 33, (4096, 5)).astype(
        np.int8)).to(dev)
    args = (Xw, wide["feat"], wide["bin"], wide["leaf"])
    got, want = pt.tree_walk_classes(*args), pt.tree_walk_classes_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K5-mc disagrees at K = 12 classes")
    cases["k12_n4096"] = {"max_abs_err": float((got - want).abs().max()),
                          "equal": True}
    cases["boundaries"] = k5mc_boundary_check(pt, np.random.default_rng(16),
                                              dev)
    margin = pt.predict_gbt_multiclass_margin(trees, Xb150, lr)
    jax_err = float(np.abs(margin.cpu().numpy() - arr["xgb_margin"]).max())
    ok = jax_err <= 2e-5
    record = {"phase": "k5mc_check", "tables": list(trees["feat"].shape),
              "cases": cases, "max_abs_err": err,
              "margin_max_abs_err_vs_jax": jax_err,
              "tolerance": {"plain": "equal", "jax_margin": 2e-5},
              "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError("K5-mc's margins disagree with the JAX "
                             "package's")
    return record, trees, {150: Xb150, 65536: Xb_big}


def class_walk_bytes(Xb, feat, bins, leaf) -> int:
    """Bytes K5-mc must move: `walk_bytes` over the (round, class) trees
    as one ensemble, plus the (n, K) output beyond its one column."""
    T, K = feat.shape[:2]
    flat = [t.reshape((T * K,) + t.shape[2:]) for t in (feat, bins, leaf)]
    return walk_bytes(Xb, *flat) + Xb.shape[0] * (K - 1) * 4


def time_k5mc(pt, trees, Xbs):
    out = {}
    for n, Xb in Xbs.items():
        args = (Xb, trees["feat"], trees["bin"], trees["leaf"])
        T, K, depth, _ = trees["feat"].shape
        nbytes = class_walk_bytes(*args)
        b, by = bound(nbytes, n * T * K * (2 * depth + 1))
        rec = {"ms": cuda_ms(lambda: pt.tree_walk_classes(*args), 20),
               "plain_ms": cuda_ms(lambda: pt.tree_walk_classes_plain(*args),
                                   3),
               "library_ms": None, "bound_ms": b, "bound_by": by,
               "bytes": nbytes}
        out[n] = rec
        emit({"phase": "timing", "kernel": "tree_walk_classes", "n": n,
              "tables": list(trees["feat"].shape), **rec})
    return out


def families_train(port, pt, run, device="cuda"):
    """The run on the card (every family, every config, the JAX package's
    MLP initial weights injected), held to its fixture; saved, reloaded
    and scored. The launch counters cover exactly this run."""
    import tempfile
    from transmogrifai_tpu_torch.models import mlp as pm
    from transmogrifai_tpu_torch.selector import model_selector as ms

    res, arr = load_fixture(run)
    pt.reset_launches()
    t0 = time.perf_counter()
    ds, label, pred = families_pipeline(port, run,
                                        family_models(port, ms, run))
    with pm.injected_mlp_init(fixture_mlp_init(arr, res["seed"])):
        model = port.Workflow().set_result_features(pred, label) \
            .set_input_dataset(ds).train(device=device)
    sync(device)
    train_s = time.perf_counter() - t0
    scores = prediction_of(model.score_compiled(ds))
    path = tempfile.mkdtemp(prefix=f"port_families_{run}_")
    model.save(path)
    again = prediction_of(port.load_model(path, device=device)
                          .score_compiled(ds))
    sync(device)
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}

    best = next(s for s in model.fitted.values() if hasattr(
        getattr(s, "summary", None), "validation_results"))
    summ = best.summary
    checker = fitted_of(model, "SanityCheckerModel")
    results = [{"model": r.model, "grid": r.grid}
               for r in summ.validation_results]
    hold = summ.holdout_metrics
    judged = judge_families_run(
        res, run, results, [r.fold_metrics for r in summ.validation_results],
        {"model": summ.best_model, "grid": summ.best_grid}, hold)
    reload_equal = all(np.array_equal(scores[k], again[k])
                       for k in ("prediction", "rawPrediction",
                                 "probability"))
    kept_equal = checker.indices == arr["kept_indices"].tolist()
    n_rows = {"binary": 891, "iris": 150, "boston": 333}[run]
    shape_ok = scores["prediction"].shape == (n_rows,) and all(
        np.isfinite(v).all() for v in scores.values())
    missing = [k for k in FAMILY_KERNELS[run] if launches[k] < 1]
    stage = dict(model.stage_seconds)
    ok = (judged["ok"] and reload_equal and kept_equal and shape_ok
          and not missing)
    record = {
        "phase": f"families_{run}_train", "rows": len(ds),
        "configs": len(results), "kept_columns": len(checker.indices),
        "kept_equal": kept_equal, "best_model": summ.best_model,
        "best_grid": summ.best_grid,
        "winner_equal": judged["winner"]["winner_equal"],
        "winner_rule": judged["winner"],
        "best_model_jax": res["best_model"], "best_grid_jax": res["best_grid"],
        "validation_metric": summ.metric_name,
        "validation_means": [round(float(np.mean(r.fold_metrics)), 6)
                             for r in summ.validation_results],
        "validation_means_jax": [round(float(np.mean(f)), 6)
                                 for f in res["fold_metrics"]],
        "validation_move_by_family": judged["by_family"],
        "jax_noise_runs": judged["noise_runs"],
        "outside_tolerance": judged["outside_tolerance"],
        "holdout_metrics": {k: v for k, v in hold.items()
                            if isinstance(v, float)},
        "holdout_metrics_jax": {k: v for k, v in
                                res["holdout_metrics"].items()
                                if isinstance(v, float)},
        "holdout_bands": judged["bands"], "reload_scores_equal": reload_equal,
        "launches_main_path": launches, "missing_kernels": missing,
        "wall_s": {"train": train_s,
                   "sanity_checker": stage.get("SanityChecker"),
                   "selector": stage.get("ModelSelector"),
                   "sweep": summ.timings["sweep_s"],
                   "sweep_by_family": summ.timings["families"],
                   "sweep_by_group": summ.timings["groups"],
                   "refit": summ.timings["refit_s"]},
        "ok": bool(ok)}
    emit(record)
    if not ok:
        raise AssertionError(f"the families_{run} run disagrees with the JAX "
                             "package's f32 fixture")
    return record


def families_serve(port, pt, device="cuda"):
    """Each new model class, fitted on the card at its family's first grid
    point (a one-config selector over the run's pipeline), saved,
    reloaded with `load_model` and scored through `score_compiled`: the
    reload equals the model; the one-config run's holdout metric is within
    the family's tolerance of the JAX package's, and its scores as close
    as the family allows (equal classes for naive Bayes and trees,
    multiclass XGBoost probabilities within 1e-2). The launch counters
    cover every fit, reload and score of the phase."""
    import tempfile
    from transmogrifai_tpu_torch.models import mlp as pm
    from transmogrifai_tpu_torch.selector import model_selector as ms

    pt.reset_launches()
    out, ok_all = [], True
    for run in RUNS:
        res, arr = load_fixture(run)
        tol, relative, _ = family_tolerances(res)
        metric = res["metric"]
        for i, (est, grids) in enumerate(family_models(port, ms, run)):
            name = type(est).__name__
            t0 = time.perf_counter()
            ds, label, pred = families_pipeline(port, run,
                                                [(est, grids[:1])])
            with pm.injected_mlp_init(fixture_mlp_init(arr, res["seed"])):
                model = port.Workflow().set_result_features(pred, label) \
                    .set_input_dataset(ds).train(device=device)
            scores = prediction_of(model.score_compiled(ds))
            path = tempfile.mkdtemp(prefix=f"port_{run}_{name}_")
            model.save(path)
            loaded = port.load_model(path, device=device)
            again = prediction_of(loaded.score_compiled(ds))
            sync(device)
            wall = time.perf_counter() - t0
            best = next(s for s in model.fitted.values() if hasattr(
                getattr(s, "summary", None), "validation_results"))
            want = res["one_config"][i]
            hold = best.summary.holdout_metrics[metric]
            hold_move = float(metric_move(
                hold, want["holdout_metrics"][metric], relative))
            t = tol[res["results"].index({"model": name,
                                          "grid": grids[0]})]
            score_err = {k: float(np.abs(scores[k] - arr[f"one{i}_{k}"])
                                  .max()) if scores[k].size else 0.0
                         for k in ("rawPrediction", "probability")}
            pred_diff = int((scores["prediction"]
                             != arr[f"one{i}_prediction"]).sum())
            reload_equal = all(np.array_equal(scores[k], again[k])
                               for k in scores)
            ok = (reload_equal and hold_move <= t
                  and type(best).__name__ == want["best_class"]
                  and all(np.isfinite(v).all() for v in scores.values()))
            if name in ("OpNaiveBayes", "OpDecisionTreeClassifier"):
                ok = ok and pred_diff == 0 and score_err["probability"] <= 1e-5
            elif name == "OpDecisionTreeRegressor":
                ok = ok and float(metric_move(
                    scores["prediction"], arr[f"one{i}_prediction"],
                    True).max()) <= 1e-2
            elif name == "OpXGBoostClassifier":
                ok = ok and score_err["probability"] <= 1e-2
            ok_all = ok_all and ok
            out.append({"run": run, "class": type(best).__name__,
                        "grid": grids[0], "reload_scores_equal":
                        reload_equal, f"holdout_{metric}": hold,
                        "holdout_move_vs_jax": hold_move, "tolerance": t,
                        "scores_max_abs_err_vs_jax": score_err,
                        "prediction_mismatches_vs_jax": pred_diff,
                        "wall_s": wall, "ok": bool(ok)})
    launches = {k: pt.LAUNCHES[k] for k in pt.LAUNCHES}
    missing = [k for k in ("bin_features", "tree_walk", "tree_walk_classes")
               if launches[k] < 1]
    record = {"phase": "families_serve", "models": out,
              "launches_main_path": launches, "missing_kernels": missing,
              "ok": bool(ok_all and not missing)}
    emit(record)
    if not record["ok"]:
        raise AssertionError("a new model class does not serve like the "
                             "JAX package's")
    return record


# --------------------------------------------------------------------------- #
# the out-of-core path (phase 21)                                             #
# --------------------------------------------------------------------------- #

BIG_ROWS = 4_456_448          # 17 upload chunks of 262,144; n·d > 2^31
BIG_D = 500
BIG_BINS = 32
BIG_SEED = 11                 # bench.py's store seed
BIG_FIXTURE = os.path.join(HERE, "transmogrifai_tpu_torch", "testdata",
                           "big_synth_16384x500")
BIG_FIXTURE_ROWS = 16384
BIG_FIXTURE_CHUNK = 4096
BIG_LR_STEPS = 200
BIG_RF = dict(n_trees=16, max_depth=6, seed=3)
BIG_RF_DEEP = dict(n_trees=1, max_depth=12, seed=5)
BIG_GBT = dict(n_estimators=2, max_depth=6, learning_rate=0.1,
               reg_lambda=1.0)
BIG_GBT_DEEP = dict(n_estimators=1, max_depth=10, learning_rate=0.1,
                    reg_lambda=1.0)
# GBT leaves: the same bf16-rounded gradients summed in f32 in another
# order (K1/K3 against the JAX package's matmuls); margins add lr · leaf
BIG_GBT_LEAF_ATOL = 1e-5
BIG_GBT_MARGIN_ATOL = 2e-6
# the LR grid: FISTA re-rounds W and the residuals to bf16 before every
# product, so a sum-order difference that moves an f32 value across a bf16
# rounding boundary moves that operand by 2^-8 relative and the path by
# ~1e-3; the port is held within twice the JAX package's own move when its
# rows are permuted (the same problem, the sums in another order)
BIG_LR_SELF_FACTOR = 2.0


def big_grid():
    """bench.py's 8 elastic-net (l1, l2) pairs (`run_big`, :861-866)."""
    l1v, l2v = [], []
    for a in (0.1, 0.5):
        for r in (0.001, 0.01, 0.1, 0.2):
            l1v.append(r * a)
            l2v.append(r * (1 - a))
    return np.asarray(l1v, np.float32), np.asarray(l2v, np.float32)


def big_folds(n: int, n_pad: int):
    """bench.py's 3 folds over the real rows (row r in fold r % 3; pad rows
    in none): training weights W (3, n_pad) and holdout masks V (3, n_pad),
    f32."""
    fold_of = np.arange(n_pad) % 3
    fold_of[n:] = -1
    W = np.stack([(fold_of != f) & (fold_of >= 0) for f in range(3)])
    V = np.stack([fold_of == f for f in range(3)])
    return W.astype(np.float32), V.astype(np.float32)


def big_gbt_weights(W, V):
    """The lockstep GBT's 6 pairs: each fold's training rows, then each
    fold's holdout rows."""
    return np.concatenate([W, V]).astype(np.float32)


def big_labels(store, n_pad: int) -> np.ndarray:
    y = np.zeros(n_pad, np.float32)
    y[:store.n_rows] = np.asarray(store.y, np.float32)
    return y


def big_lr_tolerance(want) -> dict:
    return {"W": BIG_LR_SELF_FACTOR * float(want["lr_self_move_W"]),
            "b": BIG_LR_SELF_FACTOR * float(want["lr_self_move_b"])}


def judge_big_fixture(got, want) -> dict:
    """The port's results at the fixture's shape (`got`: numpy arrays
    under the fixture's names) against the JAX package's (`want`): digests
    equal; LR W and b within twice the JAX package's own row-permutation
    move; GBT and forest split features and bins equal, GBT leaves within
    BIG_GBT_LEAF_ATOL and margins within BIG_GBT_MARGIN_ATOL, forest
    leaves equal (integer sums)."""
    rec = {}
    for k in ("store_sha256", "binned_sha256"):
        rec[k] = str(got[k]) == str(want[k])
    tol = big_lr_tolerance(want)
    rec["lr_W_err"] = float(np.abs(got["lr_W"] - want["lr_W"]).max())
    rec["lr_b_err"] = float(np.abs(got["lr_b"] - want["lr_b"]).max())
    rec["lr_tolerance"] = tol
    for fam in ("gbt", "rf"):
        rec[f"{fam}_trees_equal"] = bool(
            np.array_equal(got[f"{fam}_feat"], want[f"{fam}_feat"])
            and np.array_equal(got[f"{fam}_bin"], want[f"{fam}_bin"]))
        rec[f"{fam}_leaf_err"] = float(np.abs(
            got[f"{fam}_leaf"] - want[f"{fam}_leaf"]).max())
    rec["gbt_margin_err"] = float(np.abs(
        got["gbt_margin"] - want["gbt_margin"]).max())
    rec["ok"] = bool(
        rec["store_sha256"] and rec["binned_sha256"]
        and rec["lr_W_err"] <= tol["W"] and rec["lr_b_err"] <= tol["b"]
        and rec["gbt_trees_equal"] and rec["rf_trees_equal"]
        and rec["gbt_leaf_err"] <= BIG_GBT_LEAF_ATOL
        and rec["gbt_margin_err"] <= BIG_GBT_MARGIN_ATOL
        and rec["rf_leaf_err"] == 0.0)
    return rec


def store_digest(store) -> str:
    """sha256 over the store's column files, from the per-file checksums
    its manifest records (both packages write the same manifest)."""
    sums = store.meta["checksums"]
    text = "\n".join(f"{k}:{sums[k]['sha256']}" for k in sorted(sums))
    return hashlib.sha256(text.encode()).hexdigest()


def tensor_digest(t) -> str:
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def load_big_fixture() -> dict:
    with np.load(os.path.join(BIG_FIXTURE, "fixture.npz")) as z:
        return {k: z[k] for k in z.files}


def big_fixture_run(pbd, pcs, root, device="cuda"):
    """The port's results at the fixture's shape (16384 × 500, chunk
    4096) on `device`, with the fixture's forest draws injected: numpy
    arrays under the fixture's names."""
    want = load_big_fixture()
    chunk = BIG_FIXTURE_CHUNK
    st = pcs.synth_binary_store(os.path.join(root, "fixture_store"),
                                BIG_FIXTURE_ROWS, BIG_D, seed=BIG_SEED)
    edges = st.quantile_edges(BIG_BINS)
    X16, Xb = pbd.dual_device_matrices(st, edges, chunk_rows=chunk,
                                       device=device)
    n_pad = X16.shape[0]
    W, V = big_folds(st.n_rows, n_pad)
    y = big_labels(st, n_pad)
    dev = X16.device
    yd = torch.from_numpy(y).to(dev)
    l1v, l2v = big_grid()
    lr = pbd.fit_logreg_enet_grids_big(X16, yd, torch.from_numpy(W[0]).to(
        dev), l1v, l2v, 2, BIG_LR_STEPS)
    g = BIG_GBT
    gbt, margin = pbd.fit_gbt_big_lockstep(
        Xb, yd, torch.from_numpy(big_gbt_weights(W, V)).to(dev),
        g["n_estimators"], g["max_depth"], BIG_BINS, g["learning_rate"],
        g["reg_lambda"], "logistic", chunk=chunk)
    r = BIG_RF
    Y1 = torch.nn.functional.one_hot(yd.long(), 2).float()
    rf = pbd.fit_forest_big(Xb, Y1, torch.from_numpy(W[0]).to(dev),
                            r["n_trees"], r["max_depth"], BIG_BINS, 2,
                            seed=r["seed"], chunk=chunk,
                            draws=(want["rf_boot"].astype(np.float32),
                                   want["rf_mask"]))
    got = {"store_sha256": store_digest(st), "binned_sha256":
           tensor_digest(Xb), "lr_W": lr["W"], "lr_b": lr["b"],
           "gbt_margin": margin,
           **{f"gbt_{k}": v for k, v in gbt.items()},
           **{f"rf_{k}": v for k, v in rf.items()}}
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in got.items()}, want


BIG_QUANT_DIGESTS = os.path.join(BIG_FIXTURE, "quant_digests.json")
QUANT_WIRES = ("int8", "int4")


def sha256_hex(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def quant_digests(scale, lo, pad_row, wire_sha256: str, x16_bits, xb) -> dict:
    """The digests that hold a quantized build to the JAX package's: the
    quant plan (scale, lo, pad row), the wire tape (the artifact's
    `wire.bin` sha256 from its manifest) and the two matrices (the bf16
    matrix as its 16-bit patterns)."""
    return {"scale_sha256": sha256_hex(np.asarray(scale, np.float32)),
            "lo_sha256": sha256_hex(np.asarray(lo, np.float32)),
            "pad_row_sha256": sha256_hex(np.asarray(pad_row, np.uint8)),
            "wire_sha256": str(wire_sha256),
            "X16_sha256": sha256_hex(np.asarray(x16_bits).view(np.uint16)),
            "Xb_sha256": sha256_hex(np.asarray(xb, np.int8))}


def port_quant_fixture(pbd, pfc, store, edges, cache_dir, device="cuda"):
    """The fixture store (16384 × 500, chunk 4096) built by the port on
    `device` through the feature cache (readwrite) on each quantized
    wire: the dual build's `quant_digests` and cache key, and whether
    `device_matrix` and `device_binned` under the same wire equal the
    dual build's halves. Runs every K12-dequant entry at both widths."""
    out = {}
    for wire in QUANT_WIRES:
        params = pfc.FeatureCacheParams(dir=cache_dir, policy="readwrite",
                                        wire=wire)
        kw = dict(chunk_rows=BIG_FIXTURE_CHUNK, cache=params, device=device)
        X16, Xb, st = pbd.dual_device_matrices(store, edges,
                                               return_stats=True, **kw)
        art = pfc.FeatureCache(params).load(st.cache_key)
        rec = quant_digests(art.quant.scale, art.quant.lo, art.quant.pad_row,
                            art.meta["files"]["wire.bin"]["sha256"],
                            X16.view(torch.int16).cpu().numpy(),
                            Xb.cpu().numpy())
        rec["cache_key"] = st.cache_key
        x = pbd.device_matrix(store, **kw)
        b = pbd.device_binned(store, edges, **kw)
        rec["matrix_equals_dual"] = bool(torch.equal(
            x.view(torch.int16), X16.view(torch.int16)))
        rec["binned_equals_dual"] = bool(torch.equal(b, Xb))
        out[wire] = rec
    return out


def judge_quant_fixture(got: dict) -> dict:
    """`port_quant_fixture`'s record against the JAX package's committed
    digests (`quant_digests.json`): every digest and key equal."""
    with open(BIG_QUANT_DIGESTS) as fh:
        want = json.load(fh)
    rec = {}
    for wire in QUANT_WIRES:
        diff = sorted(k for k, v in want[wire].items()
                      if got[wire].get(k) != v)
        rec[wire] = {"differs": diff,
                     "matrix_equals_dual": got[wire]["matrix_equals_dual"],
                     "binned_equals_dual": got[wire]["binned_equals_dual"]}
    rec["ok"] = all(not r["differs"] and r["matrix_equals_dual"]
                    and r["binned_equals_dual"]
                    for r in (rec[w] for w in QUANT_WIRES))
    return rec


def profiled(fn):
    """fn() under torch.profiler: (profiled wall ms, the device's busy ms
    (its kernels' and copies' self time), the busiest items)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    items = sorted(((e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy = sum(v for _, v in items)
    return {"wall_ms_profiled": wall,
            "device_busy_ms": busy if items else "not measured",
            "device_busy_share": busy / wall if items else "not measured",
            "top_device_items_ms": items[:6]}


def timed_s(device, fn):
    """(fn()'s result, its wall seconds ending in a device sync)."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t


def once(fn):
    """(fn()'s result, the CUDA-event ms of that one call), for calls too
    long to repeat."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def once_ms(fn) -> float:
    return once(fn)[1]


def route_to_level(pt, Xb, trees, level):
    """Each tree's node ids (K, n) at `level`, routed through its fitted
    tables."""
    node = torch.zeros((trees["feat"].shape[0], Xb.shape[0]),
                       dtype=torch.int32, device=Xb.device)
    for lv in range(level):
        node = pt.route_level(Xb, node, trees["feat"][:, lv, :2 ** lv]
                              .contiguous(),
                              trees["bin"][:, lv, :2 ** lv].contiguous())
    return node


def k1_bytes(n, d, K, m, nodes, bins) -> int:
    """K1's least traffic: Xb once, the values, node ids, order and
    segments once, the histograms written once."""
    return n * d + K * n * 4 * (m + 1) + 2 * K * n * 4 + \
        K * (m + 1) * nodes * d * bins * 4


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) \
        if a.numel() else 0.0


def big_kernel_timings(pbd, pt, pdm, X16, Xb, chunk_f16, edges, y, Vf, rf,
                       rf_inputs, probs):
    """Each kernel of the big path at its shape in this run, held to its
    plain version on the same inputs (K1 and K3 leaves: integer sums,
    equal; K2, K3 routing, K5 and K8: equal; K12 bit for bit) and timed
    beside its bound, its plain version and (where one exists) a library
    call."""
    n, d = Xb.shape
    dev = Xb.device
    out = {}
    c = chunk_f16.shape[0]
    e = edges.contiguous()
    k12_bytes = c * d * (2 + 2 + 1) + edges.numel() * 4
    b_ms, b_by = bound(k12_bytes, count_ops(e, c))
    pinned = chunk_f16.cpu().pin_memory()
    cols = chunk_f16.T.float().contiguous()  # searchsorted's (d, c) rows
    w16 = torch.empty((c, d), dtype=torch.bfloat16, device=dev)
    wb = torch.empty((c, d), dtype=torch.int8, device=dev)
    pbd.dual_write_rows_plain(w16, wb, chunk_f16, e, 0)
    k12_err = max(max_err(X16[:c].view(torch.int16), w16.view(torch.int16)),
                  max_err(Xb[:c], wb))
    out["write_rows"] = {
        "ms": cuda_ms(lambda: pbd.dual_write_rows(X16, Xb, chunk_f16, e, 0),
                      10),
        "plain_ms": cuda_ms(lambda: pbd.dual_write_rows_plain(
            w16, wb, chunk_f16, e, 0), 3, warmup=1),
        "library_ms": cuda_ms(lambda: (chunk_f16.to(torch.bfloat16),
                                       torch.searchsorted(e, cols,
                                                          right=True)),
                              5, warmup=1),
        "h2d_copy_ms": cuda_ms(lambda: pinned.to(dev, non_blocking=True),
                               10),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": k12_bytes,
        "rows": c, "max_abs_err": k12_err,
        "library": "Tensor.to(bfloat16) + torch.searchsorted "
        "(torch.bucketize takes 1-D boundaries only)"}
    del pinned, cols, w16, wb
    G, H, fmask = rf_inputs
    K, m = G.shape[0], G.shape[1]
    # K1 at level 0 of the RF batch over all rows; plain and library over
    # row chunks of HIST_CHUNK_ROWS (one pass: their cell ids would not
    # fit for all rows at once)
    node0 = torch.zeros((K, n), dtype=torch.int32, device=dev)
    kb = k1_bytes(n, d, K, m, 1, BIG_BINS)
    b_ms, b_by = bound(kb, (m + 1) * K * n * d)
    step = pbd.HIST_CHUNK_ROWS

    def plain_k1():
        acc = None
        for r0 in range(0, n, step):
            sl = slice(r0, r0 + step)
            hg, hh = pt.histograms_plain(Xb[sl], node0[:, sl], G[:, :, sl],
                                         H[:, sl], 1, BIG_BINS)
            acc = (hg, hh) if acc is None else (acc[0] + hg, acc[1] + hh)
        return acc

    def library_k1():
        tot = 0.0
        for r0 in range(0, n, step):
            sl = slice(r0, r0 + step)
            cell = ((torch.arange(K, device=dev)[:, None, None] * d
                     + torch.arange(d, device=dev)[None, None, :])
                    * BIG_BINS + Xb[sl].long()[None]).reshape(-1)
            srcs = [v[:, :, None].expand(K, cell.numel() // (K * d), d)
                    .reshape(-1) for v in [G[:, j, sl] for j in range(m)]
                    + [H[:, sl]]]
            tot += once_ms(lambda: [torch.zeros(
                K * d * BIG_BINS, device=dev).index_add_(0, cell, s)
                for s in srcs])
            del cell, srcs
        return tot
    hg, hh = pt.histograms(Xb, node0, G, H, 1, BIG_BINS)
    (pg, ph), plain_ms = once(plain_k1)
    k1_err = max(max_err(hg, pg), max_err(hh, ph))
    del hg, hh, pg, ph
    out["histograms"] = {
        "ms": cuda_ms(lambda: pt.histograms(Xb, node0, G, H, 1, BIG_BINS),
                      3, warmup=1),
        # the sort the time above includes:
        "segments_ms": cuda_ms(lambda: pt.node_segments(node0, 1), 3,
                               warmup=1),
        "plain_ms": plain_ms, "library_ms": library_k1(),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": kb, "level": 0,
        "K": K, "max_abs_err": k1_err,
        "scratch_bytes": pt.hist_scratch_bytes(K, n, 1, m, d, BIG_BINS)}
    torch.cuda.empty_cache()
    L = rf["feat"].shape[1] - 1
    node = route_to_level(pt, Xb, rf, L)
    nodes = 2 ** L
    hg, hh = pt.histograms(Xb, node, G, H, nodes, BIG_BINS)
    out["histograms"].update({
        f"level{L}_ms": cuda_ms(lambda: pt.histograms(
            Xb, node, G, H, nodes, BIG_BINS), 3, warmup=1),
        f"level{L}_segments_ms": cuda_ms(
            lambda: pt.node_segments(node, nodes), 3, warmup=1),
        f"level{L}_scratch_bytes": pt.hist_scratch_bytes(
            K, n, nodes, m, d, BIG_BINS)})
    kw = dict(reg_lambda=1e-6, min_child_weight=1.0, min_gain=0.0,
              min_gain_norm=0.0, feature_mask=fmask, level=L,
              active_depth=None)
    live = occupancy(node, nodes)  # the lockstep learners' live set
    bf, bb = pt.split_search(hg, hh, BIG_BINS, **kw)
    lf, lb = pt.split_search(hg, hh, BIG_BINS, live=live, **kw)
    pf, pb = pt.split_search_plain(hg, hh, BIG_BINS, **kw)
    k2 = k2_timing(pt, hg, hh, BIG_BINS, kw, live, 10, plain_iters=2)
    out["split_search"] = {
        "ms": k2["dense_ms"], "plain_ms": k2["plain_ms"],
        "library_ms": None, "bound_ms": k2["dense_bound_ms"],
        "bound_by": k2["dense_bound_by"], "bytes": k2["dense_bytes"],
        "level": L, "max_abs_err": max(max_err(bf, pf), max_err(bb, pb))}
    out["split_search_live"] = {**k2, "level": L, "max_abs_err": max(
        max_err(lf, pf), max_err(lb, pb))}
    del hg, hh, pf, pb, lf, lb
    occ = torch.zeros((K, 2 * nodes), dtype=torch.uint8, device=dev)
    wocc = torch.zeros_like(occ)
    final = pt.route_level(Xb, node, bf, bb, occupied=occ)
    out["route_level"] = {
        **k3_route_timing(pt, Xb, node, bf, bb, 5, plain_iters=2),
        "level": L, "max_abs_err": max(
            max_err(final, pt.route_level_plain(Xb, node, bf, bb,
                                                occupied=wocc)),
            max_err(occ, wocc))}
    del occ, wocc
    leaves = 2 * nodes
    kb = (m + 2) * K * n * 4 + K * (leaves + 1) * 4 + K * leaves * m * 4
    b_ms, b_by = bound(kb, (m + 1) * K * n)
    slot = (final.long() + torch.arange(K, device=dev)[:, None]
            * leaves).reshape(-1)
    srcs = [G[:, j].reshape(-1) for j in range(m)] + [H.reshape(-1)]
    out["leaf_values"] = {
        "ms": cuda_ms(lambda: pt.leaf_values(final, G, H, leaves, 1e-6,
                                             0.0), 2, warmup=1),
        "plain_ms": cuda_ms(lambda: pt.leaf_values_plain(
            final, G, H, leaves, 1e-6, 0.0), 2, warmup=1),
        "library_ms": cuda_ms(lambda: [torch.zeros(
            K * leaves, device=dev).index_add_(0, slot, s) for s in srcs],
            2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": kb, "leaves": leaves,
        "max_abs_err": max_err(
            pt.leaf_values(final, G, H, leaves, 1e-6, 0.0),
            pt.leaf_values_plain(final, G, H, leaves, 1e-6, 0.0)),
        **leaf_designs_ms(pt, final, G, H, leaves, 1e-6, 2, warmup=1)}
    del slot, srcs, node, final
    torch.cuda.empty_cache()
    # K5 alone as `predict_forest_big` runs it: the RF batch's trees over
    # all rows; bound by the cells the walk reads, and (all_xb) by reading
    # every byte of Xb, which whole 32-byte sectors make the real floor
    args = (Xb, rf["feat"], rf["bin"], rf["leaf"])
    T_, depth, _ = rf["feat"].shape
    kb = walk_bytes(*args)
    b_ms, b_by = bound(kb, n * T_ * (2 * depth + m))
    all_xb = Xb.numel() * Xb.element_size() + n * rf["leaf"].shape[-1] * 4
    out["tree_walk"] = {
        "ms": cuda_ms(lambda: pt.tree_walk(*args), 5, warmup=1),
        "plain_ms": cuda_ms(lambda: pt.tree_walk_plain(*args), 2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": kb, "bound_all_xb_ms": bound(all_xb, 0)[0],
        "trees": T_, "depth": depth, "rows": n,
        "max_abs_err": max_err(pt.tree_walk(*args),
                               pt.tree_walk_plain(*args))}
    out["write_rows"]["hostile"] = k12_hostile_check(pbd, dev)
    P = probs.shape[0]
    s = probs[:, :, 1].contiguous()
    Vb = Vf[None].expand(P, n).contiguous()
    out["binned_aupr"] = k8_timing(pdm, s, y, Vb, 4096, False, 20)
    # the same scores clustered: 90 % of the rows moved into one bucket,
    # whose shared-memory sums every block's adds contend for
    gen = torch.Generator(dev).manual_seed(90)
    sc = s.clone()
    sc[:, torch.rand(n, device=dev, generator=gen) < 0.9] = 0.4
    out["binned_aupr_clustered"] = k8_timing(pdm, sc, y, Vb, 4096, False, 20)
    del Vb, sc
    # the same 8 grids' holdout scores at 10M rows (BASELINE target 4's
    # shape): the scores drawn from this run's, the labels and mask tiled
    n10 = 10_000_000
    pick = torch.randint(0, n, (n10,), device=dev,
                         generator=torch.Generator(dev).manual_seed(10))
    s10 = s[:, pick].contiguous()
    y10, v10 = y[pick].contiguous(), Vf[pick][None].expand(P, n10)
    out["binned_aupr_10m"] = k8_timing(pdm, s10, y10, v10.contiguous(),
                                       4096, False, 20)
    del pick, s10, y10, v10
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if v["max_abs_err"] != 0.0}
    if bad:
        raise AssertionError(f"big-path kernels disagree with their plain "
                             f"versions: {bad}")
    return out


BIG_KERNELS = ("write_rows", "histograms", "split_search",
               "split_search_live", "route_level", "leaf_values",
               "tree_walk", "binned_aupr")


# --------------------------------------------------------------------------- #
# the feature cache and the quantized wire (phase 22)                         #
# --------------------------------------------------------------------------- #

CACHE_WIRES = ("int8", "int4", "f16")
DEQUANT_ENTRIES = (("dequant_write_rows", "transmogrifai_tpu/parallel/"
                    "bigdata.py:124"),
                   ("dequant_bin_write_rows", "transmogrifai_tpu/parallel/"
                    "bigdata.py:130"),
                   ("dequant_dual_write_rows", "transmogrifai_tpu/parallel/"
                    "bigdata.py:138"))
DEQUANT_KERNELS = tuple(f"{e}_int{b}" for e, _ in DEQUANT_ENTRIES
                        for b in (8, 4))
CACHE_KERNELS = DEQUANT_KERNELS + ("write_rows", "histograms",
                                   "split_search", "split_search_live",
                                   "route_level",
                                   "leaf_values", "tree_walk", "binned_aupr")
# disk the phase needs beside the store: the largest artifact (f16) twice
# (a rebuild displaces the old artifact before deleting it) and a margin
CACHE_DISK_SLACK = 1 << 30


def build_record(st, wall_s: float, artifact_bytes: int) -> dict:
    """One cached build's numbers: wall (ending in a device sync; the
    quant plan and the artifact's seal included), the upload pipeline's
    own wall, wire GB/s over the build's wall, the pipeline's overlap and
    stage seconds (`cache_write_s`: the tee and the seal), and the
    artifact's bytes."""
    return {"cache": st.cache, "wall_s": wall_s,
            "pipeline_wall_s": st.wall_s,
            "wire_gbps": st.bytes_wire / wall_s / 1e9 if wall_s else 0.0,
            "overlap": st.overlap_frac, "read_s": st.read_s,
            "cast_s": st.cast_s, "cache_read_s": st.cache_read_s,
            "cache_write_s": st.cache_write_s,
            "dispatch_s": st.dispatch_s, "upload_wait_s": st.upload_wait_s,
            "bytes_wire": st.bytes_wire, "bytes_read": st.bytes_read,
            "cache_bytes": st.cache_bytes,
            "bytes_saved_wire": st.bytes_saved_wire,
            "artifact_bytes": artifact_bytes}


def padded_quantized_chunk(store, plan, r0: int, c: int) -> np.ndarray:
    """The wire bytes a cold build ships for rows r0 .. r0 + c: the store's
    rows quantized on the host, the tail padded with the plan's pad row."""
    q = plan.quantize(np.asarray(store.chunk(r0, r0 + c)))
    if len(q) < c:
        q = np.concatenate([q, np.tile(plan.pad_row, (c - len(q), 1))])
    return q


def bits_equal(a, b) -> bool:
    """Equal bit patterns (NaN included) of bf16, f32 or integer tensors."""
    if a.dtype in (torch.bfloat16, torch.float32):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def dequant_timings(pbd, chunks, edges, dev) -> dict:
    """Each K12-dequant entry at 8 and 4 bits on the first 262,144-row
    chunk of the phase's wire: the kernel against its plain version (bit
    for bit) and timed beside its bound, its plain version and the library
    composition (unpack by shifts, `torch.addcmul`, which rounds twice, so
    a time only, `.to(bfloat16)`, `torch.searchsorted`)."""
    out = {}
    e = edges.contiguous()
    for wire, (q, scale, lo) in chunks.items():
        bits = 8 if wire == "int8" else 4
        c = q.shape[0]
        d = scale.shape[0]
        qb = q.numel()
        # an FMA a value, then its count; at 4 bits a feature has 16 codes,
        # so 16 FMAs and counts a feature and one lookup a value
        bin_ops = (c * d * 2 + count_ops(e, c) if bits == 8
                   else 16 * d * 2 + count_ops(e, 16) + c * d)

        def lib_x():
            u = q if bits == 8 else torch.stack(
                [q & 0x0F, q >> 4], dim=-1).reshape(c, -1)[:, :d]
            return torch.addcmul(lo, u.float(), scale)

        def lib_dual():
            x = lib_x()
            return x.to(torch.bfloat16), torch.searchsorted(
                e, x.T.contiguous(), right=True)

        bufs = {k: (torch.empty((c, d), dtype=torch.bfloat16, device=dev),
                    torch.empty((c, d), dtype=torch.int8, device=dev))
                for k in ("kernel", "plain")}
        cases = {
            "dequant_write_rows": (
                lambda b: pbd.dequant_write_rows(b[0], q, scale, lo, 0, bits),
                lambda b: pbd.dequant_write_rows_plain(b[0], q, scale, lo, 0,
                                                       bits),
                lambda: lib_x().to(torch.bfloat16),
                qb + c * d * 2 + 2 * d * 4, c * d * 2, (0,)),
            "dequant_bin_write_rows": (
                lambda b: pbd.dequant_bin_write_rows(b[1], q, scale, lo, e, 0,
                                                     bits),
                lambda b: pbd.dequant_bin_write_rows_plain(b[1], q, scale, lo,
                                                           e, 0, bits),
                lambda: torch.searchsorted(e, lib_x().T.contiguous(),
                                           right=True),
                qb + c * d + e.numel() * 4 + 2 * d * 4,
                bin_ops, (1,)),
            "dequant_dual_write_rows": (
                lambda b: pbd.dequant_dual_write_rows(b[0], b[1], q, scale,
                                                      lo, e, 0, bits),
                lambda b: pbd.dequant_dual_write_rows_plain(
                    b[0], b[1], q, scale, lo, e, 0, bits),
                lib_dual, qb + c * d * 3 + e.numel() * 4 + 2 * d * 4,
                bin_ops, (0, 1))}
        for name, (kern, plain, lib, nbytes, ops, outs) in cases.items():
            kern(bufs["kernel"])
            plain(bufs["plain"])
            torch.cuda.synchronize()
            err = max(max_err(bufs["kernel"][i].float(),
                              bufs["plain"][i].float())
                      if not bits_equal(bufs["kernel"][i], bufs["plain"][i])
                      else 0.0 for i in outs)
            b_ms, b_by = bound(nbytes, ops)
            out[f"{name}_int{bits}"] = {
                "ms": cuda_ms(lambda: kern(bufs["kernel"]), 10),
                "plain_ms": cuda_ms(lambda: plain(bufs["plain"]), 2,
                                    warmup=1),
                "library_ms": cuda_ms(lib, 5, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "rows": c, "max_abs_err": err,
                "library": "unpack by shifts + torch.addcmul (two "
                           "roundings) + Tensor.to(bfloat16) / "
                           "torch.searchsorted"}
        del bufs
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if v["max_abs_err"] != 0.0}
    if bad:
        raise AssertionError(f"K12-dequant disagrees with its plain "
                             f"version: {bad}")
    out["dequant_dual_write_rows_int8"]["hostile"] = \
        k12_dequant_hostile_check(pbd, dev)
    return out


def big_cache(pbd, pfc, pcs, pdm, store, edges_np, root, ref, dev, c, hc,
              kernel_timings: bool = True) -> dict:
    """Phase 22: phase 21's store through the feature cache (module
    docstring, phase 22). `ref` holds phase 21's uncached X16 and Xb, its
    labels, folds and holdout readings."""
    import dataclasses
    import shutil

    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.obs.metrics import get_registry

    n_pad = ref["X16"].shape[0]
    d = store.n_features
    need = 2 * n_pad * d * 2 + CACHE_DISK_SLACK
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"phase 22 needs {need} free bytes beside the "
                             f"store under {root}, has {free}")
    cache_dir = os.path.join(root, "cache")
    edges = torch.from_numpy(edges_np).to(dev)
    reg = get_registry()
    rec = {"phase": "big_cache", "rows": store.n_rows, "d": d,
           "chunk_rows": c}
    first_chunks = {}
    cuda_build.reset_launches()

    def dual(params):
        return timed_s(dev, lambda: pbd.dual_device_matrices(
            store, edges_np, chunk_rows=c, cache=params, return_stats=True,
            device=dev))

    for wire in CACHE_WIRES:
        params = pfc.FeatureCacheParams(dir=cache_dir, policy="readwrite",
                                        wire=wire, verify="size")
        # 1. the cold miss: the artifact is written off the upload
        (X1, B1, s1), w1 = dual(params)
        key = s1.cache_key
        wire_path = os.path.join(cache_dir, key, pfc.WIRE)
        art_bytes = os.path.getsize(wire_path)
        wr = {"key": key, "cold": build_record(s1, w1, art_bytes)}
        ok = s1.cache == "miss" and art_bytes == s1.bytes_wire
        if wire != "f16":
            bits = 8 if wire == "int8" else 4
            art = pfc.FeatureCache(params).load(key)
            plan = art.quant
            scale = torch.from_numpy(plan.scale).to(dev)
            lo = torch.from_numpy(plan.lo).to(dev)
            checks = {}
            for r0 in (0, n_pad - c):
                tape = np.array(art.wire[r0:r0 + c])
                qc = torch.from_numpy(tape).to(dev)
                w16 = torch.empty((c, d), dtype=torch.bfloat16, device=dev)
                wb = torch.empty((c, d), dtype=torch.int8, device=dev)
                pbd.dequant_dual_write_rows_plain(w16, wb, qc, scale, lo,
                                                  edges, 0, bits)
                checks[f"rows_{r0}"] = {
                    "kernel_equals_plain": bits_equal(X1[r0:r0 + c], w16)
                    and bits_equal(B1[r0:r0 + c], wb),
                    "tape_equals_host_quantize": bool(np.array_equal(
                        tape, padded_quantized_chunk(store, plan, r0, c)))}
                if r0 == 0:
                    first_chunks[wire] = (qc, scale, lo)
                del w16, wb
            wr["k12_dequant_check"] = {**checks, "tolerance": "bit-equal"}
            wr["quant_sample_rows"] = params.quant_sample
            ok = ok and all(all(v.values()) for v in checks.values())
        # 2. the warm hit: zero store reads, bit-equal
        (X2, B2, s2), w2 = dual(params)
        wr["warm"] = build_record(s2, w2, art_bytes)
        wr["warm_equals_cold"] = bits_equal(X2, X1) and bits_equal(B2, B1)
        ok = (ok and s2.cache == "hit" and s2.read_s == 0.0
              and s2.bytes_read == 0 and s2.cache_bytes == art_bytes
              and wr["warm_equals_cold"])
        if wire == "f16":
            wr["equals_phase21_uncached"] = (bits_equal(X2, ref["X16"])
                                             and bits_equal(B2, ref["Xb"]))
            ok = ok and wr["equals_phase21_uncached"]
        del X1, B1
        if wire == "int8":
            # 5. resident reuse: the same tensors, no store or artifact IO
            rp = dataclasses.replace(params, resident=True)
            (Xr1, Br1, sr1), _ = dual(rp)
            (Xr2, Br2, sr2), wr2 = dual(rp)
            wr["resident"] = {
                "first": sr1.cache, "second": sr2.cache, "wall_s": wr2,
                "same_tensors": Xr2.data_ptr() == Xr1.data_ptr()
                and Br2.data_ptr() == Br1.data_ptr(),
                "read_s": sr2.read_s, "cache_bytes": sr2.cache_bytes,
                "released": pfc.resident_release(key)}
            ok = (ok and sr2.cache == "resident"
                  and wr["resident"]["same_tensors"] and sr2.read_s == 0.0
                  and sr2.cache_bytes == 0 and wr["resident"]["released"]
                  == 1)
            del Xr1, Br1, Xr2, Br2
            # 6. one byte of the tape flipped, verify=True: rejected,
            # counted, rebuilt cold, bit-equal
            with open(wire_path, "r+b") as fh:
                fh.seek(art_bytes // 2)
                byte = fh.read(1)
                fh.seek(art_bytes // 2)
                fh.write(bytes([byte[0] ^ 0xFF]))
            before = reg.sum_family("feature_cache_corrupt_total")
            (X3, B3, s3), w3 = dual(dataclasses.replace(params, verify=True))
            wr["corrupt"] = {
                "rebuild": build_record(s3, w3, art_bytes),
                "corrupt_counted": reg.sum_family(
                    "feature_cache_corrupt_total") - before,
                "rebuild_equals_cold": bits_equal(X3, X2)
                and bits_equal(B3, B2)}
            ok = (ok and s3.cache == "miss"
                  and wr["corrupt"]["corrupt_counted"] == 1
                  and wr["corrupt"]["rebuild_equals_cold"])
            del X3, B3
            # 8. downstream of the warm build: one LR fold, one RF batch
            l1v, l2v = big_grid()
            y, W, V = ref["y"], ref["W"], ref["V"]
            p, lr_s = timed_s(dev, lambda: pbd.fit_logreg_enet_grids_big(
                X2, y, W[0], l1v, l2v, 2, BIG_LR_STEPS))
            probs = pbd.predict_logreg_grids_big(p["W"], p["b"], X2)
            lr_aupr = pdm.binned_aupr(
                probs[:, :, 1].contiguous(), y,
                V[0][None].expand(8, n_pad).contiguous(), 4096,
                False).tolist()
            r = BIG_RF
            Y1 = torch.nn.functional.one_hot(y.long(), 2).float()
            rf, rf_s = timed_s(dev, lambda: pbd.fit_forest_big(
                B2, Y1, W[0], r["n_trees"], r["max_depth"], BIG_BINS, 2,
                seed=r["seed"], trees_per_dispatch=16, chunk=hc))
            pred = pbd.predict_forest_big(rf, B2)
            rf_aupr = pdm.binned_aupr(pred[:, 1][None].contiguous(), y,
                                      V[0][None].contiguous(), 4096,
                                      False).tolist()[0]
            wr["downstream"] = {
                "lr_fold0_s": lr_s, "lr_holdout_aupr": lr_aupr,
                "lr_holdout_aupr_phase21": ref["lr_aupr_fold0"],
                "rf_batch_d6_s": rf_s, "rf_holdout_aupr": rf_aupr,
                "rf_holdout_aupr_phase21": ref["rf_aupr_fold0"],
                "reading_not_gate": True}
            ok = ok and all(np.isfinite(lr_aupr)) and np.isfinite(rf_aupr)
            del p, probs, rf, pred, Y1
        del X2, B2
        shutil.rmtree(cache_dir)
        torch.cuda.empty_cache()
        wr["ok"] = bool(ok)
        rec[wire] = wr
        emit({"phase": f"big_cache_{wire}", **wr})
        if not ok:
            raise AssertionError(f"phase 22 failed on the {wire} wire: {wr}")
    # 7. the fixture store through int8 and int4 (every entry), held to the
    # JAX package's digests
    fixture_store = pcs.ColumnarStore(os.path.join(root, "fixture_store"))
    got = port_quant_fixture(pbd, pfc, fixture_store,
                             load_big_fixture()["edges"],
                             os.path.join(root, "fixture_cache"), dev)
    rec["fixture"] = judge_quant_fixture(got)
    emit({"phase": "big_cache_fixture", **rec["fixture"]})
    if not rec["fixture"]["ok"]:
        raise AssertionError(f"the fixture's quantized builds differ from "
                             f"the JAX package's: {rec['fixture']}")
    shutil.rmtree(os.path.join(root, "fixture_cache"))
    launches = cuda_build.launches_snapshot()
    rec["launches_main_path"] = {k: launches[k] for k in CACHE_KERNELS}
    if dev.type == "cuda" and not all(
            v >= 1 for v in rec["launches_main_path"].values()):
        raise AssertionError(f"a kernel of the cache phase never launched: "
                             f"{rec['launches_main_path']}")
    emit({"phase": "big_cache_launches",
          "launches_main_path": rec["launches_main_path"]})
    if kernel_timings:
        rec["kernels"] = dequant_timings(pbd, first_chunks, edges, dev)
        emit({"phase": "big_cache_kernel_timing", **rec["kernels"]})
    del first_chunks
    torch.cuda.empty_cache()
    return rec


def big_path(rows: int = BIG_ROWS, fixture: bool = True,
             kernel_timings: bool = True, device="cuda",
             chunk_rows: int = None, cache_phase: bool = True) -> dict:
    """Phases 21 and 22: the out-of-core path at `rows` × 500 through the
    port's entry points on the card, then the same store through the
    feature cache (`big_cache`; module docstring, phases 21 and 22). The
    store is generated once for both. `chunk_rows` (default
    `UPLOAD_CHUNK_ROWS`) and a CPU `device` serve a rehearsal at a small
    size; phase 22 needs the fixture run of phase 21."""
    import tempfile

    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.data import columnar_store as pcs
    from transmogrifai_tpu_torch.data import feature_cache as pfc
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel import bigdata as pbd

    dev = torch.device(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on; the port's products are exact f32")
    rec = {"phase": "big_path", "rows": rows, "d": BIG_D, "bins": BIG_BINS}
    c = chunk_rows or pbd.UPLOAD_CHUNK_ROWS
    hc = min(c, pbd.HIST_CHUNK_ROWS)
    with tempfile.TemporaryDirectory(prefix="big_path-") as root:
        if fixture:
            got, want = big_fixture_run(pbd, pcs, root, dev)
            judged = judge_big_fixture(got, want)
            emit({"phase": "big_fixture", "rows": BIG_FIXTURE_ROWS,
                  **judged})
            if not judged["ok"]:
                raise AssertionError(f"big path disagrees with the JAX "
                                     f"package's fixture: {judged}")
        store, rec["store_gen_s"] = timed_s(
            dev, lambda: pcs.synth_binary_store(
                os.path.join(root, "store"), rows, BIG_D, seed=BIG_SEED))
        edges_np, rec["edges_s"] = timed_s(
            dev, lambda: store.quantile_edges(BIG_BINS))
        cuda_build.reset_launches()
        # 2. the pipelined dual upload through K12
        (X16, Xb, st), rec["upload_s"] = timed_s(
            dev, lambda: pbd.dual_device_matrices(store, edges_np, chunk_rows=c,
                                             return_stats=True,
                                             device=dev))
        rec["upload"] = st.to_extra()
        n_pad = X16.shape[0]
        if n_pad * BIG_D <= 2 ** 31 and rows == BIG_ROWS:
            raise AssertionError("the phase must pass 2^31 elements")
        edges = torch.from_numpy(edges_np).to(dev)
        k12 = {}
        for r0 in (0, n_pad - c):
            raw = np.zeros((c, BIG_D), np.float16)
            part = np.asarray(store.chunk(r0, r0 + c))
            raw[:len(part)] = part
            ch = torch.from_numpy(raw).to(dev)
            want16 = ch.to(torch.bfloat16)
            wantb = pt.bin_features_plain(ch.float(), edges).to(torch.int8)
            eq = (torch.equal(X16[r0:r0 + c].view(torch.int16),
                              want16.view(torch.int16))
                  and torch.equal(Xb[r0:r0 + c], wantb))
            k12[f"rows_{r0}"] = bool(eq)
            if not eq:
                raise AssertionError(f"K12 disagrees at rows {r0}..")
            del want16, wantb
        first_chunk = torch.from_numpy(
            np.array(store.chunk(0, c), copy=True)).to(dev)
        rec["k12_check"] = {**k12, "tolerance": "bit-equal"}
        emit({"phase": "big_upload", "rows": rows, "n_pad": n_pad,
              "store_gen_s": rec["store_gen_s"], "edges_s": rec["edges_s"],
              "upload_s": rec["upload_s"], **rec["upload"],
              "k12_check": rec["k12_check"]})
        y = torch.from_numpy(big_labels(store, n_pad)).to(dev)
        W, V = (torch.from_numpy(a).to(dev)
                for a in big_folds(store.n_rows, n_pad))
        # 3. the LR grid: 8 (l1, l2) × 3 folds × 200 FISTA steps
        l1v, l2v = big_grid()
        fold_s, aupr = [], []
        for f in range(3):
            p, s = timed_s(dev, lambda: pbd.fit_logreg_enet_grids_big(
                X16, y, W[f], l1v, l2v, 2, BIG_LR_STEPS))
            fold_s.append(s)
            probs = pbd.predict_logreg_grids_big(p["W"], p["b"], X16)
            aupr.append(pdm.binned_aupr(
                probs[:, :, 1].contiguous(), y,
                V[f][None].expand(8, n_pad).contiguous(), 4096,
                False).tolist())
        Wd = torch.zeros((BIG_D, 16), dtype=torch.bfloat16, device=dev)
        Rd = torch.zeros((n_pad, 16), dtype=torch.bfloat16, device=dev)
        rec["lr"] = {
            "fold_s": fold_s, "holdout_aupr": aupr,
            "step_ms": [s / BIG_LR_STEPS * 1e3 for s in fold_s],
            "step_products_ms": cuda_ms(lambda: (pbd.mm_f32(X16, Wd),
                                                 pbd.mm_f32(X16.T, Rd)), 5),
            "step_bound_ms": bound(2 * X16.numel() * 2, 0)[0],
            "busy": profiled(lambda: pbd.fit_logreg_enet_grids_big(
                X16, y, W[0], l1v, l2v, 2, BIG_LR_STEPS))}
        del Wd, Rd
        emit({"phase": "big_lr", **rec["lr"]})
        Vf0 = V[0]
        # 4. RF: 16 trees at depth 6 in one lockstep batch; one depth-12
        r = BIG_RF
        Y1 = torch.nn.functional.one_hot(y.long(), 2).float()
        with pbd.level_times() as lv6:
            rf, s6 = timed_s(dev, lambda: pbd.fit_forest_big(
                Xb, Y1, W[0], r["n_trees"], r["max_depth"], BIG_BINS, 2,
                seed=r["seed"], trees_per_dispatch=16, chunk=hc))
        rd = BIG_RF_DEEP
        with pbd.level_times() as lv12:
            _, s12 = timed_s(dev, lambda: pbd.fit_forest_big(
                Xb, Y1, W[0], rd["n_trees"], rd["max_depth"], BIG_BINS, 2,
                seed=rd["seed"], chunk=hc))
        # two depth-12 trees at the width `lockstep_width` gives (1: K1's
        # scratch counted) and at 2 learners a batch, the same trees
        width = pbd.lockstep_width(rd["max_depth"], BIG_D, BIG_BINS, 2, 16,
                                   n=n_pad)
        deep2 = {}
        for k in sorted({width, 2}):
            keep = pbd.lockstep_width
            pbd.lockstep_width = lambda *a, k=k, **kw: k
            try:
                deep2[k] = timed_s(dev, lambda: pbd.fit_forest_big(
                    Xb, Y1, W[0], 2, rd["max_depth"], BIG_BINS, 2,
                    seed=rd["seed"], chunk=hc))
            finally:
                pbd.lockstep_width = keep
        t1, t2 = deep2[width][0], deep2[2][0]
        if not all(torch.equal(t1[key], t2[key]) for key in t1):
            raise AssertionError("depth-12 trees depend on the lockstep "
                                 "width")
        rec["rf_d12_width"] = {"lockstep_width": width,
                               "two_trees_s": {str(k): s for k, (_, s)
                                               in deep2.items()}}
        del deep2, t1, t2
        rec["rf"] = {"k1_levels_d6_ms": [v.get("histograms_ms") for v in lv6
                                         if "level" in v],
                     "k1_levels_d12_ms": [v.get("histograms_ms") for v in lv12
                                          if "level" in v],
                     "tree_d6_s": s6 / r["n_trees"], "batch_d6_s": s6,
                     "lockstep_k": r["n_trees"], "tree_d12_s": s12,
                     "levels_d6": lv6, "levels_d12": lv12,
                     "busy": profiled(lambda: pbd.fit_forest_big(
                         Xb, Y1, W[0], r["n_trees"], r["max_depth"],
                         BIG_BINS, 2, seed=r["seed"], chunk=hc))}
        emit({"phase": "big_rf", **rec["rf"], **rec["rf_d12_width"]})
        # 5. GBT: 6 pairs × 2 rounds at depth 6; one round at depth 10
        w6 = torch.cat([W, V])
        g, gd = BIG_GBT, BIG_GBT_DEEP
        with pbd.level_times() as lg6:
            (_, m6), s6 = timed_s(dev, lambda: pbd.fit_gbt_big_lockstep(
                Xb, y, w6, g["n_estimators"], g["max_depth"], BIG_BINS,
                g["learning_rate"], g["reg_lambda"], chunk=hc))
        with pbd.level_times() as lg10:
            (_, m10), s10 = timed_s(dev, lambda: pbd.fit_gbt_big_lockstep(
                Xb, y, w6, gd["n_estimators"], gd["max_depth"], BIG_BINS,
                gd["learning_rate"], gd["reg_lambda"], chunk=hc))
        if not (torch.isfinite(m6).all() and torch.isfinite(m10).all()):
            raise AssertionError("GBT margins are not finite")
        rec["gbt"] = {"round6p_d6_s": s6 / g["n_estimators"],
                      "round6p_d10_s": s10, "levels_d6": lg6,
                      "levels_d10": lg10}
        emit({"phase": "big_gbt", **rec["gbt"]})
        del m6, m10
        # 6. predict the forest over all rows
        pred, sp = timed_s(dev, lambda: pbd.predict_forest_big(rf, Xb))
        if pred.shape != (n_pad, 2) or not torch.isfinite(pred).all():
            raise AssertionError("forest predictions malformed")
        rec["predict"] = {"s": sp, "rows_per_s": store.n_rows / sp,
                          "holdout_aupr_fold0": pdm.binned_aupr(
                              pred[:, 1][None].contiguous(), y,
                              Vf0[None].contiguous(), 4096,
                              False).tolist()[0]}
        launches = cuda_build.launches_snapshot()
        rec["launches_main_path"] = {k: launches[k] for k in BIG_KERNELS}
        if dev.type == "cuda" and not all(
                v >= 1 for v in rec["launches_main_path"].values()):
            raise AssertionError(f"a kernel of the big path never "
                                 f"launched: {rec['launches_main_path']}")
        emit({"phase": "big_predict", **rec["predict"],
              "launches_main_path": rec["launches_main_path"]})
        if kernel_timings:
            boot, mask = pbd.forest_big_draws(
                r["seed"], range(r["n_trees"]), n_pad, BIG_D,
                max(int(np.sqrt(BIG_D)), 1), True, dev)
            bw = boot * W[0][None]
            G = (Y1.T[None] * bw[:, None, :]).to(torch.bfloat16).float()
            H = bw.to(torch.bfloat16).float()
            del boot, bw
            rec["kernels"] = big_kernel_timings(
                pbd, pt, pdm, X16, Xb, first_chunk, edges, y, Vf0, rf,
                (G.contiguous(), H.contiguous(), mask), probs)
            emit({"phase": "big_kernel_timing", **rec["kernels"]})
            del G, H
        del rf, pred, probs, first_chunk
        torch.cuda.empty_cache()
        if cache_phase:
            # 22. the same store through the feature cache
            rec["cache"] = big_cache(
                pbd, pfc, pcs, pdm, store, edges_np, root,
                {"X16": X16, "Xb": Xb, "y": y, "W": W, "V": V,
                 "lr_aupr_fold0": aupr[0],
                 "rf_aupr_fold0": rec["predict"]["holdout_aupr_fold0"]},
                dev, c, hc, kernel_timings=kernel_timings)
        del X16, Xb
        torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------- #
# K9-hits: hostile block products                                             #
# --------------------------------------------------------------------------- #

# 0.3 + 2^-54: an f64 split f32 cannot hold (nor 0.1)
BUCKET_F64_SPLIT = 0.30000000000000004


def bucket_hostile_values() -> list:
    """Values for the numeric bucketizers: on and just beside f32(0.1) and
    f32(BUCKET_F64_SPLIT), the f64 values themselves, ±0, ±inf, values
    near the f32 extremes, subnormals and nulls (None)."""
    f = np.float32
    near = [np.nextafter(f(BUCKET_F64_SPLIT), f(-1)), f(BUCKET_F64_SPLIT),
            np.nextafter(f(BUCKET_F64_SPLIT), f(1)),
            np.nextafter(f(0.1), f(-1)), f(0.1), np.nextafter(f(0.1), f(1))]
    vals = [float(v) for v in near] + [
        BUCKET_F64_SPLIT, 0.3, 0.1, -1.0, -2.0, 2.5, 5.0, 0.0, 1.0, -0.0,
        7.0, -7.0, 3.4e38, -3.4e38, np.inf, -np.inf, 1e-45, -1e-45]
    return vals + [None, None]


# (name, b, d, a, thr, cap, planted): one block product C (b, d) of the wide
# sanity check, rows the columns a.. of the checker
K9_HITS_CASES = (
    ("none", 64, 300, 100, 0.99, 1024, "none"),
    ("all", 64, 300, 100, -1.0, 1 << 15, "all"),
    ("all_truncated", 64, 300, 100, -1.0, 1000, "all"),
    ("first_block", 128, 1000, 0, 0.95, 2048, "sparse"),
    ("ragged_last_block", 104, 1000, 896, 0.95, 2048, "sparse"),
    ("rows_past_d", 16, 1000, 992, 0.95, 256, "sparse"),
    ("at_threshold", 64, 300, 40, 0.95, 1024, "edge"),
    ("dup40_truncated", 64, 200, 0, 0.99, 512, "dup40"),
    ("one_row", 1, 33, 32, 0.5, 16, "sparse"),
)


def k9_hits_input(rng, b: int, d: int, a: int, thr: float,
                  planted: str) -> np.ndarray:
    """A hostile block product C (b, d) f32: values in (-0.9, 0.9) and
    `planted` hits: "none"; "all" (thr < 0); "sparse" (a quarter of the
    rows hold hits of either sign below the diagonal j < a + r, the
    upper part too, which must not count, and NaN cells, which never
    hit); "edge" (cells exactly ±thr in f32, which do not hit, and the
    next f32 above, which do); "dup40" (rows and columns 10..49 one group
    of 40 identical columns: 780 hits)."""
    C = rng.uniform(-0.9, 0.9, size=(b, d)).astype(np.float32)
    if planted in ("sparse", "edge"):
        for r in rng.choice(b, size=max(1, b // 4), replace=False):
            lim = min(d, a + int(r))
            if lim > 0:
                js = rng.choice(lim, size=min(lim, 3), replace=False)
                sign = rng.choice([-1.0, 1.0], size=len(js))
                if planted == "sparse":
                    C[r, js] = sign * rng.uniform(0.96, 1.0, size=len(js))
                else:
                    t32 = np.float32(thr)
                    C[r, js[:1]] = sign[:1] * t32
                    C[r, js[1:]] = sign[1:] * np.nextafter(t32, np.float32(2))
            if lim < d:
                C[r, lim:] = np.float32(0.999)
        if planted == "sparse":
            C[rng.integers(0, b, 3), rng.integers(0, d, 3)] = np.nan
    elif planted == "dup40":
        g = np.arange(10, 50)
        C[np.ix_(g - a, g)] = 1.0
    return C


def hits_oracle(C: np.ndarray, a: int, thr: float, cap: int):
    """numpy's reading of K9-hits: (ri, ci, vals, total) as
    `corr_hits_plain` defines them."""
    b, d = C.shape
    rows = a + np.arange(b)[:, None]
    cols = np.arange(d)[None, :]
    with np.errstate(invalid="ignore"):
        mask = (np.abs(C) > np.float32(thr)) & (cols < rows) & (rows < d)
    r, c = np.nonzero(mask)
    k = min(cap, r.size)
    ri = np.full(cap, -1, dtype=np.int64)
    ci = np.full(cap, -1, dtype=np.int64)
    ri[:k], ci[:k] = r[:k], c[:k]
    return ri, ci, C[ri, ci], int(mask.sum())


def k9_hits_hostile_check(sc, dev) -> dict:
    """K9-hits on every `K9_HITS_CASES` block against `corr_hits_plain`
    on the same C: ri, ci, vals and total bit-equal, and a second launch
    bit-equal to the first; the kernel's launches counted."""
    from transmogrifai_tpu_torch import cuda_build
    rng = np.random.default_rng(9)
    out = {}
    for name, b, d, a, thr, cap, planted in K9_HITS_CASES:
        C = torch.from_numpy(k9_hits_input(rng, b, d, a, thr, planted)).to(dev)
        before = cuda_build.LAUNCHES["corr_hits"]
        got = sc.corr_hits(C, a, thr, cap)
        again = sc.corr_hits(C, a, thr, cap)
        want = sc.corr_hits_plain(C, a, thr, cap)
        torch.cuda.synchronize()
        launched = cuda_build.LAUNCHES["corr_hits"] - before
        for g, h, w, part in zip(got, again, want,
                                 ("ri", "ci", "vals", "total")):
            if not (bits_equal(g, w) and bits_equal(h, w)):
                raise AssertionError(
                    f"K9-hits disagrees with its plain version on {name} "
                    f"in {part}")
        if launched != 2:
            raise AssertionError(f"K9-hits launched {launched} times on "
                                 f"{name}, not 2")
        out[name] = {"b": b, "d": d, "a": a, "cap": cap,
                     "total": int(want[3]), "equal": True}
    return out


# --------------------------------------------------------------------------- #
# 24. feature validation at full scope                                        #
# --------------------------------------------------------------------------- #

FV_SEED = 24
FV_TRAIN_ROWS = 600          # the rest of the 891 rows are the score set
# the filter: a score set of 291 rows (default minimum 500), and a fill
# floor that cabin (≈ 23 % filled) misses
FV_FILTER = {"min_scoring_rows": 100, "min_fill": 0.25}
FV_FOLD_RTOL = 1e-4          # test_lbfgs_fits_on_the_card_match_the_cpu
FV_BANDS = (("AuPR", 0.70), ("AuROC", 0.75))


def fv_datasets(port):
    """The repo's Titanic rows split by a seeded permutation: (train,
    score)."""
    ds = port.Dataset.from_csv(TITANIC)
    perm = np.random.default_rng(FV_SEED).permutation(len(ds))
    return ds.take(perm[:FV_TRAIN_ROWS]), ds.take(perm[FV_TRAIN_ROWS:])


def fv_train(port, train, score, models, device):
    """The feature-validation pipeline trained by `Workflow.train`: the
    raw features through the RawFeatureFilter (`FV_FILTER`, `score` as
    the score set), `auto_bucketize` on age against the label, transmogrify,
    the Spearman sanity check and a binary selector (`models`; None: the
    default LR + RF + XGB), under workflow-level CV. Returns (model,
    workflow, prediction feature, seconds)."""
    preds, label = port.FeatureBuilder.from_dataset(train,
                                                    response="survived")
    age = next(f for f in preds if f.name == "age")
    vec = port.transmogrify(preds + [age.auto_bucketize(label)])
    checked = label.sanity_check(vec, correlation_type="spearman",
                                 remove_bad_features=True)
    pred = port.BinaryClassificationModelSelector.with_cross_validation(
        models=models).set_input(label, checked).get_output()
    wf = port.Workflow().set_result_features(pred, label) \
        .set_input_dataset(train).with_raw_feature_filter(
            score_dataset=score, **FV_FILTER).with_workflow_cv()
    t0 = time.perf_counter()
    model = wf.train(device=device)
    sync(device)
    return model, wf, pred, time.perf_counter() - t0


def fv_outcome(model, wf, pred) -> dict:
    """What the card's run is held to against the CPU's."""
    from transmogrifai_tpu_torch.automl.sanity_checker import (
        SanityCheckerModel)
    res = model.rff_results
    checker = next(m for m in model.fitted.values()
                   if isinstance(m, SanityCheckerModel))
    bucket = fitted_of(model, "DecisionTreeBucketizerModel")
    summ = model.fitted[pred.origin_stage.uid].summary
    return {
        "blocklist": list(wf.blocklist),
        "dropped_features": res.dropped_features,
        "dropped_map_keys": res.dropped_map_keys,
        "rff_metrics": [vars(m) for m in res.metrics],
        "kept": checker.indices,
        "drop_reasons": [s["dropped"] for s in checker.summary["stats"]],
        "thresholds": bucket.thresholds,
        "results": [{"model": r.model, "grid": r.grid}
                    for r in summ.validation_results],
        "fold_metrics": [r.fold_metrics for r in summ.validation_results],
        "best_model": summ.best_model, "best_grid": summ.best_grid,
        "holdout_metrics": summ.holdout_metrics}


def fv_compare(card: dict, cpu: dict) -> dict:
    """The card's outcome against the CPU's: everything equal but the
    fold metrics (within FV_FOLD_RTOL relative) and the float metrics of
    the filter (equal: host numpy)."""
    diff = {k: card[k] == cpu[k] for k in (
        "blocklist", "dropped_features", "dropped_map_keys", "rff_metrics",
        "kept", "drop_reasons", "thresholds", "results", "best_model",
        "best_grid")}
    a, b = np.array(card["fold_metrics"]), np.array(cpu["fold_metrics"])
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    diff["fold_metrics"] = rel <= FV_FOLD_RTOL
    return {"equal": diff, "fold_max_rel_err": rel}


def feature_validation_phase(port, pt) -> dict:
    """Phase 24 (module docstring): the LR-only pipeline on the card and
    on the CPU, compared; then the default selector under workflow CV on
    the card, its kernels' launches counted around the train alone, then
    saved, reloaded and scored through `score_compiled`, the serving
    launches counted apart."""
    import tempfile

    from transmogrifai_tpu_torch.selector.model_selector import _lr_grid
    train, score = fv_datasets(port)
    lr = [(port.OpLogisticRegression(max_iter=50), _lr_grid())]
    model, wf, pred, lr_s = fv_train(port, train, score, lr, "cuda")
    got = fv_outcome(model, wf, pred)
    rec = {"phase": "feature_validation", "train_rows": len(train),
           "score_rows": len(score), "filter": FV_FILTER,
           "blocklist": got["blocklist"],
           "map_keys_dropped": got["dropped_map_keys"],
           "kept_columns": len(got["kept"]),
           "thresholds": got["thresholds"],
           "lr_best_grid": got["best_grid"], "lr_train_s": lr_s}
    if not got["dropped_features"]:
        raise AssertionError("the filter dropped nothing (cabin expected)")
    cpu_model, cpu_wf, cpu_pred, cpu_s = fv_train(
        port, train, score, lr, "cpu")
    cmp = fv_compare(got, fv_outcome(cpu_model, cpu_wf, cpu_pred))
    rec.update({"cpu_train_s": cpu_s, "vs_cpu": cmp})
    if not all(cmp["equal"].values()):
        emit(rec)
        raise AssertionError(f"phase 24 differs from the CPU run: "
                             f"{cmp['equal']}")
    pt.reset_launches()
    model, wf, pred, default_s = fv_train(port, train, score, None, "cuda")
    launches = {k: pt.LAUNCHES[k] for k in DEFAULT_KERNELS}
    pt.reset_launches()
    with tempfile.TemporaryDirectory(prefix="port_fv_model_") as path:
        model.save(path)
        loaded = port.load_model(path, device="cuda")
        scored = prediction_of(loaded.score_compiled(train))
    sync("cuda")
    serve_launches = {k: pt.LAUNCHES[k] for k in DEFAULT_KERNELS}
    in_memory = prediction_of(model.score_compiled(train))
    out = fv_outcome(model, wf, pred)
    bands = {m: out["holdout_metrics"][m] >= lo for m, lo in FV_BANDS}
    reload_equal = all(np.array_equal(scored[k], in_memory[k]) for k in (
        "prediction", "rawPrediction", "probability"))
    served = {type(s).__name__ for s in loaded.fitted.values()}
    rec["default"] = {
        "train_s": default_s, "best_model": out["best_model"],
        "best_grid": out["best_grid"], "configs": len(out["results"]),
        "holdout_metrics": out["holdout_metrics"], "bands": bands,
        "fold_metrics_finite": bool(np.isfinite(out["fold_metrics"]).all()),
        "launches_main_path": launches,
        "launches_reload_and_serve": serve_launches,
        "reload_scores_equal": reload_equal,
        "serves": sorted(served & {"DecisionTreeBucketizerModel",
                                   "SanityCheckerModel"})}
    emit(rec)
    if not (all(bands.values()) and reload_equal
            and rec["default"]["fold_metrics_finite"]
            and len(rec["default"]["serves"]) == 2
            and all(v >= 1 for v in launches.values())):
        raise AssertionError("phase 24: the default selector under workflow "
                             "CV failed a check")
    return rec


# --------------------------------------------------------------------------- #
# 25. the wide sanity check                                                   #
# --------------------------------------------------------------------------- #

# 32 text columns at transmogrify's default 512 hash buckets each
WIDE_ROWS, WIDE_D, WIDE_SEED = 50_000, 16_384, 25
WIDE_KERNELS = ("corr_hits",)


def truncating_group(cap: int) -> int:
    """The fewest identical columns whose pairs, G·(G − 1)/2, exceed a
    block's cap: the block truncates within the group's last row, which
    keeps its first hits, so every copy is still found."""
    g = 2
    while g * (g - 1) // 2 <= cap:
        g += 1
    return g


def wide_synthetic(rows: int, d: int, block: int, seed: int, device):
    """A seeded wide table (rows, d) f32 made on `device` and returned on
    the host, its label and the planted columns. Half the columns are
    indicators of rare hashed levels (rate 0.005 to 0.2), half standard
    normals; the label is (x[d−2] + x[d−1] + noise > 0). Planted: in the
    first block of the wide path (columns < block) one group of
    `truncating_group(16·block)` identical columns at its end, so the
    block's hits pass cap; after it one group of 40 identical columns,
    twelve duplicates j = α·i + β (α < 0: anti-duplicates), one leak
    column 3·y + 0.5, and four constant columns. Returns (X, y, planted:
    {column: reason}), reasons "corr", "label corr" and "variance"."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    X = torch.empty((rows, d), dtype=torch.float32, device=device)
    half = d // 2
    rate = torch.rand(half, generator=g, device=device) * 0.195 + 0.005
    for c0 in range(0, half, 1024):
        c1 = min(half, c0 + 1024)
        X[:, c0:c1] = (torch.rand((rows, c1 - c0), generator=g,
                                  device=device) < rate[c0:c1]).float()
    X[:, half:] = torch.randn((rows, d - half), generator=g, device=device)
    noise = torch.randn(rows, generator=g, device=device)
    y = ((X[:, d - 2] + X[:, d - 1] + noise) > 0).float()
    planted = {}
    G = truncating_group(16 * block)
    if G >= block or block + 214 >= d - 2:
        raise ValueError(f"wide_synthetic: d = {d} and block = {block} "
                         "leave no room for the planted columns")
    big = range(block - G, block)
    X[:, big[1]:block] = X[:, big[0]:big[0] + 1]
    planted.update({j: "corr" for j in big[1:]})
    g40 = range(block + 10, block + 50)
    X[:, g40[1]:g40[-1] + 1] = X[:, g40[0]:g40[0] + 1]
    planted.update({j: "corr" for j in g40[1:]})
    for k, (alpha, beta) in enumerate(((2.0, 1.0), (-3.0, 0.5), (0.5, -2.0),
                                       (-1.0, 0.0)) * 3):
        i = block + 100 + 7 * k
        X[:, i + 3] = alpha * X[:, i] + beta
        planted[i + 3] = "corr"
    X[:, block + 200] = 3.0 * y + 0.5
    planted[block + 200] = "label corr"
    for t in range(4):
        X[:, block + 210 + t] = 2.0 * (t % 2)
        planted[block + 210 + t] = "variance"
    return X.cpu().numpy(), y.double().cpu().numpy(), planted


class WarningLog(logging.Handler):
    """The warning records of a logger while installed."""

    def __init__(self, name: str):
        super().__init__(logging.WARNING)
        self.logger = logging.getLogger(name)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


@contextlib.contextmanager
def swapped(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def planted_drops(summary: dict, planted: dict) -> dict:
    """Each planted column's drop reasons, and the columns dropped that
    were not planted; raises unless every planted column is dropped for
    its reason."""
    stats = summary["stats"]
    wrong = {}
    for j, reason in planted.items():
        rs = stats[j]["dropped"]
        if not any(r.startswith(reason) for r in rs):
            wrong[j] = rs
    dropped = set(summary["dropped"])
    extra = sorted(dropped - set(planted))
    if wrong or set(planted) - dropped:
        raise AssertionError(
            f"planted columns not dropped for their reason: "
            f"{dict(list(wrong.items())[:5])} (of {len(wrong)})")
    return {"planted": len(planted), "dropped": len(dropped),
            "dropped_not_planted": extra[:20]}


def wide_sanity_phase(port, device="cuda", rows: int = WIDE_ROWS,
                      d: int = WIDE_D, seed: int = WIDE_SEED) -> dict:
    """Phase 25: `SanityChecker()` (Pearson) and
    `SanityChecker(correlation_type="spearman")` fitted through
    `Workflow.train` on a seeded wide table (`wide_synthetic`), the
    duplicate check past `_WIDE_D` columns on the blocked Gram with
    K9-hits. Each type: every planted column dropped for its reason, the
    first block's truncation logged, K9-hits launched on the main path
    (counts read around the train alone); then the same fit again with
    the plain extraction, K9-hits run beside it on every block's product
    and held to it bit for bit: kept indices equal to the train's. Then,
    on the card, CUDA-event timings of one Gram block, K9-hits on a real
    block product (beside its bound, its plain version and
    `torch.nonzero` + gather), the rank transform; the fit's wall and
    `torch.cuda.max_memory_allocated` over the train and over the
    checker's fit alone."""
    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    from transmogrifai_tpu_torch.stages.base import FitContext
    import transmogrifai_tpu_torch.types as T
    dev = torch.device(device)
    block = sc.wide_block(d)
    cap = 16 * block
    t0 = time.perf_counter()
    X, y, planted = wide_synthetic(rows, d, block, seed, dev)
    xs = np.empty(rows, dtype=object)
    for i in range(rows):
        xs[i] = X[i]
    ds = port.Dataset({"x": xs, "y": y}, {"x": T.OPVector, "y": T.RealNN})
    made_s = time.perf_counter() - t0
    rec = {"phase": "wide_sanity", "rows": rows, "d": d, "block": block,
           "cap": cap, "truncating_group": truncating_group(cap),
           "synthetic_s": made_s, "types": {}}
    real_hits = sc.corr_hits
    real_fit = sc.SanityChecker.fit_model
    fit_peak = {}

    def fit_measured(self, cols, ctx):
        """The checker's fit, its own device peak recorded above what is
        allocated when it starts (`fit_peak`), the train's peak before
        it kept (`train_before`)."""
        if dev.type != "cuda":
            return real_fit(self, cols, ctx)
        torch.cuda.synchronize(dev)
        fit_peak["train_before"] = torch.cuda.max_memory_allocated(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = real_fit(self, cols, ctx)
        torch.cuda.synchronize(dev)
        fit_peak["fit"] = torch.cuda.max_memory_allocated(dev) - base
        return out

    for ctype in ("pearson", "spearman"):
        label = port.FeatureBuilder.RealNN("y").from_column("y") \
            .as_response()
        x = port.FeatureBuilder.OPVector("x").from_column("x").as_predictor()
        checked = label.sanity_check(x, correlation_type=ctype)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        fit_peak.clear()
        with WarningLog(sc.__name__) as warned, swapped(
                sc.SanityChecker, "fit_model", fit_measured):
            model = port.Workflow().set_result_features(checked, label) \
                .set_input_dataset(ds).train(device=device)
        wall = time.perf_counter() - t0
        launches = {k: cuda_build.LAUNCHES[k] for k in WIDE_KERNELS}
        peak = (max(fit_peak["train_before"],
                    torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None)
        fit_s = next(s for name, s in model.stage_seconds
                     if name == "SanityChecker")
        fitted = next(m for m in model.fitted.values()
                      if isinstance(m, sc.SanityCheckerModel))
        summary = fitted.summary
        drops = planted_drops(summary, planted)
        truncated = [m for m in warned.messages if "truncated" in m]
        if not truncated:
            raise AssertionError(f"{ctype}: no block truncated at cap {cap}")
        if dev.type == "cuda" and not all(v >= 1 for v in launches.values()):
            raise AssertionError(f"{ctype}: a kernel never launched: "
                                 f"{launches}")
        cols = [model.train_columns[f.uid] for f in (label, x)]
        ctx = FitContext(n_rows=rows, seed=0, device=dev)
        blocks = []

        def plain_held(C, a, thr, c):
            """The plain extraction, K9-hits held to it on the same C."""
            got = real_hits(C, a, thr, c)
            want = sc.corr_hits_plain(C, a, thr, c)
            if not all(bits_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"{ctype}: K9-hits differs from corr_hits_plain on the "
                    f"block at column {a}")
            blocks.append({"a": a, "total": int(want[3]), "equal": True})
            return want

        with swapped(sc, "corr_hits", plain_held):
            plain_kept = sc.SanityChecker(correlation_type=ctype).fit_model(
                cols, ctx).indices
        if plain_kept != fitted.indices:
            raise AssertionError(f"{ctype}: kept indices differ between the "
                                 "kernel's and the plain extraction")
        rec["types"][ctype] = {
            "train_wall_s": wall, "fit_s": fit_s, "peak_bytes": peak,
            "fit_peak_bytes": fit_peak.get("fit"), "x_bytes": X.nbytes,
            "launches_main_path": launches, "kept": len(fitted.indices),
            **drops, "truncation_warnings": truncated,
            "blocks_held_to_plain": blocks, "kept_equal_to_plain": True}
        del model, fitted, cols
    if dev.type == "cuda":
        rec["timing"] = wide_timings(sc, X, dev, block, cap)
    emit(rec)
    return rec


def wide_timings(sc, X_np, dev, block, cap) -> dict:
    """CUDA-event ms after warmup at the wide fit's shapes: one Gram block
    U_bᵀ·U beside its operation bound 2·n·b·d at 67 TFLOP/s f32; K9-hits
    on the first block's product beside its bytes bound (the lower
    triangle read once, the outputs written once), its plain version and
    `torch.nonzero` of the mask plus the gather; the rank transform of
    the whole table."""
    n, d = X_np.shape
    X = torch.from_numpy(X_np).to(dev)
    U = X - X.mean(0)
    sd = torch.linalg.vector_norm(U, dim=0)
    U.div_(torch.where(sd > 0, sd, 1.0)).masked_fill_(~(sd > 0), 0.0)
    out = {}
    gram_ms = cuda_ms(lambda: U[:, :block].T @ U, iters=3, warmup=1)
    b_ms, b_by = bound(0.0, 2.0 * n * block * d)
    out["gram_block"] = {"ms": gram_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "shape": [n, block, d]}
    C = U[:, :block].T @ U
    thr = sc.MAX_FEATURE_CORR
    lower = sum(min(d, r) for r in range(block))  # cells j < a + r, a = 0
    got = sc.corr_hits(C, 0, thr, cap)
    want = sc.corr_hits_plain(C, 0, thr, cap)
    total = int(want[3])
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("K9-hits differs from corr_hits_plain on the "
                             "timed block")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    hit_ms = cuda_ms(lambda: sc.corr_hits(C, 0, thr, cap), iters=20)
    plain_ms = cuda_ms(lambda: sc.corr_hits_plain(C, 0, thr, cap), iters=3,
                       warmup=1)
    rows = torch.arange(block, device=dev)[:, None]
    cols = torch.arange(d, device=dev)[None, :]
    mask = (C.abs() > thr) & (cols < rows)

    def library():
        nz = torch.nonzero(mask)
        return C[nz[:, 0], nz[:, 1]]

    lib_ms = cuda_ms(library, iters=10)
    h_ms, h_by = bound(4.0 * lower + 20.0 * cap + 8, 0.0)
    out["corr_hits"] = {"ms": hit_ms, "bound_ms": h_ms, "bound_by": h_by,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "shape": [block, d], "hits": total,
                        "max_abs_err": err}
    del C, mask, U
    torch.cuda.empty_cache()
    out["rank_transform"] = {"ms": cuda_ms(lambda: sc._rank_transform(X),
                                           iters=1, warmup=1),
                             "shape": [n, d]}
    del X
    torch.cuda.empty_cache()
    return out


def missing_parts() -> list:
    """What this run lacks before it can start: a CUDA device, and the
    port's package beside this script (a copy of `chip_smoke.py` alone in
    a directory has none)."""
    import importlib.util
    missing = []
    if not torch.cuda.is_available():
        missing.append("a CUDA device: torch.cuda.is_available() is false")
    if importlib.util.find_spec("transmogrifai_tpu_torch") is None:
        missing.append(f"the transmogrifai_tpu_torch package beside "
                       f"chip_smoke.py (looked in {HERE} and sys.path)")
    return missing


def main() -> int:
    missing = missing_parts()
    if missing:
        # one line naming what is missing; no result line follows
        emit({"phase": "preflight", "ok": False, "missing": missing})
        print("chip_smoke: cannot run: " + "; ".join(missing),
              file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch import Dataset, cuda_build, load_model
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.serving import ScoringService, ServingConfig

    dev = torch.device("cuda")
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # 1. build ------------------------------------------------------------- #
    t0 = time.perf_counter()
    secs = cuda_build.build(cuda_build.SOURCES)
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
    boundaries = walk_boundary_check(pt, np.random.default_rng(3), dev,
                                     narrow=False)
    emit({"phase": "k5_check", "sizes": list(SIZES),
          "tables": {"gbt_m1": list(tables["feat"].shape),
                     "forest_m2_depth12": list(forest["feat"].shape)},
          "max_abs_err": k5_err, "tolerance": "equal",
          "boundaries": boundaries})

    # 4. the main path: load + score_compiled on all 891 rows --------------- #
    ds = Dataset.from_csv(TITANIC)
    with np.load(os.path.join(FIXTURE, "expected_scores.npz")) as z:
        want = {k: z[k] for k in z.files}
    pt.reset_launches()
    main_model = load_model(FIXTURE, device="cuda")
    got = prediction_of(main_model.score_compiled(ds))
    torch.cuda.synchronize()
    per_batch = {k: pt.LAUNCHES[k] for k in SERVING_KERNELS}
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
    launches = {k: pt.LAUNCHES[k] for k in SERVING_KERNELS}
    if not all(v >= 1 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    emit({"phase": "service", "requests": answered, "equal": True,
          "health": health, "launches_main_path": launches})

    # 7. training kernels against their plain versions --------------------- #
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
    import transmogrifai_tpu_torch as port
    check, fit_cases = check_training_kernels(pt, pdm, rng, dev)
    emit(check)
    skew_check(pt, rng, dev)
    leaf_regime_timings(pt, rng, dev)
    torch.cuda.empty_cache()

    # 8. the training path ---------------------------------------------------- #
    trained, train_ds, train_rec = train_path(port, pt)

    # 11. forest kernels at level 11 of the depth-12 bucket ----------------- #
    forest_check, forest_cases = check_forest_kernels(pt, rng, dev)
    emit(forest_check)
    live_rec, forest_cases["live11"] = live_levels_check(pt, rng,
                                                         forest_cases, dev)
    forest_timing = time_forest_kernels(pt, forest_cases)
    del forest_cases
    torch.cuda.empty_cache()

    # 12. the README quickstart: the default sweep -------------------------- #
    default_model, default_ds, default_rec, default_draws = \
        default_train_path(port, pt)
    train_launches = default_rec["launches_main_path"]
    default_train_walls(port, pt, default_ds, default_draws, default_rec)

    # 13. the evaluation kernels, and K1/K1-sub/K2/K3 at m = 3 ------------ #
    eval_cases = eval_kernels(pdm, rng, dev)
    m3 = three_class_level(pt, rng, dev)
    emit({"phase": "eval_kernels", "cases": eval_cases,
          "three_class_level11": m3,
          "hostile": k8_hostile_check(pdm, pt, dev),
          "many_channels": many_channel_check(pt, dev)})
    torch.cuda.empty_cache()

    # 14, 15. the Iris and Boston examples, verbatim ----------------------- #
    iris_rec = example_train(port, pt, "iris")
    boston_rec = example_train(port, pt, "boston")

    # 16-18. K5-mc; the selectors' other families; each new class served -- #
    k5mc_rec, k5mc_trees, k5mc_rows = k5mc_check(pt, rng, dev)
    for run in RUNS:
        families_train(port, pt, run)
    serve_rec = families_serve(port, pt)
    k5mc_timing = time_k5mc(pt, k5mc_trees, k5mc_rows)
    del k5mc_trees, k5mc_rows

    # 23. any class count: the default multiclass selector at 7 classes,
    # a 7-class decision tree, the multinomial LR at 40 classes -------- #
    many_class_phase(port, pt)

    # 19. examples/op_titanic_simple.py, verbatim ------------------------- #
    from transmogrifai_tpu_torch.workflow import compiled as pc
    simple_model, simple_ds, simple_rec = titanic_simple_train(port, pt)

    # 20. quantized serving and CUDA graphs ------------------------------ #
    _, quant_cases = quant_kernel_check(port, pt, pc, rng, dev)
    emit({"phase": "k10_hostile", **k10_hostile_check(pc, pt, dev)})
    quant_launches, quant_loaded = quant_serving(port, pt, pc)
    quant_timing = time_quant_kernels(pt, pc, quant_cases)
    del quant_cases

    # 6. timings ------------------------------------------------------------ #
    timing = {}
    for n in SIZES:
        X, Xb = inputs[n], binned[n]
        k5 = k5_timing(pt, Xb, tables["feat"], tables["bin"], tables["leaf"])
        timing[n] = {"tree_walk": k5}
        if n > 1:
            timing[n]["bin_features"] = k4_timing(pt, X, edges, inputs[1])
        if n == 891:  # phase 3's depth-12 forest (m = 2)
            timing[n]["tree_walk_forest_m2_depth12"] = k5_timing(
                pt, Xb, forest["feat"], forest["bin"], forest["leaf"])
        emit({"phase": "timing", "n": n, **timing[n]})
    emit({"phase": "timing", "launch_idiom_floor": launch_idiom_floor(
        pt, inputs[1], edges)})
    # served batches: CUDA graphs against eager dispatch, f32 and int8, the
    # quickstart GBT and the script's models (the JAX package's, and the port's
    # own from phase 19)
    serving_timing(port, pc, {
        "gbt": (main_model, ds),
        "simple_jax": (quant_loaded["simple"][0], quant_loaded["simple"][1]),
        "simple_port": (simple_model, simple_ds)})

    # 9. training timings ------------------------------------------------- #
    fit_timing = time_training_kernels(pt, pdm, fit_cases)
    del fit_cases
    sweep_busy_share(port, trained, train_ds,
                     [(port.OpXGBoostClassifier(**XGB), GRID)], "xgboost")
    from transmogrifai_tpu_torch.selector.model_selector import (
        _default_binary_models)
    sweep_busy_share(port, default_model, default_ds,
                     _default_binary_models(), "default",
                     draws=default_draws)

    # 21, 22. the out-of-core path at 4,456,448 × 500, then the same store
    # through the feature cache ------------------------------------------ #
    big = big_path()
    bk = big["kernels"]
    big_launches = big["launches_main_path"]
    ck = big["cache"]["kernels"]
    cache_launches = big["cache"]["launches_main_path"]

    def big_entry(name, source, replaces, key=None):
        t = bk[key or name]
        return {"name": f"{name}_big" if name != "write_rows" else name,
                "route": "cuda",
                "source": f"transmogrifai_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": big_launches[name],
                **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by",
                                     "library_ms")}}

    # 24, 25. feature validation at full scope; the wide sanity check ---- #
    t0 = time.perf_counter()
    feature_validation_phase(port, pt)
    fv_s = time.perf_counter() - t0
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    hostile = k9_hits_hostile_check(sc, dev)
    wide = wide_sanity_phase(port)
    emit({"phase": "k9_hits_hostile", "cases": hostile,
          "walls_s": {"feature_validation": fv_s,
                      "wide_sanity": time.perf_counter() - t0 - fv_s}})
    wk = wide["timing"]["corr_hits"]

    # 10. the kernels line, the card, the result --------------------------- #
    main_n = timing[891]
    aupr = fit_timing[f"n{FIT_N}_aupr512"]["binned_aupr"]
    errs = {k: max(check["max_abs_err"].get(k, 0.0),
                   forest_check["max_abs_err"].get(k, 0.0))
            for k in set(check["max_abs_err"])
            | set(forest_check["max_abs_err"])}
    errs["split_search_live"] = max(
        [errs["split_search_live"]]
        + [v["diff"] for v in live_rec.values() if isinstance(v, dict)])

    def train_entry(name, source, replaces, t):
        return {"name": name, "route": "cuda",
                "source": f"transmogrifai_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": train_launches[name],
                "max_abs_err": errs[name],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
    def eval_entry(name, replaces, path_rec, t):
        return {"name": name, "route": "cuda",
                "source": "transmogrifai_tpu_torch/csrc/eval_metrics.cu",
                "replaces": replaces,
                "launches": path_rec["launches_main_path"][name],
                "max_abs_err": max(v["max_abs_err"] for k, v in
                                   eval_cases.items() if k.endswith(name)),
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}
    emit({"kernels": [
        {"name": "bin_features", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/bin_features.cu",
         "replaces": "transmogrifai_tpu/models/trees.py:63",
         "launches": train_launches["bin_features"], "max_abs_err": k4_err,
         **{k: main_n["bin_features"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "tree_walk", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/tree_walk.cu",
         "replaces": "transmogrifai_tpu/models/trees.py:334",
         "launches": train_launches["tree_walk"], "max_abs_err": k5_err,
         **{k: main_n["tree_walk"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        train_entry("histograms", "histograms.cu",
                    "transmogrifai_tpu/models/trees.py:127",
                    forest_timing["histograms"]),
        train_entry("sibling_subtract", "sibling_subtract.cu",
                    "transmogrifai_tpu/models/trees.py:278",
                    forest_timing["sibling_subtract"]),
        train_entry("split_search", "split_search.cu",
                    "transmogrifai_tpu/models/trees.py:170",
                    forest_timing["split_search"]),
        train_entry("split_search_live", "split_search.cu",
                    "transmogrifai_tpu/models/trees.py:170",
                    forest_timing["split_search_live"]),
        train_entry("route_level", "route_leaves.cu",
                    "transmogrifai_tpu/models/trees.py:271",
                    forest_timing["route_level"]),
        train_entry("leaf_values", "route_leaves.cu",
                    "transmogrifai_tpu/models/trees.py:289",
                    forest_timing["leaf_values"]),
        train_entry("binned_aupr", "binned_aupr.cu",
                    "transmogrifai_tpu/models/trees.py:564", aupr),
        eval_entry("confusion_counts",
                   "transmogrifai_tpu/evaluators/device_metrics.py:145",
                   iris_rec, eval_cases["iris:confusion_counts"]),
        eval_entry("regression_moments",
                   "transmogrifai_tpu/evaluators/device_metrics.py:159",
                   boston_rec, eval_cases["boston:regression_moments"]),
        {"name": "tree_walk_classes", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/tree_walk.cu",
         "replaces": "transmogrifai_tpu/models/trees.py:797",
         "launches": serve_rec["launches_main_path"]["tree_walk_classes"],
         "max_abs_err": k5mc_rec["max_abs_err"],
         **{k: k5mc_timing[150][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        *[{"name": name, "route": "cuda",
           "source": f"transmogrifai_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": quant_launches[name],
           "max_abs_err": 0.0,
           **{k: quant_timing[QUANT_BATCH][name][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
          for name, source, replaces in (
              ("wire_dequant", "wire_dequant.cu",
               "transmogrifai_tpu/workflow/compiled.py:170"),
              ("bin_features_f16", "bin_features.cu",
               "transmogrifai_tpu/models/trees.py:1016"),
              ("tree_walk_narrow", "tree_walk.cu",
               "transmogrifai_tpu/models/trees.py:334"))],
        big_entry("write_rows", "write_rows.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:85"),
        big_entry("histograms", "histograms.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1014"),
        big_entry("split_search", "split_search.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1131"),
        big_entry("split_search_live", "split_search.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1131"),
        big_entry("route_level", "route_leaves.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1080"),
        big_entry("leaf_values", "route_leaves.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1061"),
        big_entry("tree_walk", "tree_walk.cu",
                  "transmogrifai_tpu/parallel/bigdata.py:1413"),
        big_entry("binned_aupr", "binned_aupr.cu",
                  "transmogrifai_tpu/models/trees.py:564"),
        *[{"name": f"{entry}_int{bits}", "route": "cuda",
           "source": "transmogrifai_tpu_torch/csrc/write_rows.cu",
           "replaces": replaces,
           "launches": cache_launches[f"{entry}_int{bits}"],
           **{k: ck[f"{entry}_int{bits}"][k] for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")}}
          for entry, replaces in DEQUANT_ENTRIES for bits in (8, 4)],
        {"name": "corr_hits", "route": "cuda",
         "source": "transmogrifai_tpu_torch/csrc/corr_hits.cu",
         "replaces": "transmogrifai_tpu/automl/sanity_checker.py:173",
         "launches": sum(t["launches_main_path"]["corr_hits"]
                         for t in wide["types"].values()),
         **{k: wk[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
