"""The batched model sweep: fit → predict → metric for every (grid config,
fold) pair of one model family.

The port's counterpart of the JAX package's `parallel/sweep.py`
(`run_sweep` → `_run_sweep`, the single-device `_sweep_blocks` scaffold
and the handlers of every family its `_dispatch` knows: logistic (FISTA
and L-BFGS), linear regression, linear SVC, GLM, naive Bayes, MLP,
forests and decision trees, GBT and XGBoost (binary, softmax and
squared), for binary, multiclass and regression labels). A fold is a pair
of 0/1 row masks over the one training matrix. Configs group by their static
parameters (`static_of`: the shapes a fit compiles to in the JAX
package); the (config, fold) pairs of a group fit together along the
leading pair axis of the family's batched fit, so each kernel launch
serves every pair. Tree families bin the training matrix once per
`max_bins` (K4), shared across families through the fit context, and pad
each config's depth to its bucket (`_depth_bucket`), stopping its own
trees at its own depth. Each run of pairs is scored by one call of the
device metric over all its pairs (one launch of K8-mc or K8-reg for a
multiclass or regression group). An evaluator with no device metric
(bin score, forecast, custom lambdas) keeps the batched fits on the
device and scores on the host (`HostMetricFallback`: each block's
predictions move to the host in one copy); an estimator class the
dispatch does not know runs the generic per-config loop
(`_sweep_generic`) over its own `fit_arrays` and `predict_arrays`. Every
static group runs in a ``sweep:block`` span (`obs/trace.py`).

Fault tolerance and resume, as in the JAX package: `run_sweep(...,
journal=)` skips the configs a `runtime.journal.SweepJournal` already
holds (`journal_prefill`, bit-identical: journal floats round-trip
exactly) and appends each block's fold metrics as soon as the block
completes (`_journal_commit`); `_run_groups_resilient` fires the
``sweep.run_block`` fault point before every block and, on a device OOM,
halves the block and retries each half (an ``oom_redo`` event records the
wasted attempt). Resume, OOM halving, the scheduler's blocks and a mesh's
lanes all change which configs share one batched fit, so every family's
batched fit gives each (config, fold) pair the same bits whatever pairs
share its launch (held by `tests/test_torch_scheduler.py`).

K11, `_run_block`: with `sharding=` (`parallel/mesh.sweep_sharding`) each
static group pads to a multiple of the mesh's sweep width by repeating
its last config (`_shard_dyn`) and runs one contiguous slice per lane, as
the same batched program on the lane's device, on a worker thread with a
stream of its own; the rows come back in lane order without the pad.

The data axis: every handler fits and predicts over a
`parallel.rowshards.RowSplit` of X (`_row_split`, once per training
matrix): a fit context whose mesh has a data axis wider than 1 (a lane's
(1, data) sub-mesh) splits the rows over the row's devices, any other
gives X as one shard, the same code with the unsharded bits. K4 bins
each shard on its device; every family's fit (logistic, linear, linear
SVC, GLM, naive Bayes, MLP, the trees) reduces over the shards
explicitly; each handler's predictions come back gathered to the lead in
row order (`RowSplit.preds`), so the metric (K8, K8-mc, K8-reg) runs once
on the whole (P, n) there, with W and V whole on the lead.
`_sweep_generic` takes X whole, as in the JAX package.

Not ported: the learned cost model's hooks (the block features behind
`facts`, the HBM pre-shrink and the dispatch-width calibration) come with
`perf/` (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.evaluators.device_metrics import (
    make_device_metric)
from transmogrifai_tpu_torch.models.base import (
    binary_margin_pred, infer_n_classes, regression_pred)
from transmogrifai_tpu_torch.models.glm import (
    OpGeneralizedLinearRegression, fit_glm, glm_pred_from_eta)
from transmogrifai_tpu_torch.models.linear import (
    OpLinearRegression, fit_linreg, fit_linreg_enet)
from transmogrifai_tpu_torch.models.linear_svc import (
    OpLinearSVC, fit_linear_svc)
from transmogrifai_tpu_torch.models.logistic import (
    OpLogisticRegression, enet_iters, fit_logreg, fit_logreg_enet,
    logreg_pred_from_logits)
from transmogrifai_tpu_torch.models.mlp import (
    OpMultilayerPerceptronClassifier, _forward, fit_mlp)
from transmogrifai_tpu_torch.models.naive_bayes import (
    NEGATIVE_FEATURES, OpNaiveBayes, fit_naive_bayes, has_negative)
from transmogrifai_tpu_torch.models.trees import (
    OpGBTClassifier, OpRandomForestClassifier, OpRandomForestRegressor,
    bin_features, fit_forest, fit_gbt_multiclass_pairs, fit_gbt_pairs,
    forest_classification_pred, forest_regression_pred,
    gbt_multiclass_pred_from_margin, gbt_pred_from_margin,
    quantile_bin_edges)
from transmogrifai_tpu_torch.obs import export as obs_export
from transmogrifai_tpu_torch.obs.trace import TRACER
from transmogrifai_tpu_torch.parallel.rowshards import RowShards, RowSplit
from transmogrifai_tpu_torch.runtime.faults import (
    SITE_RUN_BLOCK, fault_point, is_oom_error)
from transmogrifai_tpu_torch.runtime.journal import SweepJournal

log = logging.getLogger(__name__)

Pred = Dict[str, torch.Tensor]

_DEPTH_BUCKETS = (4, 6, 8, 10, 12, 14)
# GBT histogram bytes one launch may hold across its pairs (G + H, deepest
# level); more pairs than fit run in several launches
_PAIR_HIST_BYTES = 2 << 30


def _grid_param(est, grid: Dict, name: str) -> Any:
    return grid.get(name, getattr(est, name, est.params.get(name)))


# --------------------------------------------------------------------------- #
# block journaling + fault-resilient group execution                          #
# --------------------------------------------------------------------------- #

# Per-family sweep state set by run_sweep for the duration of one family's
# handler call. Thread-local on purpose: the scheduler's lanes sweep
# concurrently, each with its own journal shard.
_SWEEP_TL = threading.local()


def _active_journal():
    return getattr(_SWEEP_TL, "journal", None)


def _block_fault_point() -> None:
    """The ``sweep.run_block`` site, once per block: a mesh lane's share
    of a block (`_run_block`) is not a block of its own, so it passes
    without counting, as the JAX package's one sharded program does."""
    if not getattr(_SWEEP_TL, "lane", False):
        fault_point(SITE_RUN_BLOCK)


class _BestTracker:
    """Running best-so-far (mean metric + grid) recorded into each journal
    entry, so a resumed operator can see where an interrupted sweep stood."""

    def __init__(self, larger_is_better: bool):
        self.sign = 1.0 if larger_is_better else -1.0
        self.best: Optional[Dict[str, Any]] = None

    def note(self, grid: Dict, row: List[float]) -> Optional[Dict[str, Any]]:
        mean = float(np.mean(row)) if row else float("nan")
        if np.isfinite(mean) and (
                self.best is None
                or self.sign * mean > self.sign * self.best["mean"]):
            self.best = {"mean": mean, "grid": grid}
        return self.best


def journal_prefill(journal, grids: List[Dict],
                    metrics: List[Optional[List[float]]],
                    event: str = "journal_resume") -> int:
    """Fill journaled rows into `metrics`; returns how many were skipped.
    Journal floats round-trip JSON exactly, so a resumed sweep's metric
    matrix is bit-identical to an uninterrupted run's. The one resume-
    skip implementation: the in-family path, the scheduler's per-job
    resume and the pod's cross-host merge all route through it. `event`
    names the timeline event: a resume credits the journal with blocks it
    avoided re-running ("journal_resume", the goodput report's savings),
    while a pod host merging blocks other hosts ran in this run records
    "pod_merge" (fleet work, not savings)."""
    if journal is None:
        return 0
    hits = 0
    saved_s = 0.0
    for i, g in enumerate(grids):
        if metrics[i] is not None:
            continue
        row = journal.lookup(g)
        if row is not None:
            metrics[i] = row
            saved_s += journal.duration_of(g)
            hits += 1
    if hits:
        if event == "journal_resume":
            log.info("sweep journal: resuming past %d/%d completed blocks",
                     hits, len(grids))
            obs_export.record_event("journal_resume", blocks=hits,
                                    total=len(grids),
                                    saved_s=round(saved_s, 6))
        else:
            log.info("sweep journal: merged %d/%d foreign blocks (%s)",
                     hits, len(grids), event)
            obs_export.record_event(event, blocks=hits,
                                    total=len(grids),
                                    foreign_s=round(saved_s, 6))
    return hits


def _journal_commit(grids: List[Dict],
                    metrics: List[Optional[List[float]]],
                    idxs: List[int],
                    block_s: Optional[float] = None) -> None:
    journal = _active_journal()
    if journal is None:
        return
    best = getattr(_SWEEP_TL, "best", None)
    # the block ran its configs as one program: attribute wall time evenly
    per_cfg = (block_s / len(idxs)) if (block_s and idxs) else None
    for i in idxs:
        row = metrics[i]
        if row is None or any(m is None for m in row):
            continue
        journal.append(grids[i], row,
                       best=best.note(grids[i], row) if best else None,
                       duration_s=per_cfg)


def _block_key_fn(grids: List[Dict]):
    """Content key of a block (the grids it ran), the JAX package's
    `block_key` formula: each ``sweep:block`` span carries it, so a span
    names the journal records its block wrote."""

    def key(idxs: List[int]) -> str:
        return SweepJournal.key_of({"block": [grids[i] for i in idxs]})
    return key


def _run_groups_resilient(groups: Dict[Tuple, List[int]], run_one,
                          commit, family: str, block_key=None) -> None:
    """Execute grid-block groups with the fault-tolerance contract:

    - `fault_point(SITE_RUN_BLOCK)` fires before every block, so a chaos
      plan can kill or fail the sweep at any block boundary;
    - a device-OOM failure HALVES the block and retries each half before
      surfacing (narrower blocks fit where wide ones did not); the failed
      wide attempt's wall time is recorded as an ``oom_redo`` badput
      event on the enclosing span;
    - `commit(idxs, block_s)` journals a block only after it fully
      completes, stamped with its wall cost (resume-skip accounting).
    """

    def run(static, idxs):
        t0 = time.perf_counter()
        attrs = {"block": block_key(idxs)} if block_key is not None else {}
        try:
            with TRACER.span("sweep:block", category="sweep",
                             family=family, static=repr(static),
                             configs=len(idxs), **attrs):
                _block_fault_point()
                run_one(static, idxs)
        except Exception as e:
            if len(idxs) <= 1 or not is_oom_error(e):
                raise
            wasted = time.perf_counter() - t0
            obs_export.record_event("oom_redo", family=family,
                                    configs=len(idxs),
                                    wasted_s=round(wasted, 6))
            mid = (len(idxs) + 1) // 2
            log.warning(
                "sweep %s block %r: device OOM with %d configs (%s) — "
                "halving block width and retrying", family, static,
                len(idxs), e)
            run(static, idxs[:mid])
            run(static, idxs[mid:])
            return
        commit(idxs, time.perf_counter() - t0)

    for static, idxs in groups.items():
        run(static, idxs)


def _depth_bucket(depth: int) -> int:
    """A max_depth's padding bucket: configs of one bucket grow trees of
    the bucket's depth together, each stopping at its own depth."""
    for b in _DEPTH_BUCKETS:
        if depth <= b:
            return b
    return _DEPTH_BUCKETS[-1]


def _pad_depth_of(est, grids, idxs) -> int:
    return _depth_bucket(
        max(int(_grid_param(est, grids[i], "max_depth")) for i in idxs))


class HostMetricFallback:
    """The metric_fn marker of an evaluator with no device metric: the
    batched fit and predict run on the device as for any evaluator, and
    each pair's metric is the host evaluator's (the JAX package's
    `HostMetricFallback`)."""

    def __init__(self, evaluator):
        self.evaluator = evaluator


def _metric(evaluator, y: np.ndarray, pred: Dict[str, np.ndarray],
            val_mask: np.ndarray) -> float:
    """The host evaluator's metric of one pair's predictions on its
    fold's validation rows."""
    idx = np.asarray(val_mask) > 0.5
    label = Column(T.RealNN, {
        "value": y[idx], "mask": np.ones(int(idx.sum()), dtype=bool)})
    pcol = Column(T.Prediction, {k: np.asarray(v)[idx]
                                 for k, v in pred.items()})
    return evaluator.metric_value(label, pcol)


def _host_metrics(metric_fn: HostMetricFallback, y_np: np.ndarray,
                  preds: Sequence[Pred], masks: np.ndarray) -> List[float]:
    """The host metric of each pair of a block: the block's predictions
    move to the host once, stacked along the pair axis."""
    stacked = {k: torch.stack([p[k] for p in preds]).cpu().numpy()
               for k in preds[0]}
    return [_metric(metric_fn.evaluator, y_np,
                    {k: v[t] for k, v in stacked.items()}, masks[t])
            for t in range(len(preds))]


def _sweep_blocks(grids: List[Dict], y: torch.Tensor, W: torch.Tensor,
                  V: torch.Tensor, metric_fn, ctx, family: str,
                  static_of: Callable[[Dict], Tuple],
                  dyn_of: Callable[[Dict], Dict[str, Any]],
                  fit_predict: Callable[..., Sequence[Pred]],
                  pair_width: Callable[[Tuple, List[int]], int] = None
                  ) -> List[List[float]]:
    """Group the configs the active journal does not hold by `static_of`;
    per group, run its (config, fold) pairs `pair_width` at a time (all at
    once by default) through `fit_predict(static, idxs, dyn, W_pairs,
    V_pairs)`, where `dyn` holds one list per dynamic parameter (one entry
    per pair) and the result is one prediction dict per pair, and score
    each pair's prediction on its fold's validation rows, all pairs of the
    run in one `metric_fn(y, preds, masks)` call (or on the host, pair by
    pair, for a `HostMetricFallback`). Groups run in the order their
    first config appears, through `_run_groups_resilient` (a
    ``sweep:block`` span, the fault point, OOM halving, a journal commit
    after each block); each group's seconds land in `ctx._sweep_seconds`
    (keyed by lane on a mesh lane)."""
    n_folds = W.shape[0]
    host = isinstance(metric_fn, HostMetricFallback)
    y_np = y.cpu().numpy() if host else None
    V_np = V.cpu().numpy() if host else None
    metrics: List[Optional[List[float]]] = [None] * len(grids)
    journal_prefill(_active_journal(), grids, metrics)
    groups: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(grids):
        if metrics[i] is None:
            groups.setdefault(static_of(g), []).append(i)
    seconds = getattr(ctx, "_sweep_seconds", None) if ctx is not None \
        else None
    lane = getattr(ctx, "_sweep_lane", None) if ctx is not None else None

    def run_group(static, idxs):
        t0 = time.perf_counter()
        rows = {i: [0.0] * n_folds for i in idxs}
        pairs = [(i, f) for i in idxs for f in range(n_folds)]
        width = pair_width(static, idxs) if pair_width else len(pairs)
        for s in range(0, len(pairs), max(1, width)):
            chunk = pairs[s:s + width]
            dyn = [dyn_of(grids[i]) for i, _ in chunk]
            cols = {k: [dd[k] for dd in dyn] for k in dyn[0]}
            fsel = [f for _, f in chunk]
            fs = torch.as_tensor(fsel, device=W.device)
            Vsel = V[fs]
            preds = fit_predict(static, idxs, cols, W[fs], Vsel)
            if host:
                vals = _host_metrics(metric_fn, y_np, preds, V_np[fsel])
            else:
                vals = metric_fn(y, preds, Vsel).tolist()
            for t, (i, f) in enumerate(chunk):
                rows[i][f] = float(vals[t])
        if y.is_cuda:  # this thread's stream only: lanes on one card overlap
            torch.cuda.current_stream(y.device).synchronize()
        for i in idxs:
            metrics[i] = rows[i]
        if seconds is not None:
            key = f"{family}:{static}" + ("" if lane is None
                                          else f"@lane{lane}")
            with _SECONDS_LOCK:
                seconds[key] = time.perf_counter() - t0

    _run_groups_resilient(
        groups, run_group,
        commit=lambda idxs, block_s=None: _journal_commit(
            grids, metrics, idxs, block_s),
        family=family, block_key=_block_key_fn(grids))
    return metrics  # type: ignore[return-value]


_SECONDS_LOCK = threading.Lock()


def _row_split(ctx, X: torch.Tensor) -> RowSplit:
    """X split over the data axis of the context's mesh (its first sweep
    row's devices), or X as one shard when there is no axis wider than 1.
    Cached on the context per training matrix (identity-keyed, holding
    X)."""
    cached = getattr(ctx, "_sweep_rows", None) if ctx is not None else None
    if cached is not None and cached[0] is X:
        return cached[1]
    mesh = getattr(ctx, "mesh", None) if ctx is not None else None
    if mesh is None or mesh.data_width <= 1:
        rows = RowSplit(RowShards.single(X), [X])
    else:
        shards = RowShards(X.shape[0], mesh.lane_devices(0))
        rows = RowSplit(shards, shards.split(X))
    if ctx is not None:
        ctx._sweep_rows = (X, rows)
    return rows


def _binned_cache(est, grids, X: torch.Tensor, ctx,
                  rows: RowSplit) -> Dict[int, RowSplit]:
    """X binned once per distinct max_bins (edges from X's rows), cached on
    the fit context so every family of one selector fit shares it. The
    entry keeps X itself and is dropped when another matrix arrives
    (workflow CV sweeps each fold's matrix under one context). The edges
    come from the whole X on the host, and K4 bins each shard of X's
    split (`rows`) on its device: an entry is the split of the shards'
    binned parts."""
    cached = getattr(ctx, "_sweep_bin_cache", None) if ctx is not None \
        else None
    if cached is not None and cached[0] is X and cached[1] is rows:
        out = cached[2]
    else:
        out = {}
        if ctx is not None:
            ctx._sweep_bin_cache = (X, rows, out)
    X_host = None
    for g in grids:
        mb = int(_grid_param(est, g, "max_bins"))
        if mb not in out:
            if X_host is None:
                X_host = X.cpu().numpy()
            edges = torch.as_tensor(quantile_bin_edges(X_host, mb))
            shards = rows.shards
            out[mb] = RowSplit(shards, shards.map(
                bin_features, rows.parts,
                shards.broadcast(edges.to(shards.lead))))
    return out


# --------------------------------------------------------------------------- #
# family handlers                                                             #
# --------------------------------------------------------------------------- #

def _enet_of(est, g) -> float:
    return float(_grid_param(est, g, "elastic_net_param") or 0.0)


def _l1_l2_of(est, g) -> Dict[str, float]:
    """Spark's penalty split: reg·α → L1, reg·(1 − α) → L2."""
    reg = float(_grid_param(est, g, "reg_param"))
    alpha = _enet_of(est, g)
    return {"l1": reg * alpha, "l2": reg * (1.0 - alpha)}


def _static_logistic(est, g) -> Tuple:
    return (int(_grid_param(est, g, "max_iter")), _enet_of(est, g) > 0.0)


def _static_linreg(est, g) -> Tuple:
    return (_enet_of(est, g) > 0.0,)


def _static_svc(est, g) -> Tuple:
    return (int(_grid_param(est, g, "max_iter")),)


def _static_glm(est, g) -> Tuple:
    ln = _grid_param(est, g, "link")
    return (str(_grid_param(est, g, "family")),
            int(_grid_param(est, g, "max_iter")),
            float(_grid_param(est, g, "var_power")),
            str(ln) if ln is not None else None)


def _static_nb(est, g) -> Tuple:
    return ()


def _static_mlp(est, g) -> Tuple:
    return (tuple(_grid_param(est, g, "hidden_layers")),
            int(_grid_param(est, g, "max_iter")))


def _static_forest(est, g) -> Tuple:
    return (int(_grid_param(est, g, "n_trees")),
            int(_grid_param(est, g, "max_bins")),
            bool(_grid_param(est, g, "subsample_features")),
            _depth_bucket(int(_grid_param(est, g, "max_depth"))))


def _static_gbt(est, g) -> Tuple:
    return (int(_grid_param(est, g, "n_estimators")),
            int(_grid_param(est, g, "max_bins")),
            int(_grid_param(est, g, "early_stopping_rounds") or 0),
            _depth_bucket(int(_grid_param(est, g, "max_depth"))))


def static_signature(est, grid: Dict) -> Tuple:
    """The (family, static-group) key a grid config runs under: two
    configs with equal signatures share one batched fit in the family
    handlers, and the scheduler cuts a family's grids into blocks along
    these boundaries. An estimator class the dispatch does not know gets
    a key per config (`_sweep_generic` runs a config as its unit)."""
    if isinstance(est, OpGBTClassifier):  # and the GBT/XGB regressors
        return ("gbt", _static_gbt(est, grid))
    if isinstance(est, OpRandomForestClassifier):  # forests and trees
        return ("forest", _static_forest(est, grid))
    if isinstance(est, OpLogisticRegression):
        return ("logistic", _static_logistic(est, grid))
    if isinstance(est, OpLinearRegression):
        return ("linreg", _static_linreg(est, grid))
    if isinstance(est, OpLinearSVC):
        return ("svc", _static_svc(est, grid))
    if isinstance(est, OpGeneralizedLinearRegression):
        return ("glm", _static_glm(est, grid))
    if isinstance(est, OpNaiveBayes):
        return ("naive_bayes", _static_nb(est, grid))
    if isinstance(est, OpMultilayerPerceptronClassifier):
        return ("mlp", _static_mlp(est, grid))
    return ("generic", SweepJournal.key_of(grid))


def _sweep_logistic(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
                    rows):
    shards = rows.shards

    def fit_predict(static, idxs, dyn, Wp, Vp):
        max_iter, enet = static
        if enet:  # FISTA: one fit covers the group's (l1, l2) pairs
            params = fit_logreg_enet(rows, y, Wp, dyn["l1"], dyn["l2"],
                                     n_classes, enet_iters(max_iter))
        else:  # pure L2: L-BFGS
            params = fit_logreg(rows, y, Wp, dyn["l2"], n_classes, max_iter)

        def predict(Xk, Wk, bk):
            logits = torch.matmul(Xk, Wk) + bk[:, None, :]
            return [logreg_pred_from_logits(lg) for lg in logits]
        return rows.preds(predict, rows.parts, shards.broadcast(params["W"]),
                          shards.broadcast(params["b"]))

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "logistic",
                         static_of=lambda g: _static_logistic(est, g),
                         dyn_of=lambda g: _l1_l2_of(est, g),
                         fit_predict=fit_predict)


def _sweep_linreg(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
                  rows):
    shards = rows.shards

    def fit_predict(static, idxs, dyn, Wp, Vp):
        if static[0]:  # any L1 in the group: the FISTA elastic net
            params = fit_linreg_enet(rows, y, Wp, dyn["l1"], dyn["l2"])
        else:
            params = fit_linreg(rows, y, Wp, dyn["l2"])

        def predict(Xk, beta, icpt):
            pred = torch.matmul(beta, Xk.T) + icpt[:, None]
            return [regression_pred(p) for p in pred]
        return rows.preds(predict, rows.parts,
                          shards.broadcast(params["beta"]),
                          shards.broadcast(params["intercept"]))

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "linreg",
                         static_of=lambda g: _static_linreg(est, g),
                         dyn_of=lambda g: _l1_l2_of(est, g),
                         fit_predict=fit_predict)


def _sweep_svc(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
               rows):
    shards = rows.shards

    def fit_predict(static, idxs, dyn, Wp, Vp):
        params = fit_linear_svc(rows, y, Wp, dyn["reg"], static[0])

        def predict(Xk, beta, b):
            margin = torch.matmul(beta, Xk.T) + b[:, None]
            return [binary_margin_pred(m) for m in margin]
        return rows.preds(predict, rows.parts,
                          shards.broadcast(params["beta"]),
                          shards.broadcast(params["b"]))

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "svc",
        static_of=lambda g: _static_svc(est, g),
        dyn_of=lambda g: {"reg": float(_grid_param(est, g, "reg_param"))},
        fit_predict=fit_predict)


def _sweep_glm(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
               rows):
    shards = rows.shards

    def fit_predict(static, idxs, dyn, Wp, Vp):
        family, max_iter, var_power, link = static
        params = fit_glm(rows, y, Wp, dyn["reg"], family, max_iter,
                         var_power, link)

        def predict(Xk, beta, b):
            eta = torch.matmul(beta, Xk.T) + b[:, None]
            return [glm_pred_from_eta(e, family, link, var_power)
                    for e in eta]
        return rows.preds(predict, rows.parts,
                          shards.broadcast(params["beta"]),
                          shards.broadcast(params["b"]))

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "glm",
        static_of=lambda g: _static_glm(est, g),
        dyn_of=lambda g: {"reg": float(_grid_param(est, g, "reg_param"))},
        fit_predict=fit_predict)


def _sweep_nb(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
              rows):
    shards = rows.shards
    # Spark parity: negative features fail the family (the selector drops
    # it); the verdict (over shards, the OR of each shard's) is read once
    # per training matrix
    cache = getattr(ctx, "_nb_nonneg_cache", None) if ctx is not None \
        else None
    if cache is None or cache[0] is not X:
        negative = any(shards.map(has_negative, rows.parts))
        cache = (X, negative)
        if ctx is not None:
            ctx._nb_nonneg_cache = cache
    if cache[1]:
        raise ValueError(NEGATIVE_FEATURES)

    def fit_predict(static, idxs, dyn, Wp, Vp):
        params = fit_naive_bayes(rows, y, Wp, dyn["smoothing"], n_classes)

        def predict(Xk, log_theta, log_prior):
            logits = torch.matmul(Xk, log_theta.transpose(1, 2)) \
                + log_prior[:, None, :]
            return [logreg_pred_from_logits(lg) for lg in logits]
        return rows.preds(predict, rows.parts,
                          shards.broadcast(params["log_theta"]),
                          shards.broadcast(params["log_prior"]))

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "naive_bayes",
        static_of=lambda g: _static_nb(est, g),
        dyn_of=lambda g: {
            "smoothing": float(_grid_param(est, g, "smoothing"))},
        fit_predict=fit_predict)


def _sweep_mlp(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
               rows):
    shards = rows.shards
    seed = ctx.seed if ctx is not None else 0

    def fit_predict(static, idxs, dyn, Wp, Vp):
        hidden, max_iter = static
        layers = (int(X.shape[1]),) + tuple(hidden) + (n_classes,)
        params = fit_mlp(rows, y, Wp, layers, max_iter, dyn["lr"], seed)

        def predict(Xk, *tensors):
            layer = [{"W": tensors[i], "b": tensors[i + 1]}
                     for i in range(0, len(tensors), 2)]
            return [logreg_pred_from_logits(lg)
                    for lg in _forward(layer, Xk)]
        flat = [t for layer in params for t in (layer["W"], layer["b"])]
        return rows.preds(predict, rows.parts,
                          *(shards.broadcast(t) for t in flat))

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "mlp",
        static_of=lambda g: _static_mlp(est, g),
        dyn_of=lambda g: {
            "lr": float(_grid_param(est, g, "learning_rate"))},
        fit_predict=fit_predict)


def _sweep_forest(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
                  rows, regression: bool = False):
    xb_by_bins = _binned_cache(est, grids, X, ctx, rows)
    shards = rows.shards
    if regression:
        Y = y[:, None]
        pred_fn = forest_regression_pred
    else:
        Y = torch.nn.functional.one_hot(y.long(), n_classes).to(
            torch.float32)
        pred_fn = forest_classification_pred
    seed = ctx.seed if ctx is not None else 0

    def dyn_of(g) -> Dict[str, Any]:
        mcw = max(float(_grid_param(est, g, "min_child_weight") or 1.0),
                  float(_grid_param(est, g, "min_instances_per_node") or 1.0))
        return {"depth": int(_grid_param(est, g, "max_depth")), "mcw": mcw,
                "min_gain": float(_grid_param(est, g, "min_info_gain") or 0.0)}

    def fit_predict(static, idxs, dyn, Wp, Vp):
        n_trees, max_bins, subsample = static[:3]
        Xb = xb_by_bins[max_bins]
        # one padded depth per bucket; each pair stops at its own depth
        trees = fit_forest(Xb, Y, Wp, n_trees, _pad_depth_of(est, grids, idxs),
                           max_bins, seed, subsample, dyn["mcw"],
                           active_depth=dyn["depth"],
                           bootstrap=est._bootstrap,
                           min_gain=dyn["min_gain"])

        def predict(Xbk, tk):  # K5 (K5-mc) over one shard's rows
            return [pred_fn({k: v[q] for k, v in tk.items()}, Xbk)
                    for q in range(Wp.shape[0])]
        return Xb.preds(predict, Xb.parts, shards.map(
            lambda *tables: dict(zip(trees, tables)),
            *(shards.broadcast(t) for t in trees.values())))

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "forest",
                         static_of=lambda g: _static_forest(est, g),
                         dyn_of=dyn_of, fit_predict=fit_predict)


def _sweep_gbt(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
               rows):
    objective = est._objective
    multiclass = objective == "logistic" and n_classes > 2
    xb_by_bins = _binned_cache(est, grids, X, ctx, rows)
    seed = ctx.seed if ctx is not None else 0
    eval_metric = str(getattr(est, "eval_metric", "logloss") or "logloss")
    d = X.shape[1]

    def lr_of(g) -> float:
        v = g.get("eta", g.get("learning_rate"))
        if v is None:
            v = est.params.get("eta", getattr(est, "learning_rate", 0.1))
        return float(v)

    def dyn_of(g) -> Dict[str, float]:
        mcw = max(float(_grid_param(est, g, "min_child_weight") or 1.0),
                  float(_grid_param(est, g, "min_instances_per_node") or 1.0))
        return {
            "depth": int(_grid_param(est, g, "max_depth")),
            "lr": lr_of(g),
            "lam": float(_grid_param(est, g, "reg_lambda")),
            "mcw": mcw,
            "gamma": float(_grid_param(est, g, "gamma") or 0.0),
            "alpha": float(_grid_param(est, g, "alpha") or 0.0),
            "subsample": float(_grid_param(est, g, "subsample") or 1.0),
            "colsample": float(
                _grid_param(est, g, "colsample_bytree") or 1.0),
            "min_gain_norm": float(
                _grid_param(est, g, "min_info_gain") or 0.0)}

    def pair_width(static, idxs) -> int:
        per_pair_hist = 2 ** max(_pad_depth_of(est, grids, idxs) - 1, 0) \
            * d * static[1] * 8 * (n_classes if multiclass else 1)
        return max(1, int(_PAIR_HIST_BYTES // per_pair_hist))

    def fit_predict(static, idxs, dyn, Wp, Vp):
        n_est, max_bins, esr = static[:3]
        if multiclass:
            # softmax boosting runs every round (no early stopping); the
            # fit's final margin is the prediction
            _, margin = fit_gbt_multiclass_pairs(
                xb_by_bins[max_bins], y, Wp, n_est,
                _pad_depth_of(est, grids, idxs), max_bins, n_classes,
                dyn["lr"], dyn["lam"], dyn["mcw"],
                active_depth=torch.as_tensor(dyn["depth"],
                                             dtype=torch.int32),
                gamma=dyn["gamma"], alpha=dyn["alpha"],
                subsample=dyn["subsample"], colsample=dyn["colsample"],
                seed=seed, min_gain_norm=dyn["min_gain_norm"])
            return [gbt_multiclass_pred_from_margin(mg) for mg in margin]
        _, margin, _ = fit_gbt_pairs(
            xb_by_bins[max_bins], y, Wp, n_est,
            _pad_depth_of(est, grids, idxs), max_bins, dyn["lr"],
            dyn["lam"], dyn["mcw"],
            active_depth=torch.as_tensor(dyn["depth"], dtype=torch.int32),
            gamma=dyn["gamma"], alpha=dyn["alpha"],
            subsample=dyn["subsample"], colsample=dyn["colsample"],
            seed=seed, val_w=Vp, early_stopping_rounds=esr,
            min_gain_norm=dyn["min_gain_norm"], eval_metric=eval_metric,
            objective=objective)
        return [gbt_pred_from_margin(mg, objective) for mg in margin]

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "gbt",
                         static_of=lambda g: _static_gbt(est, g),
                         dyn_of=dyn_of, fit_predict=fit_predict,
                         pair_width=pair_width)


def _sweep_generic(est, grids: List[Dict], X: torch.Tensor,
                   y: torch.Tensor,
                   folds: Sequence[Tuple[np.ndarray, np.ndarray]],
                   evaluator, ctx) -> List[List[float]]:
    """The fallback for an estimator class `_dispatch` does not know: a
    loop over configs and folds, each config's clone fitted by its own
    `fit_arrays(X, y, w, ctx)` with the fold's training rows as the 0/1
    weights w (the JAX package passes them as its fit's row weights too),
    predicted by `predict_arrays(X)` and scored by the host evaluator on
    the fold's validation rows. A config is the journaling block here:
    journaled configs are skipped, and each completed config appends as
    soon as its folds finish. Each config runs in a ``sweep:block``
    span, after the ``sweep.run_block`` fault point."""
    y_np = y.cpu().numpy()
    out: List[Optional[List[float]]] = [None] * len(grids)
    journal_prefill(_active_journal(), grids, out)
    for i, grid in enumerate(grids):
        if out[i] is not None:
            continue
        t0 = time.perf_counter()
        with TRACER.span("sweep:block", category="sweep",
                         family=type(est).__name__, configs=1):
            _block_fault_point()
            clone = type(est)(**{**{k: v for k, v in est.params.items()
                                    if k != "uid"}, **grid})
            row = []
            for tr, va in folds:
                w = torch.as_tensor(np.asarray(tr, np.float32),
                                    device=X.device)
                model = clone.fit_arrays(X, y, w, ctx)
                pred = model.predict_arrays(X)
                row.append(_metric(evaluator, y_np,
                                   {k: v.cpu().numpy()
                                    for k, v in pred.items()}, va))
        out[i] = row
        _journal_commit(grids, out, [i], time.perf_counter() - t0)
    return out  # type: ignore[return-value]


# --------------------------------------------------------------------------- #
# K11: one block over the lanes of a mesh's sweep axis                        #
# --------------------------------------------------------------------------- #

def _shard_dyn(grids: List[Dict], sharding) -> Tuple[List[List[Dict]], int]:
    """Cut a block's configs into one contiguous slice per lane of the
    sweep axis, PADDING a non-divisible block to the next multiple by
    repeating the last config (the pad rows compute real but discarded
    fits, as in the JAX package). Returns (slices, original count)."""
    g = len(grids)
    n = sharding.n_shards
    padded = list(grids) + [grids[-1]] * ((-g) % n)
    per = len(padded) // n
    return [padded[k * per:(k + 1) * per] for k in range(n)], g


class Lanes:
    """Run work on the lanes of a mesh's sweep axis: shared by K11's
    `_run_block` and the scheduler's workers (`parallel/scheduler.py`).

    `rows` holds each lane's sweep row of devices (`Mesh.rows()`; a bare
    device is a row of one). Lane k has its own `FitContext`, with the
    caller's row count and seed (bootstrap and fold streams match the
    single-device sweep bit for bit), its row's first device, binned-matrix
    cache and lane tag, and, for a row of several devices, the row as its
    (1, data) sub-mesh; the caller's `_sweep_seconds` is shared, keyed by
    lane. `run(k, fn, X, y)` calls `fn(lane_ctx, X_lane, y_lane)` with X
    and y placed on the lane's device once per training matrix
    (identity-keyed on both, holding the keys, so a reused address cannot
    false-hit); a lane with a data row also gets X split over its row's
    devices then (`_row_split` on the lane's context), so its sweeps run
    on the shards. On CUDA it runs inside the device's context and on the
    lane's own stream (so `cuda_build.launch` launches there and lanes on
    one card overlap), after the stream current on the constructing
    thread, and synchronizes that stream before it returns. Construct on
    the caller's thread; `run` may be called from the lane threads."""

    def __init__(self, ctx, rows: Sequence):
        from transmogrifai_tpu_torch.parallel.mesh import Mesh
        from transmogrifai_tpu_torch.stages.base import FitContext
        self.rows = [list(r) if isinstance(r, (list, tuple)) else [r]
                     for r in rows]
        self.devices = [r[0] for r in self.rows]
        self._ctxs = []
        for k, row in enumerate(self.rows):
            lctx = FitContext(n_rows=getattr(ctx, "n_rows", 0),
                              seed=getattr(ctx, "seed", 42), device=row[0],
                              mesh=(Mesh(np.array([row], dtype=object))
                                    if len(row) > 1 else None))
            lctx._sweep_lane = k
            lctx._sweep_seconds = getattr(ctx, "_sweep_seconds", None)
            self._ctxs.append(lctx)
        self._caller = {d: torch.cuda.current_stream(d)
                        for d in set(self.devices) if d.type == "cuda"}
        self._streams: Dict[int, Any] = {}
        self._placed: Dict[int, Tuple] = {}
        self._lock = threading.Lock()

    def _place(self, k: int, X: torch.Tensor, y: torch.Tensor):
        with self._lock:
            hit = self._placed.get(k)
            if hit is not None and hit[0] is X and hit[1] is y:
                return hit[2:]
        placed = (X.to(self.devices[k]), y.to(self.devices[k]))
        _row_split(self._ctxs[k], placed[0])  # a data row's shards, once
        with self._lock:
            self._placed[k] = (X, y) + placed
        return placed

    def run(self, k: int, fn, X: torch.Tensor, y: torch.Tensor):
        dev = self.devices[k]
        if dev.type != "cuda":
            return fn(self._ctxs[k], *self._place(k, X, y))
        with self._lock:
            stream = self._streams.get(k)
            if stream is None:
                stream = self._streams[k] = torch.cuda.Stream(dev)
        stream.wait_stream(self._caller[dev])
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = fn(self._ctxs[k], *self._place(k, X, y))
            stream.synchronize()
        return out


def _run_block(run_lane: Callable[..., List[List[float]]],
               grids: List[Dict], sharding, ctx, X: torch.Tensor,
               y: torch.Tensor) -> List[List[float]]:
    """K11: one block over the mesh's sweep axis. `_shard_dyn` cuts the
    block's configs into one slice per lane; each lane runs its slice as
    `run_lane(slice, lane_ctx, X_lane, y_lane)` — the unsharded batched
    program — on a worker thread through `Lanes.run`, and the metric rows
    come back to the host in lane order, pad rows dropped. The lanes
    persist on `ctx` across blocks and families (one placement and binned
    cache per lane). A lane's exception (or a kill) re-raises here after
    every lane ended."""
    slices, g = _shard_dyn(grids, sharding)
    rows = sharding.rows[:len(slices)]
    devices = [r[0] for r in rows]
    lanes = getattr(ctx, "_sweep_lanes", None)
    if lanes is None or lanes.rows != rows:
        lanes = ctx._sweep_lanes = Lanes(ctx, rows)
    out: List[Optional[List[List[float]]]] = [None] * len(slices)
    errors: List[BaseException] = []
    parent = TRACER.current()

    def lane_main(k: int) -> None:
        _SWEEP_TL.lane = True
        try:
            with TRACER.span(f"sweep:lane:{k}", category="sweep_lane",
                             parent=parent, lane=k,
                             device=str(devices[k]),
                             configs=len(slices[k])):
                out[k] = lanes.run(
                    k, lambda *placed: run_lane(slices[k], *placed), X, y)
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=lane_main, args=(k,),
                                name=f"sweep-lane-{k}", daemon=True)
               for k in range(len(slices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    rows = [row for lane_rows in out for row in lane_rows]
    return rows[:g]  # drop the pad rows


def _sweep_sharded(est, grids: List[Dict], X: torch.Tensor,
                   y: torch.Tensor, folds, evaluator, ctx,
                   sharding) -> List[List[float]]:
    """The sweep with its grid axis over the mesh's sweep lanes: journaled
    configs skip, the rest group by `static_signature`, and each group is
    one `_run_block` through `_run_groups_resilient` (fault point, OOM
    halving, journal commit), its lanes running the unsharded sweep."""
    metrics: List[Optional[List[float]]] = [None] * len(grids)
    journal_prefill(_active_journal(), grids, metrics)
    groups: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(grids):
        if metrics[i] is None:
            groups.setdefault(static_signature(est, g), []).append(i)

    def run_lane(lane_grids, lctx, Xl, yl):
        return _run_sweep(est, lane_grids, Xl, yl, folds, evaluator, lctx)

    def run_group(static, idxs):
        rows = _run_block(run_lane, [grids[i] for i in idxs], sharding,
                          ctx, X, y)
        for i, row in zip(idxs, rows):
            metrics[i] = row

    _run_groups_resilient(
        groups, run_group,
        commit=lambda idxs, block_s=None: _journal_commit(
            grids, metrics, idxs, block_s),
        family=type(est).__name__, block_key=_block_key_fn(grids))
    return metrics  # type: ignore[return-value]


def _dispatch(est) -> Optional[Callable]:
    # order matters: subclasses before parents
    if isinstance(est, OpGBTClassifier):  # and the GBT/XGB regressors
        return _sweep_gbt
    if isinstance(est, OpRandomForestRegressor):  # and the DT regressor
        return lambda *a, **kw: _sweep_forest(*a, regression=True, **kw)
    if isinstance(est, OpRandomForestClassifier):  # and the DT classifier
        return _sweep_forest
    if isinstance(est, OpLogisticRegression):
        return _sweep_logistic
    if isinstance(est, OpLinearRegression):
        return _sweep_linreg
    if isinstance(est, OpLinearSVC):
        return _sweep_svc
    if isinstance(est, OpGeneralizedLinearRegression):
        return _sweep_glm
    if isinstance(est, OpNaiveBayes):
        return _sweep_nb
    if isinstance(est, OpMultilayerPerceptronClassifier):
        return _sweep_mlp
    return None


def run_sweep(est, grids: List[Dict], X: torch.Tensor, y: torch.Tensor,
              folds: Sequence[Tuple[np.ndarray, np.ndarray]], evaluator,
              ctx, sharding=None, journal=None) -> List[List[float]]:
    """Metric matrix [grid][fold] for one model family, on X's device: the
    family's batched handler, or `_sweep_generic` for a class it does not
    know; the device metric, or the host evaluator's
    (`HostMetricFallback`) for an evaluator without one.

    `sharding` (`parallel/mesh.sweep_sharding(mesh)`): each static group
    runs through K11's `_run_block` over the mesh's sweep lanes.
    `journal`: a `runtime.journal.SweepJournal` (or a sharded writer) —
    completed blocks append as soon as their fold metrics are final and
    journaled configs are skipped, so a killed sweep resumed with the same
    journal re-runs only un-journaled blocks and reproduces the
    bit-identical metric matrix."""
    _SWEEP_TL.journal = journal
    best = None
    if journal is not None:
        best = _BestTracker(getattr(evaluator, "is_larger_better", True))
        # seed from every journaled row (not just this call's grids): a
        # record's `best` accounts for blocks other lanes or an earlier,
        # killed run completed
        for g, row in journal.rows():
            best.note(g, row)
    _SWEEP_TL.best = best
    try:
        if sharding is not None:
            return _sweep_sharded(est, grids, X, y, folds, evaluator, ctx,
                                  sharding)
        return _run_sweep(est, grids, X, y, folds, evaluator, ctx)
    finally:
        _SWEEP_TL.journal = None
        _SWEEP_TL.best = None


def _run_sweep(est, grids: List[Dict], X: torch.Tensor, y: torch.Tensor,
               folds: Sequence[Tuple[np.ndarray, np.ndarray]], evaluator,
               ctx) -> List[List[float]]:
    handler = _dispatch(est)
    if handler is None:
        mesh = getattr(ctx, "mesh", None) if ctx is not None else None
        if mesh is not None and mesh.data_width > 1:
            log.info("%s: the generic per-config loop takes X whole on "
                     "%s, not the data axis's row shards",
                     type(est).__name__, X.device)
        return _sweep_generic(est, grids, X, y, folds, evaluator, ctx)
    n_classes = getattr(est, "n_classes", None) or infer_n_classes(
        y.cpu().numpy())
    metric_fn = (make_device_metric(evaluator, n_classes=n_classes)
                 or HostMetricFallback(evaluator))
    W = torch.as_tensor(np.stack([tr for tr, _ in folds]), device=X.device)
    V = torch.as_tensor(np.stack([va for _, va in folds]), device=X.device)
    return handler(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
                   rows=_row_split(ctx, X))
