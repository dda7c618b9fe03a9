"""The batched model sweep: fit → predict → metric for every (grid config,
fold) pair of one model family.

The port's counterpart of the JAX package's `parallel/sweep.py`
(`run_sweep` → `_run_sweep` and `_sweep_gbt`'s single-device binary
path). A fold is a pair of 0/1 row masks over the one training matrix;
the pairs of one static group (same round count, bins, early stopping and
depth bucket) boost together along the leading pair axis of
`fit_gbt_pairs`, so each kernel launch of a level serves every pair. The
training matrix is binned once per `max_bins` (K4).

Only the GBT/XGBoost classifier family is ported; the journal, the
calibration, the mesh and the retrace instrumentation of the JAX package
are not (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.evaluators.device_metrics import (
    make_device_metric)
from transmogrifai_tpu_torch.models.base import infer_n_classes
from transmogrifai_tpu_torch.models.trees import (
    OpGBTClassifier, bin_features, fit_gbt_pairs, gbt_pred_from_margin,
    quantile_bin_edges)

_DEPTH_BUCKETS = (4, 6, 8, 10, 12, 14)
# histogram bytes one launch may hold across its pairs (G + H, deepest
# level); more pairs than fit run in several launches
_PAIR_HIST_BYTES = 2 << 30


def _grid_param(est, grid: Dict, name: str) -> Any:
    return grid.get(name, getattr(est, name, est.params.get(name)))


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


def _static_gbt(est, g) -> Tuple:
    return (int(_grid_param(est, g, "n_estimators")),
            int(_grid_param(est, g, "max_bins")),
            int(_grid_param(est, g, "early_stopping_rounds") or 0),
            _depth_bucket(int(_grid_param(est, g, "max_depth"))))


def _binned_cache(est, grids, X: torch.Tensor, ctx) -> Dict[int, torch.Tensor]:
    """X binned once per distinct max_bins (edges from X's rows), cached on
    the fit context so every family of one selector fit shares it."""
    out = getattr(ctx, "_sweep_bin_cache", None) if ctx is not None else None
    if out is None:
        out = {}
        if ctx is not None:
            ctx._sweep_bin_cache = out
    X_host = None
    for g in grids:
        mb = int(_grid_param(est, g, "max_bins"))
        if mb not in out:
            if X_host is None:
                X_host = X.cpu().numpy()
            edges = quantile_bin_edges(X_host, mb)
            out[mb] = bin_features(X, torch.as_tensor(edges, device=X.device))
    return out


def _sweep_gbt(est, grids, X, y, W, V, metric_fn, ctx) -> List[List[float]]:
    xb_by_bins = _binned_cache(est, grids, X, ctx)
    seed = ctx.seed if ctx is not None else 0
    n_folds = W.shape[0]
    eval_metric = str(getattr(est, "eval_metric", "logloss") or "logloss")

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

    groups: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(grids):
        groups.setdefault(_static_gbt(est, g), []).append(i)
    metrics: List[List[float]] = [[0.0] * n_folds for _ in grids]
    d = X.shape[1]
    for static, idxs in groups.items():
        n_est, max_bins, esr = static[:3]
        Xb = xb_by_bins[max_bins]
        pad_depth = _pad_depth_of(est, grids, idxs)
        per_pair_hist = 2 ** max(pad_depth - 1, 0) * d * max_bins * 8
        width = max(1, int(_PAIR_HIST_BYTES // per_pair_hist))
        pairs = [(i, f) for i in idxs for f in range(n_folds)]
        for s in range(0, len(pairs), width):
            chunk = pairs[s:s + width]
            dyn = [dyn_of(grids[i]) for i, _ in chunk]
            col = {k: [dd[k] for dd in dyn] for k in dyn[0]}
            fs = torch.as_tensor([f for _, f in chunk], device=X.device)
            Vsel = V[fs]
            _, margin, _ = fit_gbt_pairs(
                Xb, y, W[fs], n_est, pad_depth, max_bins, col["lr"],
                col["lam"], col["mcw"],
                active_depth=torch.as_tensor(col["depth"], dtype=torch.int32),
                gamma=col["gamma"], alpha=col["alpha"],
                subsample=col["subsample"], colsample=col["colsample"],
                seed=seed, val_w=Vsel, early_stopping_rounds=esr,
                min_gain_norm=col["min_gain_norm"], eval_metric=eval_metric)
            for t, (i, f) in enumerate(chunk):
                pred = gbt_pred_from_margin(margin[t], "logistic")
                metrics[i][f] = float(metric_fn(y, pred, Vsel[t]))
    return metrics


def run_sweep(est, grids: List[Dict], X: torch.Tensor, y: torch.Tensor,
              folds: Sequence[Tuple[np.ndarray, np.ndarray]], evaluator,
              ctx) -> List[List[float]]:
    """Metric matrix [grid][fold] for one model family, on X's device."""
    if not isinstance(est, OpGBTClassifier):
        raise NotImplementedError(
            f"{type(est).__name__}: only the GBT/XGBoost classifier family "
            "is ported to the sweep (ROADMAP.md, queue 1, item 7)")
    n_classes = getattr(est, "n_classes", None) or infer_n_classes(
        y.cpu().numpy())
    if n_classes > 2:
        raise NotImplementedError(
            "multiclass GBT sweeps are not ported yet (ROADMAP.md, queue 1, "
            "item 9)")
    metric_fn = make_device_metric(evaluator, n_classes=n_classes)
    W = torch.as_tensor(np.stack([tr for tr, _ in folds]), device=X.device)
    V = torch.as_tensor(np.stack([va for _, va in folds]), device=X.device)
    return _sweep_gbt(est, grids, X, y, W, V, metric_fn, ctx)
