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
multiclass or regression group).

Not ported (ROADMAP.md): the journal and checkpoints, the calibration of
dispatch widths, the mesh and the generic host-metric fallback.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

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

Pred = Dict[str, torch.Tensor]

_DEPTH_BUCKETS = (4, 6, 8, 10, 12, 14)
# GBT histogram bytes one launch may hold across its pairs (G + H, deepest
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


def _sweep_blocks(grids: List[Dict], y: torch.Tensor, W: torch.Tensor,
                  V: torch.Tensor, metric_fn, ctx, family: str,
                  static_of: Callable[[Dict], Tuple],
                  dyn_of: Callable[[Dict], Dict[str, Any]],
                  fit_predict: Callable[..., Sequence[Pred]],
                  pair_width: Callable[[Tuple, List[int]], int] = None
                  ) -> List[List[float]]:
    """Group the configs by `static_of`; per group, run its (config,
    fold) pairs `pair_width` at a time (all at once by default) through
    `fit_predict(static, idxs, dyn, W_pairs, V_pairs)`, where `dyn` holds
    one list per dynamic parameter (one entry per pair) and the result is
    one prediction dict per pair, and score each pair's prediction on its
    fold's validation rows, all pairs of the run in one `metric_fn(y,
    preds, masks)` call. Groups run in the order their first config
    appears; each group's seconds land in `ctx._sweep_seconds`."""
    n_folds = W.shape[0]
    groups: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(grids):
        groups.setdefault(static_of(g), []).append(i)
    metrics: List[List[float]] = [[0.0] * n_folds for _ in grids]
    seconds = getattr(ctx, "_sweep_seconds", None) if ctx is not None \
        else None
    for static, idxs in groups.items():
        t0 = time.perf_counter()
        pairs = [(i, f) for i in idxs for f in range(n_folds)]
        width = pair_width(static, idxs) if pair_width else len(pairs)
        for s in range(0, len(pairs), max(1, width)):
            chunk = pairs[s:s + width]
            dyn = [dyn_of(grids[i]) for i, _ in chunk]
            cols = {k: [dd[k] for dd in dyn] for k in dyn[0]}
            fs = torch.as_tensor([f for _, f in chunk], device=W.device)
            Vsel = V[fs]
            preds = fit_predict(static, idxs, cols, W[fs], Vsel)
            vals = metric_fn(y, preds, Vsel).tolist()
            for t, (i, f) in enumerate(chunk):
                metrics[i][f] = float(vals[t])
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        if seconds is not None:
            seconds[f"{family}:{static}"] = time.perf_counter() - t0
    return metrics


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


def _sweep_logistic(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    def fit_predict(static, idxs, dyn, Wp, Vp):
        max_iter, enet = static
        if enet:  # FISTA: one fit covers the group's (l1, l2) pairs
            params = fit_logreg_enet(X, y, Wp, dyn["l1"], dyn["l2"],
                                     n_classes, enet_iters(max_iter))
        else:  # pure L2: L-BFGS
            params = fit_logreg(X, y, Wp, dyn["l2"], n_classes, max_iter)
        logits = torch.matmul(X, params["W"]) + params["b"][:, None, :]
        return [logreg_pred_from_logits(lg) for lg in logits]

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "logistic",
                         static_of=lambda g: _static_logistic(est, g),
                         dyn_of=lambda g: _l1_l2_of(est, g),
                         fit_predict=fit_predict)


def _sweep_linreg(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    def fit_predict(static, idxs, dyn, Wp, Vp):
        if static[0]:  # any L1 in the group: the FISTA elastic net
            params = fit_linreg_enet(X, y, Wp, dyn["l1"], dyn["l2"])
        else:
            params = fit_linreg(X, y, Wp, dyn["l2"])
        pred = torch.matmul(params["beta"], X.T) \
            + params["intercept"][:, None]
        return [regression_pred(p) for p in pred]

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "linreg",
                         static_of=lambda g: _static_linreg(est, g),
                         dyn_of=lambda g: _l1_l2_of(est, g),
                         fit_predict=fit_predict)


def _sweep_svc(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    def fit_predict(static, idxs, dyn, Wp, Vp):
        params = fit_linear_svc(X, y, Wp, dyn["reg"], static[0])
        margin = torch.matmul(params["beta"], X.T) + params["b"][:, None]
        return [binary_margin_pred(m) for m in margin]

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "svc",
        static_of=lambda g: _static_svc(est, g),
        dyn_of=lambda g: {"reg": float(_grid_param(est, g, "reg_param"))},
        fit_predict=fit_predict)


def _sweep_glm(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    def fit_predict(static, idxs, dyn, Wp, Vp):
        family, max_iter, var_power, link = static
        params = fit_glm(X, y, Wp, dyn["reg"], family, max_iter, var_power,
                         link)
        eta = torch.matmul(params["beta"], X.T) + params["b"][:, None]
        return [glm_pred_from_eta(e, family, link, var_power) for e in eta]

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "glm",
        static_of=lambda g: _static_glm(est, g),
        dyn_of=lambda g: {"reg": float(_grid_param(est, g, "reg_param"))},
        fit_predict=fit_predict)


def _sweep_nb(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    # Spark parity: negative features fail the family (the selector drops
    # it); the verdict is read once per training matrix
    cache = getattr(ctx, "_nb_nonneg_cache", None) if ctx is not None \
        else None
    if cache is None or cache[0] is not X:
        cache = (X, has_negative(X))
        if ctx is not None:
            ctx._nb_nonneg_cache = cache
    if cache[1]:
        raise ValueError(NEGATIVE_FEATURES)

    def fit_predict(static, idxs, dyn, Wp, Vp):
        params = fit_naive_bayes(X, y, Wp, dyn["smoothing"], n_classes)
        logits = torch.matmul(X, params["log_theta"].transpose(1, 2)) \
            + params["log_prior"][:, None, :]
        return [logreg_pred_from_logits(lg) for lg in logits]

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "naive_bayes",
        static_of=lambda g: _static_nb(est, g),
        dyn_of=lambda g: {
            "smoothing": float(_grid_param(est, g, "smoothing"))},
        fit_predict=fit_predict)


def _sweep_mlp(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    seed = ctx.seed if ctx is not None else 0

    def fit_predict(static, idxs, dyn, Wp, Vp):
        hidden, max_iter = static
        layers = (int(X.shape[1]),) + tuple(hidden) + (n_classes,)
        params = fit_mlp(X, y, Wp, layers, max_iter, dyn["lr"], seed)
        return [logreg_pred_from_logits(lg) for lg in _forward(params, X)]

    return _sweep_blocks(
        grids, y, W, V, metric_fn, ctx, "mlp",
        static_of=lambda g: _static_mlp(est, g),
        dyn_of=lambda g: {
            "lr": float(_grid_param(est, g, "learning_rate"))},
        fit_predict=fit_predict)


def _sweep_forest(est, grids, X, y, W, V, metric_fn, ctx, n_classes,
                  regression: bool = False):
    xb_by_bins = _binned_cache(est, grids, X, ctx)
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
        return [pred_fn({k: v[q] for k, v in trees.items()}, Xb)
                for q in range(Wp.shape[0])]

    return _sweep_blocks(grids, y, W, V, metric_fn, ctx, "forest",
                         static_of=lambda g: _static_forest(est, g),
                         dyn_of=dyn_of, fit_predict=fit_predict)


def _sweep_gbt(est, grids, X, y, W, V, metric_fn, ctx, n_classes):
    objective = est._objective
    multiclass = objective == "logistic" and n_classes > 2
    xb_by_bins = _binned_cache(est, grids, X, ctx)
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


def _dispatch(est) -> Callable:
    # order matters: subclasses before parents
    if isinstance(est, OpGBTClassifier):  # and the GBT/XGB regressors
        return _sweep_gbt
    if isinstance(est, OpRandomForestRegressor):  # and the DT regressor
        return lambda *a: _sweep_forest(*a, regression=True)
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
    raise NotImplementedError(
        f"{type(est).__name__}: the sweep knows no handler for this class, "
        "and the generic host-metric fallback is not ported yet "
        "(ROADMAP.md, queue 1)")


def run_sweep(est, grids: List[Dict], X: torch.Tensor, y: torch.Tensor,
              folds: Sequence[Tuple[np.ndarray, np.ndarray]], evaluator,
              ctx) -> List[List[float]]:
    """Metric matrix [grid][fold] for one model family, on X's device."""
    handler = _dispatch(est)
    n_classes = getattr(est, "n_classes", None) or infer_n_classes(
        y.cpu().numpy())
    metric_fn = make_device_metric(evaluator, n_classes=n_classes)
    W = torch.as_tensor(np.stack([tr for tr, _ in folds]), device=X.device)
    V = torch.as_tensor(np.stack([va for _, va in folds]), device=X.device)
    return handler(est, grids, X, y, W, V, metric_fn, ctx, n_classes)
