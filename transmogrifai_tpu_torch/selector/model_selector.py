"""ModelSelector: cross-validated model and hyperparameter selection.

The port's counterpart of the JAX package's `selector/model_selector.py`,
on one device, for binary, multiclass and regression labels: prepare the
data (holdout reserve, then label balancing or label pruning), run
each family's sweep (`parallel/sweep.py`) over the folds, refit the
winner on the whole prepared training set, evaluate it on the training
and holdout rows, and return the fitted model with a
`ModelSelectorSummary`. Families run one after another, each in a
``sweep:family:<class>`` span; a family that fails is dropped, as in the
reference.

Under workflow-level CV (`ctx.cv_refit`, set by `Workflow.train`) the
feature DAG before the selector is refit inside each fold and each
family sweeps fold by fold on that fold's matrix.

Not ported yet (ROADMAP.md): a device mesh, sweep checkpoints and
journals, and the distributed scheduler.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.evaluators.evaluators import (
    BinaryClassificationEvaluator, MultiClassificationEvaluator,
    RegressionEvaluator)
from transmogrifai_tpu_torch.models.linear import OpLinearRegression
from transmogrifai_tpu_torch.models.logistic import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import (
    OpGBTRegressor, OpRandomForestClassifier, OpRandomForestRegressor,
    OpXGBoostClassifier)
from transmogrifai_tpu_torch.obs.trace import TRACER
from transmogrifai_tpu_torch.parallel.sweep import run_sweep
from transmogrifai_tpu_torch.selector.splitters import (
    DataBalancer, DataCutter, DataSplitter)
from transmogrifai_tpu_torch.selector.validators import (
    OpCrossValidation, OpTrainValidationSplit)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)

log = logging.getLogger(__name__)


@dataclass
class ValidationResult:
    model: str
    grid: Dict[str, Any]
    fold_metrics: List[float]
    model_index: int = 0

    @property
    def mean_metric(self) -> float:
        return (float(np.mean(self.fold_metrics)) if self.fold_metrics
                else float("nan"))

    def to_json(self) -> Dict:
        return {"model": self.model, "model_index": self.model_index,
                "grid": self.grid, "fold_metrics": self.fold_metrics,
                "mean": self.mean_metric}


@dataclass
class ModelSelectorSummary:
    """ModelSelectorSummary.scala analogue, kept on the fitted model."""

    problem_type: str
    metric_name: str
    validation_results: List[ValidationResult] = field(default_factory=list)
    best_model: str = ""
    best_grid: Dict[str, Any] = field(default_factory=dict)
    train_metrics: Dict[str, Any] = field(default_factory=dict)
    holdout_metrics: Dict[str, Any] = field(default_factory=dict)
    splitter_summary: Dict[str, Any] = field(default_factory=dict)
    larger_is_better: bool = True
    timings: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "problem_type": self.problem_type, "metric": self.metric_name,
            "validation_results": [r.to_json()
                                   for r in self.validation_results],
            "best_model": self.best_model, "best_grid": self.best_grid,
            "train_metrics": self.train_metrics,
            "holdout_metrics": self.holdout_metrics,
            "splitter": self.splitter_summary,
        }

    def pretty(self) -> str:
        sign = -1.0 if self.larger_is_better else 1.0
        lines = [f"Evaluated {len(self.validation_results)} model configs "
                 f"({self.metric_name}):"]
        for r in sorted(self.validation_results,
                        key=lambda r: sign * r.mean_metric):
            lines.append(f"  {r.model} {r.grid} -> {r.mean_metric:.4f}")
        lines.append(f"Best: {self.best_model} {self.best_grid}")
        return "\n".join(lines)


class ModelSelector(Estimator):
    """(RealNN label, OPVector) → Prediction: sweep, refit the winner on
    the prepared training rows, evaluate train + holdout."""

    in_types = (T.RealNN, T.OPVector)
    out_type = T.Prediction

    def __init__(self, models: Sequence[Tuple[Estimator, List[Dict]]],
                 validator=None, splitter=None, evaluator=None,
                 problem_type: str = "binary", uid: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None):
        super().__init__(uid=uid)
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "ModelSelector: sweep checkpoints and journals are not "
                "ported yet (ROADMAP.md queue 1, item 7)")
        self.models = list(models)
        self.validator = validator or OpCrossValidation()
        self.splitter = splitter
        self.evaluator = evaluator or BinaryClassificationEvaluator()
        self.problem_type = problem_type
        self.checkpoint_dir = None

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        label_col, vec_col = cols
        y_np = np.asarray(label_col.data["value"], dtype=np.float64)
        X_full = vec_col.device_value(ctx.device)

        split_summary: Dict[str, Any] = {}
        if self.splitter is not None:
            train_idx, test_idx, ssum = self.splitter.split(y_np)
            train_idx, prep_details = self.splitter.prepare(y_np, train_idx)
            split_summary = ssum.to_json()
            split_summary["details"].update(prep_details)
        else:
            train_idx = np.arange(len(y_np))
            test_idx = np.array([], dtype=np.int64)

        X = X_full[torch.as_tensor(train_idx, device=X_full.device)]
        y_train = y_np[train_idx]
        y_dev = torch.as_tensor(y_train.astype(np.float32), device=X.device)
        folds = self.validator.splits(y_train)

        t0 = time.perf_counter()
        ctx._sweep_seconds = {}
        family_s: Dict[str, float] = {}
        if ctx.cv_refit is None:
            results, failures = self._sweep(ctx, X, y_dev, folds, family_s)
        else:
            results, failures = self._sweep_with_workflow_cv(
                ctx, folds, train_idx, y_dev, X.device, family_s)
        timings = {"sweep_s": time.perf_counter() - t0,
                   "families": family_s, "groups": ctx._sweep_seconds}
        if not results:
            raise RuntimeError(
                f"All {failures} model families failed during validation")
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        finite = [r for r in results if np.isfinite(r.mean_metric)]
        return self._finish(ctx, results, finite, sign, X, X_full, y_np,
                            y_dev, train_idx, test_idx, split_summary,
                            timings)

    def _sweep(self, ctx, X, y_dev, folds, family_s):
        """Each family's sweep over every fold on X; a family that fails
        is dropped. Returns (results, families dropped)."""
        results: List[ValidationResult] = []
        failures = 0
        for mi, (est, grids) in enumerate(self.models):
            tf = time.perf_counter()
            try:
                with TRACER.span(f"sweep:family:{type(est).__name__}",
                                 category="sweep_family", grids=len(grids)):
                    grid_fold = run_sweep(est, grids, X, y_dev, folds,
                                          self.evaluator, ctx)
            except NotImplementedError:
                raise
            except Exception:
                failures += 1
                log.error("Model family %s failed; dropping from sweep",
                          type(est).__name__, exc_info=True)
                continue
            for grid, fm in zip(grids, grid_fold):
                results.append(ValidationResult(
                    model=type(est).__name__, grid=grid,
                    fold_metrics=[float(m) for m in fm], model_index=mi))
            if X.is_cuda:
                torch.cuda.synchronize(X.device)
            family_s[type(est).__name__] = time.perf_counter() - tf
        return results, failures

    def _sweep_with_workflow_cv(self, ctx, folds, train_idx, y_dev, device,
                                family_s):
        """Workflow-level CV: refit the pre-selector feature DAG on each
        fold's training rows (`ctx.cv_refit`), then sweep each family on
        that fold's matrix, one fold at a time with the families inside,
        so only one fold's refit matrix lives on the device. A family
        that fails in any fold is dropped. Returns (results, families
        dropped)."""
        per_family: Dict[int, List[List[float]]] = {}
        dead: set = set()
        for fi, (tr, va) in enumerate(folds):
            fold_rows = train_idx[np.asarray(tr) > 0.5]
            X_fold = torch.as_tensor(
                np.asarray(ctx.cv_refit(fold_rows))[train_idx],
                device=device)
            for mi, (est, grids) in enumerate(self.models):
                if mi in dead:
                    continue
                tf = time.perf_counter()
                try:
                    with TRACER.span(
                            f"sweep:family:{type(est).__name__}",
                            category="sweep_family", grids=len(grids),
                            fold=fi):
                        gm = run_sweep(est, grids, X_fold, y_dev,
                                       [(tr, va)], self.evaluator, ctx)
                except NotImplementedError:
                    raise
                except Exception:
                    dead.add(mi)
                    per_family.pop(mi, None)
                    log.exception("Model family %s failed in fold %d; "
                                  "dropping", type(est).__name__, fi)
                    continue
                rows = per_family.setdefault(
                    mi, [[] for _ in range(len(grids))])
                for gi, row in enumerate(gm):
                    rows[gi].append(float(row[0]))
                if X_fold.is_cuda:
                    torch.cuda.synchronize(X_fold.device)
                name = type(est).__name__
                family_s[name] = (family_s.get(name, 0.0)
                                  + time.perf_counter() - tf)
            del X_fold
        results: List[ValidationResult] = []
        for mi, (est, grids) in enumerate(self.models):
            if mi in per_family:
                for grid, fm in zip(grids, per_family[mi]):
                    results.append(ValidationResult(
                        model=type(est).__name__, grid=grid,
                        fold_metrics=fm, model_index=mi))
        return results, len(dead)

    def _finish(self, ctx, results, finite, sign, X, X_full, y_np, y_dev,
                train_idx, test_idx, split_summary, timings):
        if not finite:
            raise RuntimeError(
                "Every validated config produced a non-finite metric")
        best = max(finite, key=lambda r: sign * r.mean_metric)

        t0 = time.perf_counter()
        proto = self.models[best.model_index][0]
        kwargs = {k: v for k, v in proto.params.items() if k != "uid"}
        kwargs.update(best.grid)
        best_est = type(proto)(**kwargs)
        model = best_est.fit_arrays(X, y_dev, torch.ones_like(y_dev), ctx)
        if X.is_cuda:
            torch.cuda.synchronize(X.device)
        refit_s = time.perf_counter() - t0

        def _eval(idx: np.ndarray) -> Dict[str, Any]:
            if len(idx) == 0:
                return {}
            pred = model.predict_arrays(
                X_full[torch.as_tensor(idx, device=X_full.device)])
            pcol = Column(T.Prediction, {k: v.cpu().numpy()
                                         for k, v in pred.items()})
            lcol = Column(T.RealNN, {
                "value": y_np[idx], "mask": np.ones(len(idx), dtype=bool)})
            m = self.evaluator.evaluate(lcol, pcol).to_json()
            return {k: v for k, v in m.items() if not isinstance(v, list)}

        model.summary = ModelSelectorSummary(
            problem_type=self.problem_type,
            metric_name=self.evaluator.default_metric,
            validation_results=results, best_model=best.model,
            best_grid=best.grid, train_metrics=_eval(train_idx),
            holdout_metrics=_eval(test_idx), splitter_summary=split_summary,
            larger_is_better=self.evaluator.is_larger_better,
            timings={**timings, "refit_s": refit_s})
        return model


# the reference's shared grid axes (DefaultSelectorParams.scala:35-76)
_REGULARIZATION = (0.001, 0.01, 0.1, 0.2)
_ELASTIC_NET = (0.1, 0.5)
_MAX_DEPTH = (3, 6, 12)
_MIN_INFO_GAIN = (0.001, 0.01, 0.1)
_MIN_INSTANCES = (10.0, 100.0)


def _lr_grid() -> List[Dict]:
    """LR: ElasticNet {0.1, 0.5} × Regularization {0.001..0.2} = 8."""
    return [{"reg_param": r, "elastic_net_param": a}
            for a in _ELASTIC_NET for r in _REGULARIZATION]


def _rf_grid() -> List[Dict]:
    """RF: MaxDepth × MinInfoGain × MinInstancesPerNode = 18."""
    return [{"max_depth": d, "min_info_gain": g, "min_instances_per_node": m}
            for d in _MAX_DEPTH for g in _MIN_INFO_GAIN
            for m in _MIN_INSTANCES]


def _default_binary_models() -> List[Tuple[Estimator, List[Dict]]]:
    """The reference's binary default, LR + RF + XGB, in its order: LR 8
    elastic-net configs at max_iter 50, RF 18 tree-shape configs at 50
    trees, XGB 200 rounds / eta 0.02 / depth 10 / gamma 0.8 / early
    stopping 20 × min_child_weight {1, 10} — 28 configs."""
    xgb_grid = [{"min_child_weight": m} for m in (1.0, 10.0)]
    return [(OpLogisticRegression(max_iter=50), _lr_grid()),
            (OpRandomForestClassifier(n_trees=50), _rf_grid()),
            (OpXGBoostClassifier(n_estimators=200, eta=0.02, max_depth=10,
                                 gamma=0.8, early_stopping_rounds=20),
             xgb_grid)]


def _default_multiclass_models() -> List[Tuple[Estimator, List[Dict]]]:
    """The reference's multiclass default, LR + RF: LR 8 elastic-net
    configs at max_iter 50, RF 18 tree-shape configs at 50 trees — 26
    configs."""
    return [(OpLogisticRegression(max_iter=50), _lr_grid()),
            (OpRandomForestClassifier(n_trees=50), _rf_grid())]


def _default_regression_models() -> List[Tuple[Estimator, List[Dict]]]:
    """The reference's regression default, linear + RF + GBT: linear 8
    elastic-net configs, RF 18 at 50 trees, Spark-style GBT 18 at 20
    rounds and learning rate 0.1 over the RF grid — 44 configs."""
    return [(OpLinearRegression(), _lr_grid()),
            (OpRandomForestRegressor(n_trees=50), _rf_grid()),
            (OpGBTRegressor(n_estimators=20, learning_rate=0.1), _rf_grid())]


def _selector(models, default_models, validator, splitter, evaluator,
              problem_type, checkpoint_dir) -> ModelSelector:
    return ModelSelector(models=models or default_models(),
                         validator=validator, splitter=splitter,
                         evaluator=evaluator, problem_type=problem_type,
                         checkpoint_dir=checkpoint_dir)


class BinaryClassificationModelSelector:
    """`BinaryClassificationModelSelector.with_cross_validation()` factory."""

    @staticmethod
    def with_cross_validation(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            n_folds: int = 3, validation_metric: str = "AuPR",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_binary_models,
            OpCrossValidation(n_folds=n_folds, seed=seed),
            splitter if splitter is not None else DataBalancer(seed=seed),
            BinaryClassificationEvaluator(metric=validation_metric),
            "binary", checkpoint_dir)

    @staticmethod
    def with_train_validation_split(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            train_ratio: float = 0.75, validation_metric: str = "AuPR",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_binary_models,
            OpTrainValidationSplit(train_ratio=train_ratio, seed=seed),
            splitter if splitter is not None else DataBalancer(seed=seed),
            BinaryClassificationEvaluator(metric=validation_metric),
            "binary", checkpoint_dir)


class MultiClassificationModelSelector:
    """`MultiClassificationModelSelector` factories: F1 by default, the
    DataCutter splitter."""

    @staticmethod
    def with_cross_validation(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            n_folds: int = 3, validation_metric: str = "F1",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_multiclass_models,
            OpCrossValidation(n_folds=n_folds, seed=seed),
            splitter if splitter is not None else DataCutter(seed=seed),
            MultiClassificationEvaluator(metric=validation_metric),
            "multiclass", checkpoint_dir)

    @staticmethod
    def with_train_validation_split(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            train_ratio: float = 0.75, validation_metric: str = "F1",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_multiclass_models,
            OpTrainValidationSplit(train_ratio=train_ratio, seed=seed),
            splitter if splitter is not None else DataCutter(seed=seed),
            MultiClassificationEvaluator(metric=validation_metric),
            "multiclass", checkpoint_dir)


class RegressionModelSelector:
    """`RegressionModelSelector` factories: RMSE by default, the
    DataSplitter holdout."""

    @staticmethod
    def with_cross_validation(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            n_folds: int = 3, validation_metric: str = "RMSE",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_regression_models,
            OpCrossValidation(n_folds=n_folds, seed=seed),
            splitter if splitter is not None else DataSplitter(seed=seed),
            RegressionEvaluator(metric=validation_metric),
            "regression", checkpoint_dir)

    @staticmethod
    def with_train_validation_split(
            models: Optional[Sequence[Tuple[Estimator, List[Dict]]]] = None,
            train_ratio: float = 0.75, validation_metric: str = "RMSE",
            splitter=None, seed: int = 42,
            checkpoint_dir: Optional[str] = None) -> ModelSelector:
        return _selector(
            models, _default_regression_models,
            OpTrainValidationSplit(train_ratio=train_ratio, seed=seed),
            splitter if splitter is not None else DataSplitter(seed=seed),
            RegressionEvaluator(metric=validation_metric),
            "regression", checkpoint_dir)
