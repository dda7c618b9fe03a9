"""Workflow (train) and WorkflowModel (score, save).

The port's counterpart of the JAX package's `workflow/workflow.py`.
`Workflow.train` materializes the raw features (from a dataset, or
through a reader: `set_reader`), then fits the feature DAG layer by layer
on a private copy: each estimator fits on its inputs' columns and its
fitted model transforms them for the next layer, each fit and transform
in a ``stage:fit:<op>`` / ``stage:transform:<op>`` span. A
RawFeatureFilter (`with_raw_feature_filter`) first drops unhealthy raw
features and rewires the DAG around them; workflow-level CV
(`with_workflow_cv`) refits the estimators that feed a ModelSelector
inside each of its folds; warm starts (`with_model_stages`) reuse an
earlier model's fitted stages. Workflow parameters (`set_parameters`,
`workflow/params.py`) override stage params, install the run's
feature-cache policy and make the selectors' sweeps resumable
(`sweep_checkpoint`); a device mesh (`train(mesh=)`) spreads them over
the mesh's sweep lanes. `train` returns a `WorkflowModel`, whose `score`
walks the fitted DAG eagerly, whose `score_compiled` runs the planned
scorer (`workflow/compiled.py`), whose `evaluate` scores a dataset
against an evaluator, and whose `save` writes the JAX package's on-disk
format.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.data.columns import SCALAR, VECTOR, Column
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.features.dag import (
    clone_graph, rewire_without, topological_layers)
from transmogrifai_tpu_torch.obs.trace import TRACER
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FeatureGeneratorStage, FitContext, Transformer,
    is_host_stage)

log = logging.getLogger(__name__)


class Workflow:
    """Declarative workflow: wire result features, then `train()`."""

    def __init__(self):
        self.result_features: Tuple = ()
        self._dataset: Optional[Dataset] = None
        self._reader = None
        self.parameters: Dict[str, Any] = {}
        self._rff = None
        self._rff_score_source = None
        self.blocklist: List[str] = []
        self._workflow_cv = False
        self._warm_models: Dict[str, Transformer] = {}

    def set_result_features(self, *features) -> "Workflow":
        self.result_features = tuple(features)
        return self

    def set_input_dataset(self, dataset: Dataset) -> "Workflow":
        self._dataset = dataset
        return self

    def set_reader(self, reader) -> "Workflow":
        """Read the training data through `reader` (`readers/`) when no
        dataset is given: aggregating readers fold each key's events
        through the raw features' monoids."""
        self._reader = reader
        return self

    def set_parameters(self, params) -> "Workflow":
        """An OpParams or a plain dict (`workflow/params.py`):
        `stage_params` overrides apply to the DAG's stages at train time,
        `feature_cache` installs the run's cache policy for the train's
        extent, `sweep_checkpoint` makes the selectors' sweeps resumable;
        `continual` and `perf_model` blocks raise at train time, naming
        their ROADMAP items."""
        from transmogrifai_tpu_torch.workflow.params import OpParams
        if isinstance(params, OpParams):
            self.parameters = params.to_json()
        else:
            self.parameters = dict(params)
        return self

    def with_model_stages(self, model: "WorkflowModel",
                          exclude: Sequence[str] = ()) -> "Workflow":
        """Warm start (OpWorkflow.withModelStages): estimators whose uid
        matches a fitted stage of `model` reuse that fitted transformer
        instead of refitting, so only new estimators train. Uids in
        `exclude` refit even when a fitted stage exists."""
        skip = set(exclude)
        self._warm_models.update({uid: m for uid, m in model.fitted.items()
                                  if uid not in skip})
        return self

    def with_workflow_cv(self) -> "Workflow":
        """Move the feature DAG before each ModelSelector inside its CV
        folds: the estimators feeding the selector's vector refit on each
        fold's training rows, so fold-global statistics (supervised
        buckets, sanity-check selections) cannot leak into validation
        metrics."""
        self._workflow_cv = True
        return self

    def with_raw_feature_filter(self, score_dataset: Optional[Dataset] = None,
                                score_reader=None,
                                **rff_params) -> "Workflow":
        """Run a RawFeatureFilter (`rff_params` are its arguments) before
        training: raw features whose train (and, given `score_dataset` or
        `score_reader`, score) distributions fail its rules are dropped,
        and the DAG is rewired around them."""
        from transmogrifai_tpu_torch.automl.raw_feature_filter import (
            RawFeatureFilter)
        self._rff = RawFeatureFilter(**rff_params)
        self._rff_score_source = (score_dataset, score_reader)
        return self

    def _resolve_dataset(self, dataset: Optional[Dataset]) -> Dataset:
        ds = dataset if dataset is not None else self._dataset
        if ds is None and self._reader is not None:
            ds = self._reader.read(self._raw_features())
        if ds is None:
            raise RuntimeError(
                "No input data: call set_input_dataset / set_reader or pass "
                "a dataset to train()")
        return ds

    def _refuse_unported_parameters(self) -> None:
        from transmogrifai_tpu_torch.workflow.params import (
            CONTINUAL_REFUSAL, PERF_MODEL_REFUSAL)
        p = self.parameters
        if p.get("continual") is not None:
            raise NotImplementedError(CONTINUAL_REFUSAL)
        if p.get("perf_model") is not None:
            raise NotImplementedError(PERF_MODEL_REFUSAL)

    def train(self, dataset: Optional[Dataset] = None, seed: int = 42,
              device: DeviceLike = "cuda", mesh=None) -> "WorkflowModel":
        """Materialize raw features, then fit the DAG layer by layer on
        `device` (default CUDA; raises without it unless
        ``device="cpu"``). The returned model scores on the same device
        and carries `stage_seconds`: (stage, seconds) per fitted stage,
        fit and transform together. A `feature_cache` parameter is the
        process-default cache policy for the train's extent.

        `mesh` (`parallel.mesh.make_mesh(..., device=device)`): a sweep
        axis wider than 1 runs every ModelSelector's sweep through the
        work-stealing scheduler (`parallel/scheduler.py`), or through
        K11's `_run_block` under workflow CV or with
        ``TRANSMOGRIFAI_DISTRIBUTED_SWEEP=0``. A `sweep_checkpoint`
        parameter's `checkpoint_dir` goes to every ModelSelector of the
        DAG that has none of its own, so a train re-run with the same
        parameters resumes its sweeps at the first un-journaled block."""
        from transmogrifai_tpu_torch.data.feature_cache import cache_scope
        dev = resolve_device(device)
        if not self.result_features:
            raise RuntimeError("set_result_features before train()")
        if mesh is not None and any(torch.device(d).type != dev.type
                                    for d in mesh.devices.flat):
            raise ValueError(f"train(device={dev}) with a mesh over "
                             f"other devices: {mesh}")
        self._refuse_unported_parameters()
        with cache_scope(self.parameters.get("feature_cache")):
            return self._train_impl(dataset, seed, dev, mesh)

    def _train_impl(self, dataset: Optional[Dataset], seed: int,
                    dev: torch.device, mesh=None) -> "WorkflowModel":
        ds = self._resolve_dataset(dataset)
        rff_results = None
        source_features = self.result_features
        if self._rff is not None:
            ds, source_features, rff_results = self._apply_rff(ds)
        result_features = clone_graph(source_features)
        layers = topological_layers(result_features)
        stage_params = self.parameters.get("stage_params") or {}
        if stage_params:
            from transmogrifai_tpu_torch.workflow.params import (
                apply_stage_params)
            apply_stage_params([s for layer in layers[1:] for s in layer],
                               stage_params, log=log)
        sweep_ckpt = self.parameters.get("sweep_checkpoint") or {}
        if sweep_ckpt.get("checkpoint_dir"):
            for layer in layers[1:]:
                for stage in layer:
                    est = getattr(stage, "_estimator", None) or stage
                    if _is_selector(est) and est.checkpoint_dir is None:
                        est.checkpoint_dir = sweep_ckpt["checkpoint_dir"]
                        est.checkpoint_fsync = bool(
                            sweep_ckpt.get("fsync", True))
        ctx = FitContext(n_rows=len(ds), seed=seed, device=dev, mesh=mesh)
        columns: Dict[str, Column] = {}
        fitted: Dict[str, Transformer] = {}
        stage_seconds: List[Tuple[str, float]] = []
        t0 = time.perf_counter()
        for gen in layers[0] if layers else []:
            if not isinstance(gen, FeatureGeneratorStage):
                raise TypeError(
                    f"Layer-0 stage {gen!r} is not a feature generator")
            columns[gen.get_output().uid] = gen.materialize(ds)
        stage_seconds.append(("materialize", time.perf_counter() - t0))
        for li, layer in enumerate(layers[1:], start=1):
            for stage in layer:
                t0 = time.perf_counter()
                inputs = [columns[f.uid] for f in stage.input_features]
                est = getattr(stage, "_estimator", None) or stage
                warm = (self._warm_models.get(est.uid)
                        if isinstance(est, Estimator) else None)
                if warm is not None and not isinstance(warm, Estimator):
                    # warm start: the earlier model's fitted stage
                    fitted[est.uid] = warm
                    with TRACER.span(
                            f"stage:transform:{stage.operation_name}",
                            category="stage", uid=est.uid, layer=li):
                        out = warm.transform(inputs, dev)
                elif isinstance(est, Estimator):
                    stage_ctx = ctx.child(li)
                    if self._workflow_cv and _is_selector(est):
                        stage_ctx.cv_refit = _make_cv_refit(
                            stage, layers, columns, ctx)
                    with TRACER.span(
                            f"stage:fit:{stage.operation_name}",
                            category="stage", uid=est.uid, layer=li):
                        model = est.fit(inputs, stage_ctx)
                    fitted[est.uid] = model
                    with TRACER.span(
                            f"stage:transform:{stage.operation_name}",
                            category="stage", uid=est.uid, layer=li):
                        out = model.transform(inputs, dev)
                elif isinstance(stage, Transformer):
                    fitted[stage.uid] = stage
                    with TRACER.span(
                            f"stage:transform:{stage.operation_name}",
                            category="stage", uid=stage.uid, layer=li):
                        out = stage.transform(inputs, dev)
                else:
                    raise TypeError(f"Cannot execute stage {stage!r}")
                columns[stage.get_output().uid] = out
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stage_seconds.append((stage.operation_name,
                                      time.perf_counter() - t0))
        model = WorkflowModel(result_features=result_features, fitted=fitted,
                              device=dev)
        model.stage_seconds = stage_seconds
        model.train_columns = columns
        model.rff_results = rff_results
        model.blocklist = list(self.blocklist)
        model.quant_calibration = capture_quant_calibration(
            result_features, fitted, columns)
        return model

    def _raw_features(self) -> List:
        seen: Dict[str, Any] = {}
        for f in self.result_features:
            for r in f.raw_features():
                seen.setdefault(r.uid, r)
        return list(seen.values())

    def _apply_rff(self, ds: Dataset):
        """Run the RawFeatureFilter and rewire the DAG around the raw
        features it drops (they become `blocklist`). A result feature
        that can no longer be produced raises, as in the JAX package."""
        raws = self._raw_features()
        label = next((f for f in raws if f.is_response), None)
        score_ds, score_reader = self._rff_score_source
        if score_ds is None and score_reader is not None:
            score_ds = score_reader.read(raws)
        filtered = self._rff.generate_filtered_raw(
            ds, raws, score_dataset=score_ds, label_feature=label)
        self.blocklist = list(filtered.features_to_drop)
        if not filtered.features_to_drop:
            return (filtered.clean_dataset, self.result_features,
                    filtered.results)
        survived, dropped = rewire_without(
            self.result_features, filtered.features_to_drop)
        if dropped:
            raise RuntimeError(
                f"RawFeatureFilter removed raw features "
                f"{filtered.features_to_drop} making result features "
                f"{dropped} unproducible; protect them via "
                f"protected_features or relax thresholds")
        return filtered.clean_dataset, tuple(survived), filtered.results


def _is_selector(est) -> bool:
    from transmogrifai_tpu_torch.selector.model_selector import ModelSelector
    return isinstance(est, ModelSelector)


def _make_cv_refit(selector_stage, layers, columns, ctx: FitContext):
    """Workflow-level CV's refit as a closure: `refit(fold_rows)` refits
    every estimator feeding the selector's feature vector on `fold_rows`
    only, reruns the transformers, and returns the fold's feature matrix
    for all rows (host numpy). The label's subtree is not refit (the
    global pass's columns are reused), so the folds' rows stay aligned.
    A fold model fits with seed `ctx.seed * 1000003 + salt` (salt counting
    the refit stages in layer order) through `fit_model`, so the globally
    fitted model stays in the graph."""
    label_f, vec_f = selector_stage.input_features
    label_uids = {f.uid for f in label_f.traverse()}
    during_stage_uids = {
        f.origin_stage.uid for f in vec_f.traverse()
        if not f.is_raw and f.uid not in label_uids}
    base = dict(columns)  # the global columns materialized so far

    def refit(fold_rows: np.ndarray) -> np.ndarray:
        cols = dict(base)
        salt = 0
        for layer in layers[1:]:
            for stage in layer:
                if (stage is selector_stage
                        or stage.uid not in during_stage_uids):
                    continue
                salt += 1
                ins_full = [cols[f.uid] for f in stage.input_features]
                est = getattr(stage, "_estimator", None) or stage
                if isinstance(est, Estimator):
                    fold_ctx = FitContext(
                        n_rows=len(fold_rows),
                        seed=ctx.seed * 1000003 + salt, device=ctx.device,
                        mesh=ctx.mesh)
                    m = est.fit_model(
                        [c.take(fold_rows) for c in ins_full], fold_ctx)
                    m.uid = est.uid
                    m.input_features = est.input_features
                    out = m.transform(ins_full, ctx.device)
                else:
                    out = stage.transform(ins_full, ctx.device)
                cols[stage.get_output().uid] = out
        return np.asarray(cols[vec_f.uid].data)

    return refit


def capture_quant_calibration(result_features, fitted, columns
                              ) -> Optional[Dict[str, Any]]:
    """Fit-time per-column [lo, hi] ranges for the quantized serving wire
    (the JAX package's `Workflow._capture_quant_calibration`): one entry
    per host-origin device-input column (raw generator outputs and host
    stage outputs, the leaves `quantize_wire` quantizes at serving time).
    A scalar range is extended to include 0.0, since masked slots ride the
    wire as exact 0.0 fills; rows are strided past 262,144 (a vector's
    past 65,536). Returns None when no column has a finite range or the
    capture fails: quantized serving then falls back to batch-relative
    ranges."""
    try:
        host_uids = {f.uid for rf in result_features
                     for f in rf.raw_features()}
        for s in fitted.values():
            if is_host_stage(s):
                host_uids.add(s.get_output().uid)
        cal = {}
        for uid in host_uids:
            col = columns.get(uid)
            if col is None:
                continue
            if col.kind == SCALAR:
                v = np.asarray(col.data["value"], np.float64)
                v = v[np.asarray(col.data["mask"]).astype(bool)]
                if v.size > 262_144:
                    v = v[::v.size // 262_144]
                if v.size == 0:
                    continue
                with np.errstate(invalid="ignore"):
                    fin = v[np.isfinite(v)]
                if fin.size == 0:
                    continue
                cal[uid] = {"lo": [min(float(fin.min()), 0.0)],
                            "hi": [max(float(fin.max()), 0.0)]}
            elif col.kind == VECTOR:
                a = np.asarray(col.data)
                if a.ndim != 2 or a.size == 0:
                    continue
                if a.shape[0] > 65_536:
                    a = a[::a.shape[0] // 65_536]
                with np.errstate(invalid="ignore"), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    fin = np.where(np.isfinite(a), a, np.nan)
                    lo = np.nanmin(fin, axis=0)
                    hi = np.nanmax(fin, axis=0)
                lo = np.where(np.isfinite(lo), lo, 0.0)
                hi = np.where(np.isfinite(hi), hi, lo)
                cal[uid] = {"lo": [float(x) for x in lo],
                            "hi": [float(x) for x in hi]}
        return cal or None
    except Exception as e:
        log.warning("quant calibration capture failed (%s: %s); quantized "
                    "serving will use batch-relative ranges",
                    type(e).__name__, e, exc_info=True)
        return None


class WorkflowModel:
    """A fitted workflow: result features, fitted stages by uid, and the
    device it scores on (default CUDA; raises without it unless
    ``device="cpu"``)."""

    def __init__(self, result_features: Sequence,
                 fitted: Dict[str, Transformer],
                 device: DeviceLike = "cuda"):
        self.result_features = tuple(result_features)
        self.fitted = dict(fitted)
        self.device = resolve_device(device)
        self.loaded_from: Optional[str] = None
        self.stage_seconds: List[Tuple[str, float]] = []
        # the training columns by feature uid (set by `Workflow.train`;
        # empty on a loaded model), which `model_insights` reads
        self.train_columns: Dict[str, Column] = {}
        # fit-time quantization ranges, uid -> {"lo": [...], "hi": [...]}
        self.quant_calibration: Optional[Dict[str, Any]] = None
        # the RawFeatureFilterResults when the filter ran, and the raw
        # features it dropped
        self.rff_results = None
        self.blocklist: List[str] = []
        self._compiled = None

    def save(self, path: str, overwrite: bool = True) -> None:
        """Write the model in the JAX package's format (`op-model.json`,
        `arrays.npz`, `integrity.json`), readable by both packages'
        `load_model`."""
        from transmogrifai_tpu_torch.workflow.serialization import save_model
        save_model(self, path, overwrite=overwrite)

    def _execute(self, ds: Dataset) -> Dict[str, Column]:
        """Eager layer-by-layer transform walk."""
        layers = topological_layers(self.result_features)
        columns: Dict[str, Column] = {}
        for gen in layers[0] if layers else []:
            columns[gen.get_output().uid] = gen.materialize(
                ds, allow_missing_response=True)
        for layer in layers[1:]:
            for stage in layer:
                model = self.fitted.get(stage.uid)
                if model is None:
                    raise RuntimeError(
                        f"Stage {stage.operation_name} ({stage.uid}) has no "
                        "fitted model")
                inputs = [columns[f.uid] for f in stage.input_features]
                columns[stage.get_output().uid] = model.transform(
                    inputs, self.device)
        return columns

    def score(self, dataset: Dataset,
              keep_intermediate: bool = False) -> Dict[str, Column]:
        """Eager scoring: {feature_name: host Column} for the result
        features (every feature by uid with `keep_intermediate`)."""
        columns = self._execute(dataset)
        if keep_intermediate:
            return columns
        return {f.name: columns[f.uid] for f in self.result_features}

    def _ensure_compiled(self, quant: Any = None, sharding=None):
        """The model's `CompiledScorer` for quantized mode `quant` (None,
        "int8", "int4", their "-calibrated" variants or a ScoringQuant)
        and row `sharding`, rebuilt when either changes (the JAX package
        keys its cached scorer on both)."""
        from transmogrifai_tpu_torch.workflow.compiled import (
            CompiledScorer, ScoringQuant)
        q = ScoringQuant.resolve(quant)
        if (self._compiled is None or self._compiled.quant != q
                or self._compiled.sharding != sharding):
            self._compiled = CompiledScorer(self, quant=q, sharding=sharding)
        return self._compiled

    def compiled(self):
        """The model's exact-f32 `CompiledScorer` (built once)."""
        return self._ensure_compiled()

    def score_compiled(self, dataset: Dataset,
                       sharding=None) -> Dict[str, Any]:
        """Planned scoring: {feature_name: tensor pytree on the model's
        device} for the result features. `sharding`
        (`parallel.mesh.data_sharding(mesh)`) runs each device segment
        over the row shards of the mesh's data axis and gathers the rows
        back in order; a batch whose row count the shard count does not
        divide runs replicated (`workflow/compiled.py`)."""
        return self._ensure_compiled(sharding=sharding)(dataset)

    def evaluate(self, dataset: Dataset, evaluator, label_feature,
                 prediction_feature):
        """`evaluator`'s metrics of the eager scores of `dataset`: the
        label and prediction columns by their features
        (OpWorkflowModel.evaluate)."""
        cols = self._execute(dataset)
        return evaluator.evaluate(
            cols[label_feature.uid], cols[prediction_feature.uid])

    def model_insights(self):
        """The merged explanation artifact (ModelInsights.scala:74)."""
        from transmogrifai_tpu_torch.insights import ModelInsights
        return ModelInsights.extract(self)
