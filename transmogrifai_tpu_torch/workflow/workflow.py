"""Workflow (train) and WorkflowModel (score, save).

The port's counterpart of the JAX package's `workflow/workflow.py`.
`Workflow.train` materializes the raw features, then fits the feature DAG
layer by layer on a private copy: each estimator fits on its inputs'
columns and its fitted model transforms them for the next layer. It
returns a `WorkflowModel`, whose `score` walks the fitted DAG eagerly and
whose `score_compiled` runs the planned scorer (`workflow/compiled.py`),
and whose `save` writes the JAX package's on-disk format.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.features.dag import (
    clone_graph, topological_layers)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FeatureGeneratorStage, FitContext, Transformer)


class Workflow:
    """Declarative workflow: wire result features, then `train()`."""

    def __init__(self):
        self.result_features: Tuple = ()
        self._dataset: Optional[Dataset] = None
        self.parameters: Dict[str, Any] = {}

    def set_result_features(self, *features) -> "Workflow":
        self.result_features = tuple(features)
        return self

    def set_input_dataset(self, dataset: Dataset) -> "Workflow":
        self._dataset = dataset
        return self

    def set_parameters(self, params) -> "Workflow":
        """Workflow parameters; none is ported yet, so any parameter
        raises at train time."""
        self.parameters = dict(params)
        return self

    def with_workflow_cv(self) -> "Workflow":
        raise NotImplementedError(
            "workflow-level CV is not ported yet (ROADMAP.md, training "
            "slice, queued)")

    def with_raw_feature_filter(self, *args, **kwargs) -> "Workflow":
        raise NotImplementedError(
            "RawFeatureFilter is not ported yet (ROADMAP.md, queue 1, "
            "item 10)")

    def with_model_stages(self, *args, **kwargs) -> "Workflow":
        raise NotImplementedError(
            "warm starts (with_model_stages) are not ported yet "
            "(ROADMAP.md, queue 1)")

    def train(self, dataset: Optional[Dataset] = None, seed: int = 42,
              device: DeviceLike = "cuda") -> "WorkflowModel":
        """Materialize raw features, then fit the DAG layer by layer on
        `device` (default CUDA; raises without it unless
        ``device="cpu"``). The returned model scores on the same device
        and carries `stage_seconds`: (stage, seconds) per fitted stage,
        fit and transform together."""
        dev = resolve_device(device)
        if not self.result_features:
            raise RuntimeError("set_result_features before train()")
        if self.parameters:
            raise NotImplementedError(
                f"workflow parameters {sorted(self.parameters)} are not "
                "ported yet (stage_params, sweep checkpoints and the rest: "
                "ROADMAP.md, training slice, queued)")
        ds = dataset if dataset is not None else self._dataset
        if ds is None:
            raise RuntimeError(
                "No input data: call set_input_dataset or pass a dataset "
                "to train()")
        result_features = clone_graph(self.result_features)
        layers = topological_layers(result_features)
        ctx = FitContext(n_rows=len(ds), seed=seed, device=dev)
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
                if isinstance(est, Estimator):
                    model = est.fit(inputs, ctx.child(li))
                    fitted[est.uid] = model
                    out = model.transform(inputs, dev)
                elif isinstance(stage, Transformer):
                    fitted[stage.uid] = stage
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
        return model


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

    def compiled(self):
        """The model's `CompiledScorer` (built once)."""
        from transmogrifai_tpu_torch.workflow.compiled import CompiledScorer
        if self._compiled is None:
            self._compiled = CompiledScorer(self)
        return self._compiled

    def score_compiled(self, dataset: Dataset) -> Dict[str, Any]:
        """Planned scoring: {feature_name: tensor pytree on the model's
        device} for the result features."""
        return self.compiled()(dataset)
