"""WorkflowModel (scoring side): a fitted workflow loaded for scoring.

The port's counterpart of the scoring half of the JAX package's
`workflow/workflow.py`: `score` walks the fitted DAG eagerly, layer by
layer, with host Columns between stages; `score_compiled` runs the
planned scorer (`workflow/compiled.py`), whose device stages run back to
back on the model's device with no host round trip between them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.features.dag import topological_layers
from transmogrifai_tpu_torch.stages.base import Transformer


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
        self._compiled = None

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
