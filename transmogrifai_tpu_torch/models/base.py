"""Predictor base class (scoring side): a fitted model maps the (label,
features) inputs to the Prediction pytree
`{"prediction", "rawPrediction", "probability"}` of tensors."""

from __future__ import annotations

from typing import Dict

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.stages.base import Transformer


class PredictionModel(Transformer):
    """Fitted predictor: `device_apply_with` returns the Prediction dict.
    Subclasses build their fitted arrays as an `nn.Module` in
    `device_constants(device)` and apply it to the feature matrix."""

    out_type = T.Prediction

    def predict(self, consts: torch.nn.Module,
                X: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError(type(self).__name__)

    def device_apply_with(self, consts, enc, dev):
        # inputs are (label, features); the label is unused at scoring
        return self.predict(consts, dev[-1])
