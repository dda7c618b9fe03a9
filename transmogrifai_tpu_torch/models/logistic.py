"""Multinomial logistic regression (scoring side): `X @ W + b`, softmax,
argmax — the port's counterpart of `predict_logreg` and
`LogisticRegressionModel` in the JAX package's `models/logistic.py`.
Plain torch: the product is one matmul."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models.base import PredictionModel


class LinearHead(torch.nn.Module):
    """Fitted weights W (d, k) and bias b (k,) as buffers."""

    def __init__(self, W: np.ndarray, b: np.ndarray):
        super().__init__()
        self.register_buffer("W", torch.as_tensor(W, dtype=torch.float32))
        self.register_buffer("b", torch.as_tensor(b, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X @ self.W + self.b


def predict_logreg(head: LinearHead, X: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    logits = head(X)
    return {
        "prediction": torch.argmax(logits, dim=-1).to(torch.float32),
        "rawPrediction": logits,
        "probability": torch.softmax(logits, dim=-1),
    }


class LogisticRegressionModel(PredictionModel):
    def __init__(self, W=None, b=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.W = np.asarray(W, dtype=np.float32)
        self.b = np.asarray(b, dtype=np.float32)

    def device_constants(self, device):
        return LinearHead(self.W, self.b).to(device)

    def predict(self, consts, X):
        return predict_logreg(consts, X)
