"""Multinomial naive Bayes — the port's counterpart of the JAX package's
`models/naive_bayes.py`.

The fit is one class-sum product per pair, `onehot(y)ᵀ·w @ X` ((k × n) ·
(n × d), `torch.matmul` over a leading pair axis P, as the JAX package
computes it with one dot), then logs. Features must be non-negative (Spark
parity): a negative one raises, and the selector drops the family.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, infer_n_classes, per_pair)
from transmogrifai_tpu_torch.models.logistic import logreg_pred_from_logits
from transmogrifai_tpu_torch.parallel.rowshards import rows_of


def fit_naive_bayes(X, y: torch.Tensor, w: torch.Tensor,
                    smoothing: Param, n_classes: int
                    ) -> Dict[str, torch.Tensor]:
    """P fits at once over one matrix X (n, d): labels y (n,), row weights
    w (P, n) (or (n,)), smoothing one value or one per pair. Returns
    {"log_prior": (P, k), "log_theta": (P, k, d)} (the JAX package's
    `fit_naive_bayes`). Over a `parallel.rowshards.RowSplit` X, y and w
    stay whole on the lead: the class counts and feature sums are sums of
    the shards' partials there, and the logs are taken there."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    P = w.shape[0]
    smoothing = per_pair(smoothing, P, shards.lead)[:, None, None]

    def partial(Xk, yk, wk):
        oh = torch.nn.functional.one_hot(yk.long(), n_classes).to(
            torch.float32)[None, :, :] * wk[:, :, None]      # (P, n, k)
        return oh.sum(1), torch.matmul(oh.transpose(1, 2), Xk)

    got = shards.map(partial, X, y_s, w_s)
    class_counts = shards.sum([g[0] for g in got])          # (P, k)
    feat_sums = shards.sum([g[1] for g in got])             # (P, k, d)
    log_prior = torch.log(class_counts + 1e-12) - torch.log(
        torch.clamp(class_counts.sum(1, keepdim=True), min=1e-12))
    num = feat_sums + smoothing
    log_theta = torch.log(num) - torch.log(num.sum(2, keepdim=True))
    return {"log_prior": log_prior, "log_theta": log_theta}


class NaiveBayesHead(torch.nn.Module):
    """Fitted log priors (k,) and log likelihoods (k, d) as buffers."""

    def __init__(self, log_prior: np.ndarray, log_theta: np.ndarray):
        super().__init__()
        self.register_buffer("log_prior", torch.as_tensor(
            log_prior, dtype=torch.float32))
        self.register_buffer("log_theta", torch.as_tensor(
            log_theta, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        # bf16 likelihoods (the quantized mode) widen to f32 exactly
        return X @ self.log_theta.float().T + self.log_prior


def predict_naive_bayes(head: NaiveBayesHead, X: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    return logreg_pred_from_logits(head(X))


def has_negative(X: torch.Tensor) -> bool:
    return bool((X < 0).any())


NEGATIVE_FEATURES = "NaiveBayes requires non-negative features (Spark parity)"


class NaiveBayesModel(PredictionModel):
    def __init__(self, log_prior=None, log_theta=None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.log_prior = np.asarray(log_prior, dtype=np.float32)
        self.log_theta = np.asarray(log_theta, dtype=np.float32)

    def get_params(self):
        return {"log_prior": self.log_prior.tolist(),
                "log_theta": self.log_theta.tolist()}

    def device_constants(self, device):
        return NaiveBayesHead(self.log_prior, self.log_theta).to(device)

    def narrow_device_constants(self, consts: NaiveBayesHead
                                ) -> NaiveBayesHead:
        consts.log_theta = consts.log_theta.to(torch.bfloat16)
        return consts

    def predict(self, consts, X):
        return predict_naive_bayes(consts, X)


class OpNaiveBayes(PredictorEstimator):
    """Spark NaiveBayes's parameter surface (the JAX package's
    `OpNaiveBayes`): multinomial, `smoothing` 1.0 by default."""

    def __init__(self, smoothing: float = 1.0,
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(uid=uid, smoothing=smoothing, n_classes=n_classes)
        self.smoothing = smoothing
        self.n_classes = n_classes

    def fit_arrays(self, X, y, w, ctx) -> NaiveBayesModel:
        if has_negative(X):
            raise ValueError(NEGATIVE_FEATURES)
        k = self.n_classes or infer_n_classes(y.cpu().numpy())
        p = fit_naive_bayes(X, y, w, float(self.smoothing), k)
        return NaiveBayesModel(p["log_prior"][0].cpu().numpy(),
                               p["log_theta"][0].cpu().numpy())
