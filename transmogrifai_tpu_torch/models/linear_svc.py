"""Linear SVC (binary, squared hinge + L2, L-BFGS) — the port's counterpart
of the JAX package's `models/linear_svc.py`.

Plain torch, batched over a leading pair axis P of (config, fold) pairs:
two dense products per line-search trial (`X @ β` and `Xᵀ @ r`), in exact
f32. Scoring exposes sigmoid(margin) as the probability so that ranking
metrics work, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models import lbfgs
from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, binary_margin_pred,
    per_pair)
from transmogrifai_tpu_torch.models.linear import (
    RegressionHead, narrow_head)
from transmogrifai_tpu_torch.models.logistic import _weight_sums
from transmogrifai_tpu_torch.parallel.rowshards import rows_of


def fit_linear_svc(X, y: torch.Tensor, w: torch.Tensor, l2: Param,
                   max_iter: int = 100) -> Dict[str, torch.Tensor]:
    """P fits at once over one matrix X (n, d): labels y (n,) in {0, 1},
    row weights w (P, n) (or (n,)), l2 one value or one per pair. Returns
    {"beta": (P, d), "b": (P,)}.

    The JAX package's `fit_linear_svc`: Σ w·max(0, 1 − y±·margin)² /
    max(Σw, 1) + l2/2·‖β‖², minimized from zero by `max_iter` L-BFGS
    steps, with the gradient written out. Over a
    `parallel.rowshards.RowSplit` X, y and w stay whole on the lead: Σw,
    the loss and the gradient are sums of the shards' partials there, the
    penalty is added once, and L-BFGS runs on the lead."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    dev = shards.lead
    P, d = w.shape[0], X[0].shape[1]
    l2 = per_pair(l2, P, dev)
    wsum = torch.clamp(_weight_sums(shards, w_s), min=1.0)
    parts = shards.map(lambda Xk, yk, wk, ws: (Xk, 2.0 * yk - 1.0,
                                               wk / ws[:, None]),
                       X, y_s, w_s, shards.broadcast(wsum))

    def partial(x, Xk, ypm, wn):
        beta, b = x[:, :d], x[:, d]
        margin = torch.matmul(beta, Xk.T) + b[:, None]
        slack = torch.clamp(1.0 - ypm * margin, min=0.0)
        r = -2.0 * ypm * slack * wn
        return (slack ** 2 * wn).sum(1), torch.matmul(r, Xk), \
            r.sum(1, keepdim=True)

    def value_and_grad(x):
        got = shards.map(lambda xk, p: partial(xk, *p), shards.broadcast(x),
                         parts)
        value, g_beta, g_b = (shards.sum([g[i] for g in got])
                              for i in range(3))
        beta = x[:, :d]
        value = value + 0.5 * l2 * (beta ** 2).sum(1)
        return value, torch.cat([g_beta + l2[:, None] * beta, g_b], 1)

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (P, d + 1), dtype=torch.float32, device=dev), max_iter)
    return {"beta": x[:, :d], "b": x[:, d]}


def predict_linear_svc(head: RegressionHead, X: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    return binary_margin_pred(head(X))


class LinearSVCModel(PredictionModel):
    def __init__(self, beta=None, b: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.beta = np.asarray(beta, dtype=np.float32)
        self.b = float(b)

    def get_params(self):
        return {"beta": self.beta.tolist(), "b": self.b}

    def device_constants(self, device):
        return RegressionHead(self.beta, self.b).to(device)

    def narrow_device_constants(self, consts):
        return narrow_head(consts)

    def predict(self, consts, X):
        return predict_linear_svc(consts, X)


class OpLinearSVC(PredictorEstimator):
    """Spark LinearSVC's parameter surface (the JAX package's
    `OpLinearSVC`): reg_param and max_iter."""

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, reg_param=reg_param, max_iter=max_iter)
        self.reg_param = reg_param
        self.max_iter = max_iter

    def fit_arrays(self, X, y, w, ctx) -> LinearSVCModel:
        p = fit_linear_svc(X, y, w, float(self.reg_param), self.max_iter)
        return LinearSVCModel(p["beta"][0].cpu().numpy(), float(p["b"][0]))
