"""Multinomial logistic regression: the pure-L2 fit (L-BFGS), the
elastic-net fit (FISTA) and the scoring side (`X @ W + b`, softmax,
argmax) — the port's counterpart of the JAX package's
`models/logistic.py`.

Plain torch: the fits' cost is two dense products per step or line-search
trial (`X @ W` and `Xᵀ @ R`, batched over a leading pair axis P of
(config, fold) pairs), which the JAX package also computes as plain dots,
and an elementwise tail over (n, k) and (d, k) values per pair. The
products run in exact f32: the port never enables TF32.

Not ported yet: warm starts.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models import lbfgs
from transmogrifai_tpu_torch.models.base import (
    WARM_STARTS, Param, PredictionModel, PredictorEstimator,
    infer_n_classes, per_pair)


def logreg_loss(params: Dict[str, torch.Tensor], X: torch.Tensor,
                y_onehot: torch.Tensor, w: torch.Tensor,
                l2: torch.Tensor) -> torch.Tensor:
    """(P,) weighted softmax cross-entropy / max(Σw, 1) + l2/2·‖W‖² of
    params {"W": (P, d, k), "b": (P, k)} with row weights w (P, n) (the
    JAX package's `logreg_loss`, per pair)."""
    logits = torch.matmul(X, params["W"]) + params["b"][:, None, :]
    ll = -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    wsum = torch.clamp(w.sum(1), min=1.0)
    return (ll * w).sum(1) / wsum \
        + 0.5 * l2 * (params["W"] ** 2).sum((1, 2))


def fit_logreg(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, l2: Param,
               n_classes: int, max_iter: int = 100
               ) -> Dict[str, torch.Tensor]:
    """Pure-L2 multinomial logistic regression by L-BFGS for P fits at once
    over one matrix X (n, d): labels y (n,), row weights w (P, n) (or
    (n,)), l2 one value or one per pair. Returns {"W": (P, d, k), "b": (P,
    k)}.

    The JAX package's `fit_logreg`: `logreg_loss` minimized from zero by
    `max_iter` steps of optax's L-BFGS (`models/lbfgs.py`), with the
    gradient written out: (softmax − Y)·w/Σw gives Xᵀ(·) + l2·W and the
    column sums for b."""
    w = w[None, :] if w.dim() == 1 else w
    P, (n, d) = w.shape[0], X.shape
    k = n_classes
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    l2 = per_pair(l2, P, X.device)
    wn = (w / torch.clamp(w.sum(1), min=1.0)[:, None])[:, :, None]
    Xt = X.T

    def value_and_grad(x):
        W = x[:, :d * k].reshape(P, d, k)
        b = x[:, d * k:]
        logits = torch.matmul(X, W) + b[:, None, :]
        ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        value = (ll * wn[:, :, 0]).sum(1) + 0.5 * l2 * (W ** 2).sum((1, 2))
        R = (torch.softmax(logits, dim=-1) - Y) * wn
        gW = torch.matmul(Xt, R) + l2[:, None, None] * W
        return value, torch.cat([gW.reshape(P, d * k), R.sum(1)], 1)

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (P, d * k + k), dtype=torch.float32, device=X.device), max_iter)
    return {"W": x[:, :d * k].reshape(P, d, k), "b": x[:, d * k:]}


def _power_lipschitz(X: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor,
                     iters: int = 16) -> torch.Tensor:
    """(P,) λmax(Xᵀ diag(w_p) X) / wsum_p by power iteration from the
    uniform unit vector, for row weights w (P, n) — two products per
    step."""
    P, d = w.shape[0], X.shape[1]
    v = torch.full((P, d), 1.0, dtype=torch.float32, device=X.device) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                  device=X.device))
    nrm = torch.zeros(P, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        u = (w * (v @ X.T)) @ X
        nrm = torch.linalg.vector_norm(u, dim=1)
        v = u / torch.clamp(nrm, min=1e-12)[:, None]
    return nrm / wsum


def _fista_momenta(max_iter: int) -> np.ndarray:
    """The FISTA momentum β_k = (t_k − 1) / t_{k+1}, t_{k+1} = (1 + √(1 +
    4 t_k²)) / 2 from t_0 = 1, in f32 (the sequence does not depend on the
    data)."""
    t = np.float32(1.0)
    out = np.empty(max_iter, dtype=np.float32)
    for k in range(max_iter):
        t1 = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out[k] = (t - np.float32(1.0)) / t1
        t = t1
    return out


def fit_logreg_enet(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    l1: Param, l2: Param, n_classes: int,
                    max_iter: int = 200) -> Dict[str, torch.Tensor]:
    """Elastic-net multinomial logistic regression by FISTA for P fits at
    once over one matrix X (n, d): labels y (n,), row weights w (P, n) (or
    (n,)), penalties l1 = reg·α and l2 = reg·(1 − α) one value or one per
    pair. Returns {"W": (P, d, k), "b": (P, k)}.

    The JAX package's `fit_logreg_enet`: the smooth part (weighted
    softmax cross-entropy + l2/2·‖W‖²) steps by 1/L with L = 0.525 ·
    λmax(Xᵀ W X)/Σw + l2 + 1e-8 (`_power_lipschitz`), the L1 prox
    soft-thresholds W by step·l1, the bias is unpenalized, and `max_iter`
    momentum steps run from zero."""
    w = w[None, :] if w.dim() == 1 else w
    P, (n, d) = w.shape[0], X.shape
    dev = X.device
    Y = torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)
    l1 = per_pair(l1, P, dev)[:, None, None]
    l2 = per_pair(l2, P, dev)[:, None, None]
    wsum = torch.clamp(w.sum(1), min=1.0)
    L = 0.5 * 1.05 * _power_lipschitz(X, w, wsum) + l2[:, 0, 0] + 1e-8
    step = (1.0 / L)[:, None, None]
    wsum = wsum[:, None, None]
    wr = w[:, :, None]
    Xt = X.T
    W = torch.zeros((P, d, n_classes), dtype=torch.float32, device=dev)
    b = torch.zeros((P, 1, n_classes), dtype=torch.float32, device=dev)
    Wm, bm = W, b
    for beta in _fista_momenta(max_iter).tolist():
        p = torch.softmax(torch.matmul(X, Wm) + bm, dim=-1)
        R = (p - Y) * wr
        gW = torch.matmul(Xt, R) / wsum + l2 * Wm
        gb = R.sum(1, keepdim=True) / wsum
        W1 = Wm - step * gW
        W1 = torch.sign(W1) * torch.clamp(torch.abs(W1) - step * l1, min=0.0)
        b1 = bm - step * gb
        Wm = W1 + beta * (W1 - W)
        bm = b1 + beta * (b1 - b)
        W, b = W1, b1
    return {"W": W, "b": b[:, 0]}


def enet_iters(max_iter: int) -> int:
    """FISTA steps for an L-BFGS-equivalent `max_iter`: 4× with a floor
    of 200 (the JAX package's rule)."""
    return max(200, 4 * int(max_iter))


class LinearHead(torch.nn.Module):
    """Fitted weights W (d, k) and bias b (k,) as buffers."""

    def __init__(self, W: np.ndarray, b: np.ndarray):
        super().__init__()
        self.register_buffer("W", torch.as_tensor(W, dtype=torch.float32))
        self.register_buffer("b", torch.as_tensor(b, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        # bf16 weights (the quantized mode) widen to f32 exactly
        return X @ self.W.float() + self.b


def logreg_pred_from_logits(logits: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
    return {
        "prediction": torch.argmax(logits, dim=-1).to(torch.float32),
        "rawPrediction": logits,
        "probability": torch.softmax(logits, dim=-1),
    }


def predict_logreg(head: LinearHead, X: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    return logreg_pred_from_logits(head(X))


class LogisticRegressionModel(PredictionModel):
    def __init__(self, W=None, b=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.W = np.asarray(W, dtype=np.float32)
        self.b = np.asarray(b, dtype=np.float32)

    def get_params(self):
        return {"W": self.W.tolist(), "b": self.b.tolist()}

    def device_constants(self, device):
        return LinearHead(self.W, self.b).to(device)

    def narrow_device_constants(self, consts: LinearHead) -> LinearHead:
        consts.W = consts.W.to(torch.bfloat16)
        return consts

    def predict(self, consts, X):
        return predict_logreg(consts, X)


class OpLogisticRegression(PredictorEstimator):
    """Grid-sweepable hyperparameters reg_param, elastic_net_param and
    max_iter (the JAX package's `OpLogisticRegression`): the penalty is
    reg_param·(α·L1 + (1 − α)/2·L2). α > 0 fits by FISTA
    (`fit_logreg_enet`, `enet_iters(max_iter)` steps), α = 0 by L-BFGS
    (`fit_logreg`, `max_iter` steps)."""

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100,
                 elastic_net_param: float = 0.0,
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(uid=uid, reg_param=reg_param, max_iter=max_iter,
                         elastic_net_param=elastic_net_param,
                         n_classes=n_classes)
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.elastic_net_param = elastic_net_param
        self.n_classes = n_classes

    def fit_arrays(self, X, y, w, ctx) -> LogisticRegressionModel:
        k = self.n_classes or infer_n_classes(y.cpu().numpy())
        alpha = float(self.elastic_net_param)
        if self.init_params is not None:
            raise NotImplementedError(
                "logistic warm starts are not ported yet (ROADMAP.md, "
                f"{WARM_STARTS})")
        reg = float(self.reg_param)
        if alpha > 0.0:
            params = fit_logreg_enet(X, y, w, reg * alpha,
                                     reg * (1.0 - alpha), k,
                                     enet_iters(self.max_iter))
        else:
            params = fit_logreg(X, y, w, reg, k, self.max_iter)
        return LogisticRegressionModel(params["W"][0].cpu().numpy(),
                                       params["b"][0].cpu().numpy())
