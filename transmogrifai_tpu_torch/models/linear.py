"""Linear regression: the closed-form ridge solve, the elastic-net fit
(FISTA on centered data) and the scoring side (`X @ β + b`) — the port's
counterpart of the JAX package's `models/linear.py`.

Plain torch, batched over a leading pair axis P of (config, fold) pairs as
`fit_logreg_enet` is: the fit's cost is two dense products per step (or
one Gram matrix and a Cholesky solve), which the JAX package computes as
plain dots and a solve too. The products run in exact f32: the port never
enables TF32.

Not ported yet: warm starts (`init_params`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models.base import (
    WARM_STARTS, Param, PredictionModel, PredictorEstimator, per_pair,
    regression_pred)
from transmogrifai_tpu_torch.models.logistic import _fista_momenta


def _centered(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Per pair: Σw (P,), the weighted means of X (P, d) and y (P,), and the
    centered X (P, n, d) and y (P, n)."""
    wsum = torch.clamp(w.sum(1), min=1.0)
    x_mean = (X[None, :, :] * w[:, :, None]).sum(1) / wsum[:, None]
    y_mean = (y[None, :] * w).sum(1) / wsum
    return (wsum, x_mean, y_mean, X[None, :, :] - x_mean[:, None, :],
            y[None, :] - y_mean[:, None])


def _power_lipschitz_pairs(Xs: torch.Tensor, wsum: torch.Tensor,
                           iters: int = 16) -> torch.Tensor:
    """(P,) λmax(Xsᵀ Xs) / wsum per pair of Xs (P, n, d), by power
    iteration from the uniform unit vector (the JAX package's
    `_power_lipschitz` with unit weights)."""
    P, _, d = Xs.shape
    v = torch.full((P, d, 1), 1.0, dtype=torch.float32, device=Xs.device) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                  device=Xs.device))
    nrm = torch.zeros(P, dtype=torch.float32, device=Xs.device)
    for _ in range(iters):
        u = torch.bmm(Xs.transpose(1, 2), torch.bmm(Xs, v))
        nrm = torch.linalg.vector_norm(u[:, :, 0], dim=1)
        v = u / torch.clamp(nrm, min=1e-12)[:, None, None]
    return nrm / wsum


def fit_linreg_enet(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    l1: Param, l2: Param, max_iter: int = 300
                    ) -> Dict[str, torch.Tensor]:
    """Elastic-net weighted least squares by FISTA for P fits at once over
    one matrix X (n, d): labels y (n,), row weights w (P, n) (or (n,)),
    penalties l1 = reg·α and l2 = reg·(1 − α), one value or one per pair.
    Returns {"beta": (P, d), "intercept": (P,)}.

    The JAX package's `fit_linreg_enet`: on data centered by the weighted
    means, the smooth part 0.5/Σw·Σ w(Xc β − yc)² + 0.5·l2·‖β‖² steps by
    1/L with L = 1.05·λmax(Xcᵀ W Xc)/Σw + l2 + 1e-8, the L1 prox
    soft-thresholds β by step·l1, `max_iter` momentum steps run from zero,
    and the intercept is ȳ − x̄·β."""
    w = w[None, :] if w.dim() == 1 else w
    P = w.shape[0]
    dev = X.device
    l1 = per_pair(l1, P, dev)[:, None]
    l2 = per_pair(l2, P, dev)[:, None]
    wsum, x_mean, y_mean, Xc, yc = _centered(X, y, w)
    L = 1.05 * _power_lipschitz_pairs(Xc * torch.sqrt(w)[:, :, None], wsum) \
        + l2[:, 0] + 1e-8
    step = (1.0 / L)[:, None]
    wsum = wsum[:, None]
    Xt = Xc.transpose(1, 2)
    b = torch.zeros((P, X.shape[1]), dtype=torch.float32, device=dev)
    bm = b
    for beta in _fista_momenta(max_iter).tolist():
        r = (torch.bmm(Xc, bm[:, :, None])[:, :, 0] - yc) * w
        g = torch.bmm(Xt, r[:, :, None])[:, :, 0] / wsum + l2 * bm
        b1 = bm - step * g
        b1 = torch.sign(b1) * torch.clamp(torch.abs(b1) - step * l1, min=0.0)
        bm = b1 + beta * (b1 - b)
        b = b1
    return {"beta": b, "intercept": y_mean - (x_mean * b).sum(1)}


def fit_linreg(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               l2: Param) -> Dict[str, torch.Tensor]:
    """Weighted ridge regression for P fits at once (the JAX package's
    `fit_linreg`): (Xcᵀ W Xc / Σw + (l2 + ε) I) β = Xcᵀ W yc / Σw by a
    Cholesky solve, with the jitter ε = 1e-6·(tr/d + 1) that keeps a
    constant column solvable, and the intercept ȳ − x̄·β. Returns
    {"beta": (P, d), "intercept": (P,)}."""
    w = w[None, :] if w.dim() == 1 else w
    P, d = w.shape[0], X.shape[1]
    l2 = per_pair(l2, P, X.device)
    wsum, x_mean, y_mean, Xc, yc = _centered(X, y, w)
    sw = torch.sqrt(w)
    Xs = Xc * sw[:, :, None]
    ys = yc * sw
    gram = torch.bmm(Xs.transpose(1, 2), Xs) / wsum[:, None, None]
    eps = 1e-6 * (torch.diagonal(gram, dim1=1, dim2=2).sum(1) / d + 1.0)
    eye = torch.eye(d, dtype=torch.float32, device=X.device)
    gram = gram + (l2 + eps)[:, None, None] * eye
    rhs = torch.bmm(Xs.transpose(1, 2), ys[:, :, None]) / wsum[:, None, None]
    beta = torch.cholesky_solve(rhs, torch.linalg.cholesky(gram))[:, :, 0]
    return {"beta": beta, "intercept": y_mean - (x_mean * beta).sum(1)}


class RegressionHead(torch.nn.Module):
    """Fitted coefficients β (d,) and intercept as buffers."""

    def __init__(self, beta: np.ndarray, intercept: float):
        super().__init__()
        self.register_buffer("beta", torch.as_tensor(beta,
                                                     dtype=torch.float32))
        self.register_buffer("intercept", torch.tensor(
            intercept, dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        # bf16 coefficients (the quantized mode) widen to f32 exactly
        return X @ self.beta.float() + self.intercept


def narrow_head(consts: RegressionHead) -> RegressionHead:
    """The quantized mode's view of a head: β in bf16 (the JAX package's
    `narrow_device_constants` of the linear, SVC and GLM models)."""
    consts.beta = consts.beta.to(torch.bfloat16)
    return consts


class LinearRegressionModel(PredictionModel):
    def __init__(self, beta=None, intercept: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.beta = np.asarray(beta, dtype=np.float32)
        self.intercept = float(intercept)

    def get_params(self):
        return {"beta": self.beta.tolist(), "intercept": self.intercept}

    def device_constants(self, device):
        return RegressionHead(self.beta, self.intercept).to(device)

    def narrow_device_constants(self, consts):
        return narrow_head(consts)

    def predict(self, consts, X):
        return regression_pred(consts(X))


class OpLinearRegression(PredictorEstimator):
    """Spark LinearRegression's parameter surface (the JAX package's
    `OpLinearRegression`): elastic_net_param > 0 blends L1 into the
    penalty reg_param·(α·L1 + (1 − α)/2·L2) and fits by FISTA
    (`fit_linreg_enet`, 300 steps); α = 0 is the closed-form ridge
    solve."""

    def __init__(self, reg_param: float = 0.0,
                 elastic_net_param: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid, reg_param=reg_param,
                         elastic_net_param=elastic_net_param)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param

    def fit_arrays(self, X, y, w, ctx) -> LinearRegressionModel:
        if self.init_params is not None:
            raise NotImplementedError(
                "linear regression warm starts are not ported yet "
                f"(ROADMAP.md, {WARM_STARTS})")
        alpha = float(self.elastic_net_param)
        reg = float(self.reg_param)
        if alpha > 0.0:
            p = fit_linreg_enet(X, y, w, reg * alpha, reg * (1.0 - alpha))
        else:
            p = fit_linreg(X, y, w, reg)
        return LinearRegressionModel(p["beta"][0].cpu().numpy(),
                                     float(p["intercept"][0]))
