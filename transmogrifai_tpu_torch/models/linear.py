"""Linear regression: the closed-form ridge solve, the elastic-net fit
(FISTA on centered data) and the scoring side (`X @ β + b`) — the port's
counterpart of the JAX package's `models/linear.py`.

Plain torch, batched over a leading pair axis P of (config, fold) pairs as
`fit_logreg_enet` is: the fit's cost is two dense products per step (or
one Gram matrix and a Cholesky solve), which the JAX package computes as
plain dots and a solve too. The products run in exact f32: the port never
enables TF32.

Both fits take X as a tensor or as a `parallel.rowshards.RowSplit` (a
mesh's data axis): over a split, y and w stay whole on the lead, and
every sum over rows (the weighted means, the power iteration's and the
step's products, the Gram matrix and the moment vector) is a sum of the
shards' partials on the lead, where the step, the prox and the Cholesky
solve run. A tensor is the one-shard case of the same code.

Not ported yet: warm starts (`init_params`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, per_pair, regression_pred,
    resolve_init_params)
from transmogrifai_tpu_torch.models.logistic import (
    _fista_momenta, _weight_sums)
from transmogrifai_tpu_torch.parallel.rowshards import rows_of


def _centered(shards, X, y_s, w_s):
    """Per pair: Σw (P,), the weighted means of X (P, d) and y (P,), and
    each shard's centered X (P, n_k, d) and y (P, n_k); the sums over rows
    are sums of the shards' partials."""
    wsum = torch.clamp(_weight_sums(shards, w_s), min=1.0)
    x_mean = shards.sum(shards.map(
        lambda Xk, wk: (Xk[None, :, :] * wk[:, :, None]).sum(1), X, w_s)) \
        / wsum[:, None]
    y_mean = shards.sum(shards.map(lambda yk, wk: (yk[None, :] * wk).sum(1),
                                   y_s, w_s)) / wsum
    centered = shards.map(
        lambda Xk, yk, xm, ym: (Xk[None, :, :] - xm[:, None, :],
                                yk[None, :] - ym[:, None]),
        X, y_s, shards.broadcast(x_mean), shards.broadcast(y_mean))
    return (wsum, x_mean, y_mean, [c[0] for c in centered],
            [c[1] for c in centered])


def _power_lipschitz_pairs(shards, Xs, wsum: torch.Tensor,
                           iters: int = 16) -> torch.Tensor:
    """(P,) λmax(Xsᵀ Xs) / wsum per pair of Xs (P, n, d), by power
    iteration from the uniform unit vector (the JAX package's
    `_power_lipschitz` with unit weights); Xs is the shards' parts and
    each step's product a sum of the shards' partials."""
    P, _, d = Xs[0].shape
    dev = shards.lead
    v = torch.full((P, d, 1), 1.0, dtype=torch.float32, device=dev) \
        / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                  device=dev))
    nrm = torch.zeros(P, dtype=torch.float32, device=dev)
    for _ in range(iters):
        u = shards.sum(shards.map(
            lambda Xk, vk: torch.bmm(Xk.transpose(1, 2), torch.bmm(Xk, vk)),
            Xs, shards.broadcast(v)))
        nrm = torch.linalg.vector_norm(u[:, :, 0], dim=1)
        v = u / torch.clamp(nrm, min=1e-12)[:, None, None]
    return nrm / wsum


def fit_linreg_enet(X, y: torch.Tensor, w: torch.Tensor,
                    l1: Param, l2: Param, max_iter: int = 300,
                    init_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Elastic-net weighted least squares by FISTA for P fits at once over
    one matrix X (n, d): labels y (n,), row weights w (P, n) (or (n,)),
    penalties l1 = reg·α and l2 = reg·(1 − α), one value or one per pair.
    Returns {"beta": (P, d), "intercept": (P,)}.

    The JAX package's `fit_linreg_enet`: on data centered by the weighted
    means, the smooth part 0.5/Σw·Σ w(Xc β − yc)² + 0.5·l2·‖β‖² steps by
    1/L with L = 1.05·λmax(Xcᵀ W Xc)/Σw + l2 + 1e-8, the L1 prox
    soft-thresholds β by step·l1, `max_iter` momentum steps run from zero
    (or from `init_params` {"beta": (d,)}, a warm start), and the
    intercept is ȳ − x̄·β."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    P, d = w.shape[0], X[0].shape[1]
    dev = shards.lead
    l1 = per_pair(l1, P, dev)[:, None]
    l2 = per_pair(l2, P, dev)[:, None]
    wsum, x_mean, y_mean, Xc, yc = _centered(shards, X, y_s, w_s)
    L = 1.05 * _power_lipschitz_pairs(
        shards, shards.map(lambda c, wk: c * torch.sqrt(wk)[:, :, None],
                           Xc, w_s), wsum) + l2[:, 0] + 1e-8
    step = (1.0 / L)[:, None]
    wsum = wsum[:, None]
    parts = list(zip(Xc, [c.transpose(1, 2) for c in Xc], yc, w_s))
    if init_params is None:
        b = torch.zeros((P, d), dtype=torch.float32, device=dev)
    else:
        b = init_params["beta"].expand(P, d).clone()
    bm = b

    def partial(bk, Xk, Xt, yk, wk):
        r = (torch.bmm(Xk, bk[:, :, None])[:, :, 0] - yk) * wk
        return torch.bmm(Xt, r[:, :, None])[:, :, 0]

    for beta in _fista_momenta(max_iter).tolist():
        g = shards.sum(shards.map(lambda bk, p: partial(bk, *p),
                                  shards.broadcast(bm), parts)) / wsum \
            + l2 * bm
        b1 = bm - step * g
        b1 = torch.sign(b1) * torch.clamp(torch.abs(b1) - step * l1, min=0.0)
        bm = b1 + beta * (b1 - b)
        b = b1
    return {"beta": b, "intercept": y_mean - (x_mean * b).sum(1)}


def fit_linreg(X, y: torch.Tensor, w: torch.Tensor,
               l2: Param) -> Dict[str, torch.Tensor]:
    """Weighted ridge regression for P fits at once (the JAX package's
    `fit_linreg`): (Xcᵀ W Xc / Σw + (l2 + ε) I) β = Xcᵀ W yc / Σw by a
    Cholesky solve, with the jitter ε = 1e-6·(tr/d + 1) that keeps a
    constant column solvable, and the intercept ȳ − x̄·β. Returns
    {"beta": (P, d), "intercept": (P,)}. Over a `RowSplit` X the Gram
    matrix and the moment vector are sums of the shards' partials; the
    solve runs on the lead."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    P, d = w.shape[0], X[0].shape[1]
    dev = shards.lead
    l2 = per_pair(l2, P, dev)
    wsum, x_mean, y_mean, Xc, yc = _centered(shards, X, y_s, w_s)

    def moments(Xk, yk, wk):
        sw = torch.sqrt(wk)
        Xs = Xk * sw[:, :, None]
        return (torch.bmm(Xs.transpose(1, 2), Xs),
                torch.bmm(Xs.transpose(1, 2), (yk * sw)[:, :, None]))
    got = shards.map(moments, Xc, yc, w_s)
    gram = shards.sum([g[0] for g in got]) / wsum[:, None, None]
    eps = 1e-6 * (torch.diagonal(gram, dim1=1, dim2=2).sum(1) / d + 1.0)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    gram = gram + (l2 + eps)[:, None, None] * eye
    rhs = shards.sum([g[1] for g in got]) / wsum[:, None, None]
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

    def fit_arrays(self, X, y, w, ctx,
                   init_params: Optional[Dict] = None
                   ) -> LinearRegressionModel:
        alpha = float(self.elastic_net_param)
        reg = float(self.reg_param)
        if alpha > 0.0:
            warm = resolve_init_params(self, init_params,
                                       {"beta": (X.shape[1],)}, X.device)
            p = fit_linreg_enet(X, y, w, reg * alpha, reg * (1.0 - alpha),
                                init_params=warm)
        else:
            # the closed-form ridge solve is exact: a warm start has
            # nothing to continue from, so init_params is accepted and
            # ignored, as in the JAX package
            p = fit_linreg(X, y, w, reg)
        return LinearRegressionModel(p["beta"][0].cpu().numpy(),
                                     float(p["intercept"][0]))
