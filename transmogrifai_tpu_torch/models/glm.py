"""Generalized linear models (gaussian / binomial / poisson / gamma /
tweedie) over Spark GLR's family × link table — the port's counterpart of
the JAX package's `models/glm.py`.

The fit minimizes the weighted negative log-likelihood plus l2/2·‖β‖² by
L-BFGS (`models/lbfgs.py`), P fits at once over a leading pair axis; the
gradient comes from `torch.autograd` through the same link and
likelihood expressions (with their clamps) as the JAX package
differentiates. Plain torch in exact f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch.models import lbfgs
from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, per_pair,
    resolve_init_params,
    regression_pred)
from transmogrifai_tpu_torch.models.linear import (
    RegressionHead, narrow_head)
from transmogrifai_tpu_torch.models.logistic import _weight_sums
from transmogrifai_tpu_torch.parallel.rowshards import rows_of

FAMILIES = ("gaussian", "binomial", "poisson", "gamma", "tweedie")
# Spark GLR's family → valid links (the first is the canonical default);
# tweedie takes the power link 1 − var_power
VALID_LINKS = {
    "gaussian": ("identity", "log", "inverse"),
    "binomial": ("logit", "probit", "cloglog"),
    "poisson": ("log", "identity", "sqrt"),
    "gamma": ("inverse", "identity", "log"),
    "tweedie": ("power",),
}
_EPS = 1e-8

# the links of models saved without a "link" key (the JAX package's
# earlier builds hard-coded one per family)
_LEGACY_LINKS = {"gaussian": "identity", "binomial": "logit",
                 "poisson": "log", "gamma": "log", "tweedie": "log"}


def _neg_log_likelihood(family: str, mu, y, var_power: float = 1.5):
    if family == "gaussian":
        return 0.5 * (y - mu) ** 2
    if family == "binomial":
        mu = torch.clamp(mu, _EPS, 1 - _EPS)
        return -(y * torch.log(mu) + (1 - y) * torch.log(1 - mu))
    if family == "poisson":
        mu = torch.clamp(mu, min=_EPS)
        return mu - y * torch.log(mu)
    if family == "gamma":
        mu = torch.clamp(mu, min=_EPS)
        return y / mu + torch.log(mu)
    if family == "tweedie":
        mu = torch.clamp(mu, min=_EPS)
        p = var_power
        return -(y * mu ** (1 - p) / (1 - p) - mu ** (2 - p) / (2 - p))
    raise ValueError(f"Unknown family {family!r}")


def canonical_link(family: str) -> str:
    return VALID_LINKS[family][0]


def _inverse_link(family: str, eta, link: Optional[str] = None,
                  var_power: float = 1.5):
    """mu = g⁻¹(eta) for every Spark GLR link; a non-canonical link clamps
    eta into its domain, as the JAX package does."""
    link = link or canonical_link(family)
    if link == "identity":
        return eta
    if link == "log":
        return torch.exp(eta)
    if link == "inverse":
        tiny = torch.where(eta < 0, torch.full_like(eta, -_EPS),
                           torch.full_like(eta, _EPS))
        return 1.0 / torch.where(torch.abs(eta) < _EPS, tiny, eta)
    if link == "logit":
        return torch.sigmoid(eta)
    if link == "probit":
        return torch.clamp(torch.special.ndtr(eta), _EPS, 1 - _EPS)
    if link == "cloglog":
        return torch.clamp(-torch.expm1(-torch.exp(eta)), _EPS, 1 - _EPS)
    if link == "sqrt":
        return eta ** 2
    if link == "power":  # tweedie: link power 1 − var_power
        lp = 1.0 - var_power
        if abs(lp) < 1e-12:
            return torch.exp(eta)
        return torch.clamp(eta, min=_EPS) ** (1.0 / lp)
    raise ValueError(f"Unknown link {link!r}")


def _link_fwd(family: str, mu, link: Optional[str] = None,
              var_power: float = 1.5):
    """eta = g(mu): the intercept starts at g(weighted mean of y), inside
    the link's domain, as in the JAX package."""
    link = link or canonical_link(family)
    if link == "identity":
        return mu
    if link == "log":
        return torch.log(torch.clamp(mu, min=_EPS))
    if link == "inverse":
        return 1.0 / torch.clamp(mu, min=_EPS)
    if link == "logit":
        mu = torch.clamp(mu, _EPS, 1 - _EPS)
        return torch.log(mu / (1 - mu))
    if link == "probit":
        return torch.special.ndtri(torch.clamp(mu, _EPS, 1 - _EPS))
    if link == "cloglog":
        mu = torch.clamp(mu, _EPS, 1 - _EPS)
        return torch.log(-torch.log1p(-mu))
    if link == "sqrt":
        return torch.sqrt(torch.clamp(mu, min=0.0))
    if link == "power":
        lp = 1.0 - var_power
        if abs(lp) < 1e-12:
            return torch.log(torch.clamp(mu, min=_EPS))
        return torch.clamp(mu, min=_EPS) ** lp
    raise ValueError(f"Unknown link {link!r}")


def fit_glm(X, y: torch.Tensor, w: torch.Tensor, l2: Param,
            family: str = "gaussian", max_iter: int = 100,
            var_power: float = 1.5, link: Optional[str] = None,
            init_params: Optional[Dict[str, torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """P fits at once over one matrix X (n, d): labels y (n,), row weights
    w (P, n) (or (n,)), l2 one value or one per pair. Returns {"beta": (P,
    d), "b": (P,)}.

    The JAX package's `fit_glm`: β starts at zero and b at g(Σw·y /
    max(Σw, 1)); `max_iter` L-BFGS steps minimize Σ w·nll(g⁻¹(Xβ + b), y) /
    max(Σw, 1) + l2/2·‖β‖². `init_params` {"beta": (d,), "b": ()} starts
    every pair there instead (a warm start: the weights already sit in
    the link's domain).

    Over a `parallel.rowshards.RowSplit` X, y and w stay whole on the
    lead: Σw and Σw·y are
    sums of the shards' partials, taken before the first step; each
    shard's partial loss is differentiated on its own device with the
    parameters sent there, the lead's shard carrying the penalty, and the
    values and gradients are added on the lead in shard order, where
    L-BFGS steps."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    dev = shards.lead
    P, d = w.shape[0], X[0].shape[1]
    l2 = per_pair(l2, P, dev)
    wsum = torch.clamp(_weight_sums(shards, w_s), min=1.0)
    wy = shards.sum(shards.map(lambda yk, wk: (yk[None, :] * wk).sum(1),
                               y_s, w_s))
    b0 = _link_fwd(family, wy / wsum, link, var_power).to(torch.float32)

    def partial(x, Xk, yk, wk, ws, l2k, lead):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            eta = torch.matmul(x[:, :d], Xk.T) + x[:, d:]
            mu = _inverse_link(family, eta, link, var_power)
            nll = _neg_log_likelihood(family, mu, yk, var_power)
            value = (nll * wk).sum(1) / ws
            if lead:  # the penalty once, on the lead's shard
                value = value + 0.5 * l2k * (x[:, :d] ** 2).sum(1)
            grad, = torch.autograd.grad(value.sum(), x)
        return value.detach(), grad

    leads = [k == 0 for k in range(shards.n_shards)]

    def value_and_grad(x):
        got = shards.map(partial, shards.broadcast(x), X, y_s, w_s,
                         shards.broadcast(wsum), shards.broadcast(l2), leads)
        return (shards.sum([g[0] for g in got]),
                shards.sum([g[1] for g in got]))

    x0 = torch.zeros((P, d + 1), dtype=torch.float32, device=dev)
    if init_params is None:
        x0[:, d] = b0
    else:
        x0[:, :d] = init_params["beta"]
        x0[:, d] = init_params["b"].reshape(())
    x = lbfgs.minimize(value_and_grad, x0, max_iter)
    return {"beta": x[:, :d], "b": x[:, d]}


def glm_pred_from_eta(eta: torch.Tensor, family: str,
                      link: Optional[str] = None, var_power: float = 1.5
                      ) -> Dict[str, torch.Tensor]:
    """The Prediction dict of linear predictors eta (n,): mu as the
    prediction, eta as the one-column rawPrediction."""
    pred = regression_pred(_inverse_link(family, eta, link, var_power))
    pred["rawPrediction"] = eta[:, None]
    return pred


def predict_glm(head: RegressionHead, X: torch.Tensor, family: str,
                link: Optional[str] = None, var_power: float = 1.5
                ) -> Dict[str, torch.Tensor]:
    return glm_pred_from_eta(head(X), family, link, var_power)


class GLMModel(PredictionModel):
    def __init__(self, beta=None, b: float = 0.0, family: str = "gaussian",
                 link: Optional[str] = None, var_power: float = 1.5,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.beta = np.asarray(beta, dtype=np.float32)
        self.b = float(b)
        self.family = family
        # a manifest without a link predicts under its family's legacy link
        self.link = link or _LEGACY_LINKS[family]
        self.var_power = float(var_power)

    def get_params(self):
        return {"beta": self.beta.tolist(), "b": self.b,
                "family": self.family, "link": self.link,
                "var_power": self.var_power}

    def device_constants(self, device):
        return RegressionHead(self.beta, self.b).to(device)

    def narrow_device_constants(self, consts):
        return narrow_head(consts)

    def predict(self, consts, X):
        return predict_glm(consts, X, self.family, self.link, self.var_power)


class OpGeneralizedLinearRegression(PredictorEstimator):
    """family × link as in Spark GLR (the JAX package's
    `OpGeneralizedLinearRegression`); `link=None` means the family's
    canonical link. An invalid pair raises at construction."""

    def __init__(self, family: str = "gaussian", reg_param: float = 0.0,
                 max_iter: int = 100, var_power: float = 1.5,
                 link: Optional[str] = None, uid: Optional[str] = None):
        if family not in FAMILIES:
            raise ValueError(f"family must be one of {FAMILIES}")
        if link is not None and link not in VALID_LINKS[family]:
            raise ValueError(
                f"link {link!r} invalid for family {family!r}; "
                f"valid: {VALID_LINKS[family]}")
        super().__init__(uid=uid, family=family, reg_param=reg_param,
                         max_iter=max_iter, var_power=var_power, link=link)
        self.family = family
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.var_power = var_power
        self.link = link

    def fit_arrays(self, X, y, w, ctx,
                   init_params: Optional[Dict] = None) -> GLMModel:
        link = self.link or canonical_link(self.family)
        warm = resolve_init_params(self, init_params,
                                   {"beta": (X.shape[1],), "b": ()},
                                   X.device)
        p = fit_glm(X, y, w, float(self.reg_param), self.family,
                    self.max_iter, self.var_power, link, init_params=warm)
        return GLMModel(p["beta"][0].cpu().numpy(), float(p["b"][0]),
                        self.family, link, self.var_power)
