"""Multilayer perceptron classifier (sigmoid hidden layers, softmax output,
full-batch Adam) — the port's counterpart of the JAX package's
`models/mlp.py`.

Plain torch, batched over a leading pair axis P of (config, fold) pairs
with a per-pair learning rate: every layer is a batched product in exact
f32, the gradient comes from `torch.autograd`, and `max_iter` steps of
Adam run with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, the update
m̂/(√v̂ + eps)).

The initial weights W ~ N(0, 1)/√fan_in (biases 0) are drawn from a
`torch.Generator` seeded with the fit's seed and shared by every pair, as
the JAX package shares one PRNGKey(seed); its threefry draws cannot be
reproduced, so fits match it at the metric level, or exactly when its
draws are injected (`init=` / `injected_mlp_init`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, infer_n_classes, per_pair)
from transmogrifai_tpu_torch.models.logistic import (
    _weight_sums, logreg_pred_from_logits)
from transmogrifai_tpu_torch.parallel.rowshards import rows_of

_INJECTED_INIT: List[Any] = []


@contextlib.contextmanager
def injected_mlp_init(init):
    """Test hook: inside the block every `fit_mlp` call that is given no
    `init` takes these initial weights instead of its own draws — a list
    of W arrays, one per layer, or a function of (seed, layers) returning
    one (e.g. the JAX package's threefry draws)."""
    _INJECTED_INIT.append(init)
    try:
        yield
    finally:
        _INJECTED_INIT.pop()


def init_weights(layers: Tuple[int, ...], seed: int,
                 device="cpu") -> List[torch.Tensor]:
    """One W (fan_in, fan_out) per layer, N(0, 1)/√fan_in, drawn in layer
    order from a `torch.Generator` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.randn((a, b), generator=gen, device=device,
                        dtype=torch.float32) / float(np.sqrt(a))
            for a, b in zip(layers[:-1], layers[1:])]


def _forward(params: List[Dict[str, torch.Tensor]],
             X: torch.Tensor) -> torch.Tensor:
    """Logits (P, n, k) of params [{"W": (P, a, b), "b": (P, b)}, ...]
    (or unbatched (a, b) / (b,) for one model)."""
    h = X
    for layer in params[:-1]:
        # bf16 weights (the quantized mode) widen to f32 exactly
        h = torch.sigmoid(torch.matmul(h, layer["W"].float())
                          + layer["b"].unsqueeze(-2))
    last = params[-1]
    return torch.matmul(h, last["W"].float()) + last["b"].unsqueeze(-2)


def fit_mlp(X, y: torch.Tensor, w: torch.Tensor,
            layers: Tuple[int, ...], max_iter: int = 200,
            learning_rate: Param = 0.05, seed: int = 0, init=None
            ) -> List[Dict[str, torch.Tensor]]:
    """P fits at once over one matrix X (n, d): labels y (n,), row weights
    w (P, n) (or (n,)), learning rate one value or one per pair. Returns
    one {"W": (P, a, b), "b": (P, b)} per layer.

    The JAX package's `fit_mlp`: the weighted softmax cross-entropy /
    max(Σw, 1) minimized by `max_iter` full-batch Adam steps from the
    initial weights (`init`, injected ones, or `init_weights(layers,
    seed)`), the same for every pair.

    Over a `parallel.rowshards.RowSplit` X, y and w stay whole on the
    lead: Σw is a sum of
    the shards' partials; each step, the parameters go out to the shards
    once, each shard's partial loss is differentiated on its own device,
    and the gradients are added on the lead in shard order, where Adam
    steps."""
    w = w[None, :] if w.dim() == 1 else w
    shards, X, y_s, w_s = rows_of(X, y, w)
    P, dev = w.shape[0], shards.lead
    if init is None and _INJECTED_INIT:
        init = _INJECTED_INIT[-1]
        if callable(init):
            init = init(int(seed), tuple(layers))
    if init is None:
        Ws = init_weights(tuple(layers), seed, dev)
    else:
        Ws = [torch.as_tensor(np.array(W, dtype=np.float32)
                              if not isinstance(W, torch.Tensor) else W,
                              dtype=torch.float32).to(dev) for W in init]
        shapes = [tuple(W.shape) for W in Ws]
        if shapes != list(zip(layers[:-1], layers[1:])):
            raise ValueError(f"fit_mlp: initial weights {shapes} do not "
                             f"match layers {tuple(layers)}")
    params = []
    for W in Ws:
        params.append(W[None].expand(P, *W.shape).clone())
        params.append(torch.zeros((P, W.shape[1]), dtype=torch.float32,
                                  device=dev))
    lr = per_pair(learning_rate, P, dev)
    wsum = torch.clamp(_weight_sums(shards, w_s), min=1.0)
    parts = shards.map(lambda Xk, yk, wk, ws: (
        Xk, torch.nn.functional.one_hot(yk.long(), layers[-1]).to(
            torch.float32), wk / ws[:, None]),
        X, y_s, w_s, shards.broadcast(wsum))

    def partial(ps, Xk, Y, wn):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in ps]
            logits = _forward([{"W": leaves[i], "b": leaves[i + 1]}
                               for i in range(0, len(leaves), 2)], Xk)
            ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
            return torch.autograd.grad((ll * wn).sum(), leaves)

    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    one = torch.ones((), dtype=torch.float32, device=dev)
    for t in range(1, max_iter + 1):
        sent = zip(*(shards.broadcast(p) for p in params))
        got = shards.map(lambda ps, part: partial(ps, *part), list(sent),
                         parts)
        grads = [shards.sum([g[i] for g in got]) for i in range(len(params))]
        bc1 = one - (b1 * one) ** t
        bc2 = one - (b2 * one) ** t
        for i, g in enumerate(grads):
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * g ** 2 + b2 * nu[i]
            step = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + eps)
            lr_i = lr.reshape((P,) + (1,) * (step.dim() - 1))
            params[i] = params[i] + (-lr_i * step)
    return [{"W": params[i], "b": params[i + 1]}
            for i in range(0, len(params), 2)]


class MLPHead(torch.nn.Module):
    """Fitted layers as buffers W0, b0, W1, b1, ..."""

    def __init__(self, weights: Sequence[Dict[str, np.ndarray]]):
        super().__init__()
        self.n_layers = len(weights)
        for i, layer in enumerate(weights):
            self.register_buffer(f"W{i}", torch.as_tensor(
                layer["W"], dtype=torch.float32))
            self.register_buffer(f"b{i}", torch.as_tensor(
                layer["b"], dtype=torch.float32))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return _forward([{"W": getattr(self, f"W{i}"),
                          "b": getattr(self, f"b{i}")}
                         for i in range(self.n_layers)], X)


def predict_mlp(head: MLPHead, X: torch.Tensor) -> Dict[str, torch.Tensor]:
    return logreg_pred_from_logits(head(X))


class MLPModel(PredictionModel):
    def __init__(self, weights=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.weights = [
            {"W": np.asarray(layer["W"], dtype=np.float32),
             "b": np.asarray(layer["b"], dtype=np.float32)}
            for layer in weights]

    def get_params(self):
        return {"weights": [{"W": layer["W"].tolist(),
                             "b": layer["b"].tolist()}
                            for layer in self.weights]}

    def device_constants(self, device):
        return MLPHead(self.weights).to(device)

    def narrow_device_constants(self, consts: MLPHead) -> MLPHead:
        for i in range(consts.n_layers):
            setattr(consts, f"W{i}",
                    getattr(consts, f"W{i}").to(torch.bfloat16))
        return consts

    def predict(self, consts, X):
        return predict_mlp(consts, X)


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    """Spark MLP's parameter surface (the JAX package's
    `OpMultilayerPerceptronClassifier`): `hidden_layers` e.g. (10, 10); the
    input and output widths come from the data."""

    def __init__(self, hidden_layers: Sequence[int] = (10,),
                 max_iter: int = 200, learning_rate: float = 0.05,
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(uid=uid, hidden_layers=list(hidden_layers),
                         max_iter=max_iter, learning_rate=learning_rate,
                         n_classes=n_classes)
        self.hidden_layers = tuple(hidden_layers)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.n_classes = n_classes

    def fit_arrays(self, X, y, w, ctx) -> MLPModel:
        k = self.n_classes or infer_n_classes(y.cpu().numpy())
        layers = (int(X.shape[1]),) + self.hidden_layers + (k,)
        params = fit_mlp(X, y, w, layers, self.max_iter,
                         float(self.learning_rate),
                         ctx.seed if ctx is not None else 0)
        return MLPModel([{"W": layer["W"][0].cpu().numpy(),
                          "b": layer["b"][0].cpu().numpy()}
                         for layer in params])
