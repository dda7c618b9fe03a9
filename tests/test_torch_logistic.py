"""The port's elastic-net logistic regression against the JAX package's,
on the CPU.

Seeded numpy inputs at a small size: n = 300 rows, d = 40 features, 2
classes, P = 4 (config, fold) pairs fitted at once against the JAX
package's one-pair fits.

Tolerances: both run the same f32 FISTA steps, but their products sum in
different orders (torch's CPU matmul against XLA's dot), so
- the power-iteration Lipschitz estimate: rtol 1e-5;
- fitted weights W: atol 1e-4 · max|W|; bias b: atol 1e-4; the zero
  pattern of the L1 prox equal;
- probabilities of the fitted model: atol 1e-5; sweep AuPR: atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.models import logistic as jl
from transmogrifai_tpu_torch.models import logistic as pl

N, D, P = 300, 40, 4
L1 = [0.0001, 0.001, 0.05, 0.1]
L2 = [0.0009, 0.009, 0.05, 0.1]


def _data(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[:, 7] = X[:, 2]  # collinear columns
    y = ((X[:, 0] - X[:, 3] + rng.normal(size=N)) > 0).astype(np.float32)
    W = (rng.random((P, N)) < 0.7).astype(np.float32)
    return X, y, W


def test_power_lipschitz_matches_jax():
    X, _, W = _data(0)
    wsum = torch.clamp(torch.from_numpy(W).sum(1), min=1.0)
    got = pl._power_lipschitz(torch.from_numpy(X), torch.from_numpy(W), wsum)
    for p in range(P):
        want = jl._power_lipschitz(jnp.asarray(X), jnp.asarray(W[p]),
                                   jnp.maximum(jnp.asarray(W[p]).sum(), 1.0))
        np.testing.assert_allclose(float(got[p]), float(want), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_logreg_enet_matches_jax(seed):
    X, y, W = _data(seed)
    got = pl.fit_logreg_enet(torch.from_numpy(X), torch.from_numpy(y),
                             torch.from_numpy(W), L1, L2, 2, 200)
    assert got["W"].shape == (P, D, 2) and got["b"].shape == (P, 2)
    for p in range(P):
        want = jl.fit_logreg_enet(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(W[p]), jnp.float32(L1[p]),
                                  jnp.float32(L2[p]), 2, 200)
        wW = np.asarray(want["W"])
        gW = got["W"][p].numpy()
        np.testing.assert_allclose(gW, wW, rtol=0,
                                   atol=1e-4 * np.abs(wW).max())
        np.testing.assert_allclose(got["b"][p].numpy(),
                                   np.asarray(want["b"]), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(gW == 0, wW == 0)


def test_fista_momenta_are_the_f32_sequence():
    t = jnp.float32(1.0)
    want = []
    for _ in range(30):
        t1 = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        want.append(float((t - 1.0) / t1))
        t = t1
    np.testing.assert_array_equal(pl._fista_momenta(30),
                                  np.asarray(want, np.float32))


def test_estimator_matches_jax_and_serializes_alike():
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y, _ = _data(3)
    kw = dict(reg_param=0.01, elastic_net_param=0.5, max_iter=50)
    assert pl.enet_iters(50) == jl.enet_iters(50) == 200
    assert pl.enet_iters(80) == jl.enet_iters(80)
    jm = jl.OpLogisticRegression(**kw).fit_arrays(
        jnp.asarray(X), jnp.asarray(y), jnp.ones(N, jnp.float32), None)
    pm = pl.OpLogisticRegression(**kw).fit_arrays(
        torch.from_numpy(X), torch.from_numpy(y), torch.ones(N),
        FitContext(n_rows=N, device="cpu"))
    np.testing.assert_allclose(pm.W, jm.W, rtol=0,
                               atol=1e-4 * np.abs(jm.W).max())
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=0,
                               atol=1e-5)
    assert pm.get_params().keys() == jm.get_params().keys()
    assert pl.OpLogisticRegression(**kw).params == \
        jl.OpLogisticRegression(**kw).params


def test_l2_only_logistic_raises_and_names_the_roadmap():
    """The L-BFGS fit of α = 0 and its warm start are ported: warm
    weights of the wrong shape raise before the fit with the JAX
    package's message (`resolve_init_params`)."""
    X, y = torch.zeros((4, 2)), torch.tensor([0., 1., 0., 1.])
    est = pl.OpLogisticRegression(reg_param=0.1)
    est.init_params = {"W": [[0.0, 0.0]] * 3, "b": [0.0, 0.0]}
    with pytest.raises(ValueError, match="does not match the data") as got:
        est.fit_arrays(X, y, torch.ones(4), None)
    jest = jl.OpLogisticRegression(reg_param=0.1)
    jest.init_params = est.init_params
    with pytest.raises(ValueError) as want:
        jest.fit_arrays(jnp.zeros((4, 2)), jnp.asarray(y.numpy()),
                        jnp.ones(4), None)
    assert str(got.value) == str(want.value)


def test_logistic_sweep_matches_jax():
    """The LR family's sweep over 4 configs × 3 folds (one FISTA fit of 12
    pairs) against the JAX package's `run_sweep`."""
    from transmogrifai_tpu.evaluators import BinaryClassificationEvaluator \
        as JaxEval
    from transmogrifai_tpu.parallel.sweep import run_sweep as jax_sweep
    from transmogrifai_tpu.selector.validators import OpCrossValidation
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator)
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y, _ = _data(5)
    folds = OpCrossValidation(n_folds=3, seed=42).splits(y.astype(np.float64))
    grids = [{"reg_param": r, "elastic_net_param": a}
             for a in (0.1, 0.5) for r in (0.001, 0.1)]
    want = jax_sweep(jl.OpLogisticRegression(max_iter=50), grids,
                     jnp.asarray(X), jnp.asarray(y), folds, JaxEval(),
                     JaxCtx(n_rows=N, seed=1))
    got = run_sweep(pl.OpLogisticRegression(max_iter=50), grids,
                    torch.from_numpy(X), torch.from_numpy(y), folds,
                    BinaryClassificationEvaluator(),
                    FitContext(n_rows=N, seed=1, device="cpu"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-5)
