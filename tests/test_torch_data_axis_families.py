"""The linear SVC, GLM, naive Bayes and MLP sweeps on a mesh's data axis
(`parallel/sweep.py`'s handlers over a `RowSplit`; the fits of
`models/linear_svc.py`, `glm.py`, `naive_bayes.py`, `mlp.py` given one),
on the CPU.

For each family, at 256 and 301 rows (301 leaves the two shards uneven),
the port's sweep on a (1, 2) CPU mesh is held to:
- the port's unsharded sweep: fold metrics within rtol 2e-4 and the same
  winner (the JAX package's sharded-vs-unsharded bound,
  tests/test_multichip.py:31-52);
- the JAX package's sweep on `make_mesh(2, sweep=1)` (the conftest's
  virtual CPU devices): the same bound. The MLP starts from the JAX
  package's initial weights (F3, `injected_mlp_init`).

F27's rule (a metric moved past the bound by a near tie, where the JAX
package's own (1, 2) sweep moves past it too) is not needed on these
fixtures: every family stays within rtol 2e-4 of both.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_data_axis import FOLDS, data_mesh  # noqa: E402
from test_torch_families import jax_mlp_init  # noqa: E402

RTOL = 2e-4  # tests/test_multichip.py:52

FAMILIES = {
    "OpLinearSVC": ("binary", dict(max_iter=30),
                    [{"reg_param": r} for r in (0.01, 0.1)]),
    "OpGeneralizedLinearRegression": (
        "regression", dict(max_iter=30),
        [{"reg_param": 0.01},
         {"family": "poisson", "link": "log", "reg_param": 0.1}]),
    "OpNaiveBayes": ("counts", {}, [{"smoothing": s} for s in (1.0, 0.5)]),
    "OpMultilayerPerceptronClassifier": (
        "binary", dict(hidden_layers=(5,), max_iter=40),
        [{"learning_rate": lr} for lr in (0.05, 0.01)]),
}


def problem(kind, n, seed=7):
    """(X, y, folds, evaluator name) of a small fixture: binary labels, a
    positive regression target (Poisson's domain), or non-negative count
    features (naive Bayes)."""
    from transmogrifai_tpu_torch.selector.validators import (
        OpCrossValidation)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    logit = 1.2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    if kind == "regression":
        y = np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1]).astype(np.float32)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
            np.float32)
    if kind == "counts":
        X = rng.poisson(np.exp(0.3 * X)).astype(np.float32)
    folds = OpCrossValidation(FOLDS, seed=42).splits(y)
    ev = ("RegressionEvaluator" if kind == "regression"
          else "BinaryClassificationEvaluator")
    return X, y, folds, ev


def port_sweep(fam, n, mesh):
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch import evaluators as pev
    from transmogrifai_tpu_torch.models import mlp as pm
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext
    kind, params, grids = FAMILIES[fam]
    X, y, folds, ev = problem(kind, n)
    ctx = FitContext(n_rows=n, seed=42, device="cpu", mesh=mesh)
    with pm.injected_mlp_init(jax_mlp_init):
        return np.array(run_sweep(getattr(port, fam)(**params), grids,
                                  torch.from_numpy(X), torch.from_numpy(y),
                                  folds, getattr(pev, ev)(), ctx))


def jax_sweep(fam, n):
    from transmogrifai_tpu import evaluators as jev
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu.parallel.mesh import make_mesh
    from transmogrifai_tpu.parallel.sweep import run_sweep
    from transmogrifai_tpu.stages.base import FitContext
    kind, params, grids = FAMILIES[fam]
    X, y, folds, ev = problem(kind, n)
    return np.array(run_sweep(getattr(jm, fam)(**params), grids, X, y, folds,
                              getattr(jev, ev)(),
                              FitContext(n_rows=n, seed=42,
                                         mesh=make_mesh(2, sweep=1))))


def winner(fam, m):
    larger = FAMILIES[fam][0] != "regression"  # AuPR up, RMSE down
    means = m.mean(1)
    return int(np.argmax(means) if larger else np.argmin(means))


@pytest.mark.parametrize("n", [256, 301])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_family_on_a_data_axis_matches_one_device_and_the_jax_data_axis(
        fam, n):
    plain = port_sweep(fam, n, None)
    sharded = port_sweep(fam, n, data_mesh(2))
    want = jax_sweep(fam, n)
    assert sharded.shape == plain.shape == want.shape == (2, FOLDS)
    assert np.isfinite(sharded).all()
    np.testing.assert_allclose(sharded, plain, rtol=RTOL, atol=0)
    np.testing.assert_allclose(sharded, want, rtol=RTOL, atol=0)
    assert winner(fam, sharded) == winner(fam, plain) == winner(fam, want)


# --------------------------------------------------------------------------- #
# readings: the families runs' moves on a (1, 2) mesh, in both packages       #
# --------------------------------------------------------------------------- #

def run_moves(name, run):
    """{family: largest fold-metric move (relative for RMSE)} of the
    families run `run` (`chip_smoke.family_models`) trained by package
    `name` on a (1, 2) mesh against the same train on one device, one
    family of the data axis at a time (the JAX package on the virtual CPU
    devices, with its own MLP draws; the port on the CPU)."""
    from test_torch_families import family_models, run_dataset, run_pipeline
    from test_torch_multiclass import package
    ns = package(name)
    if name == "jax":
        from transmogrifai_tpu.parallel.mesh import make_mesh
        mesh, kw = make_mesh(2, sweep=1), {}
    else:
        from transmogrifai_tpu_torch.parallel.mesh import make_mesh
        mesh, kw = make_mesh(2, sweep=1, device="cpu"), {"device": "cpu"}
    out = {}
    for est, grids in family_models(ns, run):
        fam = type(est).__name__
        if fam not in FAMILIES:
            continue
        got = []
        for m in (None, mesh):
            label, pred = run_pipeline(ns, run, [(est, grids)])
            model = ns.Workflow().set_result_features(pred, label) \
                .set_input_dataset(run_dataset(ns, run)).train(mesh=m, **kw)
            summ = next(s for s in model.fitted.values() if hasattr(
                getattr(s, "summary", None), "validation_results")).summary
            got.append(np.array([r.fold_metrics
                                 for r in summ.validation_results]))
        move = np.abs(got[1] - got[0])
        if run == "boston":
            move = move / np.abs(got[0])
        out[fam] = float(move.max())
    return out


def readings() -> None:
    """Print each families run's (1, 2) move per data-axis family in both
    packages: the JAX package's own move beside the port's (F28; phase 30
    (g) of `chip_smoke.py` reads the port's on the card beside
    `family_tolerances`). Several minutes on the CPU."""
    import json
    for run in ("binary", "iris", "boston"):
        print(json.dumps({"run": run, "jax": run_moves("jax", run),
                          "port": run_moves("port", run)}), flush=True)


if __name__ == "__main__":
    import os as _os
    _os.environ.setdefault("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, _os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
    if sys.argv[1:] == ["readings"]:
        readings()
