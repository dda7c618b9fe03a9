"""The work-stealing scheduler, K11's `_run_block` and the mesh: the
port's `parallel/scheduler.py`, `parallel/mesh.py` and the sharded sweep
on CPU lanes (a CPU mesh repeats the ``cpu`` device, as the JAX tests'
mesh is 8 virtual CPU devices).

Tolerances:
- bit-equal between the port's own scheduled, sharded and unscheduled
  runs, and between a family's whole block and the same configs split
  into halves or single configs (batching invariance: resume, steals,
  pod claims and OOM halving change which configs share one fit);
- against the JAX package's scheduler on `make_mesh(4, sweep=4)`, the
  families' fold metrics within test_torch_train's per-family
  tolerances: LR 1e-4, RF and XGB 1e-2 (f32 histograms, the JAX
  package's forest draws injected);
- exact for the scheduler's bookkeeping (blocks, requeues, retirements,
  the blocks a resume re-runs).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_journal import (  # noqa: E402
    binary_problem, one_intra_op_thread, outcome, selector_fit, small_models)

FOLDS = 3
FAMILY_ATOL = {"OpLogisticRegression": 1e-4,
               "OpRandomForestClassifier": 1e-2,
               "OpXGBoostClassifier": 1e-2}


def _port_inputs(seed=0):
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator)
    from transmogrifai_tpu_torch.selector.validators import (
        OpCrossValidation)
    from transmogrifai_tpu_torch.stages.base import FitContext
    X, y = binary_problem(seed)
    folds = OpCrossValidation(FOLDS, seed=42).splits(y)
    return (torch.from_numpy(X), torch.from_numpy(y.astype(np.float32)),
            folds, BinaryClassificationEvaluator(metric="AuPR"),
            FitContext(n_rows=len(y), seed=42, device="cpu"))


def _jobs(models=None, journals=None):
    from transmogrifai_tpu_torch.parallel.scheduler import SweepJob
    models = models or small_models()
    return [SweepJob(index=i, est=est, grids=grids, name=type(est).__name__,
                     journal=None if journals is None else journals[i])
            for i, (est, grids) in enumerate(models)]


def _unscheduled(models=None):
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    X, y, folds, ev, ctx = _port_inputs()
    return [run_sweep(est, grids, X, y, folds, ev, ctx)
            for est, grids in (models or small_models())]


def _cpu_mesh(n=4):
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n, device="cpu")


def test_grid_scheduler_on_four_cpu_lanes_equals_the_unscheduled_sweep():
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    X, y, folds, ev, ctx = _port_inputs()
    sched = GridScheduler(mesh=_cpu_mesh(4))
    got = sched.run(_jobs(), X, y, folds, ev, ctx)
    assert got == _unscheduled()
    rep = sched.report.to_json()
    assert (rep["n_workers"], rep["blocks"], rep["requeues"]) == (4, 5, 0)
    assert sum(w["blocks"] for w in rep["workers"]) == 5
    assert 0.0 < rep["utilization_frac"] <= 1.0


def test_port_scheduler_matches_the_jax_scheduler(monkeypatch):
    """The same families through the JAX package's `GridScheduler` on
    `make_mesh(4, sweep=4)` and the port's on 4 CPU lanes."""
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu.evaluators import BinaryClassificationEvaluator
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.parallel.mesh import make_mesh as jax_mesh
    from transmogrifai_tpu.parallel.scheduler import (
        GridScheduler as JaxScheduler, SweepJob as JaxJob)
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")
    X, y, folds, ev, ctx = _port_inputs()
    port_models = small_models()
    jax_models = [(getattr(jm, type(est).__name__)(
        **{k: v for k, v in est.params.items() if k != "uid"}), grids)
        for est, grids in port_models]
    jobs = [JaxJob(index=i, est=e, grids=g, name=type(e).__name__)
            for i, (e, g) in enumerate(jax_models)]
    want = JaxScheduler(mesh=jax_mesh(4, sweep=4)).run(
        jobs, X.numpy(), y.numpy(), folds,
        BinaryClassificationEvaluator(metric="AuPR"),
        JaxCtx(n_rows=len(y), seed=42))
    with pt.injected_forest_draws(jax_forest_draws):
        got = GridScheduler(mesh=_cpu_mesh(4)).run(
            _jobs(port_models), X, y, folds, ev, ctx)
    for (est, _), w, g in zip(port_models, want, got):
        np.testing.assert_allclose(np.array(g), np.array(w), rtol=0,
                                   atol=FAMILY_ATOL[type(est).__name__])


def test_steal_after_a_retired_worker():
    """A worker-level fault at a claim retires that lane; its block is
    requeued and stolen by a survivor, and the results stay the
    unscheduled sweep's."""
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_WORKER_BLOCK, FaultPlan, FaultSpec)
    X, y, folds, ev, ctx = _port_inputs()
    sched = GridScheduler(mesh=_cpu_mesh(4))
    with FaultPlan([FaultSpec(SITE_WORKER_BLOCK, at=1)]).active():
        got = sched.run(_jobs(), X, y, folds, ev, ctx)
    assert got == _unscheduled()
    rep = sched.report
    assert rep.requeues == 1 and rep.steals >= 1
    assert sum(w.retired is not None for w in rep.workers) == 1
    assert sum(w.blocks for w in rep.workers) == 5


def test_a_failing_family_is_dropped_and_the_others_kept():
    from transmogrifai_tpu_torch import OpNaiveBayes
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    X, y, folds, ev, ctx = _port_inputs()
    models = small_models()
    # naive Bayes refuses negative features, as Spark does
    models.insert(1, (OpNaiveBayes(), [{"smoothing": 1.0}]))
    got = GridScheduler(mesh=_cpu_mesh(3)).run(_jobs(models), X, y, folds,
                                               ev, ctx)
    assert isinstance(got[1], ValueError)
    assert [got[0], got[2], got[3]] == _unscheduled()


def test_scheduled_kill_and_resume_reruns_only_the_in_flight_block(
        tmp_path):
    """Four blocks on four lanes, killed as the fourth block is claimed:
    the other lanes drain and journal their blocks, the kill re-raises,
    and the resumed schedule runs exactly one block, to the unscheduled
    sweep's bits."""
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_RUN_BLOCK, SITE_WORKER_BLOCK, FaultPlan, FaultSpec,
        InjectedKill)
    from transmogrifai_tpu_torch.runtime.journal import ShardedSweepJournal
    X, y, folds, ev, ctx = _port_inputs()
    models = small_models()[:2]  # LR + RF: 4 blocks

    def journals():
        return [ShardedSweepJournal(str(tmp_path / f"j{i}.journal"),
                                    meta={"sig": str(i)}, fsync=False)
                for i in range(2)]

    with FaultPlan([FaultSpec(SITE_WORKER_BLOCK, at=4,
                              kind="kill")]).active():
        with pytest.raises(InjectedKill):
            GridScheduler(mesh=_cpu_mesh(4)).run(
                _jobs(models, journals()), X, y, folds, ev, ctx)
    assert sum(len(j) for j in journals()) == 8 - 2  # one 2-config block
    counter = FaultPlan([])
    with counter.active():
        got = GridScheduler(mesh=_cpu_mesh(4)).run(
            _jobs(models, journals()), X, y, folds, ev, ctx)
    assert counter.count(SITE_RUN_BLOCK) == 1
    assert got == _unscheduled(models)


def test_mesh_utilization_rollup_lands_in_goodput():
    from transmogrifai_tpu_torch.obs.goodput import build_report
    from transmogrifai_tpu_torch.obs.trace import TRACER
    from transmogrifai_tpu_torch.parallel.scheduler import GridScheduler
    X, y, folds, ev, ctx = _port_inputs()
    with TRACER.span("run", new_trace=True) as root:
        GridScheduler(mesh=_cpu_mesh(4)).run(_jobs(), X, y, folds, ev, ctx)
    spans = TRACER.trace_spans(root.trace_id)
    assert sum(s.name.startswith("sweep:worker:") for s in spans) == 4
    mesh = build_report(root, spans).to_json()["mesh"]
    assert (mesh["workers"], mesh["blocks"], mesh["schedules"]) == (4, 5, 1)
    assert 0.0 < mesh["utilization_frac"] <= 1.0
    assert set(mesh) == {"workers", "schedules", "steals", "requeues",
                         "blocks", "idle_s", "utilization_frac"}
    assert mesh["idle_s"] >= 0.0


def _fold_refit(X):
    """A workflow-CV refit: each feature's distance from the fold rows'
    mean, in their standard deviations (not monotone in the feature, so
    the folds' binned matrices differ)."""
    def refit(fold_rows):
        mu = X[fold_rows].mean(0)
        sd = X[fold_rows].std(0) + 1e-3
        return (np.abs(X - mu) / sd).astype(np.float32)
    return refit


def test_run_block_under_workflow_cv_equals_the_unsharded_sweep():
    """Workflow CV on a 3-lane mesh takes K11's `_run_block` (a group
    padded to a multiple of 3 by repeating its last config) and gives the
    unsharded sweep's bits."""
    X, y = binary_problem(2)
    want = selector_fit(X, y, cv_refit=_fold_refit(X))[1]
    got = selector_fit(X, y, cv_refit=_fold_refit(X), mesh=_cpu_mesh(3))[1]
    assert outcome(got) == outcome(want)
    assert any(k.endswith("@lane2") for k in got.timings["groups"])


def test_selector_on_a_mesh_equals_the_single_device_fit(monkeypatch):
    """A 4-lane mesh runs the scheduler, and with
    TRANSMOGRIFAI_DISTRIBUTED_SWEEP=0 K11's `_run_block`; both give the
    single-device winner and matrix bit for bit."""
    X, y = binary_problem(3)
    want = outcome(selector_fit(X, y)[1])
    sched = selector_fit(X, y, mesh=_cpu_mesh(4))[1]
    assert outcome(sched) == want
    assert sched.timings["families"]["scheduler"]["n_workers"] == 4
    monkeypatch.setenv("TRANSMOGRIFAI_DISTRIBUTED_SWEEP", "0")
    assert outcome(selector_fit(X, y, mesh=_cpu_mesh(4))[1]) == want


def _default_families():
    """Every family of the three default selectors, cut to CPU size."""
    from transmogrifai_tpu_torch.selector.model_selector import (
        _default_binary_models, _default_multiclass_models,
        _default_regression_models)
    out = []
    for problem, models in (("binary", _default_binary_models()),
                            ("multiclass", _default_multiclass_models()[:1]),
                            ("regression", _default_regression_models())):
        for est, grids in models:
            kw = {k: v for k, v in est.params.items() if k != "uid"}
            if "n_trees" in kw:
                kw["n_trees"] = 4
                grids = grids[:4] + grids[-2:]
            if "n_estimators" in kw:
                kw["n_estimators"] = 10
                kw["max_depth"] = min(kw.get("max_depth") or 5, 5)
            out.append((problem, type(est)(**kw), grids))
    return out


@pytest.mark.parametrize("case", range(7))
def test_sweeps_are_batching_invariant(case):
    """A family's whole grid, its halves and its single configs give
    every (config, fold) pair the same bits: the property a resume, a
    steal, a pod claim or an OOM halving leans on."""
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator, MultiClassificationEvaluator,
        RegressionEvaluator)
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.selector.validators import (
        OpCrossValidation)
    from transmogrifai_tpu_torch.stages.base import FitContext
    problem, est, grids = _default_families()[case]
    X, y = binary_problem(4, n=200)
    if problem == "multiclass":
        y = np.digitize(X[:, 0] + 0.3 * X[:, 1], [-0.5, 0.5]).astype(float)
    elif problem == "regression":
        y = np.round(4 * (X[:, 0] - 0.5 * X[:, 2])) / 4  # exact label sums
    ev = {"binary": BinaryClassificationEvaluator(metric="AuPR"),
          "multiclass": MultiClassificationEvaluator(metric="F1"),
          "regression": RegressionEvaluator(metric="RMSE")}[problem]
    folds = OpCrossValidation(FOLDS, seed=42).splits(y)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.float32))

    def run(gs):
        return run_sweep(est, gs, Xt, yt, folds, ev,
                         FitContext(n_rows=len(y), seed=42, device="cpu"))

    full = run(grids)
    half = len(grids) // 2
    assert run(grids[:half]) + run(grids[half:]) == full
    assert [run([g])[0] for g in grids] == full


def test_run_sweep_shardings_equal_the_unsharded_sweep():
    """`sweep_sharding` cuts a block into one slice per sweep lane (pad
    rows repeating the last config), `replicated` keeps it whole on the
    first lane, as the JAX package's `P(SWEEP_AXIS)` and `P()` do; both
    through K11's `_run_block` give the unsharded sweep's bits."""
    from transmogrifai_tpu_torch.parallel.mesh import (
        replicated, sweep_sharding)
    from transmogrifai_tpu_torch.parallel.sweep import _shard_dyn, run_sweep
    mesh = _cpu_mesh(3)
    sweep, rep = sweep_sharding(mesh), replicated(mesh)
    assert (sweep.n_shards, len(sweep.lanes)) == (3, 3)
    assert (rep.n_shards, rep.lanes) == (1, mesh.lanes()[:1])
    grids = [{"i": i} for i in range(4)]
    assert _shard_dyn(grids, sweep) == (
        [grids[0:2], grids[2:4], [grids[3]] * 2], 4)
    assert _shard_dyn(grids, rep) == ([grids], 4)
    want = _unscheduled()
    for sharding in (sweep, rep):
        X, y, folds, ev, ctx = _port_inputs()
        got = [run_sweep(est, grids, X, y, folds, ev, ctx, sharding=sharding)
               for est, grids in small_models()]
        assert got == want


def test_a_data_axis_wider_than_one_builds_and_trains():
    """A data axis wider than 1 builds (make_mesh, the multislice layout,
    MeshParams) and trains: the scheduler on a (2, 2) mesh gives each
    worker its (1, 2) row and equals K11 on a (1, 2) mesh bit for bit,
    and both select the unsharded sweep's winner."""
    from transmogrifai_tpu_torch.parallel.mesh import (
        make_mesh, make_multislice_mesh)
    from transmogrifai_tpu_torch.workflow.params import MeshParams
    grid = make_mesh(4, sweep=2, device="cpu")
    assert grid.shape == {"sweep": 2, "data": 2}
    assert [len(r) for r in grid.rows()] == [2, 2]
    assert make_multislice_mesh(2, devices_per_slice=2,
                                device="cpu").shape == {"sweep": 2,
                                                        "data": 2}
    assert MeshParams(n_devices=4, sweep=1).build("cpu").shape == {
        "sweep": 1, "data": 4}
    mesh = make_multislice_mesh(2, devices_per_slice=2, data_per_slice=1,
                                device="cpu")
    assert mesh.shape == {"sweep": 4, "data": 1}
    assert MeshParams(n_devices=3).build("cpu").shape == {"sweep": 3,
                                                           "data": 1}
    with pytest.raises(ValueError):
        make_mesh(4, sweep=3, device="cpu")
    from test_torch_journal import binary_problem
    X, y = binary_problem(0)
    plain = outcome(selector_fit(X, y)[1])
    row = outcome(selector_fit(X, y, mesh=make_mesh(2, sweep=1,
                                                    device="cpu"))[1])
    scheduled = outcome(selector_fit(X, y, mesh=grid)[1])
    assert scheduled == row
    assert row[2] == plain[2] and row[0] == plain[0]


@pytest.mark.parametrize("family", ["OpLinearSVC",
                                    "OpGeneralizedLinearRegression",
                                    "OpNaiveBayes",
                                    "OpMultilayerPerceptronClassifier"])
def test_families_fit_on_the_data_axis(family):
    """SVC, GLM, naive Bayes and the MLP fit on a (1, 2) mesh: each fit
    receives X split over the two row shards, and
    the sweep's fold metrics equal the unsharded sweep's within the JAX
    package's sharded-vs-unsharded rtol 2e-4 (tests/test_multichip.py:52;
    tests/test_torch_data_axis_families.py holds them to the JAX
    package)."""
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu_torch.parallel import sweep as sweep_mod
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    X, y, folds, ev, ctx = _port_inputs()
    want = np.array(run_sweep(getattr(port, family)(), [{}], X.abs(), y,
                              folds, ev, ctx))
    X, y, folds, ev, ctx = _port_inputs()
    ctx.mesh = make_mesh(2, sweep=1, device="cpu")
    fit = {"OpLinearSVC": "fit_linear_svc",
           "OpGeneralizedLinearRegression": "fit_glm",
           "OpNaiveBayes": "fit_naive_bayes",
           "OpMultilayerPerceptronClassifier": "fit_mlp"}[family]
    real, seen = getattr(sweep_mod, fit), []

    def spy(*a, **kw):
        seen.append(getattr(a[0], "shards", None))
        return real(*a, **kw)
    setattr(sweep_mod, fit, spy)
    try:
        got = np.array(run_sweep(getattr(port, family)(), [{}], X.abs(), y,
                                 folds, ev, ctx))
    finally:
        setattr(sweep_mod, fit, real)
    assert seen and all(s is not None and s.n_shards == 2 for s in seen)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0)


def test_workflow_cv_bins_each_fold_matrix_f26():
    """F26: under workflow CV each fold's refit matrix is binned anew (the
    binned-matrix cache keeps the matrix it binned), so every fold's tree
    metrics equal a sweep of that fold's matrix under a fresh context."""
    from test_torch_journal import selector_cols
    from transmogrifai_tpu_torch import BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext
    X, y = binary_problem(5)
    est, grids = small_models()[1]  # the forest
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models=[(est, grids)])
    refit = _fold_refit(X)
    ctx = FitContext(n_rows=len(y), seed=42, device="cpu", cv_refit=refit)
    got = [list(r.fold_metrics) for r in sel.fit_model(
        selector_cols(X, y), ctx).summary.validation_results]
    _, _, _, y_dev, train_idx, _, _, folds = sel.sweep_inputs(
        selector_cols(X, y), ctx)
    want = [run_sweep(est, grids, torch.from_numpy(
                refit(train_idx[tr > 0.5])[train_idx]), y_dev, [(tr, va)],
                sel.evaluator, FitContext(n_rows=len(y), seed=42,
                                          device="cpu"))
            for tr, va in folds]
    assert got == [[want[f][i][0] for f in range(len(folds))]
                   for i in range(len(grids))]
