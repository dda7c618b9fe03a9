"""The sweep journal and resume: the port's `runtime/journal.py` against
the JAX package's, and a killed selector sweep resumed to the same bits.

Tolerances: exact everywhere. Journal records (`key_of`, grid,
`fold_metrics`, `best`) are compared equal between the packages,
timestamps and durations aside; a resumed sweep's metric matrix and
winner are bit-equal to an uninterrupted run's.

The helpers `binary_problem`, `small_models` and `selector_fit` are
shared with `test_torch_scheduler.py` and `test_torch_pod.py`.
"""

import json
import os

import numpy as np
import pytest

N, D = 240, 10


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread a test: the driver runs six test
    processes, and the scheduler's lanes and the pod's hosts add threads
    of their own, so default thread pools would oversubscribe the
    cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def binary_problem(seed: int = 0, n: int = N, d: int = D):
    """A seeded binary problem: (X f32 (n, d), y f64 in {0, 1})."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3] * 2)
    logit = 1.2 * X[:, 0] - X[:, 1] + 0.4 * X[:, 2] * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    return X, y


def small_models():
    """LR (2 static groups), RF (2 depth buckets) and XGB (1 group): 5
    blocks of 10 configs, small enough for the CPU."""
    from transmogrifai_tpu_torch import (
        OpLogisticRegression, OpRandomForestClassifier, OpXGBoostClassifier)
    lr = [{"reg_param": r, "elastic_net_param": a}
          for a in (0.0, 0.5) for r in (0.01, 0.1)]
    rf = [{"max_depth": dd, "min_instances_per_node": m}
          for dd in (3, 6) for m in (1.0, 10.0)]
    xgb = [{"min_child_weight": m} for m in (1.0, 10.0)]
    return [(OpLogisticRegression(max_iter=20), lr),
            (OpRandomForestClassifier(n_trees=5), rf),
            (OpXGBoostClassifier(n_estimators=12, max_depth=4, eta=0.3,
                                 early_stopping_rounds=4), xgb)]


def selector_cols(X, y):
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.data.columns import Column
    return [Column(PT.RealNN, {"value": y, "mask": np.ones(len(y), bool)}),
            Column(PT.OPVector, X)]


def selector_fit(X, y, checkpoint_dir=None, mesh=None, models=None,
                 cv_refit=None):
    """The port's binary selector (3 folds, AuPR) fitted on the CPU:
    (fitted model, its summary)."""
    from transmogrifai_tpu_torch import BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.stages.base import FitContext
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models=models or small_models(), checkpoint_dir=checkpoint_dir)
    sel.checkpoint_fsync = False
    ctx = FitContext(n_rows=len(y), seed=42, device="cpu", mesh=mesh,
                     cv_refit=cv_refit)
    model = sel.fit_model(selector_cols(X, y), ctx)
    return model, model.summary


def outcome(summary):
    """(configs, fold-metric matrix, winner) of a summary."""
    return ([(r.model, r.grid) for r in summary.validation_results],
            [list(r.fold_metrics) for r in summary.validation_results],
            (summary.best_model, summary.best_grid))


def _journal_classes(which):
    if which == "jax":
        from transmogrifai_tpu.runtime import journal
    else:
        from transmogrifai_tpu_torch.runtime import journal
    return journal.SweepJournal, journal.ShardedSweepJournal


APPENDS = [({"reg_param": 0.1, "elastic_net_param": 0.5},
            [0.7123456789012345, 0.1 + 0.2, 1e-300]),
           ({"max_depth": 6, "min_info_gain": 0.01},
            [float(np.float32(0.8375)), 0.5, 2.0 / 3.0]),
           ({"min_child_weight": 10.0}, [0.25, 0.5, 0.75])]


def _records(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    for r in recs[1:]:
        r.pop("duration_s", None)
    return recs


def test_same_appends_give_the_same_records_in_both_packages(tmp_path):
    """The same appends give the same header and records (`key_of`,
    grid, fold_metrics, best) in both packages, and each package loads
    the other's file to the same rows."""
    out = {}
    for which in ("jax", "port"):
        SJ, _ = _journal_classes(which)
        path = str(tmp_path / f"{which}.journal")
        j = SJ(path, meta={"sig": "abc"}, fsync=False)
        best = None
        for grid, row in APPENDS:
            if best is None or np.mean(row) > best["mean"]:
                best = {"mean": float(np.mean(row)), "grid": grid}
            j.append(grid, row, best=best, duration_s=0.5)
        out[which] = _records(path)
        assert SJ.key_of(APPENDS[0][0]) == out[which][1]["key"]
    assert out["jax"] == out["port"]
    for reader, writer in (("jax", "port"), ("port", "jax")):
        SJ, _ = _journal_classes(reader)
        j = SJ(str(tmp_path / f"{writer}.journal"), meta={"sig": "abc"})
        assert len(j) == len(APPENDS)
        for grid, row in APPENDS:
            assert j.lookup(grid) == row  # floats round-trip exactly
            assert j.duration_of(grid) == 0.5


@pytest.mark.parametrize("which", ["jax", "port"])
def test_torn_tail_is_truncated_and_appends_continue(tmp_path, which):
    SJ, _ = _journal_classes(which)
    path = str(tmp_path / "j.journal")
    j = SJ(path, meta={"sig": "s"}, fsync=False)
    for grid, row in APPENDS[:2]:
        j.append(grid, row)
    intact = os.path.getsize(path)
    with open(path, "a") as fh:
        fh.write('{"key": "torn", "fold_metr')  # a kill mid-append
    j2 = SJ(path, meta={"sig": "s"}, fsync=False)
    assert len(j2) == 2 and os.path.getsize(path) == intact
    j2.append(*APPENDS[2])
    j3 = SJ(path, meta={"sig": "s"})
    assert [j3.lookup(g) for g, _ in APPENDS] == [r for _, r in APPENDS]


def test_torn_tail_repair_matches_the_jax_package(tmp_path):
    """Both packages cut the same torn file to the same bytes."""
    raw = {}
    for which in ("jax", "port"):
        SJ, _ = _journal_classes(which)
        path = str(tmp_path / f"{which}.journal")
        j = SJ(path, meta={"sig": "s"}, fsync=False)
        j.append(*APPENDS[0])
        with open(path, "a") as fh:
            fh.write("garbage without a newline")
        SJ(path, meta={"sig": "s"})
        raw[which] = _records(path)
    assert raw["jax"] == raw["port"]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_meta_mismatch_rotates_the_journal_aside(tmp_path, which):
    SJ, _ = _journal_classes(which)
    path = str(tmp_path / "j.journal")
    j = SJ(path, meta={"sig": "old"}, fsync=False)
    j.append(*APPENDS[0])
    j2 = SJ(path, meta={"sig": "new"}, fsync=False)
    assert len(j2) == 0 and not os.path.exists(path)
    assert os.path.exists(path + ".stale")
    assert j2.lookup(APPENDS[0][0]) is None


def test_port_journal_shards_merge(tmp_path):
    """Per-worker shards (plain and host-qualified) merge on read, a
    pre-sharding single file at the base path merges read-only, a
    second reader sees every shard, and `refresh` picks up a shard that
    appeared later; the JAX package's sharded reader merges the port's
    shards to the same rows."""
    SJ, SSJ = _journal_classes("port")
    base = str(tmp_path / "fam.journal")
    SJ(base, meta={"sig": "m"}, fsync=False).append(*APPENDS[0])
    sj = SSJ(base, meta={"sig": "m"}, fsync=False)
    sj.shard(0).append(*APPENDS[1])
    sj.shard("h1_2").append(*APPENDS[2])
    assert len(sj) == 3
    assert os.path.exists(base + "-w0.jsonl")
    assert os.path.exists(base + "-wh1_2.jsonl")
    other = SSJ(base, meta={"sig": "m"})
    assert [other.lookup(g) for g, _ in APPENDS] == [r for _, r in APPENDS]
    late = SSJ(base, meta={"sig": "m"}, fsync=False)
    extra = ({"reg_param": 0.2}, [0.1, 0.2, 0.3])
    SJ(base + "-w7.jsonl", meta={"sig": "m"}, fsync=False).append(*extra)
    assert late.lookup(extra[0]) is None
    assert late.refresh() == 1 and late.lookup(extra[0]) == extra[1]
    _, JSSJ = _journal_classes("jax")
    jax_view = JSSJ(base, meta={"sig": "m"})
    assert sorted(map(str, jax_view.rows())) == sorted(map(str, late.rows()))
    with pytest.raises(ValueError):
        sj.shard("bad/id")


def _kill_plan(site, at):
    from transmogrifai_tpu_torch.runtime.faults import FaultPlan, FaultSpec
    return FaultPlan([FaultSpec(site, at=at, kind="kill")])


def test_kill_at_block_two_then_resume_is_bit_identical(tmp_path):
    """A selector killed at its second block resumes from the journal to
    the uninterrupted run's matrix and winner, bit for bit; the resumed
    run re-runs only the blocks not journaled, and its goodput report's
    savings section counts the skipped configs."""
    from transmogrifai_tpu_torch.obs.goodput import build_report
    from transmogrifai_tpu_torch.obs.trace import TRACER
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_RUN_BLOCK, FaultPlan, InjectedKill)
    X, y = binary_problem()
    _, want = selector_fit(X, y)
    ckpt = str(tmp_path / "ckpt")
    with _kill_plan(SITE_RUN_BLOCK, 2).active():
        with pytest.raises(InjectedKill):
            selector_fit(X, y, checkpoint_dir=ckpt)
    journals = [f for f in os.listdir(ckpt) if f.endswith(".journal")]
    assert len(journals) == 1  # the LR family, killed at its 2nd block
    with open(os.path.join(ckpt, journals[0])) as fh:
        assert len(fh.readlines()) == 1 + 2  # header + block 1's configs
    counter = FaultPlan([])
    with counter.active(), TRACER.span("resume", new_trace=True) as root:
        _, got = selector_fit(X, y, checkpoint_dir=ckpt)
    assert outcome(got) == outcome(want)
    # LR's second group, RF's two and XGB's one ran; LR's first did not
    assert counter.count(SITE_RUN_BLOCK) == 4
    report = build_report(root, TRACER.trace_spans(root.trace_id))
    assert report.counts["resumed_blocks"] == 2
    assert "resume_saved_s" in report.savings
    # the family checkpoints now hit: a third run runs no block
    again = FaultPlan([])
    with again.active():
        _, third = selector_fit(X, y, checkpoint_dir=ckpt)
    assert again.count(SITE_RUN_BLOCK) == 0
    assert outcome(third) == outcome(want)


def test_workflow_sweep_checkpoint_parameter_resumes(tmp_path):
    """OpParams' `sweep_checkpoint` goes to the workflow's selector: a
    train killed in its sweep and trained again with the same parameters
    gives the uninterrupted train's winner and matrix."""
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        Workflow, transmogrify)
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_RUN_BLOCK, InjectedKill)
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.workflow.params import OpParams
    X, y = binary_problem(1, n=200, d=4)
    ds = Dataset.from_rows(
        [{"label": float(t), **{f"x{j}": float(v[j]) for j in range(4)}}
         for v, t in zip(X, y)],
        {"label": PT.RealNN, **{f"x{j}": PT.Real for j in range(4)}})

    def train(params=None):
        preds, label = FeatureBuilder.from_dataset(ds, response="label")
        pred = BinaryClassificationModelSelector.with_cross_validation(
            models=small_models()[:1]).set_input(
                label, transmogrify(preds)).get_output()
        wf = Workflow().set_result_features(pred, label)
        if params is not None:
            wf.set_parameters(params)
        m = wf.set_input_dataset(ds).train(device="cpu")
        return outcome(next(s.summary for s in m.fitted.values()
                            if hasattr(s, "summary")))

    want = train()
    params = OpParams.from_json({"sweep_checkpoint": {
        "checkpoint_dir": str(tmp_path / "c"), "fsync": False}})
    with _kill_plan(SITE_RUN_BLOCK, 2).active():
        with pytest.raises(InjectedKill):
            train(params)
    assert train(params) == want


def test_device_oom_halves_the_block_and_records_the_redo():
    """A device OOM at a block runs its halves instead (the same bits:
    every family's fit is batching-invariant), and the wasted attempt
    lands in goodput's ``oom_redo_s`` bucket."""
    from transmogrifai_tpu_torch.obs.goodput import build_report
    from transmogrifai_tpu_torch.obs.trace import TRACER
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_RUN_BLOCK, FaultPlan, FaultSpec)
    X, y = binary_problem()
    _, want = selector_fit(X, y)
    plan = FaultPlan([FaultSpec(SITE_RUN_BLOCK, at=1, kind="oom")])
    with plan.active(), TRACER.span("oom", new_trace=True) as root:
        _, got = selector_fit(X, y)
    assert outcome(got) == outcome(want)
    assert plan.count(SITE_RUN_BLOCK) == 5 + 2  # block 1 again as 2 halves
    report = build_report(root, TRACER.trace_spans(root.trace_id))
    assert report.counts["oom_redos"] == 1
    assert report.counts["faults_injected"] == 1
    assert report.buckets["oom_redo_s"] > 0.0
