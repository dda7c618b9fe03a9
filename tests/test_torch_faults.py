"""Fault injection and bounded retry: the port's `runtime/faults.py` and
`runtime/retry.py` against the JAX package's.

Tolerances: exact. The same `FaultPlan` fires on the same passes in both
packages, `RetryPolicy` sleeps the same delays for the same seed and
label and classifies errors the same way, a save killed mid-write leaves
the previous model loadable, and an ingest whose chunk reads fail
transiently retries to the fault-free bits.
"""

import numpy as np
import pytest
import torch


def _pkg(which):
    if which == "jax":
        from transmogrifai_tpu.runtime import faults, retry
    else:
        from transmogrifai_tpu_torch.runtime import faults, retry
    return faults, retry


def _drive(faults, specs, seed, passes):
    """Pass `passes` times through each site; what each pass did."""
    plan = faults.FaultPlan([faults.FaultSpec(**s) for s in specs],
                            seed=seed)
    seen = []
    with plan.active():
        for i in range(passes):
            for site in ("ingest.read_chunk", "sweep.run_block"):
                try:
                    faults.fault_point(site)
                    seen.append((site, i, "ok"))
                except faults.InjectedKill as e:
                    seen.append((site, i, "kill", e.n))
                except faults.InjectedFault as e:
                    seen.append((site, i, "oom" if e.oom else "error",
                                 e.transient, e.n))
    assert faults.active_plan() is None
    return seen, plan.fired, {s: plan.count(s) for s in
                              ("ingest.read_chunk", "sweep.run_block")}


PLANS = [
    [dict(site="sweep.run_block", at=2, kind="kill")],
    [dict(site="ingest.read_chunk", at=3, times=2, transient=True),
     dict(site="sweep.run_block", at=1, times=0, kind="oom", prob=0.4)],
    [dict(site="ingest.read_chunk", at=1, times=0, kind="error", prob=0.5),
     dict(site="ingest.read_chunk", at=2, kind="delay", delay_s=0.0)],
]


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_fault_plans_fire_on_the_same_passes(plan):
    """Exact pass counts, kinds, and the seeded `prob` draws."""
    got = {w: _drive(_pkg(w)[0], PLANS[plan], seed=7, passes=12)
           for w in ("jax", "port")}
    assert got["jax"] == got["port"]


def test_fault_spec_validation_and_site_names_match():
    jf, _ = _pkg("jax")
    pf, _ = _pkg("port")
    for name in jf.__all__:
        if name.startswith("SITE_"):
            assert getattr(pf, name) == getattr(jf, name)
    for bad in (dict(site="x", kind="melt"), dict(site="x", at=0)):
        with pytest.raises(ValueError):
            pf.FaultSpec(**bad)
    assert issubclass(pf.InjectedKill, BaseException)
    assert not issubclass(pf.InjectedKill, Exception)


def test_nested_plan_scope_keeps_the_outer_plan():
    pf, _ = _pkg("port")
    outer, inner = pf.FaultPlan(), pf.FaultPlan()
    with outer.active():
        pf.clear_plan(inner)  # not the installed plan: a no-op
        assert pf.active_plan() is outer
    assert pf.active_plan() is None


@pytest.mark.parametrize("seed,label", [(0, "retry"), (3, "ingest"),
                                        (11, "sweep.OpLogistic")])
def test_retry_delays_match_for_the_same_seed(seed, label):
    """The same failures give the same attempts, delays and outcome."""
    out = {}
    for which in ("jax", "port"):
        _, retry = _pkg(which)
        slept, events = [], []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 4:
                raise OSError(f"flaky {calls['n']}")
            return "done"

        pol = retry.RetryPolicy(max_attempts=5, base_delay_s=0.1,
                                max_delay_s=0.3, seed=seed,
                                sleep=slept.append,
                                hooks=(lambda e: events.append(
                                    (e.label, e.attempt, e.delay_s)),))
        out[which] = (pol.call(flaky, label=label), slept, events,
                      [pol.delay_for(a, __import__("random").Random(seed))
                       for a in range(1, 6)])
    assert out["jax"] == out["port"]
    assert out["port"][0] == "done" and len(out["port"][1]) == 3


def test_retry_classification_matches():
    """Transient by `classify`, by the error's own `transient` flag, by
    type; fatal errors raise on the first attempt; exhaustion re-raises
    the last error."""
    jf, jr = _pkg("jax")
    pf, pr = _pkg("port")
    cases = [OSError("x"), TimeoutError("t"), ValueError("v"),
             pf.InjectedFault("s", 1, transient=True),
             pf.InjectedFault("s", 1, transient=False),
             RuntimeError("remote")]
    classify = lambda e: True if "remote" in str(e) else None  # noqa: E731
    for kw in ({}, {"classify": classify}, {"transient_types": ()}):
        j = jr.RetryPolicy(**kw)
        p = pr.RetryPolicy(**kw)
        assert [j.is_transient(e) for e in cases] == \
            [p.is_transient(e) for e in cases]
    for which, (faults, retry) in (("jax", (jf, jr)), ("port", (pf, pr))):
        calls = {"n": 0}

        def fatal():
            calls["n"] += 1
            raise ValueError("deterministic")

        with pytest.raises(ValueError):
            retry.RetryPolicy(sleep=lambda s: None).call(fatal)
        assert calls["n"] == 1

        def always():
            calls["n"] += 1
            raise OSError(f"attempt {calls['n']}")

        calls["n"] = 0
        with pytest.raises(OSError, match="attempt 3"):
            retry.RetryPolicy(max_attempts=3,
                              sleep=lambda s: None).call(always)


def test_metrics_and_profile_hooks_record_each_retry():
    from transmogrifai_tpu_torch.obs.metrics import MetricsRegistry
    from transmogrifai_tpu_torch.runtime.retry import (
        RetryPolicy, metrics_hook, profile_hook)
    from transmogrifai_tpu_torch.utils.profiling import RunProfile
    reg, prof = MetricsRegistry(), RunProfile()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("slow")
        return calls["n"]

    pol = RetryPolicy(sleep=lambda s: None,
                      hooks=(metrics_hook(reg), profile_hook(prof)))
    assert pol.call(flaky, label="site") == 3
    assert reg.find("runtime_retry_attempts_total", site="site").value == 2
    assert [p.name for p in prof.phases] == ["retry:site"] * 2


def test_is_oom_error_recognizes_the_torch_and_cuda_ooms():
    pf, _ = _pkg("port")
    jf, _ = _pkg("jax")
    assert pf.is_oom_error(torch.cuda.OutOfMemoryError("Tried to allocate"))
    msgs = ["CUDA out of memory. Tried to allocate 2.00 GiB",
            "RESOURCE_EXHAUSTED: hbm", "CUDA error: out of memory",
            "index out of range", "illegal memory access"]
    assert [pf.is_oom_error(RuntimeError(m)) for m in msgs] == \
        [True, True, True, False, False]
    for m in msgs:  # the messages both packages know agree
        assert pf.is_oom_error(RuntimeError(m)) == \
            jf.is_oom_error(RuntimeError(m))
    assert pf.is_oom_error(pf.InjectedFault("s", 1, oom=True))


def _small_model():
    from transmogrifai_tpu_torch import (
        BinaryClassificationModelSelector, Dataset, FeatureBuilder,
        OpLogisticRegression, Workflow, transmogrify)
    from transmogrifai_tpu_torch import types as PT
    rng = np.random.default_rng(2)
    rows = [{"y": float(rng.uniform() < 0.5), "a": float(rng.normal()),
             "b": float(rng.normal())} for _ in range(120)]
    ds = Dataset.from_rows(rows, {"y": PT.RealNN, "a": PT.Real,
                                  "b": PT.Real})
    preds, label = FeatureBuilder.from_dataset(ds, response="y")
    pred = BinaryClassificationModelSelector.with_cross_validation(
        models=[(OpLogisticRegression(max_iter=10), [{"reg_param": 0.1}])]
    ).set_input(label, transmogrify(preds)).get_output()
    return Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device="cpu"), ds


@pytest.mark.parametrize("at,kind", [(1, "kill"), (2, "kill"),
                                     (2, "error")])
def test_a_save_killed_mid_write_leaves_the_old_model(tmp_path, at, kind):
    """A kill (or an error) at each ``serialize.write_file`` pass of a
    save over an existing model leaves that model at the path, loadable
    and verified, and no staged directory behind."""
    from transmogrifai_tpu_torch import load_model
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_WRITE_FILE, FaultPlan, FaultSpec, InjectedKill)
    model, ds = _small_model()
    path = str(tmp_path / "m")
    model.save(path)
    want = load_model(path, device="cpu").score(ds)
    counter = FaultPlan([])
    with counter.active():
        model.save(str(tmp_path / "count"))
    assert counter.count(SITE_WRITE_FILE) == 2  # manifest, integrity
    plan = FaultPlan([FaultSpec(SITE_WRITE_FILE, at=at, kind=kind)])
    with plan.active():
        with pytest.raises((InjectedKill, RuntimeError)):
            model.save(path)
    got = load_model(path, device="cpu").score(ds)
    assert repr(got) == repr(want)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["count", "m"]


def test_ingest_retries_until_success_bit_for_bit():
    """`run_chunk_pipeline(retry=)`: chunk prepares failing transiently
    retry to the fault-free output; past the budget the error surfaces;
    a fatal error never retries."""
    from transmogrifai_tpu_torch.data.pipeline import run_chunk_pipeline
    from transmogrifai_tpu_torch.runtime.faults import (
        SITE_READ_CHUNK, FaultPlan, FaultSpec, InjectedFault)
    from transmogrifai_tpu_torch.runtime.retry import RetryPolicy
    data = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)

    def build(plan=None, retry=None):
        out = np.zeros_like(data)

        def prepare(i):
            return i, data[i] * 2.0

        def upload(p):
            out[p[0]] = p[1]

        if plan is None:
            st = run_chunk_pipeline(range(16), prepare, upload, workers=3,
                                    retry=retry)
        else:
            with plan.active():
                st = run_chunk_pipeline(range(16), prepare, upload,
                                        workers=3, retry=retry)
        return out, st

    want, st0 = build()
    pol = RetryPolicy(max_attempts=4, base_delay_s=0.0)
    got, st = build(FaultPlan([FaultSpec(SITE_READ_CHUNK, at=4, times=3,
                                         transient=True)]), pol)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (st0.retries, st.retries) == (0, 3)
    with pytest.raises(InjectedFault):  # fatal: no retry
        build(FaultPlan([FaultSpec(SITE_READ_CHUNK, at=2)]), pol)
    with pytest.raises(InjectedFault):  # transient past the budget
        build(FaultPlan([FaultSpec(SITE_READ_CHUNK, at=2, times=0,
                                   transient=True)]), pol)


def test_ingest_retries_environment_sets_the_default_attempts(monkeypatch):
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    monkeypatch.setenv("TRANSMOGRIFAI_INGEST_RETRIES", "5")
    assert pbd._default_ingest_retry().max_attempts == 5
    monkeypatch.setenv("TRANSMOGRIFAI_INGEST_RETRIES", "0")
    assert pbd._default_ingest_retry().max_attempts == 1
