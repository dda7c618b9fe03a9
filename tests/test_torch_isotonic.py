"""Parity of the port's isotonic calibrator with the JAX package on the
CPU (`models/isotonic.py`).

- `pav_fit`: the knots equal (f64, bit for bit), increasing and
  decreasing.
- The interpolation on hostile knots (every score tied, one point, knots
  repeated by rounded scores, f64 knots that collapse in f32, scores below
  and above the range, subnormal scores, constant labels): the port's
  `device_apply_with` bit-equal to both the JAX package's eager transform
  and its jitted scorer. `jnp.interp` is a jitted function, so both JAX
  paths run it as one XLA program that contracts fp[i−1] + (delta/dx)·df
  into one FMA; the port rounds it so too (`fma_f32`). Rounded apart, 42
  of 200,000 random scores move by one ulp
  (`test_separate_rounding_would_differ`).
- A calibrator trained in a workflow, served through `score_compiled` and
  eagerly: equal to each other and to the JAX package's.
- `from_jax_params`, and save and load in both directions.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from transmogrifai_tpu.models import isotonic as ji  # noqa: E402
from transmogrifai_tpu_torch.models import isotonic as pi  # noqa: E402

from test_torch_multiclass import package  # noqa: E402


def fit_data(case: str, seed: int = 1):
    """(scores, labels, extra scoring points) of one hostile case."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=3000)
    y = (rng.uniform(size=3000) < x).astype(np.float64)
    extra = np.array([0.0, 1e-40, -1e-40, 1e-45, -0.5, 2.0,
                      np.float32(x.min()), np.float32(x.max())])
    if case == "random":
        return x, y, extra
    if case == "decreasing":
        return x, 1.0 - y, extra
    if case == "all_tied":
        return np.full(50, 0.3), (np.arange(50) % 2).astype(float), extra
    if case == "one_point":
        return np.array([0.4]), np.array([1.0]), extra
    if case == "repeated_knots":
        xr = np.round(x[:2000], 2)
        return xr, (rng.uniform(size=2000) < xr).astype(float), \
            np.concatenate([extra, xr])
    if case == "f32_collapse":
        xf = np.float32(0.5) + np.arange(200) * 1e-9
        return (xf.astype(np.float64) + rng.uniform(0, 1e-9, 200),
                (rng.uniform(size=200) < 0.5).astype(float),
                np.concatenate([extra, xf]))
    if case == "constant_labels":
        return x, np.ones_like(x), extra
    raise KeyError(case)


CASES = ("random", "decreasing", "all_tied", "one_point", "repeated_knots",
         "f32_collapse", "constant_labels")


def scoring_points(extra, seed=2):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.2, 1.2, 20000), extra]) \
        .astype(np.float32)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("increasing", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_pav_knots_equal_jax(case, increasing):
    x, y, _ = fit_data(case)
    jb, jv = ji.pav_fit(x, y, increasing=increasing)
    pb, pv = pi.pav_fit(x, y, increasing=increasing)
    assert jb.dtype == pb.dtype == np.float64
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pv, jv)


def port_interp(model, xs, mask=None):
    mask = np.ones(len(xs), bool) if mask is None else mask
    out = model.device_apply_with(
        model.device_constants("cpu"), None,
        [{"value": torch.from_numpy(xs), "mask": torch.from_numpy(mask)}])
    return out["value"].numpy(), out["mask"].numpy()


@pytest.mark.parametrize("case", CASES)
def test_interpolation_bit_equal_to_jax(case):
    x, y, extra = fit_data(case)
    b, v = ji.pav_fit(x, y, increasing=case != "decreasing")
    jm = ji.IsotonicCalibratorModel(b, v)
    pm = pi.IsotonicCalibratorModel(b, v)
    xs = scoring_points(extra)
    mask = np.arange(len(xs)) % 7 != 0
    eager = jm.device_apply(None, [{"value": xs, "mask": mask}])
    jitted = jax.jit(lambda c, v, m: jm.device_apply_with(
        c, None, [{"value": v, "mask": m}]))(jm.device_constants(), xs, mask)
    got, got_mask = port_interp(pm, xs, mask)
    np.testing.assert_array_equal(bits(got), bits(eager["value"]))
    np.testing.assert_array_equal(bits(got), bits(jitted["value"]))
    np.testing.assert_array_equal(got_mask, mask)


def test_separate_rounding_would_differ():
    """The FMA matters: rounding the product and the sum apart moves some
    random scores (42 of 200,000 here) by one ulp from the JAX package's
    values (the finding that fixed the port's rounding)."""
    x, y, _ = fit_data("random", seed=0)
    b, v = ji.pav_fit(x, y)
    jm = ji.IsotonicCalibratorModel(b, v)
    xs = np.random.default_rng(0).uniform(-0.1, 1.1, 200000) \
        .astype(np.float32)
    want = bits(jm.device_apply(None, [{"value": xs, "mask": np.ones(
        len(xs), bool)}])["value"])
    xp, fp = torch.from_numpy(jm.boundaries), torch.from_numpy(jm.values)
    t = torch.from_numpy(xs)
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    q = (t - xp[i - 1]) / torch.where(dx0, torch.ones_like(dx), dx)
    apart = torch.where(dx0, fp[i - 1], fp[i - 1] + q * (fp[i] - fp[i - 1]))
    apart = torch.where(t < xp[0], fp[0], apart)
    apart = torch.where(t > xp[-1], fp[-1], apart)
    assert int((bits(apart.numpy()) != want).sum()) > 0
    assert int((bits(pi.interp(t, xp, fp).numpy()) != want).sum()) == 0


def calibrator_workflow(name, xs):
    """A workflow whose result is the isotonic calibration of the score
    column "s" against the label "y", trained by package `name`:
    (model, dataset, calibrated feature)."""
    ns = package(name)
    t = ns.t
    rng = np.random.default_rng(4)
    ds = ns.Dataset({"s": xs.astype(np.float64),
                     "y": (rng.uniform(size=len(xs)) < np.clip(xs, 0, 1))
                     .astype(np.float64)},
                    {"s": t.RealNN, "y": t.RealNN})
    s = ns.FeatureBuilder.RealNN("s").from_column("s").as_predictor()
    lab = ns.FeatureBuilder.RealNN("y").from_column("y").as_response()
    cal = ns.models.IsotonicRegressionCalibrator().set_input(lab, s) \
        .get_output()
    # the JAX package's graph check flags the calibrator as mixing the
    # label with a predictor (its class is not marked response-aware), so
    # its train and compile run with strict=False
    kw = {"strict": False} if name == "jax" else {"device": "cpu"}
    model = ns.Workflow().set_result_features(cal, lab) \
        .set_input_dataset(ds).train(**kw)
    return model, ds, cal


def test_calibrator_serves_compiled_and_eager_like_jax():
    """Eager scores and `score_compiled`'s, in each package: all four
    bit-equal, and the knots equal."""
    xs = np.round(np.random.default_rng(5).uniform(-0.1, 1.1, 600), 3)
    pm, pds, pcal = calibrator_workflow("port", xs)
    jm, jds, jcal = calibrator_workflow("jax", xs)
    pfit = pm.fitted[pcal.origin_stage.uid]
    jfit = jm.fitted[jcal.origin_stage.uid]
    np.testing.assert_array_equal(pfit.boundaries, jfit.boundaries)
    np.testing.assert_array_equal(pfit.values, jfit.values)
    eager = pm.score(pds)[pcal.name].data["value"]
    compiled = pm.score_compiled(pds)[pcal.name]["value"].cpu().numpy()
    j_eager = jm.score(jds)[jcal.name].data["value"]
    j_compiled = np.asarray(
        jm.score_compiled(jds, strict=False)[jcal.name]["value"])
    for other in (compiled, j_eager, j_compiled):
        np.testing.assert_array_equal(bits(eager), bits(other))


def test_from_jax_params_and_save_load_both_ways(tmp_path):
    from transmogrifai_tpu.workflow.serialization import \
        load_model as jax_load
    from transmogrifai_tpu_torch import from_jax_params
    from transmogrifai_tpu_torch.workflow.serialization import \
        load_model as port_load
    x, y, extra = fit_data("repeated_knots")
    b, v = ji.pav_fit(x, y)
    jm = ji.IsotonicCalibratorModel(b, v)
    pm = from_jax_params("IsotonicCalibratorModel", jm.get_params())
    assert isinstance(pm, pi.IsotonicCalibratorModel)
    np.testing.assert_array_equal(pm.boundaries, jm.boundaries)
    np.testing.assert_array_equal(pm.values, jm.values)
    assert pm.get_params() == jm.get_params()
    # a workflow whose result is the calibrated score, trained by each
    # package, saved, and loaded by the other
    xs = scoring_points(extra)
    for name, other_load in (("jax", port_load), ("port", jax_load)):
        model, ds, cal = calibrator_workflow(name, xs)
        path = str(tmp_path / name)
        model.save(path)
        other = (other_load(path, device="cpu") if name == "jax"
                 else other_load(path))
        want = np.asarray(model.score(ds)[cal.name].data["value"])
        got = np.asarray(other.score(ds)[cal.name].data["value"])
        np.testing.assert_array_equal(bits(got), bits(want))
