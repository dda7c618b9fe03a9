"""The Iris and Boston examples' default selectors trained on a data axis
(`Workflow.train(mesh=)`, a CPU mesh that repeats the ``cpu`` device):
multiclass LR + RF, and linear regression + RF regression + GBT
regression, at full width.

Tolerances: configs and winner equal to the train without a mesh; fold
metrics within the JAX package's own sharded-vs-unsharded bounds
(tests/test_multichip.py:52, :272-275): linear families rtol 2e-4, tree
families atol 2e-3 with at least 90 % of entries within 2e-4; the
scheduler's (2, 2) mesh equal to the (1, 2) mesh bit for bit (each
worker's lane is a (1, 2) row, and every batched fit gives a config the
same bits whatever configs share it).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_data_axis import data_mesh, within_sharded_bounds  # noqa: E402
from test_torch_journal import one_intra_op_thread  # noqa: E402,F401
from test_torch_multiclass import (  # noqa: E402
    example_dataset, example_pipeline, package, selected)


def example_outcome(example, mesh):
    ns = package("port")
    label, pred = example_pipeline(ns, example)
    model = ns.Workflow().set_result_features(pred, label) \
        .set_input_dataset(example_dataset(ns, example)) \
        .train(device="cpu", mesh=mesh)
    s = selected(model).summary
    return ([(r.model, r.grid) for r in s.validation_results],
            [list(r.fold_metrics) for r in s.validation_results],
            (s.best_model, s.best_grid))


@pytest.mark.parametrize("example", ["iris", "boston"])
def test_default_selector_on_a_data_axis(example):
    plain = example_outcome(example, None)
    row = example_outcome(example, data_mesh(2))
    grid = example_outcome(example, data_mesh(2, sweep=2))
    assert grid == row
    assert row[0] == plain[0] and row[2] == plain[2]
    families = {}
    for (fam, _), a, b in zip(plain[0], row[1], plain[1]):
        got, want = families.setdefault(fam, ([], []))
        got.extend(a)
        want.extend(b)
    for fam, (a, b) in families.items():
        linear = "Linear" in fam or "Logistic" in fam
        assert within_sharded_bounds(np.array(a), np.array(b), linear), fam


def family_gaps(plain, sharded) -> dict:
    """Per family: the largest fold-metric gap and the share within 2e-4."""
    out = {}
    for (fam, _), a, b in zip(plain[0], sharded[1], plain[1]):
        gap = np.abs(np.array(a) - np.array(b))
        got = out.setdefault(fam, {"max_abs": 0.0, "within_2e-4": [0, 0]})
        got["max_abs"] = max(got["max_abs"], float(gap.max()))
        got["within_2e-4"][0] += int((gap <= 2e-4).sum())
        got["within_2e-4"][1] += gap.size
    return out


def titanic_outcome(mesh):
    """The README quickstart's default selector (LR 8 + RF 18 × 50 trees +
    XGB 2) trained on the CPU, as `example_outcome` reads it."""
    import chip_smoke
    import transmogrifai_tpu_torch as port
    ds = port.Dataset.from_csv(chip_smoke.TITANIC)
    pred, label = chip_smoke.readme_quickstart(port, ds)
    model = port.Workflow().set_result_features(pred, label) \
        .set_input_dataset(ds).train(device="cpu", mesh=mesh)
    s = selected(model).summary
    return ([(r.model, r.grid) for r in s.validation_results],
            [list(r.fold_metrics) for r in s.validation_results],
            (s.best_model, s.best_grid))


if __name__ == "__main__":
    # python tests/test_torch_data_axis_examples.py [titanic] [iris] [boston]
    # prints, per example, each mesh's winner check and per-family gaps
    # against the train without a mesh (the Titanic default takes tens of
    # minutes on a CPU)
    import json
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in sys.argv[1:] or ["iris", "boston"]:
        run = titanic_outcome if name == "titanic" else (
            lambda mesh, name=name: example_outcome(name, mesh))
        plain = run(None)
        got = {"1x2": run(data_mesh(2)), "2x2": run(data_mesh(2, sweep=2))}
        print(json.dumps({name: {
            "2x2_equals_1x2": got["2x2"] == got["1x2"],
            **{k: {"winner_equal": v[2] == plain[2],
                   "configs_equal": v[0] == plain[0],
                   "families": family_gaps(plain, v)}
               for k, v in got.items()}}}), flush=True)
