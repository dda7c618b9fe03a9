"""The data axis: row-sharded sweeps with explicit cross-shard reductions
(`parallel/rowshards.py`, the sharded paths of `models/trees.py`,
`models/logistic.py`, `models/linear.py` and `parallel/sweep.py`, the
scheduler's (1, data) rows and sharded scoring), on the CPU. A CPU mesh
repeats the ``cpu`` device; the JAX package's side runs on the conftest's
8 virtual CPU devices (`make_mesh(2, sweep=1)`).

Tolerances:
- the `RowShards` primitives, and anything whose sums are exact (integer
  weights and counts: forest histograms, the live sets): equal;
- `grow_trees` over 2 and 3 shards against one: tables and flags equal on
  fixtures without near-ties, leaves within K1's f32 summation bound (a
  leaf's sums regrouped: 2·(c − 1)·2^-24 of Σ|G| and Σ H over its c rows);
- the sharded fits against the unsharded ones: rtol 1e-4 on the linear
  and logistic weights (f32 sums regrouped over 16–800 steps), and the
  GBT margins within 1e-4;
- `run_sweep` sharded against unsharded at 256 and 301 rows: the JAX
  package's own sharded-vs-unsharded bounds (tests/test_multichip.py:52,
  :272-275): linear families rtol 2e-4, tree families atol 2e-3 with at
  least 90 % of entries within 2e-4, the winner equal;
- the port's data axis against the JAX package's: test_torch_train's
  per-family tolerances (LR 1e-4, RF and XGB 1e-2; f32 histograms and the
  JAX package's forest draws injected), the winner equal;
- sharded scoring against the unsharded scorer: equal (the same per-row
  arithmetic on each shard).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_journal import (  # noqa: E402,F401
    binary_problem, one_intra_op_thread, outcome, selector_fit)

FOLDS = 3
U = 2.0 ** -24
FAMILY_ATOL = {"OpLogisticRegression": 1e-4,
               "OpRandomForestClassifier": 1e-2,
               "OpXGBoostClassifier": 1e-2}


def cpu_rows(S):
    from transmogrifai_tpu_torch.parallel.rowshards import RowShards
    return lambda n: RowShards(n, ["cpu"] * S)


def data_mesh(S, sweep=1):
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(S * sweep, sweep=sweep, device="cpu")


# --------------------------------------------------------------------------- #
# RowShards                                                                   #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,S", [(12, 3), (13, 3), (7, 2), (5, 1)])
def test_row_shards_split_gather_sum_any_broadcast(n, S):
    from transmogrifai_tpu_torch.parallel.rowshards import RowShards
    rs = RowShards(n, ["cpu"] * S)
    assert sum(rs.sizes) == n and max(rs.sizes) - min(rs.sizes) <= 1
    assert rs.sizes == sorted(rs.sizes, reverse=True)
    assert rs.bounds[0] == 0 and rs.bounds[-1] == n
    x = torch.arange(n * 4, dtype=torch.float32).reshape(n, 4)
    parts = rs.split(x)
    assert [p.shape[0] for p in parts] == rs.sizes
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(rs.gather(parts), x)
    cols = rs.split(x.T.contiguous(), 1)
    assert torch.equal(rs.gather(cols, 1), x.T)
    vals = [torch.full((3,), 0.1 * (k + 1)) for k in range(S)]
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    assert torch.equal(rs.sum(vals), acc)  # shard order, left to right
    flags = [torch.tensor([k == j for j in range(S + 1)], dtype=torch.uint8)
             for k in range(S)]
    got = rs.any(flags)
    assert got.tolist() == [1] * S + [0]
    into = torch.zeros(S + 1, dtype=torch.uint8)
    into[S] = 1
    rs.any(flags, out=into)
    assert into.tolist() == [1] * (S + 1)
    w = torch.ones(2)
    copies = rs.broadcast(w)
    assert len(copies) == S and all(c is w for c in copies)


def test_row_shards_refuse_more_shards_than_rows():
    from transmogrifai_tpu_torch.parallel.rowshards import RowShards
    with pytest.raises(ValueError, match="cannot fill"):
        RowShards(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="rows along dim"):
        RowShards(4, ["cpu"] * 2).split(torch.zeros(5, 2))


def test_data_sharding_and_lane_devices():
    from transmogrifai_tpu_torch.parallel.mesh import (
        data_sharding, replicated, sweep_sharding)
    mesh = data_mesh(2, sweep=2)
    assert mesh.shape == {"sweep": 2, "data": 2}
    assert [str(d) for d in mesh.lane_devices(1)] == ["cpu", "cpu"]
    assert data_sharding(mesh).n_shards == 2
    assert len(data_sharding(mesh).data_devices) == 2
    assert replicated(mesh).data_devices == mesh.lane_devices(0)[:1]
    assert sweep_sharding(mesh).rows == mesh.rows()
    assert len(replicated(mesh).rows) == 1


# --------------------------------------------------------------------------- #
# the sharded tree                                                            #
# --------------------------------------------------------------------------- #

def tree_inputs(seed, n=257, d=6, n_bins=16, P=3, m=2, integer=False):
    rng = np.random.default_rng(seed)
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d)).astype(np.int8))
    if integer:  # counts: every sum exact in f32
        H = torch.from_numpy(rng.integers(0, 4, (P, n)).astype(np.float32))
        Y = torch.from_numpy(rng.integers(0, 2, (m, n)).astype(np.float32))
        G = Y[None] * H[:, None]
    else:
        H = torch.from_numpy(rng.uniform(0.1, 1.0, (P, n)).astype(np.float32))
        G = torch.from_numpy(rng.normal(size=(P, m, n)).astype(np.float32))
    return Xb, G.contiguous(), H.contiguous()


def _grow(Xb, G, H, depth, n_bins, S, monkeypatch, **kw):
    """grow_trees on S row shards (None: unsharded), recording the live
    set K2 is given at every level."""
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel.rowshards import RowSplit
    seen = []
    real = pt.split_search

    def spy(*a, live=None, **k):
        seen.append(None if live is None else live.clone())
        return real(*a, live=live, **k)
    monkeypatch.setattr(pt, "split_search", spy)
    if S is None:
        tree, node = pt.grow_trees(Xb, G, H, depth, n_bins, **kw)
    else:
        rs = cpu_rows(S)(Xb.shape[0])
        tree, node = pt.grow_trees(RowSplit(rs, rs.split(Xb)),
                                   rs.split(G, 2), rs.split(H, 1), depth,
                                   n_bins, **kw)
        node = rs.gather(node, 1)
    monkeypatch.setattr(pt, "split_search", real)
    return tree, node, seen


def _leaf_bound(node, G, H, n_leaves):
    from transmogrifai_tpu_torch.models.trees import leaf_sums_plain
    mag = leaf_sums_plain(node, G.abs(), H, n_leaves)
    cnt = leaf_sums_plain(node, torch.ones_like(G[:, :1]),
                          torch.ones_like(H), n_leaves)[..., 0]
    c = (2 * (cnt - 1).clamp(min=0) * U)[..., None]
    return c * mag[..., :-1], c[..., 0] * mag[..., -1], mag[..., -1]


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("depth,integer", [(4, False), (12, True)])
def test_grow_trees_on_shards_matches_one_device(S, depth, integer,
                                                 monkeypatch):
    """Depth 4 on real-valued channels (K1 direct); depth 12 (sibling
    subtraction) on counts. Tables and each level's live set equal, the
    node ids equal, leaves within the regrouped sums' bound."""
    Xb, G, H = tree_inputs(depth, integer=integer)
    kw = dict(reg_lambda=1.0, min_child_weight=0.5, alpha=0.05)
    want, wnode, wseen = _grow(Xb, G, H, depth, 16, None, monkeypatch, **kw)
    got, gnode, gseen = _grow(Xb, G, H, depth, 16, S, monkeypatch, **kw)
    assert torch.equal(got["feat"], want["feat"])
    assert torch.equal(got["bin"], want["bin"])
    assert torch.equal(gnode, wnode)
    assert len(gseen) == len(wseen) == depth
    for a, b in zip(gseen, wseen):
        assert (a is None and b is None) or torch.equal(a, b)
    eg, eh, h = _leaf_bound(wnode, G, H, 2 ** depth)
    # leaf = soft(g) / (h + λ): its move is at most (eg + |leaf|·eh) /
    # (h + λ), one rounding of the division on top
    leaf = want["leaf"]
    bound = (eg + leaf.abs() * eh[..., None]) / (h + 1.0)[..., None] \
        + 2 * U * leaf.abs()
    assert ((got["leaf"] - leaf).abs() <= bound).all()
    if integer:
        assert torch.equal(got["leaf"], leaf)


def test_leaf_sums_over_shards_then_the_formula_is_leaf_values():
    from transmogrifai_tpu_torch.models import trees as pt
    rng = np.random.default_rng(5)
    P, m, n, L = 3, 3, 301, 16
    node = torch.from_numpy(rng.integers(0, L, (P, n)).astype(np.int32))
    G = torch.from_numpy(rng.normal(size=(P, m, n)).astype(np.float32))
    H = torch.from_numpy(rng.uniform(0.1, 1, (P, n)).astype(np.float32))
    lam = torch.tensor([1.0, 0.5, 2.0])
    want = pt.leaf_values_plain(node, G, H, L, lam, 0.1)
    whole = pt.leaf_sums(node, G, H, L)
    assert whole.shape == (P, L, m + 1)
    assert torch.equal(pt._leaf_formula(whole[..., :-1], whole[..., -1],
                                        lam, 0.1), want)
    rs = cpu_rows(3)(n)
    sums = rs.sum([pt.leaf_sums(a, b, c, L) for a, b, c in zip(
        rs.split(node, 1), rs.split(G, 2), rs.split(H, 1))])
    got = pt._leaf_formula(sums[..., :-1], sums[..., -1], lam, 0.1)
    eg, eh, h = _leaf_bound(node, G, H, L)
    bound = (eg + want.abs() * eh[..., None]) / (h[..., None] + 0.5) \
        + 2 * U * want.abs()
    assert ((got - want).abs() <= bound).all()


# --------------------------------------------------------------------------- #
# the sharded fits                                                            #
# --------------------------------------------------------------------------- #

def fit_inputs(n=301, d=6, P=4, seed=3, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    logit = 1.2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    if classes == 2:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
            np.float32)
    else:
        y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])).astype(
            np.float32)
    w = (rng.uniform(size=(P, n)) < 0.7).astype(np.float32)
    return torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w)


def _binned(X, n_bins=16):
    from transmogrifai_tpu_torch.models.trees import (
        bin_features, quantile_bin_edges)
    return bin_features(X, torch.as_tensor(quantile_bin_edges(X.numpy(),
                                                              n_bins)))


FITS = ["forest", "gbt", "gbt_multiclass", "logreg_enet", "logreg",
        "linreg_enet", "linreg"]


def _fit(name, X, y, w, shards):
    from transmogrifai_tpu_torch.models import linear, logistic, trees
    from transmogrifai_tpu_torch.parallel.rowshards import RowSplit
    Xs = X if shards is None else RowSplit(shards, shards.split(X))
    if name in ("forest", "gbt", "gbt_multiclass"):
        Xb = _binned(X)
        Xs = Xb if shards is None else RowSplit(shards, shards.split(Xb))
    if name == "forest":
        Y = torch.nn.functional.one_hot(y.long(), 2).float()
        return trees.fit_forest(Xs, Y, w, 4, 6, 16, seed=7,
                                min_child_weight=2.0)
    if name == "gbt":
        _, margin, since = trees.fit_gbt_pairs(
            Xs, y, w, 6, 3, 16, 0.3, 1.0, val_w=1 - w,
            early_stopping_rounds=3, subsample=0.8, seed=4)
        return {"margin": margin, "since": since}
    if name == "gbt_multiclass":
        _, margin = trees.fit_gbt_multiclass_pairs(
            Xs, y, w, 4, 3, 16, 3, 0.3, 1.0, colsample=0.8, seed=4)
        return {"margin": margin}
    k = 3 if name.startswith("logreg") else None
    if name == "logreg_enet":
        return logistic.fit_logreg_enet(Xs, y, w, [0.01, 0.02, 0.0, 0.05],
                                        0.01, k, 200)
    if name == "logreg":
        return logistic.fit_logreg(Xs, y, w, 0.05, k, 30)
    if name == "linreg_enet":
        return linear.fit_linreg_enet(Xs, y, w, 0.01, 0.1)
    return linear.fit_linreg(Xs, y, w, [0.1, 0.0, 1.0, 0.01])


@pytest.mark.parametrize("name", FITS)
def test_sharded_fits_match_the_unsharded_fits(name):
    X, y, w = fit_inputs(classes=3 if name in ("gbt_multiclass",
                                                "logreg_enet", "logreg")
                         else 2)
    if name.startswith("linreg"):
        y = X[:, 0] * 2 - X[:, 1] + 0.25 * torch.round(4 * X[:, 2])
    want = _fit(name, X, y, w, None)
    for S in (2, 3):
        got = _fit(name, X, y, w, cpu_rows(S)(X.shape[0]))
        assert got.keys() == want.keys()
        for key in want:
            a, b = got[key], want[key]
            assert a.shape == b.shape and a.dtype == b.dtype
            if name == "forest" or key == "since":
                assert torch.equal(a, b), key  # integer sums: exact
            elif name.startswith("gbt"):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------- #
# the sweeps                                                                  #
# --------------------------------------------------------------------------- #

def family_models(problem):
    import transmogrifai_tpu_torch as port
    lr = [{"reg_param": r, "elastic_net_param": a}
          for a in (0.0, 0.5) for r in (0.01, 0.1)]
    if problem == "regression":
        return [(port.OpLinearRegression(), lr),
                (port.OpRandomForestRegressor(n_trees=5),
                 [{"max_depth": 4, "min_instances_per_node": 5.0}]),
                (port.OpGBTRegressor(n_estimators=6, max_depth=3),
                 [{"max_depth": 3}])]
    models = [(port.OpLogisticRegression(max_iter=20), lr),
              (port.OpRandomForestClassifier(n_trees=5),
               [{"max_depth": dd, "min_instances_per_node": 5.0}
                for dd in (3, 6)])]
    if problem == "binary":
        models.append((port.OpXGBoostClassifier(
            n_estimators=8, max_depth=4, eta=0.3, early_stopping_rounds=3),
            [{"min_child_weight": m} for m in (1.0, 10.0)]))
    return models


def sweep_problem(problem, n):
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator, MultiClassificationEvaluator,
        RegressionEvaluator)
    from transmogrifai_tpu_torch.selector.validators import (
        OpCrossValidation)
    X, y, _ = fit_inputs(n=n, classes=3 if problem == "multiclass" else 2)
    if problem == "regression":
        y = X[:, 0] * 2 - X[:, 1] + X[:, 2] * X[:, 3]
    ev = {"binary": BinaryClassificationEvaluator(metric="AuPR"),
          "multiclass": MultiClassificationEvaluator(),
          "regression": RegressionEvaluator()}[problem]
    return X, y, OpCrossValidation(FOLDS, seed=42).splits(y.numpy()), ev


def _sweep(problem, n, mesh):
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext
    X, y, folds, ev = sweep_problem(problem, n)
    ctx = FitContext(n_rows=n, seed=42, device="cpu", mesh=mesh)
    return ev, [(type(est).__name__, np.array(run_sweep(
        est, grids, X, y, folds, ev, ctx)))
        for est, grids in family_models(problem)]


def _winner(ev, fams):
    sign = 1.0 if ev.is_larger_better else -1.0
    rows = [(sign * m.mean(1)[i], f, i) for f, m in fams
            for i in range(m.shape[0])]
    return max(rows, key=lambda r: r[0])[1:]


def within_sharded_bounds(a, b, linear: bool) -> bool:
    """The JAX package's sharded-vs-unsharded bounds: linear families
    rtol 2e-4; tree families atol 2e-3 with at least 90 % within 2e-4."""
    if linear:
        return bool(np.allclose(a, b, rtol=2e-4, atol=0))
    gap = np.abs(a - b)
    return bool(gap.max() <= 2e-3 and (gap <= 2e-4).mean() >= 0.9)


def jax_family_sweeps(problem, n, fam):
    """The JAX package's own unsharded and (1, 2)-mesh sweeps of family
    `fam` on the same fixture (f32 histograms)."""
    from transmogrifai_tpu import evaluators as jev
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.parallel.mesh import make_mesh as jax_mesh
    from transmogrifai_tpu.parallel.sweep import run_sweep as jax_sweep
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    X, y, folds, ev = sweep_problem(problem, n)
    est, grids = next((e, g) for e, g in family_models(problem)
                      if type(e).__name__ == fam)
    jest = getattr(jm, fam)(**{k: v for k, v in est.params.items()
                               if k != "uid"})
    jeval = getattr(jev, type(ev).__name__)(metric=ev.default_metric)
    saved = jt.HIST_PRECISION
    jt.HIST_PRECISION = "f32"
    try:
        return [np.array(jax_sweep(jest, grids, X.numpy(), y.numpy(), folds,
                                   jeval, JaxCtx(n_rows=n, seed=42,
                                                 mesh=mesh)))
                for mesh in (None, jax_mesh(2, sweep=1))]
    finally:
        jt.HIST_PRECISION = saved


@pytest.mark.parametrize("n", [256, 301])
@pytest.mark.parametrize("problem", ["binary", "multiclass", "regression"])
def test_run_sweep_on_a_data_axis_matches_one_device(problem, n):
    """Every family within the JAX package's own sharded-vs-unsharded
    bounds, and the same winner. Where a tree family moves past them (a
    near-tie split or early-stopping round going the other way, F27), the
    JAX package's own data axis must move past them on the same fixture
    too, and the port's two matrices must be the JAX package's within
    test_torch_train's per-family tolerance."""
    ev, want = _sweep(problem, n, None)
    _, got = _sweep(problem, n, data_mesh(2))
    for (fam, a), (_, b) in zip(got, want):
        linear = "Linear" in fam or "Logistic" in fam
        if within_sharded_bounds(a, b, linear):
            continue
        assert not linear, fam
        j_plain, j_sharded = jax_family_sweeps(problem, n, fam)
        assert not within_sharded_bounds(j_sharded, j_plain, False), fam
        np.testing.assert_allclose(b, j_plain, rtol=0, atol=1e-2)
        np.testing.assert_allclose(a, j_sharded, rtol=0, atol=1e-2)
    assert _winner(ev, got) == _winner(ev, want)


@pytest.fixture(scope="module")
def jax_data_axis():
    """The JAX package's LR, RF (f32 histograms) and XGB sweeps on its
    (1, 2) data mesh over 256 rows, once for the module."""
    from test_torch_scheduler import _port_inputs
    from test_torch_journal import small_models
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu.evaluators import BinaryClassificationEvaluator
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.parallel.mesh import make_mesh as jax_mesh
    from transmogrifai_tpu.parallel.sweep import run_sweep as jax_sweep
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    X, y, folds, _, _ = _port_inputs()
    saved = jt.HIST_PRECISION
    jt.HIST_PRECISION = "f32"
    try:
        ctx = JaxCtx(n_rows=len(y), seed=42, mesh=jax_mesh(2, sweep=1))
        out = []
        for est, grids in small_models():
            jest = getattr(jm, type(est).__name__)(
                **{k: v for k, v in est.params.items() if k != "uid"})
            out.append(np.array(jax_sweep(
                jest, grids, X.numpy(), y.numpy(), folds,
                BinaryClassificationEvaluator(metric="AuPR"), ctx)))
    finally:
        jt.HIST_PRECISION = saved
    return out


def test_port_data_axis_matches_the_jax_data_axis(jax_data_axis):
    """LR, RF (the JAX package's draws injected) and XGB on the port's
    (1, 2) mesh against the JAX package's on its (1, 2) mesh."""
    from test_torch_scheduler import _port_inputs
    from test_torch_journal import small_models
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu_torch.models import trees as pt
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    X, y, folds, ev, ctx = _port_inputs()
    ctx.mesh = data_mesh(2)
    with pt.injected_forest_draws(jax_forest_draws):
        got = [np.array(run_sweep(est, grids, X, y, folds, ev, ctx))
               for est, grids in small_models()]
    for (est, _), g, w in zip(small_models(), got, jax_data_axis):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=FAMILY_ATOL[type(est).__name__])
    fams = [(type(e).__name__, m) for (e, _), m in zip(small_models(), got)]
    jfams = [(f, m) for (f, _), m in zip(fams, jax_data_axis)]
    assert _winner(ev, fams) == _winner(ev, jfams)


def test_scheduler_on_two_by_two_equals_one_by_two():
    """The scheduler gives each of a (2, 2) mesh's workers its (1, 2) row:
    the metric matrix is K11's on a (1, 2) mesh, bit for bit."""
    X, y = binary_problem(1)
    row = outcome(selector_fit(X, y, mesh=data_mesh(2))[1])
    grid = outcome(selector_fit(X, y, mesh=data_mesh(2, sweep=2))[1])
    assert grid == row


# --------------------------------------------------------------------------- #
# the workflow: train on a data mesh, score sharded                           #
# --------------------------------------------------------------------------- #

def iris_models(ns):
    return [(ns.models.OpLogisticRegression(max_iter=20),
             [{"reg_param": r, "elastic_net_param": 0.1}
              for r in (0.001, 0.1)]),
            (ns.models.OpRandomForestClassifier(n_trees=4),
             [{"max_depth": 3, "min_instances_per_node": 5.0}])]


def iris_train(name, mesh):
    from test_torch_multiclass import (
        example_dataset, example_pipeline, package, selected)
    ns = package(name)
    label, pred = example_pipeline(ns, "iris", iris_models(ns))
    ds = example_dataset(ns, "iris")
    wf = ns.Workflow().set_result_features(pred, label).set_input_dataset(ds)
    model = (wf.train(mesh=mesh) if name == "jax"
             else wf.train(device="cpu", mesh=mesh))
    s = selected(model).summary
    return model, ds, (s.best_model, s.best_grid)


@pytest.fixture(scope="module")
def iris_on_mesh():
    from test_torch_train import jax_forest_draws
    from transmogrifai_tpu_torch.models import trees as pt
    with pt.injected_forest_draws(jax_forest_draws):
        return iris_train("port", data_mesh(2))


def test_workflow_trains_on_a_data_mesh_with_the_jax_winner(iris_on_mesh):
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.parallel.mesh import make_mesh as jax_mesh
    saved = jt.HIST_PRECISION
    jt.HIST_PRECISION = "f32"
    try:
        _, _, want = iris_train("jax", jax_mesh(2, sweep=1))
    finally:
        jt.HIST_PRECISION = saved
    assert iris_on_mesh[2] == want


def test_score_compiled_sharded_equals_unsharded(iris_on_mesh):
    """150 rows over 2 shards, and 301 rows (2 does not divide them: the
    batch runs replicated, and is counted) against the unsharded scorer."""
    from transmogrifai_tpu_torch.parallel.mesh import data_sharding
    model, ds, _ = iris_on_mesh
    sharding = data_sharding(data_mesh(2))
    odd = type(ds).concat([ds, ds, ds.take(np.array([0]))])
    for batch, counts in ((ds, (1, 0)), (odd, (0, 1))):
        want = model.score_compiled(batch)
        got = model.score_compiled(batch, sharding=sharding)
        scorer = model._compiled
        assert scorer.sharding is sharding
        assert (scorer.sharded_batches, scorer.replicated_batches) == counts
        assert got.keys() == want.keys()
        for k in want:
            a, b = got[k], want[k]
            if isinstance(b, dict):
                for kk in b:
                    assert torch.equal(a[kk], b[kk]), (k, kk)
            else:
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


if __name__ == "__main__":
    # python tests/test_torch_data_axis.py: F27's readings, the largest
    # sharded-vs-unsharded XGB fold-metric move at 256 and 301 rows,
    # without and with early stopping, in the port (2 CPU shards) and in
    # the JAX package (its (1, 2) mesh on 8 virtual CPU devices)
    import json
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import transmogrifai_tpu_torch as port
    from transmogrifai_tpu import models as jm
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.evaluators import (
        BinaryClassificationEvaluator as JaxEval)
    from transmogrifai_tpu.parallel.mesh import make_mesh as jax_mesh
    from transmogrifai_tpu.parallel.sweep import run_sweep as jax_sweep
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.parallel.sweep import run_sweep
    from transmogrifai_tpu_torch.stages.base import FitContext
    jt.HIST_PRECISION = "f32"
    torch.set_num_threads(1)
    grids = [{"min_child_weight": m} for m in (1.0, 10.0)]
    for n in (256, 301):
        X, y, folds, ev = sweep_problem("binary", n)
        for esr in (0, 3):
            kw = dict(n_estimators=8, max_depth=4, eta=0.3,
                      early_stopping_rounds=esr)
            p = [np.array(run_sweep(
                port.OpXGBoostClassifier(**kw), grids, X, y, folds, ev,
                FitContext(n_rows=n, seed=42, device="cpu", mesh=mesh)))
                for mesh in (None, data_mesh(2))]
            j = [np.array(jax_sweep(
                jm.OpXGBoostClassifier(**kw), grids, X.numpy(), y.numpy(),
                folds, JaxEval(metric="AuPR"),
                JaxCtx(n_rows=n, seed=42, mesh=mesh)))
                for mesh in (None, jax_mesh(2, sweep=1))]
            print(json.dumps({"rows": n, "early_stopping_rounds": esr,
                              "port_move": float(np.abs(p[0] - p[1]).max()),
                              "jax_move": float(np.abs(j[0] - j[1]).max())}),
                  flush=True)
