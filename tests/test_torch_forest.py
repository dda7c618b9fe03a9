"""The port's forest learner against the JAX package's, on the CPU (the
plain PyTorch versions; the CUDA kernels are held to these on the card in
tests/test_torch_cuda.py and chip_smoke.py).

Seeded numpy inputs at a small size: n = 256 rows, d = 12 features, 16
bins, m = 2 class channels (one-hot labels times Poisson bootstrap
counts, the forest's values), depth 12 (the sibling-subtraction path) and
3 trees. The JAX package runs in its exact-f32 histogram mode
(`HIST_PRECISION` patched to "f32" before its first trace, as
tests/test_models.py does; it subtracts siblings only in that mode).

Tolerances:
- K1 histograms with m = 2: equal — forest values are small integers,
  whose f32 sums are exact in any order (XLA's matmul and the port's
  row-order adds alike); float values: rtol 1e-5, atol 1e-5;
- K1-sub: equal to the JAX package's `stack([hg - hg_r, hg_r])`;
- K2 split choice with m = 2: bins equal, features equal where the node
  splits, from the same histograms;
- K3 leaves with m = 2: atol 1e-7 — the same exact sums; XLA may divide
  by the broadcast weight as a multiply by its reciprocal, one ulp away;
- grown trees and forests: split bins equal, split features equal where a
  node splits, leaf values atol 1e-6, final node ids equal.
"""

import sys
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import trees as pt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import jax_forest_draws  # noqa: E402

N, D, B, M, DEPTH, P = 256, 12, 16, 2, 12, 3


@pytest.fixture(autouse=True)
def exact_histograms(monkeypatch):
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")


def _forest_values(seed, n=N, d=D, n_bins=B, P=P):
    """Binned rows, one-hot labels Y (n, 2), and per tree G = Y·boot (P, 2,
    n) and H = boot (P, n) with Poisson(1) bootstrap counts."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (n, d)).astype(np.int8)
    Xb[:, 5] = Xb[:, 2]  # a duplicate column: exact gain ties
    y = (Xb[:, 0] + rng.integers(0, n_bins, n) >= n_bins).astype(np.int64)
    Y = np.eye(2, dtype=np.float32)[y]
    boot = rng.poisson(1.0, (P, n)).astype(np.float32)
    G = (Y.T[None] * boot[:, None, :]).astype(np.float32)
    return Xb, Y, G, boot


def _nodes(seed, n_nodes):
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, n_nodes, (P, N)).astype(np.int32)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n_nodes", [1, 8])
def test_histograms_with_class_channels_match_jax(exact, n_nodes):
    Xb, _, G, H = _forest_values(n_nodes)
    if not exact:
        rng = np.random.default_rng(3)
        G = rng.normal(size=G.shape).astype(np.float32)
        H = rng.uniform(0.1, 1.0, H.shape).astype(np.float32)
    node = _nodes(4, n_nodes)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H),
                           n_nodes, B)
    assert hg.shape == (P, M, n_nodes, D, B) and hh.shape == (P, n_nodes, D, B)
    Bj = jt.bins_onehot(jnp.asarray(Xb), B)
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-5)
    for p in range(P):
        wg, wh = jt._histograms(Bj, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T), jnp.asarray(H[p]),
                                n_nodes)
        np.testing.assert_allclose(hg[p].numpy(), np.asarray(wg), **tol)
        np.testing.assert_allclose(hh[p].numpy(), np.asarray(wh), **tol)


def test_histograms_leave_out_rows_with_the_spare_node_id():
    """Node id n_nodes leaves a row out: the histograms of the rows routed
    right, grouped by parent, equal the JAX package's zero-weighted ones."""
    Xb, _, G, H = _forest_values(5)
    rng = np.random.default_rng(6)
    node = rng.integers(0, 8, (P, N)).astype(np.int32)  # level-3 ids
    right = (node & 1).astype(bool)
    parent = np.where(right, node >> 1, 4).astype(np.int32)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(parent),
                           torch.from_numpy(G), torch.from_numpy(H), 4, B)
    Bj = jt.bins_onehot(jnp.asarray(Xb), B)
    for p in range(P):
        r = right[p].astype(np.float32)
        wg, wh = jt._histograms(Bj, jnp.asarray(node[p] >> 1),
                                jnp.asarray(G[p].T * r[:, None]),
                                jnp.asarray(H[p] * r), 4)
        np.testing.assert_array_equal(hg[p].numpy(), np.asarray(wg))
        np.testing.assert_array_equal(hh[p].numpy(), np.asarray(wh))
    order, seg = pt.node_segments(torch.from_numpy(parent), 4)
    assert seg[:, -1].tolist() == right.sum(1).tolist()


def test_sibling_subtract_interleaves_like_jax():
    rng = np.random.default_rng(7)
    hg = rng.integers(0, 9, (P, M, 4, D, B)).astype(np.float32)
    hh = hg.sum(1)
    hg_r = np.minimum(hg, rng.integers(0, 5, hg.shape)).astype(np.float32)
    hh_r = hg_r.sum(1)
    cg, ch = pt.sibling_subtract(*(torch.from_numpy(a)
                                   for a in (hg, hh, hg_r, hh_r)))
    assert cg.shape == (P, M, 8, D, B) and ch.shape == (P, 8, D, B)
    for p in range(P):
        want_g = jnp.stack([hg[p] - hg_r[p], hg_r[p]], axis=2).reshape(
            M, 8, D, B)
        want_h = jnp.stack([hh[p] - hh_r[p], hh_r[p]], axis=1).reshape(
            8, D, B)
        np.testing.assert_array_equal(cg[p].numpy(), np.asarray(want_g))
        np.testing.assert_array_equal(ch[p].numpy(), np.asarray(want_h))


SPLIT_CASES = [
    # (mcw, min_gain_norm, masked, level, active_depth)
    (1.0, 0.0, False, 2, None),
    (10.0, 0.001, False, 3, None),   # Spark's minInstances / minInfoGain
    (1.0, 0.1, True, 1, None),       # feature mask, large gain threshold
    (1.0, 0.01, False, 3, 3),        # level cut
    (1e9, 0.0, False, 0, None),      # no valid cell anywhere
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_search_with_class_channels_matches_jax(case):
    mcw, mgn, masked, level, active = case
    Xb, _, G, H = _forest_values(11 + level)
    n_nodes = 2 ** level
    node = _nodes(5, n_nodes)
    node[:, :3] = n_nodes - 1 if n_nodes > 1 else 0
    Bj = jt.bins_onehot(jnp.asarray(Xb), B)
    fmask = np.ones((P, D), bool)
    if masked:
        fmask[:, [0, 2]] = False
    hgs, hhs, want_f, want_b = [], [], [], []
    for p in range(P):
        hg, hh = jt._histograms(Bj, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T), jnp.asarray(H[p]),
                                n_nodes)
        bf, bb = jt.split_from_histograms(
            hg, hh, B, 1e-6, mcw, 0.0, mgn,
            jnp.asarray(fmask[p]) if masked else None, level,
            None if active is None else jnp.int32(active))
        hgs.append(np.asarray(hg))
        hhs.append(np.asarray(hh))
        want_f.append(np.asarray(bf))
        want_b.append(np.asarray(bb))
    got_f, got_b = pt.split_search(
        torch.from_numpy(np.stack(hgs)), torch.from_numpy(np.stack(hhs)),
        B, 1e-6, mcw, 0.0, mgn, torch.from_numpy(fmask) if masked else None,
        level, active)
    np.testing.assert_array_equal(got_b.numpy(), np.stack(want_b))
    split = np.stack(want_b) < B
    np.testing.assert_array_equal(got_f.numpy()[split],
                                  np.stack(want_f)[split])


def test_split_search_of_empty_nodes_equals_the_full_search():
    """Nodes without rows share one search of a zero histogram in the
    plain version; it must write what the full search writes."""
    Xb, _, G, H = _forest_values(2)
    node = torch.from_numpy(_nodes(2, 4) * 2)  # odd nodes of 8 are empty
    hg, hh = pt.histograms(torch.from_numpy(Xb), node, torch.from_numpy(G),
                           torch.from_numpy(H), 8, B)
    for mcw, mg in ((1.0, 0.0), (0.0, -1.0)):  # mcw 0: zero gains valid
        got = pt.split_search(hg, hh, B, 1e-6, mcw, mg, 0.0, None, 3, None)
        Bj = jt.bins_onehot(jnp.asarray(Xb), B)
        for p in range(P):
            jg, jh = jt._histograms(Bj, jnp.asarray(node[p].numpy()),
                                    jnp.asarray(G[p].T), jnp.asarray(H[p]),
                                    8)
            wf, wb = jt.split_from_histograms(jg, jh, B, 1e-6, mcw, mg, 0.0,
                                              None, 3, None)
            np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(wf))
            np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(wb))


def test_leaf_values_with_class_channels_match_jax():
    Xb, _, G, H = _forest_values(8)
    node = _nodes(8, 16)
    leaf = pt.leaf_values(torch.from_numpy(node), torch.from_numpy(G),
                          torch.from_numpy(H), 16, 1e-6, 0.0)
    assert leaf.shape == (P, 16, M)
    for p in range(P):
        # grow_tree's leaf step (models/trees.py:289-293)
        idx = jnp.asarray(node[p])
        lg = jnp.zeros((16, M), jnp.float32).at[idx].add(jnp.asarray(G[p].T))
        lh = jnp.zeros((16,), jnp.float32).at[idx].add(jnp.asarray(H[p]))
        lg = jnp.sign(lg) * jnp.maximum(jnp.abs(lg) - 0.0, 0.0)
        want = lg / (lh + 1e-6)[:, None]
        np.testing.assert_allclose(leaf[p].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-7)


def _jax_grow(Xb, G, H, mcw, fmask, mgn, depth):
    grow = jax.jit(jax.vmap(
        lambda g, h, c, f, t: jt.grow_tree(
            jnp.asarray(Xb), g, h, depth, B, reg_lambda=1e-6,
            min_child_weight=c, feature_mask=f, min_gain_norm=t),
        in_axes=(0, 0, 0, 0, 0)))
    return grow(jnp.asarray(np.swapaxes(G, 1, 2)), jnp.asarray(H),
                jnp.asarray(mcw, jnp.float32), jnp.asarray(fmask),
                jnp.asarray(mgn, jnp.float32))


def _assert_trees_equal(got, want):
    wb = np.asarray(want["bin"])
    np.testing.assert_array_equal(got["bin"].numpy(), wb)
    split = wb < B
    assert split.any()
    np.testing.assert_array_equal(got["feat"].numpy()[split],
                                  np.asarray(want["feat"])[split])
    np.testing.assert_allclose(got["leaf"].numpy(), np.asarray(want["leaf"]),
                               rtol=0, atol=1e-6)


def test_depth12_grow_trees_subtracts_like_jax():
    """Depth 12 takes the sibling-subtraction branch in both packages."""
    Xb, _, G, H = _forest_values(21)
    rng = np.random.default_rng(22)
    fmask = rng.random((P, D)) < 0.7
    mcw, mgn = [1.0, 3.0, 2.0], [0.001, 0.01, 0.0]
    tree, node = pt.grow_trees(
        torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H),
        DEPTH, B, reg_lambda=1e-6, min_child_weight=mcw,
        feature_mask=torch.from_numpy(fmask), min_gain_norm=mgn)
    assert tree["feat"].shape == (P, DEPTH, 2 ** DEPTH)
    assert tree["leaf"].shape == (P, 2 ** DEPTH, M)
    want = _jax_grow(Xb, G, H, mcw, fmask, mgn, DEPTH)
    _assert_trees_equal(tree, want)
    assert int(np.asarray(want["bin"] < B)[:, 6:].sum()) > 0  # deep splits
    for p in range(P):
        walked = jt._tree_walk({k: v[p] for k, v in want.items()},
                               jnp.asarray(Xb))
        np.testing.assert_array_equal(node[p].numpy(), np.asarray(walked))


def test_subtraction_and_direct_growth_agree():
    """The port's depth-12 path (subtraction) and a direct build of the
    same levels give the same trees: the cut of depth 12 to depth 11 +
    active_depth changes only which branch runs."""
    Xb, _, G, H = _forest_values(31)
    args = (torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H))
    deep, _ = pt.grow_trees(*args, 12, B, reg_lambda=1e-6,
                            min_child_weight=2.0, active_depth=11)
    direct, _ = pt.grow_trees(*args, 11, B, reg_lambda=1e-6,
                              min_child_weight=2.0)
    assert torch.equal(deep["bin"][:, :11, :2 ** 11], direct["bin"][:, :, :])
    split = direct["bin"] < B
    assert torch.equal(deep["feat"][:, :11, :2 ** 11][split],
                       direct["feat"][split])
    # level 11 does not split: every row of leaf k lands in leaf 2k
    assert torch.equal(deep["leaf"][:, 0::2], direct["leaf"])


@pytest.mark.parametrize("depth", [4, 12])
def test_fit_forest_with_jax_draws_matches_jax(depth):
    """Two (config, fold) pairs of 3 trees each with the JAX package's
    threefry draws injected, against its `fit_forest`, pair by pair."""
    Xb, Y, _, _ = _forest_values(41)
    rng = np.random.default_rng(42)
    w = (rng.random((2, N)) < 0.7).astype(np.float32)
    seed, T = 1234, 3
    draws = jax_forest_draws(seed, T, N, D)
    mcw, mgn, active = [10.0, 1.0], [0.001, 0.01], [depth, 3]
    got = pt.fit_forest(torch.from_numpy(Xb), torch.from_numpy(Y),
                        torch.from_numpy(w), T, depth, B, seed,
                        min_child_weight=mcw, active_depth=active,
                        min_gain=mgn, draws=draws)
    assert got["leaf"].shape == (2, T, 2 ** depth, M)
    for q in range(2):
        want = jt.fit_forest(jnp.asarray(Xb), jnp.asarray(Y),
                             jnp.asarray(w[q]), T, depth, B, M, seed, True,
                             mcw[q], active_depth=jnp.int32(active[q]),
                             min_gain=jnp.float32(mgn[q]))
        _assert_trees_equal({k: v[q] for k, v in got.items()}, want)


def test_forest_chunks_do_not_change_the_forest(monkeypatch, caplog):
    Xb, Y, _, _ = _forest_values(51)
    w = np.ones((2, N), np.float32)
    args = (torch.from_numpy(Xb), torch.from_numpy(Y), torch.from_numpy(w),
            4, 5, B, 9)
    caplog.set_level("INFO", logger=pt.__name__)
    whole = pt.fit_forest(*args, min_child_weight=[1.0, 5.0])
    assert "8 trees at depth 5 in 1 chunks of 8" in caplog.text
    per_tree = pt.forest_chunk(8, 5, M, N, D, B, "cpu")[2]
    monkeypatch.setattr(pt, "_FOREST_CPU_BUDGET", 3 * per_tree)
    parts = pt.fit_forest(*args, min_child_weight=[1.0, 5.0])
    assert "8 trees at depth 5 in 3 chunks of 3" in caplog.text
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k


def test_forest_draws_are_seeded_poisson_and_sqrt_masks():
    boot, mask = pt.forest_draws(40, 2000, 49, seed=3)
    again, mask2 = pt.forest_draws(40, 2000, 49, seed=3)
    assert torch.equal(boot, again) and torch.equal(mask, mask2)
    assert abs(float(boot.mean()) - 1.0) < 0.02
    assert torch.equal(boot, boot.round()) and float(boot.min()) == 0.0
    assert mask.sum(1).tolist() == [7] * 40
    other, _ = pt.forest_draws(40, 2000, 49, seed=4)
    assert not torch.equal(boot, other)
    ones, all_f = pt.forest_draws(2, 10, 49, seed=3, subsample_features=False,
                                  bootstrap=False)
    assert bool((ones == 1).all()) and bool(all_f.all())


def test_random_forest_estimator_matches_jax_with_its_draws():
    """`OpRandomForestClassifier.fit_arrays` (binning, one-hot labels, the
    forest) against the JAX package's, the JAX draws of the fit's seed
    injected; then its predictions through K5."""
    from transmogrifai_tpu.models.trees import (
        OpRandomForestClassifier as JaxRF)
    from transmogrifai_tpu.stages.base import FitContext as JaxCtx
    from transmogrifai_tpu_torch.stages.base import FitContext

    rng = np.random.default_rng(61)
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = ((X[:, 0] + X[:, 4] + rng.normal(size=N)) > 0).astype(np.float32)
    kw = dict(n_trees=4, max_depth=12, min_info_gain=0.001,
              min_instances_per_node=5.0)
    jm = JaxRF(**kw).fit_arrays(jnp.asarray(X), jnp.asarray(y),
                                jnp.ones(N, jnp.float32),
                                JaxCtx(n_rows=N, seed=77))
    with pt.injected_forest_draws(jax_forest_draws):
        pm = pt.OpRandomForestClassifier(**kw).fit_arrays(
            torch.from_numpy(X), torch.from_numpy(y), torch.ones(N),
            FitContext(n_rows=N, seed=77, device="cpu"))
    np.testing.assert_array_equal(pm.edges, jm.edges)
    _assert_trees_equal({k: torch.from_numpy(np.asarray(v))
                         for k, v in pm.trees.items()}, jm.trees)
    got = pm.predict_arrays(torch.from_numpy(X))
    want = jm.predict_arrays(jnp.asarray(X))
    np.testing.assert_allclose(got["probability"].numpy(),
                               np.asarray(want["probability"]), rtol=0,
                               atol=1e-6)
    assert pm.get_params().keys() == jm.get_params().keys()


def test_random_forest_refuses_what_is_not_ported():
    X = torch.zeros((6, 2))
    for est in (pt.OpRandomForestClassifier(n_trees=2),
                pt.OpRandomForestRegressor(n_trees=2)):
        est.init_params = {"trees": {}}
        with pytest.raises(NotImplementedError, match="warm starts"):
            est.fit_arrays(X, torch.tensor([0., 1., 2., 0., 1., 2.]),
                           torch.ones(6), None)


@pytest.mark.parametrize("n_values", [2, 4, 11])
def test_sorted_metrics_group_ties_like_jax(n_values):
    """Forest probabilities take few distinct values (fractions of the
    trees' leaf values): AuPR and AuROC over heavily tied scores, with
    fold masks, against the JAX package's (atol 1e-6: both sum the curve
    in f32) and the host metric on the unmasked rows."""
    from transmogrifai_tpu.evaluators import device_metrics as jdm
    from transmogrifai_tpu.evaluators import metrics as jmetrics
    from transmogrifai_tpu_torch.evaluators import device_metrics as pdm

    rng = np.random.default_rng(n_values)
    n = 802
    y = (rng.random(n) < 0.38).astype(np.float32)
    # tree-vote fractions, ranked with the label so the curve is not flat
    s = np.clip(rng.integers(0, n_values, n) + 2 * y, 0, n_values - 1)
    s = (s / (n_values - 1)).astype(np.float32)
    for mask in ((rng.random(n) < 0.67).astype(np.float32),
                 np.ones(n, np.float32)):
        Y, S, Mk = (torch.from_numpy(a) for a in (y, s, mask))
        jy, js, jm = (jnp.asarray(a) for a in (y, s, mask))
        got = float(pdm.aupr_dev(Y, S, Mk))
        assert abs(got - float(jdm.aupr_dev(jy, js, jm))) <= 1e-6
        assert abs(float(pdm.auroc_dev(Y, S, Mk))
                   - float(jdm.auroc_dev(jy, js, jm))) <= 1e-6
        sel = mask > 0
        assert abs(got - jmetrics.aupr_score(y[sel], s[sel])) <= 1e-6
