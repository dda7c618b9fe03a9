"""The port's tree-learner device programs against the JAX package's, on
the CPU (the plain PyTorch versions; the CUDA kernels are held to these on
the card in tests/test_torch_cuda.py and chip_smoke.py).

Seeded numpy inputs at a small size: n = 257 rows, d = 7 features, 8 and
32 bins, depth 4, P = 3 pairs. The JAX package's histograms run in exact
f32 (`HIST_PRECISION` patched to "f32", as tests/test_models.py does);
its bf16 default differs by design.

Tolerances:
- K1 histograms: rtol 1e-5, atol 1e-5 (XLA's f32 matmul sums rows in
  another order than `index_add_`'s row order);
- K2 split choice: bins equal, and features equal wherever the node
  splits, from the same histograms (ties from duplicate columns go to the
  first index in both). A node that does not split (bin = n_bins) keeps
  the argmax of gains at or below its threshold, often rounding noise
  around 0, and its feature never routes a row;
- K3 trees: split bins equal, split features equal where the node
  splits, leaf values atol 1e-6, final node ids equal;
- K8 binned AuPR: atol 1e-6 (JAX sums the curve in f32, the port in f64
  rounded once); bucket ids equal for scores at least 1e-3 of a bucket's
  width from an edge, which is at least 32 f32 ulps of the score at every
  score (`_margins` makes every row so, and the test checks it). Within an
  ulp or two of an edge, XLA's f32 exp may land on either side, and not
  the same side in every process; the port's buckets come from the f64
  sigmoid rounded to f32 once, so they equal numpy's f64 reference there
  and lie at most one bucket from JAX's;
- sorted AuPR / AuROC and confusion metrics: atol 1e-6; host metrics:
  equal (the same numpy code).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu.evaluators import metrics as jmetrics
from transmogrifai_tpu_torch.models import trees as pt
from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
from transmogrifai_tpu_torch.evaluators import metrics as pmetrics

N, D, DEPTH, P = 257, 7, 4, 3


@pytest.fixture(autouse=True)
def exact_histograms(monkeypatch):
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")


def _inputs(seed, n_bins, dup=True):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, (N, D)).astype(np.int8)
    if dup:
        Xb[:, 3] = Xb[:, 1]  # a duplicate column: exact gain ties
    G = rng.normal(size=(P, 1, N)).astype(np.float32)  # m = 1 channel
    H = rng.uniform(0.05, 1.0, size=(P, N)).astype(np.float32)
    H[:, rng.integers(0, N, 20)] = 0.0  # zero-weight rows
    return Xb, G, H


def _nodes(seed, n_nodes):
    rng = np.random.default_rng(seed + 1)
    node = rng.integers(0, n_nodes, (P, N)).astype(np.int32)
    node[:, :5] = 0
    return node


@pytest.mark.parametrize("n_bins,n_nodes", [(8, 1), (8, 4), (32, 8)])
def test_histograms_plain_matches_jax(n_bins, n_nodes):
    Xb, G, H = _inputs(n_bins + n_nodes, n_bins)
    node = _nodes(n_bins, n_nodes)
    got_g, got_h = pt.histograms(torch.from_numpy(Xb),
                                 torch.from_numpy(node),
                                 torch.from_numpy(G), torch.from_numpy(H),
                                 n_nodes, n_bins)
    assert got_g.shape == (P, 1, n_nodes, D, n_bins)
    B = jt.bins_onehot(jnp.asarray(Xb), n_bins)
    for p in range(P):
        hg, hh = jt._histograms(B, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T),
                                jnp.asarray(H[p]), n_nodes)
        np.testing.assert_allclose(got_g[p].numpy(), np.asarray(hg),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_h[p].numpy(), np.asarray(hh),
                                   rtol=1e-5, atol=1e-5)


def test_histograms_of_an_empty_node_are_zero():
    Xb, G, H = _inputs(3, 8)
    node = np.zeros((P, N), np.int32)  # nodes 1..3 hold no rows
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H), 4, 8)
    assert not hg[:, 1:].any() and not hh[:, 1:].any()


def test_node_segments_group_rows_stably():
    node = torch.tensor([[2, 0, 2, 1, 0], [0, 0, 0, 0, 0]],
                        dtype=torch.int32)
    order, seg = pt.node_segments(node, 4)
    assert order.tolist() == [[1, 4, 3, 0, 2], [0, 1, 2, 3, 4]]
    assert seg.tolist() == [[0, 2, 3, 5, 5], [0, 5, 5, 5, 5]]


SPLIT_CASES = [
    # (mcw, min_gain, min_gain_norm, masked, level, active_depth)
    (1.0, 0.0, 0.0, False, 2, None),
    (25.0, 0.0, 0.0, False, 2, None),     # invalid (child weight) cells
    (1.0, 0.5, 0.0, True, 1, None),       # feature mask, raw gamma
    (1.0, 0.0, 0.05, False, 3, 3),        # normalized gain, level cut
    (1e9, 0.0, 0.0, False, 0, None),      # no valid cell anywhere
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("n_bins", [8, 32])
def test_split_search_plain_matches_jax(case, n_bins):
    mcw, min_gain, mgn, masked, level, active = case
    Xb, G, H = _inputs(11 + n_bins, n_bins)
    n_nodes = 2 ** level
    node = _nodes(5, n_nodes)
    B = jt.bins_onehot(jnp.asarray(Xb), n_bins)
    fmask = np.ones((P, D), bool)
    if masked:
        fmask[:, [0, 2]] = False
        fmask[1, 5] = False
    hgs, hhs, want_f, want_b = [], [], [], []
    for p in range(P):
        hg, hh = jt._histograms(B, jnp.asarray(node[p]),
                                jnp.asarray(G[p].T),
                                jnp.asarray(H[p]), n_nodes)
        bf, bb = jt.split_from_histograms(
            hg, hh, n_bins, 1.0, mcw, min_gain, mgn,
            jnp.asarray(fmask[p]) if masked else None, level,
            None if active is None else jnp.int32(active))
        hgs.append(np.asarray(hg))
        hhs.append(np.asarray(hh))
        want_f.append(np.asarray(bf))
        want_b.append(np.asarray(bb))
    got_f, got_b = pt.split_search(
        torch.from_numpy(np.stack(hgs)), torch.from_numpy(np.stack(hhs)),
        n_bins, 1.0, mcw, min_gain, mgn,
        torch.from_numpy(fmask) if masked else None, level, active)
    np.testing.assert_array_equal(got_b.numpy(), np.stack(want_b))
    split = np.stack(want_b) < n_bins
    np.testing.assert_array_equal(got_f.numpy()[split],
                                  np.stack(want_f)[split])


def test_split_search_ties_go_to_the_first_index():
    """Two identical columns: the earlier one wins in both packages."""
    Xb, G, H = _inputs(7, 8)
    Xb[:, 4] = Xb[:, 0]
    Xb[:, 6] = Xb[:, 0]
    node = np.zeros((P, N), np.int32)
    hg, hh = pt.histograms(torch.from_numpy(Xb), torch.from_numpy(node),
                           torch.from_numpy(G), torch.from_numpy(H), 1, 8)
    hg[:, :, :, 1:4] = 0.0  # only columns 0, 4, 6 (equal) and 5 can win
    hh[:, :, 1:4] = 0.0
    feat, _ = pt.split_search(hg, hh, 8, 1.0, 1.0, 0.0, 0.0, None, 0, None)
    for p in range(P):
        jf, _ = jt.split_from_histograms(
            jnp.asarray(hg[p].numpy()), jnp.asarray(hh[p].numpy()), 8,
            1.0, 1.0, 0.0, 0.0, None, 0, None)
        assert int(feat[p, 0]) == int(jf[0])
        assert int(feat[p, 0]) not in (4, 6)


@pytest.mark.parametrize("n_bins", [8, 32])
@pytest.mark.parametrize("alpha", [0.0, 0.3])
def test_grow_trees_plain_matches_jax(n_bins, alpha):
    Xb, G, H = _inputs(21 + n_bins, n_bins)
    mcws = [1.0, 3.0, 0.5]
    gammas = [0.0, 0.2, 0.05]
    active = [DEPTH, 2, DEPTH]
    fmask = np.ones((P, D), bool)
    fmask[2, [1, 6]] = False
    tree, node = pt.grow_trees(
        torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H),
        DEPTH, n_bins, reg_lambda=1.0, min_child_weight=mcws,
        min_gain=gammas, feature_mask=torch.from_numpy(fmask),
        active_depth=active, alpha=alpha, min_gain_norm=0.0)
    assert tree["feat"].shape == (P, DEPTH, 2 ** DEPTH)
    assert tree["leaf"].shape == (P, 2 ** DEPTH, 1)
    for p in range(P):
        want = jt.grow_tree(jnp.asarray(Xb), jnp.asarray(G[p].T),
                            jnp.asarray(H[p]), DEPTH, n_bins,
                            reg_lambda=1.0, min_child_weight=mcws[p],
                            min_gain=gammas[p],
                            feature_mask=jnp.asarray(fmask[p]),
                            active_depth=jnp.int32(active[p]), alpha=alpha)
        np.testing.assert_array_equal(tree["bin"][p].numpy(),
                                      np.asarray(want["bin"]))
        split = np.asarray(want["bin"]) < n_bins
        np.testing.assert_array_equal(tree["feat"][p].numpy()[split],
                                      np.asarray(want["feat"])[split])
        np.testing.assert_allclose(tree["leaf"][p].numpy(),
                                   np.asarray(want["leaf"]), rtol=0,
                                   atol=1e-6)
        walked = jt._tree_walk(want, jnp.asarray(Xb))
        np.testing.assert_array_equal(node[p].numpy(), np.asarray(walked))


def test_route_level_and_leaf_values_plain():
    Xb, G, H = _inputs(2, 8)
    node = torch.from_numpy(_nodes(2, 4))
    feat = torch.tensor([[0, 1, 2, 3]] * P, dtype=torch.int32)
    bins = torch.tensor([[3, 8, 0, 5]] * P, dtype=torch.int32)
    out = pt.route_level(torch.from_numpy(Xb), node, feat, bins)
    Xl = torch.from_numpy(Xb).long()
    for p in range(P):
        for r in range(N):
            k = int(node[p, r])
            right = int(Xl[r, int(feat[p, k])] > bins[p, k])
            assert int(out[p, r]) == 2 * k + right
    assert not (out % 2)[node == 1].any()  # bin 8 = n_bins never fires
    leaf = pt.leaf_values(out, torch.from_numpy(G), torch.from_numpy(H), 8,
                          [1.0, 2.0, 0.5], [0.0, 0.1, 0.0])
    for p, (lam, a) in enumerate([(1.0, 0.0), (2.0, 0.1), (0.5, 0.0)]):
        for k in range(8):
            sel = (out[p] == k).numpy()
            g = np.float32(0)
            h = np.float32(0)
            for r in np.flatnonzero(sel):  # row order, as both sum
                g = np.float32(g + G[p, 0, r])
                h = np.float32(h + H[p, r])
            g = np.float32(np.sign(g) * max(abs(g) - np.float32(a), 0))
            assert leaf[p, k, 0].item() == np.float32(g / np.float32(h + lam))


# the least distance of a score from a 512-bucket edge in `_margins`, as a
# share of a bucket's width
EDGE_GAP = 1e-3


def _sigmoid64(m):
    return 1.0 / (1.0 + np.exp(-np.asarray(m, dtype=np.float64)))


def _margins(seed, n=N):
    """(P, n) f32 margins whose scores lie in random 512-buckets, every one
    at least EDGE_GAP of a bucket's width from the bucket's edges; a
    quarter of the rows at just that distance, either side of an edge."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 512, (P, n))
    frac = rng.uniform(EDGE_GAP, 1.0 - EDGE_GAP, (P, n))
    q = n // 4
    frac[:, :q] = np.where(rng.random((P, q)) < 0.5, EDGE_GAP,
                           1.0 - EDGE_GAP)
    s = (k + frac) / 512.0
    return np.log(s / (1.0 - s)).astype(np.float32)


def _jax_buckets(m):
    return np.asarray(jnp.minimum((jax.nn.sigmoid(jnp.asarray(m)) * 512)
                                  .astype(jnp.int32), 511))


def test_score_buckets_match_jax_off_the_edges():
    m = _margins(3, 4096)
    s = _sigmoid64(m)
    gap = np.abs(s * 512 - np.round(s * 512)) / 512
    ulps = gap / np.spacing(s.astype(np.float32)).astype(np.float64)
    assert gap.min() >= 0.99 * EDGE_GAP / 512 and ulps.min() >= 32, \
        (gap.min(), ulps.min())
    got = pdm.score_bins(torch.from_numpy(m), 512, from_margin=True)
    np.testing.assert_array_equal(got.numpy(), _jax_buckets(m))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_buckets_near_the_edges_within_one_bucket(seed):
    """Scores within two f32 ulps of an edge: the port's buckets equal the
    f64 reference rounded to f32 once, and lie at most one bucket from
    XLA's f32 formula."""
    rng = np.random.default_rng(seed)
    edge = (rng.integers(1, 512, (P, N)) / 512.0).astype(np.float32)
    steps = rng.integers(-2, 3, (P, N)).astype(np.float32)
    s = (edge.astype(np.float64)
         + steps * np.spacing(edge).astype(np.float64))
    m = np.log(s / (1.0 - s)).astype(np.float32)
    got = pdm.score_bins(torch.from_numpy(m), 512, from_margin=True).numpy()
    ref = np.minimum((_sigmoid64(m).astype(np.float32)
                      * np.float32(512)).astype(np.int32), 511)
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got - _jax_buckets(m)).max() <= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gbt_val_loss_aupr_matches_jax(seed):
    m = _margins(seed)
    rng = np.random.default_rng(seed + 10)
    y = (rng.random(N) < 0.4).astype(np.float32)
    vw = (rng.random((P, N)) < 0.3).astype(np.float32)
    got = pt.gbt_val_loss(torch.from_numpy(m), torch.from_numpy(y),
                          torch.from_numpy(vw), "aupr")
    for p in range(P):
        want = jt._gbt_val_loss(jnp.asarray(m[p]), jnp.asarray(y),
                                jnp.asarray(vw[p]), "logistic", "aupr")
        assert abs(float(got[p]) - float(want)) <= 1e-6
    ll = pt.gbt_val_loss(torch.from_numpy(m), torch.from_numpy(y),
                         torch.from_numpy(vw), "logloss")
    for p in range(P):
        want = jt._gbt_val_loss(jnp.asarray(m[p]), jnp.asarray(y),
                                jnp.asarray(vw[p]), "logistic", "logloss")
        assert abs(float(ll[p]) - float(want)) <= 1e-6


def test_binned_aupr_without_positives_is_zero():
    m = torch.from_numpy(_margins(4))
    y = torch.zeros(N)
    w = torch.ones((P, N))
    assert not pdm.binned_aupr(m, y, w, 512, True).any()


@pytest.mark.parametrize("seed", [0, 5])
def test_device_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    y = (rng.random(n) < 0.35).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    s[::7] = np.round(s[::7], 1)  # ties
    mask = (rng.random(n) < 0.7).astype(np.float32)
    Y, S, M = (torch.from_numpy(a) for a in (y, s, mask))
    jy, js, jm = (jnp.asarray(a) for a in (y, s, mask))
    assert abs(float(pdm.aupr_dev(Y, S, M))
               - float(jdm.aupr_dev(jy, js, jm))) <= 1e-6
    assert abs(float(pdm.auroc_dev(Y, S, M))
               - float(jdm.auroc_dev(jy, js, jm))) <= 1e-6
    assert abs(float(pdm.aupr_binned_dev(Y, S, M))
               - float(jdm.aupr_binned_dev(jy, js, jm))) <= 1e-6
    got = pdm.binary_confusion_dev(Y, S, M)
    want = jdm.binary_confusion_dev(jy, js, jm)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    sel = mask > 0
    assert pmetrics.aupr_score(y[sel], s[sel]) == \
        jmetrics.aupr_score(y[sel], s[sel])
    assert pmetrics.auroc_score(y[sel], s[sel]) == \
        jmetrics.auroc_score(y[sel], s[sel])
    assert pmetrics.binary_metrics(y, s).to_json() == \
        jmetrics.binary_metrics(y, s).to_json()


def test_fit_gbt_pairs_matches_jax_fit_gbt():
    """Three pairs of one early-stopped boosting fit (fold masks, 512-bucket
    AuPR stopping) against the JAX package's `fit_gbt`, pair by pair."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(N, D)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 2] + rng.normal(size=N)) > 0) \
        .astype(np.float32)
    edges = jt.quantile_bin_edges(X, 16)
    np.testing.assert_array_equal(pt.quantile_bin_edges(X, 16), edges)
    Xb = np.array(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    fold = rng.integers(0, P, N)
    W = np.stack([(fold != k) for k in range(P)]).astype(np.float32)
    V = 1.0 - W
    mcw = [1.0, 5.0, 2.0]
    _, margin, since = pt.fit_gbt_pairs(
        torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(W),
        30, 3, 16, 0.3, 1.0, mcw, active_depth=3, gamma=0.1,
        val_w=torch.from_numpy(V), early_stopping_rounds=4,
        eval_metric="aupr")
    for p in range(P):
        _, want = jt.fit_gbt(jnp.asarray(Xb), jnp.asarray(y),
                             jnp.asarray(W[p]), 30, 3, 16, 0.3, 1.0,
                             "logistic", mcw[p], active_depth=3, gamma=0.1,
                             val_w=jnp.asarray(V[p]),
                             early_stopping_rounds=4, eval_metric="aupr")
        np.testing.assert_allclose(margin[p].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
