"""K2's live set and K3's out-of-place routing with flags, on the CPU (the
plain PyTorch versions, which take the same flags as the kernels; the
CUDA kernels are held to them on the card in tests/test_torch_cuda.py and
chip_smoke.py), against the JAX package.

Seeded numpy inputs at a small size: n = 300 rows, d = 8 features, 16
bins, depth 12 (the sibling-subtraction path), P = 3 pairs, with float
GBT-like gradients (normal G, uniform H; also with min_child_weight 0 and
a negative gamma, so that a split may leave its left side empty), the
same on a 1/8 grid, and an integer-valued forest chunk (one-hot labels
times Poisson bootstrap counts; also with lambda 0 and min_child_weight
0, where an empty node's gains are 0/0 = NaN). The JAX
package runs in its exact-f32 histogram mode (`HIST_PRECISION` patched to
"f32", as tests/test_models.py does; it subtracts siblings only there).

The live set of a level is the nodes K3's routing flagged as holding rows
and, on the subtraction path, the left child 2j of every node j searched
a level up (a left child is parent − right, which can keep a rounding
residue without rows). Tolerances:
- the live set contains every node with a non-zero histogram cell:
  exact. With float gradients, min_child_weight 0 and gamma -1, left
  children without rows carry parent − right's residue (the first, at
  level 6 of pair 1, node 48: |cell| <= 6e-7); with min_child_weight > 0
  and gamma >= 0 no left child is empty (a split's sides both hold
  weight, and a node that does not split sends its rows left), so the
  other cases show none;
- split tables from the live-set search: equal to the dense search (every
  node searched) and, on the integer forest, to the JAX package's
  `split_from_histograms` on every node, from the same histograms (exact
  sums). With float gradients XLA's `cumsum` adds the bins in another
  order than the port's sequential running sums, so gains differ in the
  last ulps: bins equal, features equal where the node splits (as
  tests/test_torch_train_kernels.py holds them);
- routing: node ids equal to the JAX package's routing step, flags equal
  to the set of node ids (a bincount > 0);
- `grow_trees` with the live set: tables, leaves and node ids bit-equal
  to `grow_trees(live=False)` in every case; against the JAX package's
  `grow_tree` (f32 mode) where the sums are exact (the integer forest, and
  gradients and hessians on a 1/8 grid): tables equal, leaves atol 1e-6
  (XLA may divide by a reciprocal), final node ids equal. With float
  gradients near-tie splits go either way at depth 12 (sum order), as
  tests/test_torch_forest.py notes for regression forests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import trees as pt

N, D, B, DEPTH, P = 300, 8, 16, 12, 3


@pytest.fixture(autouse=True)
def exact_histograms(monkeypatch):
    monkeypatch.setattr(jt, "HIST_PRECISION", "f32")


def _binned(rng):
    Xb = rng.integers(0, B, (N, D)).astype(np.int8)
    Xb[:, 5] = Xb[:, 2]  # a duplicate column: exact gain ties
    return Xb


def _gbt_values(seed):
    rng = np.random.default_rng(seed)
    Xb = _binned(rng)
    G = rng.normal(size=(P, 1, N)).astype(np.float32)
    H = rng.uniform(0.05, 1.0, size=(P, N)).astype(np.float32)
    return Xb, G, H


def _gbt_grid_values(seed):
    """Gradients and hessians on a 1/8 grid: every f32 sum is exact, so the
    JAX package's trees come out equal to the port's, not only close."""
    rng = np.random.default_rng(seed)
    Xb = _binned(rng)
    G = np.round(rng.normal(size=(P, 1, N)) * 8) / 8
    H = rng.integers(1, 9, size=(P, N)) / 8
    return Xb, G.astype(np.float32), H.astype(np.float32)


def _forest_values(seed):
    rng = np.random.default_rng(seed)
    Xb = _binned(rng)
    y = (Xb[:, 0] + rng.integers(0, B, N) >= B).astype(np.int64)
    boot = rng.poisson(1.0, (P, N)).astype(np.float32)
    G = (np.eye(2, dtype=np.float32)[y].T[None] * boot[:, None, :])
    return Xb, G.astype(np.float32), boot


# (values, reg_lambda, min_child_weight, min_gain, min_gain_norm)
CASES = {
    "gbt_float": (_gbt_values, 1.0, [0.5, 1.0, 0.1], 0.0, 0.0),
    # min_child_weight 0 and a negative gamma: a node may split with no
    # rows on the left, whose histogram is then parent − right's residue
    "gbt_float_empty_left": (_gbt_values, 1.0, 0.0, -1.0, 0.0),
    "gbt_grid": (_gbt_grid_values, 1.0, [0.5, 1.0, 0.125], 0.0, 0.0),
    "forest_int": (_forest_values, 1e-6, [1.0, 0.0, 2.0], 0.0, 0.001),
    # lambda 0 and min_child_weight 0: an empty node's gains are 0/0 = NaN,
    # so the zero search yields NaN gains (no split) as the full one does
    "forest_nan": (_forest_values, 0.0, 0.0, 0.0, 0.0),
}


# the cases whose histogram sums are exact in any order
EXACT = ("gbt_grid", "forest_int", "forest_nan")


def _levels(case, seed=3):
    """The subtraction path of `grow_trees` step by step through the
    port's plain functions: per level the histograms, the live set (the
    flags K3 and K2's marks wrote), the live-set and dense searches and
    the routing. Returns the inputs and one record a level."""
    values, lam, mcw, mg, mgn = CASES[case]
    Xb, G, H = (torch.from_numpy(a) for a in values(seed))
    max_nodes = 2 ** DEPTH
    flags = torch.zeros((P, DEPTH, max_nodes), dtype=torch.uint8)
    node = torch.zeros((P, N), dtype=torch.int32)
    hg, hh = pt.histograms(Xb, node, G, H, 1, B)
    kw = dict(reg_lambda=lam, min_child_weight=mcw, min_gain=mg,
              min_gain_norm=mgn, feature_mask=None, active_depth=None)
    levels = []
    for level in range(DEPTH):
        n_nodes = 2 ** level
        live = flags[:, level, :n_nodes] if level else None
        nxt = flags[:, level + 1, :2 * n_nodes] if level + 1 < DEPTH else None
        f, b = pt.split_search(hg, hh, B, level=level, live=live, mark=nxt,
                               **kw)
        df, db = pt.split_search(hg, hh, B, level=level, **kw)
        rows = torch.zeros((P, n_nodes), dtype=torch.bool)
        rows.scatter_(1, node.long(), True)
        levels.append(dict(level=level, hg=hg, hh=hh, node=node,
                           live=None if live is None else live.clone(),
                           rows=rows, f=f, b=b, df=df, db=db))
        node = pt.route_level(Xb, node, f, b, occupied=nxt)
        if level + 1 < DEPTH:
            parent = torch.where((node & 1).bool(), node >> 1,
                                 torch.full_like(node, n_nodes))
            hg_r, hh_r = pt.histograms(Xb, parent, G, H, n_nodes, B)
            hg, hh = pt.sibling_subtract(hg, hh, hg_r, hh_r)
    return (Xb, G, H, kw), levels


def _nonzero(hg, hh):
    return (hh != 0).flatten(2).any(2) | (hg != 0).transpose(1, 2) \
        .flatten(2).any(2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_set_holds_every_node_with_a_non_zero_cell(case):
    _, levels = _levels(case)
    residues = []
    for rec in levels[1:]:
        live = rec["live"].bool()
        nonzero = _nonzero(rec["hg"], rec["hh"])
        assert not (nonzero & ~live).any(), rec["level"]
        assert not (rec["rows"] & ~live).any(), rec["level"]
        # live nodes without rows: left children searched for a residue
        for p, k in (live & ~rec["rows"]).nonzero().tolist():
            assert k % 2 == 0
            if nonzero[p, k]:
                residues.append((rec["level"], p, k))
    if case == "gbt_float_empty_left":
        # e.g. the first: (level, pair, node) of a left child with no rows
        # whose histogram is parent − right's rounding residue
        assert residues, "no left child without rows carries a residue"
        level, p, k = residues[0]
        rec = levels[level]
        assert not rec["rows"][p, k]
        assert float(rec["hh"][p, k].abs().max()
                     + rec["hg"][p, :, k].abs().max()) > 0
    else:
        # integer sums are exact, and with min_child_weight > 0 and gamma
        # >= 0 a split leaves rows on both sides (a node that does not
        # split sends every row left): no left child is empty
        assert not residues


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_search_equals_the_dense_search_and_jax(case):
    _, levels = _levels(case)
    exact = case in EXACT
    lam, mcw = CASES[case][1], CASES[case][2]
    mcws = mcw if isinstance(mcw, list) else [mcw] * P
    for rec in levels:
        assert torch.equal(rec["f"], rec["df"]), rec["level"]
        assert torch.equal(rec["b"], rec["db"]), rec["level"]
        for p in range(P):
            wf, wb = jt.split_from_histograms(
                jnp.asarray(rec["hg"][p].numpy()),
                jnp.asarray(rec["hh"][p].numpy()), B, lam, mcws[p],
                CASES[case][3], CASES[case][4], None, rec["level"], None)
            wf, wb = np.asarray(wf), np.asarray(wb)
            np.testing.assert_array_equal(rec["b"][p].numpy(), wb)
            split = wb < B
            if exact:
                np.testing.assert_array_equal(rec["f"][p].numpy(), wf)
            else:
                np.testing.assert_array_equal(rec["f"][p].numpy()[split],
                                              wf[split])
    if case == "forest_nan":  # every gain NaN somewhere: nothing splits
        assert all(bool((rec["b"] == B).all()) for rec in levels)


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_level_out_of_place_with_flags_matches_jax(case):
    (Xb, _, _, _), levels = _levels(case)
    for rec in levels[:-1]:
        node, f, b = rec["node"], rec["f"], rec["b"]
        n_nodes = f.shape[1]
        before = node.clone()
        occ = torch.zeros((P, 2 * n_nodes), dtype=torch.uint8)
        out = pt.route_level(Xb, node, f, b, occupied=occ)
        assert torch.equal(node, before)  # out of place
        for p in range(P):
            ff, bb = jnp.asarray(f[p].numpy()), jnp.asarray(b[p].numpy())
            nd = jnp.asarray(node[p].numpy())
            sample_bin = jt._select_bin(jnp.asarray(Xb.numpy()), ff[nd])
            want = nd * 2 + (sample_bin > bb[nd]).astype(jnp.int32)
            np.testing.assert_array_equal(out[p].numpy(), np.asarray(want))
            count = np.bincount(out[p].numpy(), minlength=2 * n_nodes)
            np.testing.assert_array_equal(occ[p].numpy(),
                                          (count > 0).astype(np.uint8))


def test_route_level_reads_split_tables_through_a_row_stride():
    (Xb, _, _, _), levels = _levels("gbt_float")
    rec = levels[5]
    table_f = torch.zeros((P, DEPTH, 64), dtype=torch.int32)
    table_b = torch.full((P, DEPTH, 64), B, dtype=torch.int32)
    table_f[:, 5, :32], table_b[:, 5, :32] = rec["f"], rec["b"]
    flags = torch.zeros((P, DEPTH, 64), dtype=torch.uint8)
    got = pt.route_level(Xb, rec["node"], table_f[:, 5, :32],
                         table_b[:, 5, :32], occupied=flags[:, 6, :])
    assert torch.equal(got, pt.route_level(Xb, rec["node"], rec["f"],
                                           rec["b"]))
    assert torch.equal(flags[:, 6].bool(),
                       torch.zeros((P, 64), dtype=torch.bool).scatter_(
                           1, got.long(), True))
    assert not flags[:, :6].any() and not flags[:, 7:].any()


def _grow(case, **extra):
    (Xb, G, H, kw), _ = _levels(case)
    args = dict(reg_lambda=kw["reg_lambda"],
                min_child_weight=kw["min_child_weight"],
                min_gain=kw["min_gain"], min_gain_norm=kw["min_gain_norm"])
    return (Xb, G, H, args), pt.grow_trees(Xb, G, H, DEPTH, B, **args,
                                           **extra)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_trees_with_the_live_set_equals_the_dense_search(case):
    (Xb, G, H, args), (tree, node) = _grow(case)
    dense, dnode = pt.grow_trees(Xb, G, H, DEPTH, B, live=False, **args)
    for k in ("feat", "bin"):
        assert torch.equal(tree[k], dense[k]), k
    # NaN leaves (0/0 at lambda 0) in the same places
    np.testing.assert_array_equal(tree["leaf"].numpy(),
                                  dense["leaf"].numpy())
    assert torch.equal(node, dnode)


@pytest.mark.parametrize("case", ["forest_int", "gbt_grid"])
def test_grow_trees_with_the_live_set_matches_jax(case):
    (Xb, G, H, args), (tree, node) = _grow(case)
    mcw = args["min_child_weight"]
    mcws = mcw if isinstance(mcw, list) else [mcw] * P
    for p in range(P):
        want = jt.grow_tree(jnp.asarray(Xb.numpy()), jnp.asarray(G[p].T),
                            jnp.asarray(H[p]), DEPTH, B,
                            reg_lambda=args["reg_lambda"],
                            min_child_weight=mcws[p],
                            min_gain=args["min_gain"],
                            min_gain_norm=args["min_gain_norm"])
        np.testing.assert_array_equal(tree["bin"][p].numpy(),
                                      np.asarray(want["bin"]))
        np.testing.assert_array_equal(tree["feat"][p].numpy(),
                                      np.asarray(want["feat"]))
        np.testing.assert_allclose(tree["leaf"][p].numpy(),
                                   np.asarray(want["leaf"]), rtol=0,
                                   atol=1e-6)
        walked = jt._tree_walk(want, jnp.asarray(Xb.numpy()))
        np.testing.assert_array_equal(node[p].numpy(), np.asarray(walked))


def test_split_search_writes_into_table_rows_in_place():
    _, levels = _levels("forest_int")
    rec = levels[4]
    feats = torch.zeros((P, DEPTH, 32), dtype=torch.int32)
    bins = torch.full((P, DEPTH, 32), B, dtype=torch.int32)
    here = (feats[:, 4, :16], bins[:, 4, :16])
    lam, mcw, mg, mgn = CASES["forest_int"][1:]
    got = pt.split_search(rec["hg"], rec["hh"], B, lam, mcw, mg, mgn, None,
                          4, None, live=rec["live"], out=here)
    assert got[0].data_ptr() == feats[:, 4].data_ptr()
    assert torch.equal(feats[:, 4, :16], rec["f"])
    assert torch.equal(bins[:, 4, :16], rec["b"])
    assert not feats[:, :4].any() and bool((bins[:, 5:] == B).all())
