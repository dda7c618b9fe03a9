"""K5's plain walks and K12's plain writes against the JAX package on the
CPU, and the operation count of their bounds.

The CUDA kernels are held bit for bit to these plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`); here the plain versions
are held to the JAX package at the tree counts and class counts the card
tests use: 1, TC - 1, TC, TC + 1 and 200 trees, TC = K5_CHUNK_PAIRS / R
for R = 1, 8 and 64 (the trees a K5 chunk holds), forests of m = 1, 2, 8, 9 and
11 classes, and softmax boosting of K = 3 and 12 classes. Inputs come from
a numpy seed; split bins of n_bins (never fire) are among the tables.

Tolerances:
- the walks (`predict_gbt_margin`, `predict_forest`,
  `predict_gbt_multiclass_margin`): the port adds each row's T leaf values
  in tree order, the JAX package in chunks of trees whose sum order XLA
  picks, so each output is held within the summation bound of two orders,
  2 (T - 1) 2^-24 sum_t |v_t| (times the learning rate, or over T for the
  forest's mean), and the leaves each row reaches are equal;
- K12's plain writes (`write_cast_rows_plain`, `bin_write_rows_plain`,
  `dual_write_rows_plain`) against the JAX package's jitted
  `_write_cast_rows`, `_bin_write_rows` and `_dual_write_rows`, and the
  dequantizing ones against `_dequant_*write_rows`, on
  `chip_smoke.hostile_edges` (unsorted, duplicate, NaN, +-inf and +-0
  edges) and `hostile_values`, up to 2100 features (many of K12's
  256-feature windows): bit for bit (bf16 as bits; NaN is 0x7FC0 in both on the CPU);
- `chip_smoke.count_ops` (the compares of K4's and K12's bounds): equal
  to the count worked by hand.

K5's launch plan lives in csrc/tree_walk.cu; `tests/test_torch_cuda.py`
holds it on the card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.parallel import bigdata as jbd
from transmogrifai_tpu_torch.models import trees as pt
from transmogrifai_tpu_torch.parallel import bigdata as pbd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (hostile edges and values)

D, DEPTH, N_BINS = 9, 4, 16
# the tree counts around a K5 chunk (TC = K5_CHUNK_PAIRS / R) for R = 1, 8,
# 64
TREE_COUNTS = sorted({1, 200} | {cs.K5_CHUNK_PAIRS // r + k
                                 for r in (1, 8, 64) for k in (-1, 0, 1)})


def _tables(rng, T, m, depth=DEPTH):
    width = 2 ** depth
    feat = rng.integers(0, D, (T, depth, width)).astype(np.int32)
    bins = rng.integers(0, N_BINS + 1, (T, depth, width)).astype(np.int32)
    bins[:, 1, ::3] = N_BINS  # never fires: every row goes left
    leaf = rng.normal(size=(T, width, m)).astype(np.float32)
    return {"feat": feat, "bin": bins, "leaf": leaf}


def _Xb(rng, n):
    return rng.integers(0, N_BINS, (n, D)).astype(np.int8)


def _sum_bound(Xb, tables):
    """Per (row, channel): 2 (T - 1) 2^-24 sum_t |v_t| over the leaf values
    the row reaches (the plain walk's own nodes)."""
    t = {k: torch.from_numpy(v) for k, v in tables.items()}
    node = pt._walk_nodes(torch.from_numpy(Xb), t["feat"], t["bin"])
    T, n = node.shape
    m = t["leaf"].shape[-1]
    vals = torch.gather(t["leaf"], 1, node[:, :, None].expand(T, n, m))
    return (2 * max(T - 1, 0) * 2.0 ** -24
            * vals.double().abs().sum(0)).numpy()


@pytest.mark.parametrize("T", TREE_COUNTS)
def test_plain_gbt_margin_matches_jax_at_chunk_tree_counts(T):
    rng = np.random.default_rng(T)
    tables = _tables(rng, T, 1)
    Xb = _Xb(rng, 70)
    want = np.asarray(jt.predict_gbt_margin(
        {k: jnp.asarray(v) for k, v in tables.items()}, jnp.asarray(Xb),
        jnp.float32(0.3)))
    got = pt.predict_gbt_margin({k: torch.from_numpy(v)
                                 for k, v in tables.items()},
                                torch.from_numpy(Xb), 0.3).numpy()
    bound = 0.3 * _sum_bound(Xb, tables)[:, 0] + 2.0 ** -24 * np.abs(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("m", [1, 2, 8, 9, 11])
@pytest.mark.parametrize("T", [1, 200, cs.K5_CHUNK_PAIRS // 8 + 1])
def test_plain_forest_matches_jax_at_every_class_count(T, m):
    rng = np.random.default_rng(100 * m + T)
    tables = _tables(rng, T, m)
    tables["leaf"] = np.abs(tables["leaf"])  # class scores are >= 0
    Xb = _Xb(rng, 65)
    want = np.asarray(jt.predict_forest(
        {k: jnp.asarray(v) for k, v in tables.items()}, jnp.asarray(Xb)))
    got = pt.predict_forest({k: torch.from_numpy(v)
                             for k, v in tables.items()},
                            torch.from_numpy(Xb)).numpy()
    bound = _sum_bound(Xb, tables) / T + 2.0 ** -24 * np.abs(want)
    assert got.shape == (65, m)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("K,T", [(3, 200), (3, 342), (12, 1), (12, 86)])
def test_plain_multiclass_margin_matches_jax(K, T):
    """Softmax boosting's (round, class) walk: 342 rounds of 3 classes and
    86 of 12 put a K5-mc chunk boundary (1024 flat trees) inside a
    round."""
    rng = np.random.default_rng(K * 1000 + T)
    flat = _tables(rng, T * K, 1)
    tables = {k: v.reshape((T, K) + v.shape[1:]) for k, v in flat.items()}
    Xb = _Xb(rng, 40)
    want = np.asarray(jt.predict_gbt_multiclass_margin(
        {k: jnp.asarray(v) for k, v in tables.items()}, jnp.asarray(Xb),
        jnp.float32(0.1)))
    t = {k: torch.from_numpy(v) for k, v in tables.items()}
    got = pt.predict_gbt_multiclass_margin(t, torch.from_numpy(Xb),
                                           0.1).numpy()
    # each class's rounds: the bound over that class's T trees
    bound = np.stack([0.1 * _sum_bound(Xb, {k: v[:, c] for k, v in
                                            tables.items()})[:, 0]
                      for c in range(K)], axis=1)
    bound += 2.0 ** -24 * np.abs(want)
    assert got.shape == (40, K)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    # the plain walk itself: every (row, class) sum adds its rounds in
    # index order, as K5-mc does
    node = pt._walk_nodes(torch.from_numpy(Xb), t["feat"].flatten(0, 1),
                          t["bin"].flatten(0, 1)).reshape(T, K, -1)
    vals = torch.gather(t["leaf"][..., 0], 2, node)
    acc = torch.zeros((K, Xb.shape[0]))
    for r in range(T):
        acc = acc + vals[r]
    assert torch.equal(pt.tree_walk_classes_plain(
        torch.from_numpy(Xb), t["feat"], t["bin"], t["leaf"]), acc.T)


def _torch_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("d,n_edges", [(12, 31), (13, 15), (7, 126),
                                       (1100, 31), (2100, 31)])
def test_plain_writes_equal_the_jax_packages_on_hostile_edges(d, n_edges):
    rng = np.random.default_rng(d * 100 + n_edges)
    e = cs.hostile_edges(rng, d, n_edges).astype(np.float16).astype(
        np.float32)
    ch = cs.hostile_values(rng, 300, e).astype(np.float16)
    n, r0 = 400, 37
    chunk, edges = torch.from_numpy(ch), torch.from_numpy(e)
    # bf16 and f32 widening
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        buf = torch.full((n, d), 5.0, dtype=tdt)
        pbd.write_cast_rows_plain(buf, chunk, r0)
        want = jbd._write_cast_rows(jnp.full((n, d), 5.0, jdt),
                                    jnp.asarray(ch), r0)
        np.testing.assert_array_equal(_torch_bits(buf),
                                      np.asarray(want).view(
                                          np.uint16 if tdt == torch.bfloat16
                                          else np.float32))
    bufb = torch.full((n, d), 9, dtype=torch.int8)
    pbd.bin_write_rows_plain(bufb, chunk, edges, r0)
    wantb = jbd._bin_write_rows(jnp.full((n, d), 9, jnp.int8),
                                jnp.asarray(ch), jnp.asarray(e), r0)
    np.testing.assert_array_equal(bufb.numpy(), np.asarray(wantb))
    b16 = torch.zeros((n, d), dtype=torch.bfloat16)
    bb = torch.zeros((n, d), dtype=torch.int8)
    pbd.dual_write_rows_plain(b16, bb, chunk, edges, r0)
    w16, wb = jbd._dual_write_rows(jnp.zeros((n, d), jnp.bfloat16),
                                   jnp.zeros((n, d), jnp.int8),
                                   jnp.asarray(ch), jnp.asarray(e), r0)
    np.testing.assert_array_equal(_torch_bits(b16),
                                  np.asarray(w16).view(np.uint16))
    np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))
    # the hostile values reach every kind of edge: NaN rows land in bin 0
    assert (bb.numpy()[r0:r0 + 300][np.isnan(ch.astype(np.float32))]
            == 0).all()


@pytest.mark.parametrize("bits,d", [(8, 12), (4, 12), (4, 13), (8, 1100),
                                    (4, 2100), (4, 2101)])
def test_plain_dequant_writes_equal_the_jax_packages_on_hostile_edges(bits,
                                                                       d):
    rng = np.random.default_rng(bits * 10 + d)
    c, n, r0 = 64, 120, 11
    q = rng.integers(0, 1 << bits, (c, d)).astype(np.uint8)
    scale = rng.uniform(0.01, 2.0, d).astype(np.float32)
    lo = (rng.normal(size=d) * 4).astype(np.float32)
    x = pbd.unpack_dequant_plain(torch.from_numpy(q), torch.from_numpy(scale),
                                 torch.from_numpy(lo), 8, d).numpy()
    e = cs.hostile_edges(rng, d, 31)
    e[0::6, 5] = x[3, 0::6]  # a value on a sorted feature's edge
    e[0::6] = np.sort(e[0::6], axis=1)
    wire = q if bits == 8 else np.concatenate(
        [q, np.zeros((c, d % 2), np.uint8)], 1)
    if bits == 4:
        wire = (wire[:, 0::2] | (wire[:, 1::2] << 4)).astype(np.uint8)
    t = [torch.from_numpy(a) for a in (wire, scale, lo, e)]
    j = [jnp.asarray(a) for a in (wire, scale, lo, e)]
    b16 = torch.zeros((n, d), dtype=torch.bfloat16)
    bb = torch.zeros((n, d), dtype=torch.int8)
    pbd.dequant_dual_write_rows_plain(b16, bb, *t, r0, bits)
    w16, wb = jbd._dequant_dual_write_rows(
        jnp.zeros((n, d), jnp.bfloat16), jnp.zeros((n, d), jnp.int8), *j,
        r0, bits=bits)
    np.testing.assert_array_equal(_torch_bits(b16),
                                  np.asarray(w16).view(np.uint16))
    np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))
    bb2 = torch.zeros((n, d), dtype=torch.int8)
    pbd.dequant_bin_write_rows_plain(bb2, *t, r0, bits)
    assert torch.equal(bb2, bb)


# --------------------------------------------------------------------------- #
# the bounds' operation count                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_edges", [1, 15, 31, 32, 126])
def test_count_ops_searches_sorted_features_and_counts_the_rest(n_edges):
    """ceil(log2(n_edges + 1)) compares a value of a non-decreasing
    feature, n_edges of an unsorted one or one with a NaN edge."""
    rng = np.random.default_rng(n_edges)
    e = np.sort(rng.normal(size=(6, n_edges)), axis=1).astype(np.float32)
    if n_edges > 1:
        e[1] = e[1, ::-1]  # decreasing
        e[2, n_edges // 2] = np.nan
    e[3] = 0.0  # all equal: non-decreasing
    search = int(np.ceil(np.log2(n_edges + 1)))
    unsorted = 2 if n_edges > 1 else 0
    want = 7 * ((6 - unsorted) * search + unsorted * n_edges)
    assert cs.count_ops(torch.from_numpy(e), 7) == want
    assert cs.count_ops(torch.from_numpy(e).half(), 7) == want


@pytest.mark.parametrize("depth,m", [(1, 1), (3, 2), (6, 1), (10, 3)])
def test_predict_tree_dense_equals_jax_and_the_walk(depth, m):
    """K15 (`predict_tree_dense`, one tree's predict as one-hot products)
    in the port's f32 against the JAX package's bf16 operands with f32
    accumulation, and against `tree_walk_plain` on the same tree: bit for
    bit (bin ids up to N_BINS and 0/1 path products are exact in both,
    and one weight of 1 selects each row's leaf). Split bins of N_BINS
    (never fire) are among the tables."""
    rng = np.random.default_rng(15 + depth)
    n, width = 300, 2 ** depth
    feat = rng.integers(0, D, (depth, width)).astype(np.int32)
    bins = rng.integers(0, N_BINS + 1, (depth, width)).astype(np.int32)
    leaf = rng.normal(size=(width, m)).astype(np.float32)
    Xb = rng.integers(0, N_BINS + 1, (n, D)).astype(np.int32)
    want = np.asarray(jt.predict_tree_dense(
        {"feat": jnp.asarray(feat), "bin": jnp.asarray(bins),
         "leaf": jnp.asarray(leaf)}, jnp.asarray(Xb)))
    tree = {"feat": torch.from_numpy(feat), "bin": torch.from_numpy(bins),
            "leaf": torch.from_numpy(leaf)}
    got = pt.predict_tree_dense(tree, torch.from_numpy(Xb)).numpy()
    walk = pt.tree_walk_plain(torch.from_numpy(Xb), tree["feat"][None],
                              tree["bin"][None], tree["leaf"][None]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, walk)
