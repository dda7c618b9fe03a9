"""K4 (binning) and K5 (ensemble walk) of the PyTorch port against the JAX
package's `bin_features`, `predict_gbt_margin` and `predict_forest`.

These run the port's plain PyTorch versions, which its wrappers take for
CPU tensors; the CUDA kernels are held against the same plain versions on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Inputs come from a numpy seed at small shapes (n = 257 rows, d = 13
features, 15 edges, 8 trees at depth 4, m in {1, 3}), with NaN cells and
values exactly on edges. Tolerances:
- bin ids: equal (the same f32 comparisons);
- tree sums (GBT margin, forest mean): atol 1e-5, because the 8 leaf
  values are summed in tree order here and by a vmapped reduction in the
  JAX program;
- predictions: equal where the margin is not within 1e-4 of 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import trees as pt

N, D, DEPTH, N_TREES = 257, 13, 4, 8


def _data(seed: int, n_edges: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    edges = np.sort(rng.normal(size=(D, n_edges)), axis=1).astype(np.float32)
    # values exactly on an edge, and missing cells
    r = rng.integers(0, N, 40)
    f = rng.integers(0, D, 40)
    X[r, f] = edges[f, rng.integers(0, n_edges, 40)]
    X[rng.integers(0, N, 10), rng.integers(0, D, 10)] = np.nan
    return X, edges


def _tables(seed: int, m: int, n_bins: int):
    rng = np.random.default_rng(seed)
    width = 2 ** DEPTH
    feat = rng.integers(0, D, (N_TREES, DEPTH, width)).astype(np.int32)
    # bin == n_bins is the "no split" marker: the walk always goes left
    bins = rng.integers(0, n_bins + 1, (N_TREES, DEPTH, width)).astype(
        np.int32)
    leaf = rng.normal(size=(N_TREES, width, m)).astype(np.float32)
    return {"feat": feat, "bin": bins, "leaf": leaf}


def _jax(tree_np):
    return {k: jnp.asarray(v) for k, v in tree_np.items()}


def _torch(tree_np):
    return {k: torch.from_numpy(v) for k, v in tree_np.items()}


@pytest.mark.parametrize("n_edges", [15, 200])
def test_bin_features_matches_jax(n_edges):
    X, edges = _data(0, n_edges)
    want = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(edges)))
    got = pt.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    assert got.dtype == (torch.int8 if n_edges == 15 else torch.int32)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    np.testing.assert_array_equal(got.numpy(), want)
    # NaN lands in bin 0; a value on an edge counts that edge
    assert (got.numpy()[np.isnan(X)] == 0).all()
    assert pt.bin_features(torch.tensor([[edges[0, 2]]]),
                           torch.from_numpy(edges[:1])).item() == 3


def test_cpu_wrappers_use_the_plain_versions_without_launching():
    X, edges = _data(1, 15)
    tables = _torch(_tables(1, 1, 16))
    before = dict(pt.LAUNCHES)
    Xb = pt.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    assert torch.equal(Xb, pt.bin_features_plain(torch.from_numpy(X),
                                                 torch.from_numpy(edges)))
    s = pt.tree_walk(Xb, tables["feat"], tables["bin"], tables["leaf"])
    assert torch.equal(s, pt.tree_walk_plain(
        Xb, tables["feat"], tables["bin"], tables["leaf"]))
    assert pt.LAUNCHES == before


@pytest.mark.parametrize("n_edges", [15, 200])
def test_gbt_margin_matches_jax(n_edges):
    X, edges = _data(2, n_edges)
    tables = _tables(2, 1, n_edges + 1)
    Xb_j = jt.bin_features(jnp.asarray(X), jnp.asarray(edges))
    want = np.asarray(jt.predict_gbt_margin(_jax(tables), Xb_j,
                                            jnp.float32(0.1)))
    Xb = pt.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    got = pt.predict_gbt_margin(_torch(tables), Xb, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_pred = {k: np.asarray(v) for k, v in
                 jt.gbt_pred_from_margin(jnp.asarray(want), "logistic").items()}
    got_pred = pt.gbt_pred_from_margin(torch.from_numpy(got), "logistic")
    decided = np.abs(want) > 1e-4
    np.testing.assert_array_equal(got_pred["prediction"].numpy()[decided],
                                  want_pred["prediction"][decided])
    np.testing.assert_allclose(got_pred["probability"].numpy(),
                               want_pred["probability"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [1, 3])
def test_forest_matches_jax(m):
    X, edges = _data(3, 15)
    tables = _tables(3, m, 16)
    tables["leaf"] = np.abs(tables["leaf"])  # class scores are >= 0
    Xb_j = jt.bin_features(jnp.asarray(X), jnp.asarray(edges))
    want = np.asarray(jt.predict_forest(_jax(tables), Xb_j))
    Xb = pt.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    got = pt.predict_forest(_torch(tables), Xb).numpy()
    assert got.shape == (N, m)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_pred = jt.forest_classification_pred(_jax(tables), Xb_j)
    got_pred = pt.forest_classification_pred(_torch(tables), Xb)
    np.testing.assert_allclose(got_pred["probability"].numpy(),
                               np.asarray(want_pred["probability"]),
                               rtol=0, atol=1e-5)


def test_walk_ignores_unused_table_slots():
    """At level l only the first 2^l slots are nodes; whatever the padding
    holds beyond them is never read."""
    X, edges = _data(4, 15)
    tables = _tables(4, 1, 16)
    Xb = pt.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    want = pt.tree_walk_plain(Xb, *_torch(tables).values())
    for level in range(DEPTH):
        tables["feat"][:, level, 2 ** level:] = 10 ** 6
        tables["bin"][:, level, 2 ** level:] = -(10 ** 6)
    got = pt.tree_walk_plain(Xb, *_torch(tables).values())
    assert torch.equal(got, want)
    model = pt.GBTClassificationModel(edges, tables, learning_rate=0.5)
    model.device_constants("cpu")  # the padding passes validation
    tables["feat"][0, 1, 1] = D
    with pytest.raises(ValueError, match="outside"):
        pt.GBTClassificationModel(edges, tables).device_constants("cpu")


def test_walk_rejects_mismatched_tables():
    Xb = torch.zeros((4, D), dtype=torch.int8)
    t = _torch(_tables(5, 1, 16))
    with pytest.raises(ValueError, match="leaves"):
        pt.tree_walk(Xb, t["feat"], t["bin"], t["leaf"][:, :8])
    with pytest.raises(ValueError, match="must be equal"):
        pt.tree_walk(Xb, t["feat"], t["bin"][:, :2], t["leaf"])
