"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips when no CUDA device is present.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them; `tests/conftest.py` imports jax, so run it there
with the conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: bin ids equal; tree sums equal, because kernel and plain
version add the same f32 leaf values in the same tree order.
"""

import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import trees as pt

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata",
                       "titanic_quickstart_gbt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _binning_inputs(rng, n, d, n_edges):
    X = rng.normal(size=(n, d)).astype(np.float32)
    edges = np.sort(rng.normal(size=(d, n_edges)), axis=1).astype(np.float32)
    if n and d and n_edges:
        k = max(1, n * d // 10)
        r, f = rng.integers(0, n, k), rng.integers(0, d, k)
        X[r, f] = edges[f, rng.integers(0, n_edges, k)]
        X[rng.integers(0, n, k), rng.integers(0, d, k)] = np.nan
    return X, edges


@pytest.mark.parametrize("n,d,n_edges", [
    (1, 1, 1), (7, 13, 15), (64, 496, 31), (1000, 33, 200), (5000, 40, 31),
    (0, 5, 31)])
def test_bin_features_kernel_equals_plain(cuda, n, d, n_edges):
    rng = np.random.default_rng(n + d + n_edges)
    X, edges = _binning_inputs(rng, n, d, n_edges)
    Xc, ec = torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda)
    before = pt.LAUNCHES["bin_features"]
    got = pt.bin_features(Xc, ec)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["bin_features"] == before + (1 if n else 0)
    want = pt.bin_features_plain(Xc, ec)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def _walk_inputs(rng, n, d, n_trees, depth, m, bin_dtype):
    width = 2 ** depth
    n_bins = 32 if bin_dtype == torch.int8 else 201
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d))).to(bin_dtype)
    feat = torch.from_numpy(
        rng.integers(0, d, (n_trees, depth, width)).astype(np.int32))
    bins = torch.from_numpy(
        rng.integers(0, n_bins + 1, (n_trees, depth, width)).astype(np.int32))
    leaf = torch.from_numpy(
        rng.normal(size=(n_trees, width, m)).astype(np.float32))
    return Xb, feat, bins, leaf


@pytest.mark.parametrize("n,d,n_trees,depth,m,bin_dtype", [
    (1, 3, 1, 1, 1, torch.int8), (129, 13, 8, 4, 3, torch.int8),
    (891, 496, 200, 10, 1, torch.int8), (300, 20, 50, 12, 2, torch.int8),
    (257, 9, 5, 3, 11, torch.int8), (100, 7, 6, 5, 1, torch.int32)])
def test_tree_walk_kernel_equals_plain(cuda, n, d, n_trees, depth, m,
                                       bin_dtype):
    rng = np.random.default_rng(n * 7 + m)
    args = [t.to(cuda) for t in
            _walk_inputs(rng, n, d, n_trees, depth, m, bin_dtype)]
    before = pt.LAUNCHES["tree_walk"]
    got = pt.tree_walk(*args)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["tree_walk"] == before + -(-m // 8)
    assert torch.equal(got, pt.tree_walk_plain(*args))


def test_kernels_raise_on_what_they_do_not_take(cuda):
    X = torch.zeros((4, 3), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        pt.bin_features(X, torch.zeros((3, 5), device=cuda))
    with pytest.raises(ValueError, match="edges on cpu"):
        pt.bin_features(X.float(), torch.zeros((3, 5)))
    Xb = torch.zeros((4, 3), device=cuda, dtype=torch.int16)
    t = [a.to(cuda) for a in _walk_inputs(np.random.default_rng(0), 4, 3, 2,
                                          2, 1, torch.int8)[1:]]
    with pytest.raises(ValueError, match="int8 or int32"):
        pt.tree_walk(Xb, *t)


def test_titanic_model_scores_on_the_card(cuda):
    """The served path on the card reaches both kernels and matches the
    JAX package's scores within the GBT tolerances of
    tests/test_torch_slice.py."""
    from transmogrifai_tpu_torch import Dataset, load_model

    csv = os.path.join(REPO, "examples", "data", "titanic.csv")
    model = load_model(FIXTURE, device="cuda")
    ds = Dataset.from_csv(csv)
    before = dict(pt.LAUNCHES)
    scores = model.score_compiled(ds)
    torch.cuda.synchronize()
    assert all(pt.LAUNCHES[k] > before[k] for k in before)
    name = next(k for k, v in scores.items()
                if isinstance(v, dict) and "probability" in v)
    got = {k: v.cpu().numpy() for k, v in scores[name].items()}
    with np.load(os.path.join(FIXTURE, "expected_scores.npz")) as z:
        want = {k: z[k] for k in z.files}
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    decided = np.abs(want["rawPrediction"][:, 1]) > 1e-4
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want["prediction"][decided])
