"""K4 (binning) of the PyTorch port against the JAX package's
`bin_features` on every kind of edge, on the CPU.

The port's plain version (`bin_features_plain`, which its wrapper takes
for CPU tensors) is the CUDA kernel's oracle on the card
(tests/test_torch_cuda.py, chip_smoke.py). The kernel counts a feature
whose edges are non-decreasing by binary search and any other feature
linearly; the plain mirrors of those two steps (`monotone_edges`,
`search_bins_plain`) are held here to the broadcast count.

Inputs come from numpy seeds: `chip_smoke.hostile_edges` (per feature:
sorted, shuffled, with a NaN, with duplicates, with +-inf and +-0, one
value repeated) and `chip_smoke.hostile_values` (values on edges, NaN,
+-inf, +-0), n = 257 rows, d = 13 features. Tolerance: bin ids equal and
dtypes equal (int8 up to 126 edges, int32 above), since both packages
make the same f32 comparisons (f16 edges widened to f32 first).
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import trees as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (hostile edges and values)

N, D = 257, 13


def _case(n_edges, seed=0, half=False):
    rng = np.random.default_rng(seed + n_edges)
    e = cs.hostile_edges(rng, D, n_edges)
    if half:
        e = e.astype(np.float16)
    X = cs.hostile_values(rng, N, e.astype(np.float32))
    return X, e


@pytest.mark.parametrize("n_edges", [1, 2, 3, 31, 32, 63, 126, 127, 200,
                                     1023])
def test_plain_bins_equal_jax_on_hostile_edges(n_edges):
    X, e = _case(n_edges)
    want = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(e)))
    got = pt.bin_features(torch.from_numpy(X), torch.from_numpy(e))
    assert got.dtype == pt.bin_dtype(n_edges)
    assert str(got.numpy().dtype) == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_edges", [31, 200, 1023])
def test_plain_bins_equal_jax_on_f16_edges(n_edges):
    """The quantized mode's narrowed tables: f16 edges against f32
    values, promoted to f32 in both packages."""
    X, e16 = _case(n_edges, seed=1, half=True)
    want = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(e16)))
    got = pt.bin_features(torch.from_numpy(X), torch.from_numpy(e16))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, pt.bin_features(
        torch.from_numpy(X), torch.from_numpy(e16.astype(np.float32))))


def test_monotone_test_flags_shuffled_and_nan_edges_only():
    """Of the six kinds of `hostile_edges`, the shuffled and the NaN ones
    are not non-decreasing; duplicates, +-inf, +-0 and a repeated value
    are (-0 <= +0 and +0 <= -0 both hold)."""
    _, e = _case(31)
    mono = pt.monotone_edges(torch.from_numpy(e))
    assert mono.tolist() == [True, False, False, True, True, True] * 2 \
        + [True]


@pytest.mark.parametrize("n_edges", [1, 2, 3, 5, 31, 32, 63, 200, 1023])
@pytest.mark.parametrize("half", [False, True])
def test_search_mirror_equals_broadcast_where_edges_are_non_decreasing(
        n_edges, half):
    """Binary lifting over ceil(log2(n_edges + 1)) compares gives the
    broadcast count on every non-decreasing feature, NaN values at 0;
    with the linear count elsewhere (the kernel's choice per feature)
    it equals the broadcast count everywhere."""
    X, e = _case(n_edges, seed=2, half=half)
    Xt, et = torch.from_numpy(X), torch.from_numpy(e)
    mono = pt.monotone_edges(et)
    full = pt.bin_features_plain(Xt, et).to(torch.int32)
    search = pt.search_bins_plain(Xt, et)
    assert mono.any()
    assert torch.equal(search[:, mono], full[:, mono])
    assert not search[torch.isnan(Xt)].any()
    assert torch.equal(torch.where(mono[None, :], search, full), full)


def test_search_alone_differs_from_broadcast_on_unsorted_edges():
    """Why the kernel keeps a linear count: on shuffled edges, or edges
    with a NaN, a binary search counts a prefix that is not the set of
    edges below the value."""
    e = torch.tensor([[3.0, 1.0, 2.0], [0.0, float("nan"), 2.0]])
    X = torch.tensor([[1.5, 3.0]])
    assert pt.bin_features_plain(X, e).tolist() == [[1, 2]]
    assert pt.search_bins_plain(X, e).tolist() == [[2, 1]]
    assert pt.monotone_edges(e).tolist() == [False, False]
    X, e = _case(31, seed=3)
    Xt, et = torch.from_numpy(X), torch.from_numpy(e)
    differ = (pt.search_bins_plain(Xt, et)
              != pt.bin_features_plain(Xt, et).to(torch.int32)).any(0)
    assert differ.any() and not (differ & pt.monotone_edges(et)).any()


@pytest.mark.parametrize("fn", sorted(pt._BIN_ENTRIES.values()))
def test_ctypes_argtypes_name_every_c_parameter(fn):
    """The wrapper declares every parameter of K4's entry points, the
    stream too (ctypes would pass an undeclared pointer as a 32-bit
    int)."""
    with open(os.path.join(os.path.dirname(pt.__file__), os.pardir, "csrc",
                           "bin_features.cu")) as f:
        params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                           f.read())[1]
    assert len(params.split(",")) == len(pt._BIN_ARGS)
