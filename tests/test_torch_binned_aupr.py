"""K8 (binned AuPR) of the PyTorch port against the JAX package's
`aupr_binned_dev`, and the kernel's partition of rows over blocks, on the
CPU.

The port's plain version (`binned_aupr_plain`, which its wrapper takes
for CPU tensors) is the CUDA kernel's oracle on the card
(tests/test_torch_cuda.py, chip_smoke.py). The kernel splits each pair's
rows into G ranges (`aupr_row_blocks`), histograms each range in one
block and sums the ranges' histograms in range order; its plain mirror
(`binned_aupr_blocks_plain`) is held here bit-equal to the plain version.

Inputs come from numpy seeds: n = 20,000 scores with ties (a fifth
rounded to 0.01), labels 40 % positive, 0/1 weights 70 % ones.
Tolerance against JAX: atol 1e-6. Both count 0/1 weights exactly (JAX as
bf16 one-hot products summed in f32, the port as f32 `bincount`); JAX
then walks the curve in f32, the port in f64 rounded to f32 once. The
trapezoid telescopes, so the rounding of neighbouring curve points
cancels and the two stay within a few f32 ulps of the area (at most
6e-8 on these inputs, at 1 to 16,384 buckets). The mirror is held
bit-equal: f32 sums of integer-valued weights below 2^24 are exact in
any order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu_torch.evaluators import device_metrics as pdm

N = 20_000


def _scores(seed, n=N):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    s[::5] = np.round(s[::5], 2)  # ties
    w = (rng.random(n) < 0.7).astype(np.float32)
    return y, s, w


@pytest.mark.parametrize("n_bins", [1, 7, 512, 4096, 16384])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_binned_aupr_matches_jax(n_bins, seed):
    y, s, w = _scores(seed + n_bins)
    want = float(jdm.aupr_binned_dev(jnp.asarray(y), jnp.asarray(s),
                                     jnp.asarray(w), n_bins))
    got = float(pdm.aupr_binned_dev(torch.from_numpy(y), torch.from_numpy(s),
                                    torch.from_numpy(w), n_bins))
    assert abs(got - want) <= 1e-6


def test_plain_binned_aupr_without_positives_matches_jax():
    y, s, w = _scores(3)
    y[:] = 0.0
    want = float(jdm.aupr_binned_dev(jnp.asarray(y), jnp.asarray(s),
                                     jnp.asarray(w)))
    got = float(pdm.aupr_binned_dev(torch.from_numpy(y), torch.from_numpy(s),
                                    torch.from_numpy(w)))
    assert got == want == 0.0


@pytest.mark.parametrize("P,n,n_bins", [
    (6, 802, 512), (6, 65536, 512), (8, 4_456_448, 4096), (1, 10_000_000,
                                                            4096),
    (300, 100_000, 512), (8, 1_000_000, 1 << 20), (3, 0, 512),
    (6, 100_003, 512), (1, 32_767, 512), (1, 32_768, 512)])
def test_row_blocks_cover_every_row_once_and_fill_the_card(P, n, n_bins):
    """G ranges of `chunk` rows cover n, none of them empty; one block a
    pair below 32,768 rows; at most 264 blocks of the card's 132 SMs when
    a pair takes more than one, each range but the last at least 16,384
    rows; the partials' scratch within 256 MB."""
    G, chunk = pdm.aupr_row_blocks(P, n, n_bins)
    assert G >= 1 and G * chunk >= n and (G - 1) * chunk < max(n, 1)
    if n < 2 * pdm._AUPR_MIN_ROWS:
        assert G == 1
    if G > 1:
        assert P * G <= pdm._AUPR_BLOCKS
        assert P * G * 2 * n_bins * 4 <= pdm._AUPR_SCRATCH_BYTES
        assert chunk >= pdm._AUPR_MIN_ROWS


@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 33])
@pytest.mark.parametrize("from_margin,n_bins", [(True, 512), (False, 4096),
                                                (False, 16384)])
def test_block_order_mirror_is_bit_equal_to_the_plain_version(
        blocks, from_margin, n_bins):
    """Row ranges of ⌈n / G⌉ rows (n = 10,007, not a multiple), zero-weight
    rows, a pair with no positive weight, a pair with no weight at all."""
    rng = np.random.default_rng(blocks + n_bins)
    P, n = 4, 10_007
    m = rng.normal(size=(P, n)).astype(np.float32) * 3
    if not from_margin:
        m = 1 / (1 + np.exp(-m))
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = (rng.random((P, n)) < 0.6).astype(np.float32)
    w[2] *= 1 - y  # no positive weight
    w[3] = 0.0
    M, Y, W = (torch.from_numpy(a.astype(np.float32)) for a in (m, y, w))
    want = pdm.binned_aupr_plain(M, Y, W, n_bins, from_margin)
    got = pdm.binned_aupr_blocks_plain(M, Y, W, n_bins, from_margin, blocks)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert want[0] > 0 and want[1] > 0 and want[2] == 0 and want[3] == 0


def _c_params(source: str, fn: str) -> int:
    """The number of parameters of `extern "C" int fn(...)` in
    transmogrifai_tpu_torch/csrc/<source>."""
    text = (Path(pdm.__file__).resolve().parents[1] / "csrc"
            / source).read_text()
    params = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)[1]
    return len([p for p in params.split(",") if p.strip()])


def test_ctypes_argtypes_name_every_c_parameter():
    """The wrapper declares every parameter of K8's entry points, the
    stream too (ctypes would pass an undeclared pointer as a 32-bit
    int)."""
    assert _c_params("binned_aupr.cu", "binned_aupr") == len(pdm._AUPR_ARGS)
    assert _c_params("binned_aupr.cu", "binned_aupr_shared_max_bins") == 0
