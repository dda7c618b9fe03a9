"""Parity of the port's sanity checker with the JAX package on its wide
path (the blocked Gram past `_WIDE_D` columns, its hit extraction K9-hits
as the plain version `corr_hits_plain`) and on Spearman correlation (the
rank transform), on the CPU.

Tolerances: the label correlations and the hit values within 1e-5 (f32
Gram products summed in another order; no planted pair lies within 1e-4
of the threshold, so the hit sets are equal), except without the
duplicate check (`max_feature_corr=1.0`), where both packages take the
label correlations from f32 column moments, sxx − n·mean² cancels most
of sxx, and torch's CPU column sums run row after row while XLA's are
blocked: there 1e-4 (measured 2.35e-5 on Spearman ranks of 300 rows,
the JAX package within 7.7e-8 of the exact value); hit pairs, their order
under truncation, kept indices and drop reasons equal; the rank
transform bit-equal to the JAX package's (pandas) one; `corr_hits_plain`
equal to a numpy reading of the same rule on hostile block products.
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import transmogrifai_tpu.automl.sanity_checker as jsc  # noqa: E402
import transmogrifai_tpu.types as jt  # noqa: E402
from transmogrifai_tpu.data.columns import Column as JColumn  # noqa: E402
from transmogrifai_tpu.stages.base import FitContext as JFitContext  # noqa

import transmogrifai_tpu_torch as port  # noqa: E402
import transmogrifai_tpu_torch.automl.sanity_checker as psc  # noqa: E402
import transmogrifai_tpu_torch.types as pt  # noqa: E402
from transmogrifai_tpu_torch.data.columns import Column as PColumn  # noqa
from transmogrifai_tpu_torch.stages.base import FitContext as PFitContext  # noqa

ATOL = 1e-5


def both_blocked(X, y, thr, block):
    want = jsc._corr_label_and_hits_blocked(
        jnp.asarray(X), jnp.asarray(y), thr=thr, block=block)
    got = psc._corr_label_and_hits_blocked(
        torch.as_tensor(X), torch.as_tensor(y), thr=thr, block=block)
    return got, want


def assert_same_pairs(got, want):
    assert set(got) == set(want)
    for i in want:
        assert [j for j, _ in got[i]] == [j for j, _ in want[i]], i
        np.testing.assert_allclose([v for _, v in got[i]],
                                   [v for _, v in want[i]], atol=ATOL)


def test_blocked_matches_jax_on_planted_pairs():
    """The JAX package's case (tests/test_sanity_checker.py): 300 × 37 in
    blocks of 8, a duplicate (7, 3) and an anti-duplicate (20, 11)."""
    rng = np.random.default_rng(5)
    n, d = 300, 37
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 7] = X[:, 3] * 2.0 + 1e-6
    X[:, 20] = -X[:, 11]
    y = (X[:, 0] > 0).astype(np.float32)
    dense = np.corrcoef(X.T.astype(np.float64))
    off = np.abs(np.tril(dense, -1))
    assert not np.any(np.abs(off - 0.95) < 1e-4)  # no pair near thr
    (cy, pairs), (cy_j, pairs_j) = both_blocked(X, y, 0.95, 8)
    np.testing.assert_allclose(cy, cy_j, atol=ATOL)
    assert set(pairs) == {7, 20}
    assert_same_pairs(pairs, pairs_j)


def test_truncation_keeps_the_first_cap_hits_in_row_major_order(caplog):
    """50 identical columns (10..59) in blocks of 16: the block of rows
    48..63 holds 522 hits past its cap of 256; both packages keep the
    same first 256 in row-major order and log the truncation."""
    rng = np.random.default_rng(8)
    n, d = 200, 64
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 11:60] = X[:, 10:11]
    y = (X[:, 0] > 0).astype(np.float32)
    with caplog.at_level(logging.WARNING):
        (cy, pairs), (cy_j, pairs_j) = both_blocked(X, y, 0.99, 16)
    np.testing.assert_allclose(cy, cy_j, atol=ATOL)
    assert_same_pairs(pairs, pairs_j)
    port_warnings = [r.getMessage() for r in caplog.records
                     if r.name == psc.__name__]
    jax_warnings = [r.getMessage() for r in caplog.records
                    if r.name == jsc.__name__]
    assert port_warnings == jax_warnings
    assert any("522 hits in block 48..64 truncated to 256" in m
               for m in port_warnings)
    kept = sum(len(pairs.get(i, ())) for i in range(48, 64))
    assert kept == 256


@pytest.mark.parametrize("case", chip_smoke.K9_HITS_CASES,
                         ids=[c[0] for c in chip_smoke.K9_HITS_CASES])
def test_corr_hits_plain_matches_numpy_on_hostile_blocks(case):
    name, b, d, a, thr, cap, planted = case
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    C = chip_smoke.k9_hits_input(rng, b, d, a, thr, planted)
    want = chip_smoke.hits_oracle(C, a, thr, cap)
    got = psc.corr_hits(torch.from_numpy(C), a, thr, cap)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[3]) == want[3]
    assert got[3].dtype == torch.int64


def test_hostile_cases_cover_truncation_and_the_edges():
    rng = np.random.default_rng(0)
    totals = {}
    for name, b, d, a, thr, cap, planted in chip_smoke.K9_HITS_CASES:
        C = chip_smoke.k9_hits_input(rng, b, d, a, thr, planted)
        totals[name] = (chip_smoke.hits_oracle(C, a, thr, cap)[3], cap)
    assert totals["none"][0] == 0
    assert totals["all_truncated"][0] > totals["all_truncated"][1]
    assert totals["dup40_truncated"] == (780, 512)
    assert totals["rows_past_d"][0] > 0


def rank_inputs():
    rng = np.random.default_rng(2)
    ties = rng.integers(0, 4, size=(400, 5)).astype(np.float32)
    onehot = np.zeros((400, 6), dtype=np.float32)
    onehot[np.arange(400), rng.integers(0, 6, 400)] = 1.0
    nan = rng.normal(size=(400, 4)).astype(np.float32)
    nan[rng.integers(0, 400, 40), rng.integers(0, 4, 40)] = np.nan
    nan[:, 3] = np.nan
    signed = np.tile(np.float32([0.0, -0.0, 1.0, -1.0]), (100, 1))
    return {"ties": ties, "onehot": onehot, "nan": nan, "signed_zero": signed,
            "label": rng.integers(0, 3, size=(400, 1)).astype(np.float64),
            "one_row": np.float32([[3.0, np.nan]])}


@pytest.mark.parametrize("name", sorted(rank_inputs()))
def test_rank_transform_bit_equal_to_jax(name):
    A = rank_inputs()[name]
    want = jsc._rank_transform(A)
    got = psc._rank_transform(torch.as_tensor(A)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_rank_transform_in_column_chunks(monkeypatch):
    A = rank_inputs()["ties"]
    whole = psc._rank_transform(torch.as_tensor(A)).numpy()
    monkeypatch.setattr(psc, "_CHUNK_ENTRIES", 2 * A.shape[0])  # 2 columns
    np.testing.assert_array_equal(
        psc._rank_transform(torch.as_tensor(A)).numpy(), whole)


def checker_inputs(seed, n, d):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 5] = np.round(X[:, 5])             # ties
    X[:, 13] = X[:, 4]                      # duplicate
    X[:, 17] = np.exp(X[:, 2])              # a monotone copy: Spearman 1
    X[:, 19] = 1.5                          # zero variance
    y = (X[:, 0] + rng.normal(0, 0.5, n) > 0).astype(np.float64)
    X[:, 21] = 2.0 * y - 1.0                # leak
    return X, y


def fit_both(X, y, **kw):
    n = X.shape[0]
    jlabel = JColumn(jt.RealNN, {"value": y, "mask": np.ones(n, bool)})
    plabel = PColumn(pt.RealNN, {"value": y, "mask": np.ones(n, bool)})
    jm = jsc.SanityChecker(**kw).fit_model(
        [jlabel, JColumn(jt.OPVector, X)], JFitContext(n_rows=n, seed=0))
    pm = psc.SanityChecker(**kw).fit_model(
        [plabel, PColumn(pt.OPVector, X)], PFitContext(n_rows=n, seed=0))
    return pm, jm


MOMENTS_ATOL = 1e-4


def assert_same_fit(pm, jm, corr_atol=ATOL):
    assert pm.indices == jm.indices
    assert ([s["dropped"] for s in pm.summary["stats"]]
            == [s["dropped"] for s in jm.summary["stats"]])
    np.testing.assert_allclose(
        [s["corrLabel"] for s in pm.summary["stats"]],
        [s["corrLabel"] for s in jm.summary["stats"]], atol=corr_atol)
    for key in ("mean", "variance", "min", "max"):
        np.testing.assert_allclose(
            [s[key] for s in pm.summary["stats"]],
            [s[key] for s in jm.summary["stats"]], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ctype", ["pearson", "spearman"])
@pytest.mark.parametrize("wide", [False, True], ids=["dense", "wide"])
def test_fit_matches_jax(ctype, wide, monkeypatch):
    """Kept indices and drop reasons equal, the raw moments reported
    whichever type, on the dense path and on the wide one (`_WIDE_D` 16 in
    both packages, as tests/test_sanity_checker.py forces it)."""
    if wide:
        monkeypatch.setattr(jsc, "_WIDE_D", 16)
        monkeypatch.setattr(psc, "_WIDE_D", 16)
    X, y = checker_inputs(6, 400, 24)
    pm, jm = fit_both(X, y, correlation_type=ctype)
    assert_same_fit(pm, jm)
    assert 13 not in pm.indices and 21 not in pm.indices
    assert (17 in pm.indices) == (ctype == "pearson")
    assert pm.summary["correlationType"] == ctype


@pytest.mark.parametrize("ctype", ["pearson", "spearman"])
def test_fit_without_the_duplicate_check_matches_jax(ctype):
    X, y = checker_inputs(7, 300, 24)
    pm, jm = fit_both(X, y, correlation_type=ctype, max_feature_corr=1.0)
    assert_same_fit(pm, jm, corr_atol=MOMENTS_ATOL)


def test_wide_phase_rehearsed_on_the_cpu(monkeypatch):
    """`chip_smoke.py` phase 25 at 1,500 × 2,048 (blocks of 512, cap 8192,
    a truncating group of 129 columns): every planted column dropped for
    its reason, the truncation logged, each block's plain extraction and
    kept indices equal."""
    monkeypatch.setattr(psc, "_WIDE_D", 1024)
    monkeypatch.setattr(psc, "_BLOCK_ENTRIES", 1 << 20)
    rec = chip_smoke.wide_sanity_phase(port, device="cpu", rows=1500, d=2048)
    for ctype in ("pearson", "spearman"):
        r = rec["types"][ctype]
        assert r["dropped_not_planted"] == []
        assert r["planted"] == r["dropped"]
        assert r["blocks_held_to_plain"][0]["total"] > rec["cap"]
        assert len(r["blocks_held_to_plain"]) == 4
