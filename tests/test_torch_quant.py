"""Parity of the port's quantized serving (K10's wire, the narrowed tables,
the calibration) with the JAX package, on the CPU, on the same seeded
inputs.

Tolerances:
- the wire (`quantize_leaf`, `quantize_wire`, `_pack4_np`): bytes equal;
- the dequantization (`dequantize_leaf_plain`, `dequantize_wire`): bit
  for bit the JAX package's jitted `dequantize_leaf` (XLA's CPU program
  rounds q·scale + lo once, as a fused multiply-add; so do the plain
  version and the kernel) on every 1-D leaf (the scalar columns); where
  XLA's fusion of a larger program keeps the product and the sum apart
  (a 2-D leaf in a tree of leaves), one rounding apart; each value within
  the stated per-feature tolerance scale/2 of its input (plus f32
  rounding of the result);
- narrowed tables: bin ids against f16 edges and the walk over int16/uint8
  tables equal; tree scores at the serving tolerances (rawPrediction atol
  2e-5, probability 1e-5: the leaf sums run in another order); the linear
  families' scores from bf16 weights within 1e-5 relative to the largest
  score (products summed in another order);
- the fixtures' quantized scores (`quant_scores.npz`, the JAX package's
  scores of each saved model over the 891 rows in batches of 64, int8,
  int4 and int8-calibrated): wire digests equal, rawPrediction atol 2e-5,
  probability atol 1e-5, predictions equal where |margin| > 1e-4;
- the calibration's fallback, the service's quantize setting and the
  graph switch (the capture itself is tested on the card).
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke as cs  # noqa: E402
from test_torch_titanic_simple import (  # noqa: E402
    GBT_FIXTURE, QUANT_BATCH, QUANT_MODES, SIMPLE_FIXTURE,
    quant_fixture_inputs)
from transmogrifai_tpu_torch import cuda_build  # noqa: E402
from transmogrifai_tpu_torch.stages.base import compiled_scoring  # noqa
from transmogrifai_tpu_torch.workflow import compiled as pc  # noqa: E402

RAW_ATOL, PROB_ATOL = 2e-5, 1e-5


def _jc():
    from transmogrifai_tpu.workflow import compiled as jc
    return jc


def _leaf_inputs(seed, n=37, d=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * rng.uniform(0.01, 300, size=d)
         + rng.normal(size=d) * 50).astype(np.float32)
    x[rng.integers(0, n, 4), rng.integers(0, d, 4)] = np.nan
    x[:, d // 2] = 2.5  # a constant column: scale degenerates to 1
    x[0, 0] = np.inf
    x[1, min(1, d - 1)] = -np.inf
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [1, 6, 7])
@pytest.mark.parametrize("one_d", [False, True])
def test_quantize_leaf_bytes_equal_jax(bits, d, one_d):
    x = _leaf_inputs(bits + d, d=d)
    if one_d:
        x = x[:, 0]
    got = pc.quantize_leaf(x, bits)
    want = _jc().quantize_leaf(x, bits)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_quantize_leaf_calibrated_ranges_bytes_equal_jax():
    x = _leaf_inputs(3)
    lo = np.nanmin(np.where(np.isfinite(x), x, np.nan), 0) - 1.0
    hi = np.nanmax(np.where(np.isfinite(x), x, np.nan), 0) * 0.5
    for bits in (8, 4):
        got = pc.quantize_leaf(x, bits, lo=lo, hi=hi)
        want = _jc().quantize_leaf(x, bits, lo=lo, hi=hi)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (bits, k)


def _raw_tree(seed, n=29):
    rng = np.random.default_rng(seed)
    x = _leaf_inputs(seed, n=n)
    m = (rng.random(n) > 0.2).astype(np.float32)
    return {"Feature_a": {"value": np.where(m > 0, x[:, 0], 0.0)
                          .astype(np.float32), "mask": m},
            "Feature_b": x,
            "Feature_c": {"value": x[:, 3].copy(), "mask": np.ones(
                n, np.float32)},
            "Feature_p": {"prediction": x[:, 1].astype(np.float64)}}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_wire_bytes_equal_jax(bits):
    tree = _raw_tree(bits)
    ranges = {"Feature_a": {"lo": [-3.0], "hi": [40.0]},
              "Feature_b": {"lo": [0.0] * 3, "hi": [1.0] * 3},  # stale
              "Feature_c": {"lo": [-100.0], "hi": [100.0]}}
    for rng in (None, ranges):
        got = pc.quantize_wire(tree, bits, ranges=rng)
        want = _jc().quantize_wire(tree, bits, ranges=rng)
        assert cs.wire_digest([got]) == cs.wire_digest([want])


def test_pack4_equals_jax():
    q = np.random.default_rng(0).integers(0, 16, (9, 11)).astype(np.uint8)
    assert pc._pack4_np(q).tobytes() == _jc()._pack4_np(q).tobytes()


def _jax_dequant(wire, bits):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.jit(lambda w: _jc().dequantize_leaf(w, bits))(
        {k: jnp.asarray(v) for k, v in wire.items()}))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("one_d", [False, True])
def test_plain_dequant_bit_equal_jax(bits, one_d):
    x = _leaf_inputs(11 + bits, n=513, d=13)
    if one_d:
        x = x[:, 2]
    wire = pc.quantize_leaf(x, bits)
    got = pc.dequantize_leaf_plain(
        {k: torch.from_numpy(v) for k, v in wire.items()}, bits).numpy()
    want = _jax_dequant(wire, bits)
    assert got.shape == want.shape == x.shape
    assert got.tobytes() == want.tobytes()
    # the stated per-feature tolerance: scale/2 (and f32 rounding)
    fin = np.isfinite(x)
    lo = np.nanmin(np.where(fin, x, np.nan), 0)
    hi = np.nanmax(np.where(fin, x, np.nan), 0)
    tol = wire["scale"] / 2 + 1e-6 * np.maximum(np.abs(lo), np.abs(hi))
    clipped = np.clip(np.where(fin, x, got), lo, hi)
    assert np.all(np.abs(got - clipped) <= tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_wire_matches_jax(bits):
    """The whole wire tree: masks exact; the scalar columns' 1-D leaves
    (what the fixtures' raw columns ride) bit for bit; a 2-D leaf within
    one rounding, since XLA's fusion of this tree's program keeps the
    product and the sum apart there: each of its values is the JAX
    package's two-rounding value, and the port's the single-rounding
    one."""
    import jax
    import jax.numpy as jnp
    wire = pc.quantize_wire(_raw_tree(5 + bits), bits)
    got = pc.dequantize_wire(pc.to_device(wire, "cpu"), bits)
    want = jax.jit(lambda t: _jc().dequantize_wire(t, bits))(
        jax.tree_util.tree_map(jnp.asarray, wire))

    def leaves(t, path=""):
        if isinstance(t, dict):
            return [kv for k in sorted(t) for kv in leaves(t[k],
                                                           f"{path}/{k}")]
        return [(path, np.asarray(t))]
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype, p
        if a.ndim == 1:
            assert a.tobytes() == b.tobytes(), p
            continue
        leaf = wire[p.strip("/")]
        q = leaf["q"]
        if bits == 4:
            q = np.stack([q & 15, q >> 4], -1).reshape(q.shape[0], -1)[
                :, :a.shape[1]]
        two = q.astype(np.float32) * leaf["scale"] + leaf["lo"]
        once = (q.astype(np.float64) * leaf["scale"] + leaf["lo"]).astype(
            np.float32)
        assert np.array_equal(a, once), p
        assert np.all((b == two) | (b == once)), p


def _emulate_wire_dequant(plan, tensors, views):
    """K10's flat index space in numpy, as csrc/wire_dequant.cu walks it:
    each leaf's first warp from the warps of the leaves before it (a chunk
    of 512 elements a warp), a warp's leaf by the last start at or below
    it, lane l of step s taking elements 128 s + 4 l .. + 3 of the chunk,
    its column from one division a chunk, then advanced (by 128 mod d a
    step, by 1 an element). Returns the batch's output buffer; every
    element written exactly once."""
    chunk, steps, step = 512, 4, 128
    starts, warps = [], 0
    for total, _, _ in plan.table[:, 4:]:
        starts.append(warps)
        warps += -(-int(total) // chunk)
    buf = np.full(plan.size, np.nan, np.float32)
    seen = np.zeros(plan.size, np.int64)
    for wp in range(warps):
        a = int(np.searchsorted(starts, wp, side="right")) - 1
        total, d, bits = (int(v) for v in plan.table[a, 4:])
        q, scale, lo = (None if t is None else t.numpy()
                        for t in tensors[plan.jobs[a]])
        qf = q.reshape(-1)
        base = plan.offsets[a] // 4
        c0 = (wp - starts[a]) * chunk
        for lane in range(32):
            j = (c0 + 4 * lane) % d
            for s in range(steps):
                i0 = c0 + s * step + 4 * lane
                jj = j
                for i in range(i0, min(i0 + 4, total)):
                    if bits == 8:
                        code = int(qf[i])
                    elif d == 1:
                        code = int(qf[i]) & 15
                    else:
                        r, col = divmod(i, d)
                        byte = int(qf[r * ((d + 1) // 2) + col // 2])
                        code = byte >> 4 if col & 1 else byte & 15
                    buf[base + i] = code if scale is None else np.float32(
                        np.float64(code) * scale[jj] + lo[jj])
                    seen[base + i] += 1
                    jj = 0 if jj + 1 == d else jj + 1
                j = (j + step % d) % d
    for a, b, _ in views:
        assert (seen[a:b] == 1).all()
    return buf


@pytest.mark.parametrize("bits", [8, 4])
def test_wire_dequant_plan_and_index_space_match_plain(bits):
    """The K10 wrapper's plan (one output buffer, each leaf's view at a
    multiple of 16 bytes, the table's sizes) and the kernel's flat index
    space, emulated, over scalar, mask, even- and odd-width and empty
    leaves: every element written once, equal to the plain version."""
    rng = np.random.default_rng(bits)
    tree = {"a": {"value": rng.normal(size=37).astype(np.float32),
                  "mask": (rng.random(37) > 0.3).astype(np.float32)},
            "v6": (rng.normal(size=(37, 6)) * 9).astype(np.float32),
            "v7": (rng.normal(size=(37, 7)) * 9).astype(np.float32),
            "e": np.zeros((0, 5), np.float32)}
    wire = pc.to_device(pc.quantize_wire(tree, bits), "cpu")
    jobs = []

    def collect(node):
        if isinstance(node, dict):
            if set(node) in pc._WIRE_KEYS:
                jobs.append(("wire", node))
            else:
                for v in node.values():
                    collect(v)
        elif isinstance(node, torch.Tensor) and node.dtype == torch.uint8:
            jobs.append(("mask", node))
    collect(wire)
    tensors = [((x["q1"] if "q1" in x else x["q"]), x["scale"], x["lo"])
               if kind == "wire" else (x, None, None) for kind, x in jobs]
    plan = pc._DequantPlan(jobs, bits, 48)
    starts = np.cumsum([0] + plan.sizes)
    views = [(starts[i], starts[i + 1], shape)
             for i, shape in zip(plan.pieces, plan.shapes)]
    assert all(a % 4 == 0 for a, _, _ in views)
    assert len(plan.jobs) == len(jobs) - 1  # the empty leaf has no work
    buf = _emulate_wire_dequant(plan, tensors, views)
    want = pc.dequantize_wire_plain(wire, bits)
    flat = []

    def walk(node):
        if isinstance(node, dict) and set(node) not in pc._WIRE_KEYS:
            for v in node.values():
                walk(v)
        else:
            flat.append(node)
    walk(want)
    for (a, b, shape), w in zip(views, flat):
        got = buf[a:b].reshape(shape or (b - a,))
        assert got.tobytes() == w.numpy().tobytes()


def test_fma_f32_rounds_once():
    from fractions import Fraction
    rng = np.random.default_rng(1)
    n = 4000
    a = rng.integers(0, 256, n).astype(np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    got = pc.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.float32(v).view(np.int32))
                                        & 1))
        assert got[i] == best, i


def test_scoring_quant_resolves_like_jax():
    jc = _jc()
    for s in ("int8", "int4", "int8-calibrated", "int4-calibrated"):
        got, want = pc.ScoringQuant.resolve(s), jc.ScoringQuant.resolve(s)
        assert (got.mode, got.calibrated, got.bits) == (
            want.mode, want.calibrated, want.bits)
    assert pc.ScoringQuant.resolve(None) is None
    for bad in ("int16", "fp8"):
        with pytest.raises(ValueError):
            pc.ScoringQuant.resolve(bad)


# -- narrowed tables -------------------------------------------------------- #

def _tree_arrays(seed, d=23, n_trees=9, depth=5, m=1, n_edges=31):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.normal(size=(d, n_edges)) * 10, 1).astype(np.float32)
    width = 2 ** (depth - 1)
    return edges, {
        "feat": rng.integers(0, d, (n_trees, depth, width)).astype(np.int32),
        "bin": rng.integers(0, n_edges + 2, (n_trees, depth, width))
        .astype(np.int32),
        "leaf": (rng.normal(size=(n_trees, 2 ** depth, m)) if m == 1 else
                 rng.dirichlet(np.ones(m), (n_trees, 2 ** depth))
                 ).astype(np.float32)}


def _score_inputs(seed, edges, n=64):
    rng = np.random.default_rng(seed)
    X = cs.binning_input(rng, n, edges)
    return X


def test_bin_features_f16_edges_equal_jax():
    import jax.numpy as jnp
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu_torch.models import trees as pt
    edges, _ = _tree_arrays(0)
    X = _score_inputs(1, edges, n=300)
    e16 = edges.astype(np.float16)
    X[::7, 3] = e16[3, 5]  # values exactly on an f16 edge
    got = pt.bin_features(torch.from_numpy(X), torch.from_numpy(e16))
    want = np.asarray(jt.bin_features(jnp.asarray(X), jnp.asarray(e16)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


_TREE_CLASSES = {"GBTClassificationModel": 1, "GBTRegressionModel": 1,
                 "ForestClassificationModel": 2,
                 "ForestRegressionModel": 1}


def _jax_narrow_scores(cls_name, params, X):
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu import models as jm  # noqa: F401
    from transmogrifai_tpu.stages.base import StageRegistry
    m = StageRegistry.get(cls_name)(**params)
    c = m.narrow_device_constants(m.device_constants())
    out = jax.jit(lambda c, X: m.device_apply_with(c, None, [None, X]))(
        c, jnp.asarray(X))
    return c, {k: np.asarray(v) for k, v in out.items()}


def _port_narrow_scores(cls_name, params, X):
    from transmogrifai_tpu_torch.workflow.serialization import (
        from_jax_params)
    m = from_jax_params(cls_name, params)
    c = m.narrow_device_constants(m.device_constants("cpu"))
    with compiled_scoring():
        out = m.device_apply_with(c, None, [None, torch.from_numpy(X)])
    return c, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("cls_name", sorted(_TREE_CLASSES))
def test_narrowed_tree_tables_score_like_jax(cls_name):
    edges, trees = _tree_arrays(3, m=_TREE_CLASSES[cls_name])
    params = {"edges": edges, "trees": trees}
    if cls_name.startswith("GBT"):
        params["learning_rate"] = 0.1
    X = _score_inputs(4, edges, n=200)
    jcst, want = _jax_narrow_scores(cls_name, params, X)
    pcst, got = _port_narrow_scores(cls_name, params, X)
    assert pcst.feat.dtype == torch.int16 and pcst.bin.dtype == torch.uint8
    assert pcst.edges.dtype == torch.float16
    assert str(jcst["trees"]["feat"].dtype) == "int16"
    np.testing.assert_array_equal(pcst.edges.numpy(),
                                  np.asarray(jcst["edges"]))
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               atol=RAW_ATOL, rtol=0)
    np.testing.assert_allclose(got["probability"], want["probability"],
                               atol=PROB_ATOL, rtol=0)


def test_narrowed_walk_plain_equals_int32_walk():
    from transmogrifai_tpu_torch.models import trees as pt
    edges, trees = _tree_arrays(7, m=2)
    X = torch.from_numpy(_score_inputs(8, edges, n=100))
    Xb = pt.bin_features(X, torch.from_numpy(edges))
    t = {k: torch.from_numpy(v) for k, v in trees.items()}
    wide = pt.tree_walk(Xb, t["feat"], t["bin"], t["leaf"])
    narrow = pt.tree_walk(Xb, t["feat"].to(torch.int16),
                          t["bin"].to(torch.uint8), t["leaf"])
    assert torch.equal(wide, narrow)


def _linear_params(cls_name, seed, d=12, k=3):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(d, k)) * 3).astype(np.float32)
    if cls_name == "LogisticRegressionModel":
        return {"W": W, "b": rng.normal(size=k).astype(np.float32)}
    if cls_name == "NaiveBayesModel":
        return {"log_prior": np.log(np.full(k, 1.0 / k, np.float32)),
                "log_theta": -np.abs(W.T)}
    if cls_name == "MLPModel":
        return {"weights": [
            {"W": W, "b": rng.normal(size=k).astype(np.float32)},
            {"W": rng.normal(size=(k, 2)).astype(np.float32),
             "b": rng.normal(size=2).astype(np.float32)}]}
    beta = W[:, 0]
    if cls_name == "LinearRegressionModel":
        return {"beta": beta, "intercept": 0.5}
    if cls_name == "LinearSVCModel":
        return {"beta": beta, "b": 0.25}
    return {"beta": beta * 0.05, "b": 0.1, "family": "poisson",
            "link": "log", "var_power": 1.5}


@pytest.mark.parametrize("cls_name", [
    "GLMModel", "LinearRegressionModel", "LinearSVCModel",
    "LogisticRegressionModel", "MLPModel", "NaiveBayesModel"])
def test_narrowed_linear_tables_score_like_jax(cls_name):
    params = _linear_params(cls_name, 5)
    X = np.abs(np.random.default_rng(6).normal(size=(50, 12))).astype(
        np.float32)
    _, want = _jax_narrow_scores(cls_name, params, X)
    pcst, got = _port_narrow_scores(cls_name, params, X)
    assert any(b.dtype == torch.bfloat16 for b in pcst.buffers())
    for key in want:
        w = want[key].astype(np.float64)
        scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got[key], w, atol=1e-5 * scale, rtol=0,
                                   err_msg=key)


# -- the fixtures' quantized scores --------------------------------------- #

@pytest.mark.parametrize("which", ["gbt", "simple"])
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_fixture_quantized_scores_match_jax(which, mode):
    from test_torch_multiclass import package, registered_age_group
    ns = package("port")
    registered_age_group(ns)
    model_dir, ds = quant_fixture_inputs(ns, which)
    with np.load(os.path.join(SIMPLE_FIXTURE if which == "simple"
                              else GBT_FIXTURE, "quant_scores.npz")) as z:
        want = {k: z[k] for k in z.files if k.startswith(f"{mode}:")}
    model = ns.load_model(model_dir, device="cpu")
    scorer = model._ensure_compiled(quant=mode)
    seen, inner = [], pc.quantize_wire

    def recording(tree, bits, ranges=None):
        out = inner(tree, bits, ranges=ranges)
        seen.append(out)
        return out

    digests, parts = [], []
    pc.quantize_wire = recording
    try:
        for s in range(0, len(ds), QUANT_BATCH):
            seen.clear()
            parts.append(cs.prediction_of(scorer.score_padded(
                ds.take(np.arange(s, min(s + QUANT_BATCH, len(ds)))),
                QUANT_BATCH)))
            digests.append(cs.wire_digest(seen))
    finally:
        pc.quantize_wire = inner
    got = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    assert digests == list(want[f"{mode}:wire_sha256"])
    np.testing.assert_allclose(got["rawPrediction"],
                               want[f"{mode}:rawPrediction"], atol=RAW_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["probability"],
                               want[f"{mode}:probability"], atol=PROB_ATOL,
                               rtol=0)
    decided = np.abs(want[f"{mode}:rawPrediction"][:, -1]) > 1e-4
    np.testing.assert_array_equal(got["prediction"][decided],
                                  want[f"{mode}:prediction"][decided])


def test_simple_fixture_f32_scores_match_jax():
    """The script's saved model, f32: the compiled scorer divides by a
    fitted constant as x·(1/c), as XLA's program does (the z-normalized
    age sits on the model's bin edges, so the other rounding flips bins
    of 32 rows)."""
    from test_torch_multiclass import package, registered_age_group
    ns = package("port")
    registered_age_group(ns)
    model_dir, ds = quant_fixture_inputs(ns, "simple")
    got = cs.prediction_of(ns.load_model(model_dir, device="cpu")
                           .score_compiled(ds))
    with np.load(os.path.join(SIMPLE_FIXTURE, "scores.npz")) as z:
        np.testing.assert_allclose(got["rawPrediction"], z["rawPrediction"],
                                   atol=RAW_ATOL, rtol=0)
        np.testing.assert_allclose(got["probability"], z["probability"],
                                   atol=PROB_ATOL, rtol=0)


def test_eager_and_compiled_rounding_differ_as_in_jax():
    """The two roundings of the script's model, both the port's: its
    op-by-op `score` divides the z-normalized age by the std (as the JAX
    package's transforms do), its compiled scorer multiplies by the f32
    reciprocal (as XLA's program does). On this fixture the ages differ
    by one ulp on 243 of 891 rows, and the GBT's margins, whose bin edges
    those ages sit on, by up to 0.77 on 32 rows."""
    from test_torch_multiclass import package, registered_age_group
    ns = package("port")
    registered_age_group(ns)
    model_dir, ds = quant_fixture_inputs(ns, "simple")
    model = ns.load_model(model_dir, device="cpu")
    scaler = next(s for s in model.fitted.values()
                  if type(s).__name__ == "StandardScalerModel")
    eager = model.score(ds, keep_intermediate=True)
    age_eager = eager[scaler.get_output().uid].data["value"].astype(
        np.float32)
    # a segment output: the next segment (after an `alias` hop) reads it
    vals, _ = model.compiled().run(ds)
    age_compiled = vals[scaler.get_output().uid]["value"].numpy()
    ulps = np.abs(age_eager.view(np.int32).astype(np.int64)
                  - age_compiled.view(np.int32).astype(np.int64))
    assert ulps.max() == 1 and int((ulps == 1).sum()) == 243
    pred = next(f for f in model.result_features
                if f.ftype.__name__ == "Prediction")
    raw_eager = eager[pred.uid].data["rawPrediction"]
    raw_compiled = cs.prediction_of(model.score_compiled(ds))[
        "rawPrediction"]
    moved = np.abs(raw_eager - raw_compiled).max(1)
    assert int((moved > 1e-4).sum()) == 32
    assert abs(float(moved.max()) - 0.7723) < 1e-3


def test_calibrated_scores_do_not_depend_on_batchmates():
    from test_torch_multiclass import package
    ns = package("port")
    model_dir, ds = quant_fixture_inputs(ns, "gbt")
    model = ns.load_model(model_dir, device="cpu")
    base = np.arange(3)

    def probs(quant, extra):
        sub = ds.take(np.concatenate([base, extra]))
        out = cs.prediction_of(model._ensure_compiled(quant=quant)
                               .score_padded(sub, 8))
        return out["probability"][:3]

    a, b = np.arange(10, 14), np.arange(100, 104)
    np.testing.assert_array_equal(probs("int8-calibrated", a),
                                  probs("int8-calibrated", b))
    assert float(np.abs(probs("int8", a) - probs("int8", b)).max()) < 0.05


def test_calibrated_falls_back_without_calibration(caplog):
    from test_torch_multiclass import package
    ns = package("port")
    model_dir, ds = quant_fixture_inputs(ns, "gbt")
    model = ns.load_model(model_dir, device="cpu")
    assert model.quant_calibration
    model.quant_calibration = None
    scorer = model._ensure_compiled(quant="int8-calibrated")
    assert scorer._cal_ranges is None
    out = cs.prediction_of(scorer.score_padded(ds.take(np.arange(3)), 4))
    assert out["probability"].shape == (3, 2)


def test_pad_rows_do_not_move_quantized_scores():
    from test_torch_multiclass import package
    ns = package("port")
    model_dir, ds = quant_fixture_inputs(ns, "gbt")
    scorer = ns.load_model(model_dir, device="cpu")._ensure_compiled(
        quant="int8")
    sub = ds.take(np.arange(6))
    a = cs.prediction_of(scorer.score_padded(sub, 8))
    b = cs.prediction_of(scorer.score_padded(sub, 32))
    np.testing.assert_array_equal(a["probability"], b["probability"])


def test_quant_service_answers_like_score_padded():
    from transmogrifai_tpu_torch.serving import ScoringService, ServingConfig
    svc = ScoringService.from_path(
        GBT_FIXTURE, ServingConfig(max_batch=8, quantize="int8-calibrated"),
        device="cpu").start()
    try:
        from test_torch_multiclass import package
        _, ds = quant_fixture_inputs(package("port"), "gbt")
        rows = ds.to_rows()[:5]
        res = svc.score([dict(r) for r in rows])
        health = svc.health()
    finally:
        svc.stop()
    assert health["quantize"] == "int8-calibrated"
    assert health["cuda_graphs"] is False
    direct = cs.prediction_of(svc.scorer.score_padded(ds.take(np.arange(5)),
                                                      8))
    got = next(v for v in res.outputs.values()
               if isinstance(v, dict) and "probability" in v)
    np.testing.assert_array_equal(got["probability"], direct["probability"])


def test_graphs_need_a_cuda_device():
    from test_torch_multiclass import package
    ns = package("port")
    model = ns.load_model(GBT_FIXTURE, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pc.CompiledScorer(model, graphs=True)
    assert pc.CompiledScorer(model).graphs is False


def test_replay_launch_counts_add_and_restore():
    before = cuda_build.launches_snapshot()
    cuda_build.add_launches({"wire_dequant": 2, "tree_walk_narrow": 1})
    after = cuda_build.launches_snapshot()
    assert after["wire_dequant"] == before["wire_dequant"] + 2
    assert after["tree_walk_narrow"] == before["tree_walk_narrow"] + 1
    cuda_build.set_launches(before)
    assert cuda_build.launches_snapshot() == before
