"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips when no CUDA device is present.
This file imports neither jax nor the JAX package, so it also runs on a
machine without them; `tests/conftest.py` imports jax, so run it there
with the conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: bin ids equal (K4 also on shuffled, NaN, duplicated, +-inf
and +-0 edges, 1 to 1023 edges, f32 and f16, staged and read from global
memory); tree sums equal, because kernel and plain
version add the same f32 leaf values in the same tree order (K5, K5-narrow
and K5-mc also at their tile and chunk boundaries, rows too wide to stage,
misaligned and odd-width rows, one launch for any class count). Training
kernels: K1 histograms within rtol 1e-5 / atol 1e-5 of the plain version
(`index_add_` adds in another order on the card) and bit-equal from run
to run; K2 split features and bins equal when fed the same histograms
(the same f32 operations in the same order, no fused multiply-adds),
dense and over a live set (the nodes that hold rows, nodes outside it
taking the pair's zero search, also at lambda 0 and min_child_weight 0
where that search's gains are NaN), written into strided table rows, its
marks equal; K3 node ids and flags equal, out of place and through a row
stride, and leaf values within atol 1e-6 of the plain version and
bit-equal to a row-order f32 sum; `grow_trees` over the live set equal to
the dense search and to the CPU's, at depth 12 with float gradients; K8 binned AuPR equal at 512, 4096 and
16,384 buckets, one block a pair and rows split over blocks, on clustered
scores, without positives, and the same bits on two runs. Forest kernels (m = 2 class channels, integer values): K1 and
K1-sub equal (integer sums are exact in any order), K2 and K3 leaves as
above; a depth-12 forest grown on the card equals the CPU's. The same at
m = 3 class channels (a depth-12 three-class forest) and m = 1 with the
regression label as the channel (labels on a 1/4 grid, exact sums: equal
forests); at m = 5, 7 and 12 class channels (K1 in one launch a channel
group, K2's any-m search) equal to the plain versions, and 7- and
12-class depth-12 forests equal to the CPU's. Evaluation kernels: K8-mc
confusion counts at any class count (k = 1 to 300, no row, one row, rows
over several blocks) equal for 0/1 masks and within 1e-6 relative for
fractional weights (both sum in f64, in another order, and round once);
K8-reg sums within 1e-6 relative; both the same bits on a second call
and under CUDA-graph replay. Quantized serving: K10's dequantized
wire equal to its plain version (both round q·scale + lo once), on the
card and on the CPU, also at 1 to 97 leaves, odd widths at 4 bits, empty
leaves, unaligned views and past 2^31 elements; K4's f16-edge variant and K5 over narrowed tables
equal to their plain versions (and to the f32 / int32 versions); a
`score_padded` graph replay equal to eager scoring, its launches counted
per replay; a device stage that cannot be captured raises and names
itself. The out-of-core path: K12 equal to its plain version bit for bit
(rows past 2^31 elements, hostile edges and values, odd and narrow d,
unaligned offsets and views); K12-dequant's entries equal to their plain
versions bit for bit at 8 and 4 bits (odd d, subnormals, values on and
beside edges, hostile edges, unaligned views, rows past 2^31 elements),
and a warm feature-cache replay on
the card equal to its cold build and to the CPU's; K1 over 16 lockstep
learners equal to `histograms_plain` (integer sums); `mm_f32` within
2·K·2^-24·Σ|a||b| of the widened f32 product (the same exact products
summed in another order); the big path on the card against the CPU:
matrices and trees equal, GBT margins within 2e-6, the LR grid within
1e-2.
"""

import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
from transmogrifai_tpu_torch.models import trees as pt

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (hostile edges and values for K4)
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


def _plain_bins(X, e, rows=2048):
    """`bin_features_plain` over row chunks (its broadcast holds n·d·n_edges
    booleans)."""
    if X.shape[0] <= rows:
        return pt.bin_features_plain(X, e)
    return torch.cat([pt.bin_features_plain(X[i:i + rows], e)
                      for i in range(0, X.shape[0], rows)])


def _check_bins(X, e):
    counter = "bin_features_f16" if e.dtype == torch.float16 else \
        "bin_features"
    before = pt.LAUNCHES[counter]
    got = pt.bin_features(X, e)
    torch.cuda.synchronize()
    assert pt.LAUNCHES[counter] == before + 1
    want = _plain_bins(X, e)
    assert got.dtype == want.dtype == pt.bin_dtype(e.shape[1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 64, 891, 65543])
@pytest.mark.parametrize("d", [496, 497])
def test_bin_features_kernel_on_hostile_edges(cuda, n, d):
    """K4 at the path's 31 edges on every kind of edge (sorted, shuffled,
    with NaN, duplicates, +-inf and +-0, constant) and of value (on edges,
    NaN, +-inf, +-0): equal to the broadcast count. d = 496 takes the
    16-byte path, d = 497 the scalar one."""
    rng = np.random.default_rng(n + d)
    e = cs.hostile_edges(rng, d, 31)
    X = cs.hostile_values(rng, n, e)
    _check_bins(torch.from_numpy(X).to(cuda), torch.from_numpy(e).to(cuda))


@pytest.mark.parametrize("n_edges", [31, 32, 63, 64, 65, 66, 200, 1023])
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("d", [61, 64])
def test_bin_features_kernel_at_every_edge_count(cuda, n_edges, half, d):
    """Edges staged in shared memory (up to 65 edges: 64 and 65 fill the
    96 KB exactly) and read from global memory (66, 200, 1023; int32 bins
    above 126 edges), f32 and f16 edges, hostile edges and values: equal
    to the broadcast count."""
    rng = np.random.default_rng(n_edges + d)
    e = cs.hostile_edges(rng, d, n_edges)
    if half:
        e = e.astype(np.float16)
    X = cs.hostile_values(rng, 891, e.astype(np.float32))
    _check_bins(torch.from_numpy(X).to(cuda), torch.from_numpy(e).to(cuda))


def test_bin_features_kernel_on_rows_not_16_byte_aligned(cuda):
    """A contiguous X whose storage starts 4 bytes past a 16-byte boundary
    (d % 4 == 0) takes the scalar path: equal to the broadcast count."""
    rng = np.random.default_rng(3)
    e = torch.from_numpy(cs.hostile_edges(rng, 128, 31)).to(cuda)
    flat = torch.from_numpy(cs.hostile_values(
        rng, 301, cs.hostile_edges(rng, 128, 31))).reshape(-1).to(cuda)
    X = flat[1:1 + 300 * 128].view(300, 128)
    assert X.is_contiguous() and X.data_ptr() % 16 == 4
    _check_bins(X, e)


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
    assert pt.LAUNCHES["tree_walk"] == before + 1  # every class at once
    assert torch.equal(got, pt.tree_walk_plain(*args))


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("R,n,T,m,bin_dtype", cs.walk_boundary_cases())
def test_tree_walk_kernel_at_tile_and_chunk_boundaries(cuda, R, n, T, m,
                                                        bin_dtype, narrow):
    """K5 and K5-narrow at `chip_smoke.walk_boundary_cases`: for R rows a
    block (forced; the plan's own R where None) a chunk holds TC =
    K5_CHUNK_PAIRS / R trees; n around R and tree counts around TC, channel
    counts around a pass's 4 and two passes' 8, int8 and int32 Xb, split
    bins of n_bins (never fire); one launch, equal to the plain version."""
    rng = np.random.default_rng((R or 0) + 7 * n + 11 * T + m)
    Xb, feat, bins, leaf = (t.to(cuda) for t in _walk_inputs(
        rng, n, 37, T, 5, m, bin_dtype))
    n_bins = 32 if bin_dtype == torch.int8 else 201
    bins[:, 2] = n_bins  # level 2 never splits: every row goes left
    if narrow:
        feat, bins = feat.to(torch.int16), bins.to(torch.uint8)
    key = "tree_walk_narrow" if narrow else "tree_walk"
    before = pt.LAUNCHES[key]
    got = pt._tree_walk_cuda(Xb, feat, bins, leaf, rows=R)
    torch.cuda.synchronize()
    assert pt.LAUNCHES[key] == before + 1
    assert torch.equal(got, pt.tree_walk_plain(Xb, feat, bins, leaf))


@pytest.mark.parametrize("case", ["wide_rows", "misaligned", "odd_row"])
def test_tree_walk_kernel_where_rows_are_not_staged_by_words(cuda, case):
    """Rows too wide for the tile (read from device memory), a view whose
    rows start off a 4-byte boundary and rows of an odd byte count (both
    copied byte by byte): equal to the plain version."""
    rng = np.random.default_rng(len(case))
    d, dt = {"wide_rows": (13000, torch.int32), "misaligned": (64, torch.int8),
             "odd_row": (37, torch.int8)}[case]
    n, T = 300, 40
    Xb, feat, bins, leaf = (t.to(cuda) for t in _walk_inputs(
        rng, n, d, T, 6, 2, dt))
    if case == "misaligned":
        flat = torch.empty(n * d + 1, dtype=torch.int8, device=cuda)
        flat[1:] = Xb.reshape(-1)
        Xb = flat[1:].view(n, d)
        assert Xb.is_contiguous() and Xb.data_ptr() % 4 != 0
    _, staged, _ = pt.walk_plan(n, T, d, Xb.element_size(), 2, 2,
                                _sms(cuda))
    assert staged == (case != "wide_rows")
    got = pt.tree_walk(Xb, feat, bins, leaf)
    torch.cuda.synchronize()
    assert torch.equal(got, pt.tree_walk_plain(Xb, feat, bins, leaf))


def _sms(cuda):
    return torch.cuda.get_device_properties(cuda).multi_processor_count


# (n_flat, d, xb_bytes, n_cols, m): the Titanic GBT, its int32 bins, the
# out-of-core forest, the Iris softmax model, an 11-class forest, a row too
# wide to stage
PLAN_CASES = [(200, 496, 1, 1, 1), (200, 496, 4, 1, 1), (16, 500, 1, 2, 2),
              (600, 3, 1, 3, 1), (50, 37, 1, 11, 11), (40, 13000, 4, 2, 2)]
PLAN_SMS = 132
PLAN_FILL = 2  # csrc/tree_walk.cu FILL: blocks an SM the tiles give


def _plan_ns():
    """Every n up to 4096, then steps of 97 to 2^20, and each switch of the
    plan (where ceil(n / 2R) reaches PLAN_FILL * SMs, and n = 2R) +- 2."""
    ns = set(range(1, 4097)) | set(range(4097, 2 ** 20 + 1, 97))
    ns.add(2 ** 20)
    for r in (1, 2, 4, 8, 16, 32, 64):
        for at in (2 * r * (PLAN_FILL * PLAN_SMS - 1), 2 * r):
            ns.update(at + k for k in range(-2, 3) if at + k >= 1)
    return sorted(ns)


@pytest.mark.parametrize("n_flat,d,xb_bytes,n_cols,m", PLAN_CASES)
def test_walk_plan_for_every_n_up_to_2_20(cuda, n_flat, d, xb_bytes, n_cols,
                                          m):
    """K5's plan (csrc/tree_walk.cu): R a power of two up to 64 that never
    shrinks as n grows, TC = K5_CHUNK_PAIRS / R; R grew while the tiles
    still gave PLAN_FILL blocks an SM or one chunk held every tree, and
    stopped where both fail, at 64, or where 2R rows do not fit (a forced
    2R is refused, or not staged where R is)."""
    def rule(r, n):
        return -(-n // r) >= PLAN_FILL * PLAN_SMS or (
            r <= n and cs.K5_CHUNK_PAIRS // r >= n_flat)

    args = (n_flat, d, xb_bytes, n_cols, m, PLAN_SMS)
    grown = {}
    for r in (2, 4, 8, 16, 32, 64):  # whether 2R fits as R is staged
        try:
            grown[r] = pt.walk_plan(1, *args, rows=r)[1]
        except RuntimeError:
            grown[r] = None
    prev = 0
    for n in _plan_ns():
        rows, staged, tc = pt.walk_plan(n, *args)
        assert rows in (1, 2, 4, 8, 16, 32, 64) and tc * rows == \
            cs.K5_CHUNK_PAIRS
        assert rows >= prev, (n, rows, prev)
        prev = rows
        if rows > 1:
            assert rule(rows, n), n
        grow = 2 * rows
        if grow <= 64 and grown[grow] is not None and (
                grown[grow] or not staged):
            assert not rule(grow, n), n


def test_walk_plan_at_the_main_path_shapes(cuda):
    """The served Titanic GBT: one row a block at n = 1, small tiles whose
    chunk holds all 200 trees at 64 and 891 rows, 64-row tiles at 65,536;
    the out-of-core forest (16 trees, 500 features): 64-row tiles of
    staged rows; a forced R is kept; no plan past the shared memory."""
    plan = pt.walk_plan
    assert plan(1, 200, 496, 1, 1, 1, 132) == (1, True, 1024)
    assert plan(64, 200, 496, 1, 1, 1, 132) == (4, True, 256)
    assert plan(891, 200, 496, 1, 1, 1, 132) == (4, True, 256)
    assert plan(65536, 200, 496, 1, 1, 1, 132) == (64, True, 16)
    assert plan(4_456_448, 16, 500, 1, 2, 2, 132) == (64, True, 16)
    assert plan(300, 40, 13000, 4, 2, 2, 132)[1] is False
    assert plan(1, 200, 496, 1, 1, 1, 132, rows=32) == (32, True, 32)
    for bad in ((1, 200, 496, 1, 1, 1, 132, 3),
                (1, 1, 4, 1, 20000, 1, 132, 0)):
        with pytest.raises(RuntimeError, match="tree_walk_plan"):
            plan(*bad)


@pytest.mark.parametrize("R", [None, 1, 4, 64])
@pytest.mark.parametrize("K", [3, 12])
def test_class_tree_walk_kernel_at_tile_and_chunk_boundaries(cuda, K, R):
    """K5-mc over (row, class, round): rounds added in index order per
    (row, class), chunks of flat trees that cut a round's classes apart."""
    rng = np.random.default_rng(K * 100 + (R or 0))
    T = 171 if K == 3 else 45
    tables = [t.to(cuda) for t in _class_tables(rng, T, K, 6, 9)]
    for n in (1, 63, 64, 65, 891):
        Xb = torch.from_numpy(rng.integers(0, 33, (n, 9)).astype(
            np.int8)).to(cuda)
        before = pt.LAUNCHES["tree_walk_classes"]
        got = pt._tree_walk_classes_cuda(Xb, *tables, rows=R)
        torch.cuda.synchronize()
        assert pt.LAUNCHES["tree_walk_classes"] == before + 1
        assert torch.equal(got, pt.tree_walk_classes_plain(Xb, *tables))


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
    serving = ("bin_features", "tree_walk")
    before = {k: pt.LAUNCHES[k] for k in serving}
    scores = model.score_compiled(ds)
    torch.cuda.synchronize()
    assert all(pt.LAUNCHES[k] > before[k] for k in serving)
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


# --------------------------------------------------------------------------- #
# training kernels (K1, K2, K3, K8)                                           #
# --------------------------------------------------------------------------- #

def _fit_inputs(rng, P, n, d, n_bins, n_nodes):
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d)).astype(np.int8))
    Xb[:, min(3, d - 1)] = Xb[:, 0]  # a duplicate column: exact ties
    node = torch.from_numpy(
        rng.integers(0, n_nodes, (P, n)).astype(np.int32))
    G = torch.from_numpy(rng.normal(size=(P, 1, n)).astype(np.float32))
    H = torch.from_numpy(rng.uniform(0.05, 1, (P, n)).astype(np.float32))
    return Xb, node, G, H


FIT_SHAPES = [(1, 1, 1, 2, 1), (3, 257, 7, 8, 4), (6, 802, 496, 32, 32),
              (6, 802, 496, 32, 512), (2, 5000, 40, 32, 16)]


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FIT_SHAPES)
def test_histograms_kernel_matches_plain(cuda, P, n, d, n_bins, n_nodes):
    rng = np.random.default_rng(n + n_nodes)
    args = [t.to(cuda) for t in _fit_inputs(rng, P, n, d, n_bins, n_nodes)]
    before = pt.LAUNCHES["histograms"]
    hg, hh = pt.histograms(*args, n_nodes, n_bins)
    hg2, hh2 = pt.histograms(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["histograms"] == before + 2
    assert torch.equal(hg, hg2) and torch.equal(hh, hh2)
    wg, wh = pt.histograms_plain(*args, n_nodes, n_bins)
    torch.testing.assert_close(hg, wg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hh, wh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FIT_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_split_search_kernel_equals_plain(cuda, P, n, d, n_bins, n_nodes,
                                          masked):
    rng = np.random.default_rng(n * 3 + n_nodes)
    args = [t.to(cuda) for t in _fit_inputs(rng, P, n, d, n_bins, n_nodes)]
    hg, hh = pt.histograms(*args, n_nodes, n_bins)
    fm = None
    if masked:
        fm = torch.from_numpy(rng.random((P, d)) < 0.7).to(cuda)
    mcw = [1.0 + 2 * p for p in range(P)]
    kw = dict(reg_lambda=1.0, min_child_weight=mcw, min_gain=0.1,
              min_gain_norm=0.001, feature_mask=fm, level=3,
              active_depth=[4] * P)
    before = pt.LAUNCHES["split_search"]
    f, b = pt.split_search(hg, hh, n_bins, **kw)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["split_search"] == before + 1
    wf, wb = pt.split_search_plain(hg, hh, n_bins, **kw)
    assert torch.equal(f, wf) and torch.equal(b, wb)


def _live(node, n_nodes, extra_rate, rng):
    """Flags of the nodes that hold rows, and a share of the others (the
    subtraction path's left children)."""
    live = torch.zeros((node.shape[0], n_nodes), dtype=torch.uint8,
                       device=node.device).scatter_(1, node.long(), 1)
    more = torch.from_numpy(rng.random(tuple(live.shape)) < extra_rate)
    return live | more.to(live.device, torch.uint8)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FIT_SHAPES + [
    (53, 802, 496, 32, 2048), (16, 20000, 500, 32, 32)])
@pytest.mark.parametrize("lam,mcw", [(1.0, 1.0), (0.0, 0.0)])
def test_split_search_kernel_over_the_live_set_equals_plain(
        cuda, P, n, d, n_bins, n_nodes, lam, mcw):
    rng = np.random.default_rng(n * 7 + n_nodes)
    Xb, node, G, H = _fit_inputs(rng, P, n, d, n_bins, n_nodes)
    # a deep level: the rows fill a few nodes only
    node = node % max(1, n_nodes // 64) * 64 if n_nodes >= 512 else node
    Xb, node, G, H = (t.to(cuda) for t in (Xb, node, G, H))
    hg, hh = pt.histograms(Xb, node, G, H, n_nodes, n_bins)
    live = _live(node, n_nodes, 0.05, rng)
    kw = dict(reg_lambda=lam, min_child_weight=mcw, min_gain=0.0,
              min_gain_norm=0.0, feature_mask=None, level=3,
              active_depth=None)
    feats = torch.zeros((P, 3, 2 * n_nodes), dtype=torch.int32,
                        device=cuda)
    bins = torch.zeros_like(feats)
    mark = torch.zeros((P, 3, 2 * n_nodes), dtype=torch.uint8, device=cuda)
    before = dict(pt.LAUNCHES)
    f, b = pt.split_search(hg, hh, n_bins, live=live,
                           out=(feats[:, 1, :n_nodes], bins[:, 1, :n_nodes]),
                           mark=mark[:, 2], **kw)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["split_search_live"] == \
        before["split_search_live"] + 1
    assert pt.LAUNCHES["split_search"] == before["split_search"]
    wmark = torch.zeros((P, 2 * n_nodes), dtype=torch.uint8, device=cuda)
    wf, wb = pt.split_search_plain(hg, hh, n_bins, live=live, mark=wmark,
                                   **kw)
    df, db = pt.split_search(hg, hh, n_bins, **kw)
    assert torch.equal(f, wf) and torch.equal(b, wb)
    assert torch.equal(f, df) and torch.equal(b, db)
    assert torch.equal(mark[:, 2], wmark)
    assert not feats[:, (0, 2)].any() and not mark[:, (0, 1)].any()


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FIT_SHAPES + [
    (53, 802, 496, 32, 2048), (16, 20000, 500, 32, 32),
    (3, 257, 13001, 8, 4)])  # rows too wide for a shared tile
def test_route_kernel_out_of_place_with_flags_equals_plain(
        cuda, P, n, d, n_bins, n_nodes):
    rng = np.random.default_rng(n * 9 + n_nodes)
    Xb, node, G, H = (t.to(cuda) for t in
                      _fit_inputs(rng, P, n, d, n_bins, n_nodes))
    feat = torch.zeros((P, 4, 2 * n_nodes), dtype=torch.int32, device=cuda)
    bins = torch.zeros_like(feat)
    feat[:, 2, :n_nodes] = torch.from_numpy(
        rng.integers(0, d, (P, n_nodes)).astype(np.int32)).to(cuda)
    bins[:, 2, :n_nodes] = torch.from_numpy(
        rng.integers(0, n_bins + 1, (P, n_nodes)).astype(np.int32)).to(cuda)
    occ = torch.zeros((P, 4, 2 * n_nodes), dtype=torch.uint8, device=cuda)
    kept = node.clone()
    out = pt.route_level(Xb, node, feat[:, 2, :n_nodes],
                         bins[:, 2, :n_nodes], occupied=occ[:, 3])
    torch.cuda.synchronize()
    assert torch.equal(node, kept)
    wocc = torch.zeros((P, 2 * n_nodes), dtype=torch.uint8, device=cuda)
    want = pt.route_level_plain(Xb, node, feat[:, 2, :n_nodes].contiguous(),
                                bins[:, 2, :n_nodes].contiguous(),
                                occupied=wocc)
    assert torch.equal(out, want) and torch.equal(occ[:, 3], wocc)
    assert not occ[:, :3].any()
    if Xb.shape[1] > 1:  # int32 bins take the other entry
        out32 = pt.route_level(Xb.to(torch.int32), node,
                               feat[:, 2, :n_nodes], bins[:, 2, :n_nodes])
        assert torch.equal(out32, want)


@pytest.mark.parametrize("min_child_weight,min_gain", [(1.0, 0.0),
                                                       (0.0, -1.0)])
def test_depth12_trees_over_the_live_set_equal_the_dense_search(
        cuda, min_child_weight, min_gain):
    """Float gradients on the subtraction path: residues of parent −
    right in left children without rows (min_child_weight 0, gamma -1)
    are searched, as the dense search searches them. (The CPU's sums run
    in another order, so its trees may part at near-ties.)"""
    rng = np.random.default_rng(12)
    Xb, G, H = (t.to(cuda) for t in (
        _fit_inputs(rng, 4, 600, 24, 16, 1)[i] for i in (0, 2, 3)))
    kw = dict(reg_lambda=1.0, min_child_weight=min_child_weight,
              min_gain=min_gain)
    before = dict(pt.LAUNCHES)
    tree, node = pt.grow_trees(Xb, G, H, 12, 16, **kw)
    assert pt.LAUNCHES["split_search_live"] == \
        before["split_search_live"] + 11
    dense, dnode = pt.grow_trees(Xb, G, H, 12, 16, live=False, **kw)
    torch.cuda.synchronize()
    for k in ("feat", "bin", "leaf"):
        assert torch.equal(tree[k], dense[k])
    assert torch.equal(node, dnode)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FIT_SHAPES)
def test_route_and_leaf_kernels_match_plain(cuda, P, n, d, n_bins, n_nodes):
    rng = np.random.default_rng(n * 5 + n_nodes)
    Xb, node, G, H = (t.to(cuda) for t in
                      _fit_inputs(rng, P, n, d, n_bins, n_nodes))
    feat = torch.from_numpy(rng.integers(0, d, (P, n_nodes))
                            .astype(np.int32)).to(cuda)
    bins = torch.from_numpy(rng.integers(0, n_bins + 1, (P, n_nodes))
                            .astype(np.int32)).to(cuda)
    before = dict(pt.LAUNCHES)
    out = pt.route_level(Xb, node, feat, bins)
    leaf = pt.leaf_values(out, G, H, 2 * n_nodes, [1.0] * P,
                          [0.0, 0.2] * (P // 2) + [0.0] * (P % 2))
    torch.cuda.synchronize()
    assert pt.LAUNCHES["route_level"] == before["route_level"] + 1
    assert pt.LAUNCHES["leaf_values"] == before["leaf_values"] + 1
    assert torch.equal(out, pt.route_level_plain(Xb, node, feat, bins))
    want = pt.leaf_values_plain(out.cpu(), G.cpu(), H.cpu(), 2 * n_nodes,
                                [1.0] * P,
                                [0.0, 0.2] * (P // 2) + [0.0] * (P % 2))
    # the CPU's index_add_ adds in row order, as the kernel does
    assert torch.equal(leaf.cpu(), want)


@pytest.mark.parametrize("n_bins", [512, 4096])
@pytest.mark.parametrize("from_margin", [True, False])
def test_binned_aupr_kernel_equals_plain(cuda, n_bins, from_margin):
    rng = np.random.default_rng(n_bins)
    P, n = 6, 65536
    m = rng.normal(size=(P, n)).astype(np.float32) * 3
    if not from_margin:
        m = 1 / (1 + np.exp(-m))
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = (rng.random((P, n)) < 0.33).astype(np.float32)
    M, Y, W = (torch.from_numpy(a).to(cuda) for a in (m, y, w))
    before = pt.LAUNCHES["binned_aupr"]
    got = pdm.binned_aupr(M, Y, W, n_bins, from_margin)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["binned_aupr"] == before + 1
    want = pdm.binned_aupr_plain(M, Y, W, n_bins, from_margin)
    assert torch.equal(got, want)


def _aupr_case(rng, P, n, from_margin, clustered=False):
    m = rng.normal(size=(P, n)).astype(np.float32) * 3
    if clustered:  # 90 % of the rows in one bucket
        m[:, rng.random(n) < 0.9] = 0.8125
    if not from_margin:
        m = 1 / (1 + np.exp(-m))
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = (rng.random((P, n)) < 0.33).astype(np.float32)
    return m.astype(np.float32), y, w


def _check_aupr(cuda, m, y, w, n_bins, from_margin):
    M, Y, W = (torch.from_numpy(a).to(cuda) for a in (m, y, w))
    before = pt.LAUNCHES["binned_aupr"]
    got = pdm.binned_aupr(M, Y, W, n_bins, from_margin)
    again = pdm.binned_aupr(M, Y, W, n_bins, from_margin)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["binned_aupr"] == before + 2
    want = pdm.binned_aupr_plain(M, Y, W, n_bins, from_margin)
    assert torch.equal(got, want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    G, _ = pdm.aupr_row_blocks(*m.shape, n_bins)
    assert torch.equal(got, pdm.binned_aupr_blocks_plain(
        M, Y, W, n_bins, from_margin, G))
    return got


@pytest.mark.parametrize("n_bins", [512, 4096, 16384])
@pytest.mark.parametrize("from_margin", [True, False])
@pytest.mark.parametrize("n", [802, 100_003])
def test_binned_aupr_kernel_over_row_blocks(cuda, n_bins, from_margin, n):
    """One block a pair (n = 802) and rows split over blocks (n = 100,003:
    6 blocks a pair), histograms in shared memory (512, 4096 buckets) and
    in global scratch (16,384): equal to the plain version and to its
    block-order mirror, the same bits on two runs."""
    rng = np.random.default_rng(n_bins + n)
    _check_aupr(cuda, *_aupr_case(rng, 6, n, from_margin), n_bins,
                from_margin)


def test_binned_aupr_kernel_at_the_big_path_shape(cuda):
    """The LR grid's 8 holdout score rows at 2^22 + 13 rows, 4096 buckets:
    equal to the plain version, the same bits on two runs."""
    rng = np.random.default_rng(22)
    _check_aupr(cuda, *_aupr_case(rng, 8, 2 ** 22 + 13, False), 4096, False)


@pytest.mark.parametrize("n_bins,from_margin", [(512, True), (4096, False),
                                                (16384, False)])
@pytest.mark.parametrize("n", [802, 2 ** 20 + 7])
def test_binned_aupr_kernel_on_clustered_scores(cuda, n_bins, from_margin, n):
    """90 % of the scores in one bucket (a warp's lanes mostly share it):
    equal to the plain version."""
    rng = np.random.default_rng(n_bins + n)
    _check_aupr(cuda, *_aupr_case(rng, 3, n, from_margin, clustered=True),
                n_bins, from_margin)


@pytest.mark.parametrize("n", [802, 100_003])
def test_binned_aupr_kernel_without_positives(cuda, n):
    """No positive label, or no weight at all: 0 for every pair."""
    rng = np.random.default_rng(n)
    m, y, w = _aupr_case(rng, 4, n, True)
    got = _check_aupr(cuda, m, np.zeros_like(y), w, 512, True)
    assert not got.any()
    w[1] = 0.0
    got = _check_aupr(cuda, m, y, w, 4096, True)
    assert got[1] == 0 and got[0] > 0


def test_boosting_on_the_card_matches_the_cpu(cuda):
    """Three early-stopped pairs boosted on the card and on the CPU: the
    same split tables, margins within atol 1e-5."""
    rng = np.random.default_rng(3)
    n, d, P = 600, 30, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] + X[:, 3] + rng.normal(size=n)) > 0).astype(np.float32)
    edges = torch.from_numpy(pt.quantile_bin_edges(X, 32))
    fold = rng.integers(0, P, n)
    W = torch.from_numpy(np.stack([fold != k for k in range(P)])
                         .astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        Xb = pt.bin_features(torch.from_numpy(X).to(dev), edges.to(dev))
        trees, margin, _ = pt.fit_gbt_pairs(
            Xb, torch.from_numpy(y).to(dev), W.to(dev), 25, 6, 32, 0.1, 1.0,
            [1.0, 5.0, 10.0], gamma=0.5,
            val_w=(1 - W).to(dev), early_stopping_rounds=5,
            eval_metric="aupr", keep_trees=True)
        out[dev] = ({k: v.cpu() for k, v in trees.items()}, margin.cpu())
    (tc, mc), (tg, mg) = out["cpu"], out["cuda"]
    assert torch.equal(tc["bin"], tg["bin"])
    split = tc["bin"] < 32
    assert torch.equal(tc["feat"][split], tg["feat"][split])
    torch.testing.assert_close(mg, mc, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# forest kernels: m = 2 class channels, sibling subtraction (K1-sub)          #
# --------------------------------------------------------------------------- #

def _forest_inputs(rng, P, n, d, n_bins, n_nodes):
    Xb = torch.from_numpy(rng.integers(0, n_bins, (n, d)).astype(np.int8))
    node = torch.from_numpy(
        rng.integers(0, n_nodes + 1, (P, n)).astype(np.int32))  # + left out
    y = torch.from_numpy(rng.integers(0, 2, n))
    H = torch.from_numpy(rng.poisson(1.0, (P, n)).astype(np.float32))
    G = (torch.nn.functional.one_hot(y, 2).float().T[None]
         * H[:, None, :]).contiguous()
    return Xb, node, G, H


FOREST_SHAPES = [(1, 1, 1, 2, 1), (3, 257, 7, 8, 4), (4, 802, 496, 32, 1024),
                 (2, 5000, 40, 32, 16)]


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FOREST_SHAPES)
def test_histograms_kernel_with_class_channels_equals_plain(
        cuda, P, n, d, n_bins, n_nodes):
    rng = np.random.default_rng(n + n_nodes + 1)
    args = [t.to(cuda) for t in _forest_inputs(rng, P, n, d, n_bins,
                                               n_nodes)]
    before = pt.LAUNCHES["histograms"]
    hg, hh = pt.histograms(*args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["histograms"] == before + 1
    assert hg.shape == (P, 2, n_nodes, d, n_bins)
    wg, wh = pt.histograms_plain(*args, n_nodes, n_bins)
    assert torch.equal(hg, wg) and torch.equal(hh, wh)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FOREST_SHAPES)
def test_sibling_subtract_kernel_equals_plain(cuda, P, n, d, n_bins,
                                              n_nodes):
    rng = np.random.default_rng(n * 7 + n_nodes)
    Xb, node, G, H = (t.to(cuda) for t in
                      _forest_inputs(rng, P, n, d, n_bins, n_nodes))
    parent = torch.clamp(node, max=n_nodes - 1)
    right = torch.where(node % 2 == 1, parent,
                        torch.full_like(parent, n_nodes))
    hists = (*pt.histograms(Xb, parent, G, H, n_nodes, n_bins),
             *pt.histograms(Xb, right, G, H, n_nodes, n_bins))
    before = pt.LAUNCHES["sibling_subtract"]
    cg, ch = pt.sibling_subtract(*hists)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["sibling_subtract"] == before + 1
    wg, wh = pt.sibling_subtract_plain(*hists)
    assert torch.equal(cg, wg) and torch.equal(ch, wh)
    # an odd cell count takes the scalar path
    odd = [t[..., :n_bins - 1].contiguous() for t in hists]
    cg, ch = pt.sibling_subtract(*odd)
    wg, wh = pt.sibling_subtract_plain(*odd)
    assert torch.equal(cg, wg) and torch.equal(ch, wh)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FOREST_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_split_search_kernel_with_class_channels_equals_plain(
        cuda, P, n, d, n_bins, n_nodes, masked):
    rng = np.random.default_rng(n * 11 + n_nodes)
    Xb, node, G, H = (t.to(cuda) for t in
                      _forest_inputs(rng, P, n, d, n_bins, n_nodes))
    hg, hh = pt.histograms(Xb, node, G, H, n_nodes, n_bins)
    fm = (torch.from_numpy(rng.random((P, d)) < 0.5).to(cuda)
          if masked else None)
    for mcw, mgn in ((1.0, 0.0), (10.0, 0.001)):
        kw = dict(reg_lambda=1e-6, min_child_weight=mcw, min_gain=0.0,
                  min_gain_norm=mgn, feature_mask=fm, level=5,
                  active_depth=[12] * P)
        f, b = pt.split_search(hg, hh, n_bins, **kw)
        wf, wb = pt.split_search_plain(hg, hh, n_bins, **kw)
        assert torch.equal(f, wf) and torch.equal(b, wb)


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes", FOREST_SHAPES)
def test_leaf_kernel_with_class_channels_matches_plain(cuda, P, n, d,
                                                       n_bins, n_nodes):
    rng = np.random.default_rng(n * 13 + n_nodes)
    _, node, G, H = _forest_inputs(rng, P, n, d, n_bins, n_nodes)
    node = torch.clamp(node, max=n_nodes - 1)
    leaf = pt.leaf_values(node.to(cuda), G.to(cuda), H.to(cuda), n_nodes,
                          1e-6, 0.0)
    assert leaf.shape == (P, n_nodes, 2)
    want = pt.leaf_values_plain(node, G, H, n_nodes, 1e-6, 0.0)
    assert torch.equal(leaf.cpu(), want)


def test_depth12_forest_on_the_card_matches_the_cpu(cuda):
    """Two (config, fold) pairs of 4 depth-12 trees (the subtraction path)
    grown with the same draws on the card and on the CPU: equal tables,
    leaves equal (integer sums, the same divisions)."""
    rng = np.random.default_rng(5)
    n, d = 700, 30
    Xb = torch.from_numpy(rng.integers(0, 32, (n, d)).astype(np.int8))
    y = torch.from_numpy((rng.random(n) < 0.4).astype(np.int64))
    Y = torch.nn.functional.one_hot(y, 2).float()
    w = torch.from_numpy((rng.random((2, n)) < 0.67).astype(np.float32))
    draws = pt.forest_draws(4, n, d, seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        trees = pt.fit_forest(Xb.to(dev), Y.to(dev), w.to(dev), 4, 12, 32, 3,
                              min_child_weight=[1.0, 10.0],
                              min_gain=[0.0, 0.001], draws=draws)
        out[dev] = {k: v.cpu() for k, v in trees.items()}
    for k in ("feat", "bin", "leaf"):
        assert torch.equal(out["cpu"][k], out["cuda"][k]), k


# --------------------------------------------------------------------------- #
# forests with m = 3 class channels and the regression y channel (m = 1)      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m", [3, 1])
def test_depth12_multiclass_and_regression_forests_on_the_card(cuda, m):
    """Two pairs of 4 depth-12 trees grown with the same draws on the card
    and on the CPU: 3 one-hot class channels, or the regression label on a
    1/4 grid. Both give sums that are exact in any order, so the tables
    and leaves are equal. On general float labels a near-tie split may go
    either way (the example's fixture check holds that at the metric
    level)."""
    rng = np.random.default_rng(6 + m)
    n, d = 700, 12
    Xb = torch.from_numpy(rng.integers(0, 32, (n, d)).astype(np.int8))
    if m == 3:
        Y = torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(0, 3, n)), 3).float()
    else:
        Y = torch.from_numpy(np.round(
            (Xb[:, 0].numpy() * 0.5 + rng.normal(size=n) + 20) * 4)
            .astype(np.float32) / 4)[:, None]
    w = torch.from_numpy((rng.random((2, n)) < 0.67).astype(np.float32))
    draws = pt.forest_draws(4, n, d, seed=3)
    before = pt.LAUNCHES["histograms"]
    out = {}
    for dev in ("cpu", "cuda"):
        trees = pt.fit_forest(Xb.to(dev), Y.to(dev), w.to(dev), 4, 12, 32, 3,
                              min_child_weight=[1.0, 10.0],
                              min_gain=[0.0, 0.001], draws=draws)
        out[dev] = {k: v.cpu() for k, v in trees.items()}
    assert pt.LAUNCHES["histograms"] > before
    assert out["cuda"]["leaf"].shape[-1] == m
    for k in ("feat", "bin", "leaf"):
        assert torch.equal(out["cpu"][k], out["cuda"][k]), k


# --------------------------------------------------------------------------- #
# K8-mc and K8-reg                                                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("P,n,k", [(1, 1, 2), (26, 34, 3), (18, 65536, 3),
                                   (4, 3000, 32), (2, 0, 3)])
@pytest.mark.parametrize("weights", ["01", "frac"])
def test_confusion_counts_kernel_equals_plain(cuda, P, n, k, weights):
    rng = np.random.default_rng(P + n + k)
    y = torch.from_numpy(rng.integers(-1, k + 1, n).astype(np.int32))
    pred = torch.from_numpy(rng.integers(-1, k + 1, (P, n)).astype(np.int32))
    mask = torch.from_numpy(
        (rng.random((P, n)) < 0.4).astype(np.float32) if weights == "01"
        else rng.uniform(0, 2, (P, n)).astype(np.float32))
    args = [t.to(cuda) for t in (y, pred, mask)]
    before = pt.LAUNCHES["confusion_counts"]
    got = pdm.confusion_counts(*args, k)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["confusion_counts"] == before + 1
    assert got.shape == (P, k, k)
    want = pdm.confusion_counts_plain(y, pred, mask, k)
    if weights == "01":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(got, pdm.confusion_counts(*args, k))  # same bits


@pytest.mark.parametrize("P,n", [(1, 1), (8, 75), (18, 65536), (3, 1500)])
@pytest.mark.parametrize("weights", ["01", "frac"])
def test_regression_moments_kernel_equals_plain(cuda, P, n, weights):
    rng = np.random.default_rng(P * n)
    y = torch.from_numpy((rng.normal(size=n) * 9 + 22).astype(np.float32))
    pred = torch.from_numpy((y.numpy() + rng.normal(size=(P, n)) * 3)
                            .astype(np.float32))
    mask = torch.from_numpy(
        (rng.random((P, n)) < 0.3).astype(np.float32) if weights == "01"
        else rng.uniform(0, 2, (P, n)).astype(np.float32))
    args = [t.to(cuda) for t in (pred, y, mask)]
    before = pt.LAUNCHES["regression_moments"]
    got = pdm.regression_moments(*args)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["regression_moments"] == before + 1
    want = pdm.regression_moments_plain(pred, y, mask)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(got, pdm.regression_moments(*args))  # same bits
    rmse = pdm.regression_dev(args[1], args[0], args[2])["RMSE"]
    torch.testing.assert_close(
        rmse.cpu(), pdm.regression_dev(y, pred, mask)["RMSE"], rtol=1e-6,
        atol=0)


def test_evaluation_kernels_refuse_bad_inputs(cuda):
    y = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        pdm.confusion_counts(y, torch.zeros((1, 4), device=cuda),
                             torch.ones((1, 4), device=cuda), 3)
    with pytest.raises(ValueError, match="fewer than 1"):
        pdm.confusion_counts(y, y[None], torch.ones((1, 4), device=cuda), 0)
    with pytest.raises(ValueError, match=r"\(P, n\)"):
        pdm.regression_moments(torch.zeros(4, device=cuda),
                               torch.zeros(4, device=cuda),
                               torch.ones(4, device=cuda))


@pytest.mark.parametrize("weights", ["01", "frac"])
@pytest.mark.parametrize("P,n,k", cs.K8MC_HOSTILE_CASES)
def test_confusion_counts_kernel_on_hostile_cases(cuda, P, n, k, weights):
    """K8-mc at any class count (shared and global histograms), no row,
    one row and rows the plan's ranges do not divide: equal to the plain
    version at 0/1 weights, within 1e-6 relative at fractional ones, one
    launch, the same bits twice."""
    cpu = cs.eval_hostile_inputs(np.random.default_rng(P + n + k), P, n, k,
                                 weights)
    args = [t.to(cuda) for t in cpu]
    got, launches = cs.launched(pt, "confusion_counts",
                                lambda: pdm.confusion_counts(*args, k))
    assert launches == 1 and got.shape == (P, k, k)
    want = pdm.confusion_counts_plain(*cpu, k)
    if weights == "01":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(got, pdm.confusion_counts(*args, k))


@pytest.mark.parametrize("weights", ["01", "frac"])
@pytest.mark.parametrize("P,n", cs.K8REG_HOSTILE_CASES)
def test_regression_moments_kernel_on_hostile_cases(cuda, P, n, weights):
    cpu = cs.regression_hostile_inputs(np.random.default_rng(P * 7 + n), P,
                                       n, weights)
    args = [t.to(cuda) for t in cpu]
    got, launches = cs.launched(pt, "regression_moments",
                                lambda: pdm.regression_moments(*args))
    assert launches == 1
    torch.testing.assert_close(got.cpu(), pdm.regression_moments_plain(*cpu),
                               rtol=1e-6, atol=0)
    assert torch.equal(got, pdm.regression_moments(*args))


@pytest.mark.parametrize("P,n,k", [(18, 65536, 3), (3, 100_003, 300)])
def test_evaluation_kernels_replay_in_a_cuda_graph(cuda, P, n, k):
    """K8-mc and K8-reg with rows over several blocks (K8-reg: two
    launches and its arrival counters) captured in a CUDA graph: every
    replay equals the eager call."""
    rng = np.random.default_rng(n + k)
    y, pred, mask = (t.to(cuda) for t in cs.eval_hostile_inputs(
        rng, P, n, k, "frac"))
    rp, ry, rm = (t.to(cuda) for t in cs.regression_hostile_inputs(
        rng, P, n, "frac"))
    want = (pdm.confusion_counts(y, pred, mask, k),
            pdm.regression_moments(rp, ry, rm))
    assert pdm.confusion_plan(P, n, k)[0] > 1
    assert pdm.moments_row_blocks(P, n)[0] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pdm.confusion_counts(y, pred, mask, k)
        pdm.regression_moments(rp, ry, rm)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = (pdm.confusion_counts(y, pred, mask, k),
               pdm.regression_moments(rp, ry, rm))
    for _ in range(3):
        for t in out:
            t.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("P,n,d,n_bins,n_nodes,m", cs.MANY_CHANNEL_CASES)
def test_histograms_and_split_search_at_many_channels(cuda, P, n, d, n_bins,
                                                      n_nodes, m):
    """K1 at m = 5, 7 and 12 class channels, one launch a channel group:
    equal to the plain version (integer sums); K2 from the same
    histograms, dense and over the live set, masked and not, one launch:
    tables equal to the plain version's; each the same bits twice."""
    rng = np.random.default_rng(P * n + m)
    cpu = cs.many_channel_inputs(rng, P, n, d, n_bins, n_nodes, m)
    args = [t.to(cuda) for t in cpu]
    (hg, hh), launches = cs.launched(
        pt, "histograms", lambda: pt.histograms(*args, n_nodes, n_bins))
    assert launches == len(pt.hist_channel_groups(m, 4))
    wg, wh = pt.histograms_plain(*cpu, n_nodes, n_bins)
    assert torch.equal(hg.cpu(), wg) and torch.equal(hh.cpu(), wh)
    hg2, hh2 = pt.histograms(*args, n_nodes, n_bins)
    assert torch.equal(hg, hg2) and torch.equal(hh, hh2)
    live = torch.zeros((P, n_nodes), dtype=torch.uint8, device=cuda)
    live.scatter_(1, args[1].long().clamp(max=n_nodes - 1), 1)
    for fm in (None, torch.from_numpy(rng.random((P, d)) < 0.5).to(cuda)):
        kw = dict(reg_lambda=1e-6, min_child_weight=2.0, min_gain=0.0,
                  min_gain_norm=0.001, feature_mask=fm, level=3,
                  active_depth=[12] * P)
        for lv, name in ((None, "split_search"), (live, "split_search_live")):
            (f, b), launches = cs.launched(pt, name, lambda: pt.split_search(
                hg, hh, n_bins, live=lv, **kw))
            assert launches == 1
            wf, wb = pt.split_search_plain(hg, hh, n_bins, live=lv, **kw)
            assert torch.equal(f, wf) and torch.equal(b, wb)
            f2, b2 = pt.split_search(hg, hh, n_bins, live=lv, **kw)
            assert torch.equal(f, f2) and torch.equal(b, b2)


@pytest.mark.parametrize("m", [7, 12])
def test_many_class_forest_on_the_card_matches_the_cpu(cuda, m):
    """A depth-12 forest at m class channels (numpy draws on both
    devices): the card's tables equal the CPU's."""
    rng = np.random.default_rng(m)
    n, d = 3000, 16
    Xb = torch.from_numpy(rng.integers(0, 32, (n, d)).astype(np.int8))
    y = torch.from_numpy(np.clip((Xb[:, 0].numpy().astype(int)
                                  + rng.integers(0, 32, n)) * m // 64, 0,
                                 m - 1))
    Y = torch.nn.functional.one_hot(y, m).float()
    out = {}
    with pt.injected_forest_draws(cs.numpy_forest_draws):
        for dev in ("cpu", "cuda"):
            t = pt.fit_forest(Xb.to(dev), Y.to(dev), torch.ones(n, device=dev),
                              6, 12, 32, seed=4, min_child_weight=2.0,
                              min_gain=0.001)
            out[dev] = {k: v.cpu() for k, v in t.items()}
    for k in ("feat", "bin", "leaf"):
        assert torch.equal(out["cpu"][k], out["cuda"][k]), k


# --------------------------------------------------------------------------- #
# K5-mc, and the other families' fits on the card                             #
# --------------------------------------------------------------------------- #

IRIS_FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "testdata",
                            "families_iris_f32")


def _class_tables(rng, T, K, depth, d, n_bins=32):
    width = 2 ** depth
    return [torch.from_numpy(a) for a in (
        rng.integers(0, d, (T, K, depth, width)).astype(np.int32),
        rng.integers(0, n_bins + 1, (T, K, depth, width)).astype(np.int32),
        rng.normal(size=(T, K, width, 1)).astype(np.float32))]


@pytest.mark.parametrize("n,bin_dtype", [(150, torch.int8),
                                         (150, torch.int32),
                                         (65536, torch.int8),
                                         (65536, torch.int32)])
def test_class_tree_walk_kernel_equals_plain_on_the_iris_model(cuda, n,
                                                               bin_dtype):
    """K5-mc on the JAX package's Iris model (200 rounds x 3 classes at
    depth 10): equal to its plain version (rounds added in index order in
    f32 by both); one launch per call."""
    with np.load(os.path.join(IRIS_FIXTURE, "scores.npz")) as z:
        arr = {k: z[k] for k in z.files}
    feat, bins = (torch.from_numpy(arr[f"xgb_{k}"].astype(np.int32)).to(cuda)
                  for k in ("feat", "bin"))
    leaf = torch.from_numpy(arr["xgb_leaf"]).to(cuda)
    Xb = torch.from_numpy(arr["xgb_Xb"]) if n == 150 else torch.from_numpy(
        np.random.default_rng(n).integers(0, 32, (n, 3)).astype(np.int8))
    Xb = Xb.to(bin_dtype).to(cuda)
    before = pt.LAUNCHES["tree_walk_classes"]
    got = pt.tree_walk_classes(Xb, feat, bins, leaf)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["tree_walk_classes"] == before + 1
    assert torch.equal(got, pt.tree_walk_classes_plain(Xb, feat, bins, leaf))
    if n == 150:
        margin = pt.predict_gbt_multiclass_margin(
            {"feat": feat, "bin": bins, "leaf": leaf}, Xb,
            float(arr["xgb_learning_rate"]))
        np.testing.assert_allclose(margin.cpu().numpy(), arr["xgb_margin"],
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("T,K,depth,n", [(1, 1, 1, 1), (7, 12, 5, 300),
                                         (3, 40, 4, 2000)])
def test_class_tree_walk_kernel_with_many_classes(cuda, T, K, depth, n):
    rng = np.random.default_rng(T * K)
    tables = [t.to(cuda) for t in _class_tables(rng, T, K, depth, 6)]
    Xb = torch.from_numpy(rng.integers(0, 33, (n, 6)).astype(np.int8)).to(
        cuda)
    got = pt.tree_walk_classes(Xb, *tables)
    torch.cuda.synchronize()
    assert got.shape == (n, K)
    assert torch.equal(got, pt.tree_walk_classes_plain(Xb, *tables))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _fit_both(fit, *arrays, **kw):
    """fit(...) on the CPU and on the card from the same numpy inputs."""
    out = {}
    for dev in ("cpu", "cuda"):
        got = fit(*(torch.from_numpy(a).to(dev) for a in arrays), **kw)
        out[dev] = ({k: v.cpu() for k, v in got.items()}
                    if isinstance(got, dict) else
                    [{k: v.cpu() for k, v in layer.items()} for layer in got])
    return out["cpu"], out["cuda"]


def _well_conditioned(seed, n=300, d=8, k=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if k:
        y = np.argmax(X[:, :k] + rng.gumbel(size=(n, k)), 1)
    else:
        y = (X[:, :3].sum(1) + rng.logistic(size=n) > 0)
    w = (rng.random((2, n)) < 0.8).astype(np.float32)
    return X, y.astype(np.float32), w


def test_lbfgs_fits_on_the_card_match_the_cpu(cuda):
    """Logistic (binary and multinomial), SVC and two GLMs, 100 L-BFGS
    steps on well-conditioned data, two pairs each: coefficients within
    1e-4 relative of the CPU's."""
    from transmogrifai_tpu_torch.models import glm, linear_svc, logistic

    for k in (2, 3):
        X, y, w = _well_conditioned(k, k=k)
        c, g = _fit_both(logistic.fit_logreg, X, y, w, l2=[0.01, 0.1],
                         n_classes=k, max_iter=100)
        assert _rel(g["W"], c["W"]) <= 1e-4 and _rel(g["b"], c["b"]) <= 1e-4
    X, y, w = _well_conditioned(5)
    c, g = _fit_both(linear_svc.fit_linear_svc, X, y, w, l2=0.01,
                     max_iter=100)
    assert _rel(g["beta"], c["beta"]) <= 1e-4
    rng = np.random.default_rng(6)
    y_count = rng.poisson(np.exp(0.3 * X[:, :2].sum(1))).astype(np.float32)
    for family, link in (("poisson", "log"), ("gaussian", "identity")):
        c, g = _fit_both(glm.fit_glm, X, y_count, w, l2=0.01, family=family,
                         max_iter=100, link=link)
        assert _rel(g["beta"], c["beta"]) <= 1e-4, (family, link)


def test_naive_bayes_and_mlp_on_the_card_match_the_cpu(cuda):
    """Naive Bayes parameters within 1e-5; the MLP from the same initial
    weights within 1e-4 after 50 Adam steps, two learning rates."""
    from transmogrifai_tpu_torch.models import mlp, naive_bayes

    X, y, w = _well_conditioned(7, k=3)
    counts = np.abs(np.round(X * 3)).astype(np.float32)
    c, g = _fit_both(naive_bayes.fit_naive_bayes, counts, y, w,
                     smoothing=[1.0, 0.5], n_classes=3)
    for key in c:
        torch.testing.assert_close(g[key], c[key], rtol=0, atol=1e-5)
    init = [W.numpy() for W in mlp.init_weights((8, 6, 3), 3)]
    c, g = _fit_both(mlp.fit_mlp, X, y, w, layers=(8, 6, 3), max_iter=50,
                     learning_rate=[0.05, 0.01], init=init)
    for lc, lg in zip(c, g):
        for key in lc:
            torch.testing.assert_close(lg[key], lc[key], rtol=0, atol=1e-4)


def test_decision_trees_and_softmax_boosting_on_the_card_match_the_cpu(cuda):
    """A decision tree on classes and on a 1/4-grid label (exact sums:
    equal trees), and softmax boosting (5 rounds, 4 classes, depth 4):
    equal split tables, leaves and margins within 1e-5."""
    from transmogrifai_tpu_torch.stages.base import FitContext

    X, y, _ = _well_conditioned(8, n=500, k=4)
    y_reg = (np.round(X[:, 0] * 8) / 4).astype(np.float32)
    for est, labels in ((pt.OpDecisionTreeClassifier(max_depth=12), y),
                        (pt.OpDecisionTreeRegressor(max_depth=6), y_reg)):
        got = {}
        for dev in ("cpu", "cuda"):
            m = est.fit_arrays(torch.from_numpy(X).to(dev),
                               torch.from_numpy(labels).to(dev),
                               torch.ones(500, device=dev),
                               FitContext(n_rows=500, seed=1, device=dev))
            got[dev] = m.trees
        for k in ("feat", "bin"):
            np.testing.assert_array_equal(got["cuda"][k], got["cpu"][k])
        np.testing.assert_allclose(got["cuda"]["leaf"], got["cpu"]["leaf"],
                                   rtol=0, atol=1e-6)
    edges = torch.from_numpy(pt.quantile_bin_edges(X, 32))
    out = {}
    for dev in ("cpu", "cuda"):
        Xb = pt.bin_features(torch.from_numpy(X).to(dev), edges.to(dev))
        W = torch.ones((2, 500), device=dev)
        W[1, ::3] = 0.0
        trees, margin = pt.fit_gbt_multiclass_pairs(
            Xb, torch.from_numpy(y).to(dev), W, 5, 4, 32, 4, 0.3, 1.0,
            [1.0, 3.0], gamma=0.1, keep_trees=True)
        out[dev] = ({k: v.cpu() for k, v in trees.items()}, margin.cpu())
    (tc, mc), (tg, mg) = out["cpu"], out["cuda"]
    assert torch.equal(tc["bin"], tg["bin"])
    split = tc["bin"] < 32
    assert torch.equal(tc["feat"][split], tg["feat"][split])
    torch.testing.assert_close(tg["leaf"], tc["leaf"], rtol=0, atol=1e-5)
    torch.testing.assert_close(mg, mc, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# quantized serving (K10, K4-f16, K5-narrow) and CUDA graphs                  #
# --------------------------------------------------------------------------- #

def _wire_tree(rng, n, n_cols, d_vec=0):
    """A host device-input tree like a model's raw columns: scalar
    value/mask pairs, one 1-D leaf and optionally an (n, d_vec) vector."""
    tree = {}
    for j in range(n_cols):
        m = (rng.random(n) > 0.2).astype(np.float32)
        v = (rng.normal(size=n) * rng.uniform(0.1, 500)).astype(np.float32)
        tree[f"F{j:03d}"] = {"value": np.where(m > 0, v, 0.0).astype(
            np.float32), "mask": m}
    if d_vec:
        tree["V"] = (rng.normal(size=(n, d_vec)) * 30).astype(np.float32)
    return tree


@pytest.mark.parametrize("n,n_cols,d_vec", [
    (1, 3, 0), (64, 12, 5), (891, 12, 0), (4097, 7, 33), (64, 30, 3)])
@pytest.mark.parametrize("bits", [8, 4])
def test_wire_dequant_kernel_equals_plain(cuda, n, n_cols, d_vec, bits):
    """K10: every leaf of the tree in one launch per 48 leaves (masks
    included), equal to the plain version on the card and on the CPU."""
    from transmogrifai_tpu_torch.workflow import compiled as pc
    rng = np.random.default_rng(n + n_cols + bits)
    wire = pc.quantize_wire(_wire_tree(rng, n, n_cols, d_vec), bits)
    on_card = pc.to_device(wire, cuda)
    before = pt.LAUNCHES["wire_dequant"]
    got = pc.dequantize_wire(on_card, bits)
    torch.cuda.synchronize()
    leaves = 2 * n_cols + (1 if d_vec else 0)
    assert pt.LAUNCHES["wire_dequant"] == before + -(-leaves // 48)
    plain = pc.dequantize_wire_plain(on_card, bits)
    cpu = pc.dequantize_wire(pc.to_device(wire, "cpu"), bits)
    for key, node in got.items():
        for sub, t in (node.items() if isinstance(node, dict)
                       else [(None, node)]):
            want = plain[key] if sub is None else plain[key][sub]
            host = cpu[key] if sub is None else cpu[key][sub]
            assert t.dtype == torch.float32
            assert torch.equal(t, want), (key, sub)
            assert torch.equal(t.cpu(), host), (key, sub)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("leaves,n", cs.K10_HOSTILE_CASES)
def test_wire_dequant_kernel_on_hostile_wires(cuda, leaves, n, bits):
    """K10 at 1, 48, 49 and 97 leaves (one launch a 48 with work): width
    1, masks, even and odd widths (4 bits: the scalar path), empty leaves,
    unaligned views; equal to the plain version, the same bits twice."""
    from transmogrifai_tpu_torch.workflow import compiled as pc
    wire = cs.k10_hostile_wire(np.random.default_rng(leaves * 10 + n + bits),
                               leaves, n, bits, cuda)
    work = sum(1 for v in wire.values()
               if (v.numel() if isinstance(v, torch.Tensor)
                   else v["scale"].numel()) * n > 0)
    got, launches = cs.launched(pt, "wire_dequant",
                                lambda: pc.dequantize_wire(wire, bits))
    assert launches == -(-work // 48)
    assert cs.tree_equal(got, pc.dequantize_wire_plain(wire, bits))
    assert cs.tree_equal(got, pc.dequantize_wire(wire, bits))


@pytest.mark.parametrize("bits", [8, 4])
def test_wire_dequant_kernel_past_2_31_elements(cuda, bits):
    """A leaf of more than 2^31 elements (odd width 7) takes K10's 64-bit
    index path: its first, middle and last rows equal the plain version
    on those rows."""
    from transmogrifai_tpu_torch.workflow import compiled as pc
    d = 7
    n = (1 << 31) // d + 1001
    width = (d + 1) // 2 if bits == 4 else d
    gen = torch.Generator(device=cuda).manual_seed(bits)
    q = torch.randint(0, 256, (n, width), dtype=torch.uint8, device=cuda,
                      generator=gen)
    if bits == 4:
        q[:, -1] &= 0x0F
    scale = torch.linspace(0.01, 2.0, d, device=cuda)
    lo = torch.linspace(-30.0, 30.0, d, device=cuda)
    got = pc.dequantize_wire({"q": q, "scale": scale, "lo": lo}, bits)
    torch.cuda.synchronize()
    assert got.shape == (n, d) and n * d > 1 << 31
    for r0 in (0, n // 2, n - 1000):
        want = pc.dequantize_leaf_plain(
            {"q": q[r0:r0 + 1000], "scale": scale, "lo": lo}, bits)
        assert torch.equal(got[r0:r0 + 1000], want), r0
    del got, q


@pytest.mark.parametrize("n", [1, 64, 891, 5000])
def test_bin_features_f16_kernel_equals_plain(cuda, n):
    rng = np.random.default_rng(n)
    X, edges = _binning_inputs(rng, n, 40, 31)
    e16 = torch.from_numpy(edges).to(cuda).half()
    Xc = torch.from_numpy(X).to(cuda)
    Xc[::5, 3] = e16[3, 7].float()  # values on an f16 edge
    before = pt.LAUNCHES["bin_features_f16"]
    got = pt.bin_features(Xc, e16)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["bin_features_f16"] == before + 1
    assert torch.equal(got, pt.bin_features_plain(Xc, e16))
    assert torch.equal(got, pt.bin_features(Xc, e16.float()))


@pytest.mark.parametrize("n,n_trees,depth,m", [
    (1, 3, 2, 1), (64, 200, 10, 1), (891, 50, 12, 2), (3000, 20, 6, 3)])
def test_tree_walk_narrow_kernel_equals_plain(cuda, n, n_trees, depth, m):
    """K5 over int16 split features and uint8 split bins: equal to its
    plain version and to the int32 walk."""
    rng = np.random.default_rng(n + depth)
    Xb, feat, bins, leaf = (t.to(cuda) for t in _walk_inputs(
        rng, n, 37, n_trees, depth, m, torch.int8))
    f16, b8 = feat.to(torch.int16), bins.to(torch.uint8)
    before = pt.LAUNCHES["tree_walk_narrow"]
    got = pt.tree_walk(Xb, f16, b8, leaf)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["tree_walk_narrow"] == before + 1
    assert torch.equal(got, pt.tree_walk_plain(Xb, f16, b8, leaf))
    assert torch.equal(got, pt.tree_walk(Xb, feat, bins, leaf))


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_graph_replay_equals_eager_and_counts_launches(cuda, quant):
    """`score_padded` on the card replays one CUDA graph per bucket: its
    scores equal eager scoring of the same batches, and every replay
    counts the launches its capture recorded."""
    from transmogrifai_tpu_torch import Dataset, load_model
    from transmogrifai_tpu_torch.workflow import compiled as pc
    model = load_model(FIXTURE, device="cuda")
    ds = Dataset.from_csv(os.path.join(REPO, "examples", "data",
                                       "titanic.csv"))
    graphs = pc.CompiledScorer(model, quant=quant)
    eager = pc.CompiledScorer(model, quant=quant, graphs=False)
    assert graphs.graphs and not eager.graphs
    kernels = (("bin_features", "tree_walk") if quant is None else
               ("wire_dequant", "bin_features_f16", "tree_walk_narrow"))
    for rows, bucket in ((np.arange(5), 8), (np.arange(100, 108), 8),
                         (np.arange(30, 64), 64)):
        batch = ds.take(rows)
        before = {k: pt.LAUNCHES[k] for k in kernels}
        got = graphs.score_padded(batch, bucket)
        torch.cuda.synchronize()
        counted = {k: pt.LAUNCHES[k] - before[k] for k in kernels}
        want = eager.score_padded(batch, bucket)
        name = next(k for k, v in got.items()
                    if isinstance(v, dict) and "probability" in v)
        for k in ("prediction", "rawPrediction", "probability"):
            assert torch.equal(got[name][k], want[name][k]), k
        assert all(v >= 1 for v in counted.values()), counted
    assert len(graphs._graph_cache) == 2  # one per bucket


def test_graph_capture_failure_raises_and_names_the_stage(cuda):
    """A device stage that syncs with the host (`.item()`) cannot be
    captured: scoring raises and names it, with no eager fallback."""
    from transmogrifai_tpu_torch import Dataset, load_model
    model = load_model(FIXTURE, device="cuda")
    gbt = next(s for s in model.fitted.values()
               if type(s).__name__ == "GBTClassificationModel")
    inner = gbt.predict

    def syncing(consts, X):
        float(X.sum().item())
        return inner(consts, X)
    gbt.predict = syncing
    ds = Dataset.from_csv(os.path.join(REPO, "examples", "data",
                                       "titanic.csv"))
    with pytest.raises(RuntimeError, match="GBTClassificationModel"):
        model.compiled().score_padded(ds.take(np.arange(3)), 4)


# --------------------------------------------------------------------------- #
# the out-of-core path: K12, K1 over 16 lockstep learners, bf16 products      #
# --------------------------------------------------------------------------- #

def test_write_rows_kernel_equals_plain_past_2_31_elements(cuda):
    """K12's three entries against their plain versions, bit for bit, at
    rows whose flat offsets (r0 + r)·d pass 2^31 in a 4,456,448 × 500
    buffer, on a chunk with values on the edges, NaN, ±inf and bf16
    ties; rows outside the chunk stay untouched."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    n, d, c = 4_456_448, 500, 4096
    rng = np.random.default_rng(12)
    edges = np.sort(rng.normal(size=(d, 31)), axis=1).astype(np.float32)
    ch = rng.normal(size=(c, d)).astype(np.float16)
    ch[0] = edges[:, 7].astype(np.float16)
    ch[1, :3] = [np.nan, np.inf, -np.inf]
    ch[2, :2] = [np.float16(1.00390625), np.float16(1.01171875)]
    chunk, e = torch.from_numpy(ch).to(cuda), torch.from_numpy(edges).to(cuda)
    X16 = torch.zeros((n, d), dtype=torch.bfloat16, device=cuda)
    Xb = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    r0 = n - c
    assert r0 * d > 2 ** 31
    before = pt.LAUNCHES["write_rows"]
    pbd.dual_write_rows(X16, Xb, chunk, e, r0)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["write_rows"] == before + 1
    w16 = torch.zeros((c, d), dtype=torch.bfloat16, device=cuda)
    wb = torch.zeros((c, d), dtype=torch.int8, device=cuda)
    pbd.dual_write_rows_plain(w16, wb, chunk, e, 0)
    assert torch.equal(X16[r0:].view(torch.int16), w16.view(torch.int16))
    assert torch.equal(Xb[r0:], wb)
    assert not X16[:r0].view(torch.int16).any() and not Xb[:r0].any()
    X16.zero_()
    Xb.zero_()
    pbd.write_cast_rows(X16, chunk, r0 - 1)
    pbd.bin_write_rows(Xb, chunk, e, r0 - 1)
    torch.cuda.synchronize()
    assert torch.equal(X16[r0 - 1:n - 1].view(torch.int16),
                       w16.view(torch.int16))
    assert torch.equal(Xb[r0 - 1:n - 1], wb)
    del X16, Xb
    X32 = torch.zeros((c + 5, d), dtype=torch.float32, device=cuda)
    pbd.write_cast_rows(X32, chunk, 5)
    assert torch.equal(X32[5:].view(torch.int32),
                       chunk.float().view(torch.int32))  # NaN bits too
    with pytest.raises(ValueError, match="f16 chunk"):
        pbd.write_cast_rows(X32, chunk.float(), 0)


def _dequant_inputs(rng, c, d, bits, n_edges=31):
    """A uint8 wire chunk with codes over the whole range, scale and lo
    with a subnormal result (feature 0) and a subnormal scale and lo
    (feature 1), edges on dequantized values and one ulp beside them, a
    subnormal edge, and (int4, odd d) the pad nibble set."""
    qmax = (1 << bits) - 1
    q = rng.integers(0, qmax + 1, size=(c, d)).astype(np.uint8)
    scale = rng.uniform(0.01, 2.0, d).astype(np.float32)
    lo = (rng.normal(size=d) * 4.0).astype(np.float32)
    scale[0], lo[0] = 2.0 ** -110, -(2.0 ** -110) - 2.0 ** -130
    q[:3, 0] = [1, 0, 2]
    scale[1], lo[1] = np.float32(3e-39), np.float32(-1e-39)
    x = (q.astype(np.float64) * scale + lo).astype(np.float32)
    edges = np.sort(rng.normal(size=(d, n_edges)) * 4.0, axis=1).astype(
        np.float32)
    edges[2:, 5] = x[3, 2:]
    edges[2:, 6] = np.nextafter(x[4, 2:], np.float32(np.inf))
    edges[2:, 7] = np.nextafter(x[5, 2:], np.float32(-np.inf))
    edges[0, 0] = np.float32(1e-40)
    edges = np.sort(edges, axis=1)
    if bits == 4:
        packed = np.concatenate([q, np.zeros((c, d % 2), np.uint8)], 1)
        q = (packed[:, 0::2] | (packed[:, 1::2] << 4)).astype(np.uint8)
        if d % 2:
            q[:, -1] |= np.uint8(0xA0)
    return q, scale, lo, edges


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [500, 501, 7])
def test_dequant_write_rows_kernels_equal_plain(cuda, bits, d):
    """K12-dequant's three entries (bf16 and f32 targets, int8 bins, dual)
    against their plain versions bit for bit at 8 and 4 bits, odd d
    included: one FMA rounded once, subnormals flushed to signed zero,
    the bins of values on and beside edges; rows outside the chunk stay
    untouched; each entry counts its launch."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    rng = np.random.default_rng(bits * 1000 + d)
    c, n, r0 = 3000, 3100, 41
    q, scale, lo, edges = (torch.from_numpy(a).to(cuda) for a in
                           _dequant_inputs(rng, c, d, bits))
    key = f"_int{bits}"
    want16 = torch.zeros((n, d), dtype=torch.bfloat16, device=cuda)
    want32 = torch.zeros((n, d), dtype=torch.float32, device=cuda)
    wantb = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    pbd.dequant_write_rows_plain(want16, q, scale, lo, r0, bits)
    pbd.dequant_write_rows_plain(want32, q, scale, lo, r0, bits)
    pbd.dequant_bin_write_rows_plain(wantb, q, scale, lo, edges, r0, bits)
    assert want32[r0, 0].item() == 0.0 and \
        want32[r0:r0 + 1, 0].view(torch.int32).item() == -2 ** 31
    for name, bufs, call in (
            ("dequant_write_rows", ("16",), lambda b: pbd.dequant_write_rows(
                b["16"], q, scale, lo, r0, bits)),
            ("dequant_write_rows", ("32",), lambda b: pbd.dequant_write_rows(
                b["32"], q, scale, lo, r0, bits)),
            ("dequant_bin_write_rows", ("b",),
             lambda b: pbd.dequant_bin_write_rows(b["b"], q, scale, lo, edges,
                                                  r0, bits)),
            ("dequant_dual_write_rows", ("16", "b"),
             lambda b: pbd.dequant_dual_write_rows(
                 b["16"], b["b"], q, scale, lo, edges, r0, bits))):
        got = {"16": torch.zeros_like(want16), "32": torch.zeros_like(want32),
               "b": torch.zeros_like(wantb)}
        before = pt.LAUNCHES[name + key]
        call(got)
        torch.cuda.synchronize()
        assert pt.LAUNCHES[name + key] == before + 1
        want = {"16": want16, "32": want32, "b": wantb}
        for k in bufs:
            a, w = got[k], want[k]
            if a.dtype != torch.int8:
                a, w = a.view(torch.int16 if k == "16" else torch.int32), \
                    w.view(torch.int16 if k == "16" else torch.int32)
            assert torch.equal(a, w), (name, k)


def test_dequant_write_rows_kernel_past_2_31_elements(cuda):
    """The dual entry at rows whose flat offsets pass 2^31 in a 4,456,448
    × 500 buffer (int8 and int4), equal to its plain version; the rows
    before stay untouched."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    n, d, c = 4_456_448, 500, 4096
    r0 = n - c
    assert r0 * d > 2 ** 31
    X16 = torch.zeros((n, d), dtype=torch.bfloat16, device=cuda)
    Xb = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    for bits in (8, 4):
        rng = np.random.default_rng(bits)
        q, scale, lo, edges = (torch.from_numpy(a).to(cuda) for a in
                               _dequant_inputs(rng, c, d, bits))
        pbd.dequant_dual_write_rows(X16, Xb, q, scale, lo, edges, r0, bits)
        w16 = torch.zeros((c, d), dtype=torch.bfloat16, device=cuda)
        wb = torch.zeros((c, d), dtype=torch.int8, device=cuda)
        pbd.dequant_dual_write_rows_plain(w16, wb, q, scale, lo, edges, 0,
                                          bits)
        assert torch.equal(X16[r0:].view(torch.int16), w16.view(torch.int16))
        assert torch.equal(Xb[r0:], wb)
        assert not X16[:r0].view(torch.int16).any() and not Xb[:r0].any()


def _bits_view(t):
    return {torch.bfloat16: lambda: t.view(torch.int16),
            torch.float32: lambda: t.view(torch.int32)}.get(
                t.dtype, lambda: t)()


def _misaligned(t, cuda):
    """`chip_smoke.misaligned`: a contiguous copy of `t` one element past
    an aligned address (the kernels' scalar path)."""
    out = cs.misaligned(t.to(cuda))
    assert out.is_contiguous() and out.data_ptr() % 8 != 0
    return out


def _check_writes(cuda, n, d, entries):
    """Each (name, counter, buffer dtypes, kernel call, plain call) on
    buffers of n rows prefilled with a sentinel: the kernel's buffers equal
    the plain version's bit for bit (rows outside the chunk untouched), and
    the entry counts one launch."""
    for name, counter, dtypes, kernel, plain in entries:
        got = [torch.full((n, d), 3, dtype=dt, device=cuda) for dt in dtypes]
        want = [b.clone() for b in got]
        before = pt.LAUNCHES[counter]
        kernel(*got)
        torch.cuda.synchronize()
        assert pt.LAUNCHES[counter] == before + 1, name
        plain(*want)
        for a, w in zip(got, want):
            assert torch.equal(_bits_view(a), _bits_view(w)), name


@pytest.mark.parametrize("d,r0,n_edges,view", cs.K12_HOSTILE_CASES)
def test_write_rows_kernels_on_hostile_edges(cuda, d, r0, n_edges, view):
    """K12's four entries against their plain versions on
    `chip_smoke.hostile_edges` (unsorted, duplicate, NaN, +-inf and +-0
    edges, f16-exact so values fall on them) and `hostile_values` (values
    on edges, NaN, +-inf, +-0), at `chip_smoke.K12_HOSTILE_CASES`: d odd,
    d % 8 != 0, d < 8, r0 * d not a multiple of 8 (the scalar path), 126
    edges at d = 500, 1100 and 2100 features (many 256-feature windows), a
    misaligned chunk."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    rng = np.random.default_rng(d * 1000 + r0 + n_edges)
    c, n = 3000, 3100
    e = cs.hostile_edges(rng, d, n_edges).astype(np.float16).astype(
        np.float32)
    chunk = torch.from_numpy(cs.hostile_values(rng, c, e).astype(
        np.float16)).to(cuda)
    if view:
        chunk = _misaligned(chunk, cuda)
    edges = torch.from_numpy(e).to(cuda)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    _check_writes(cuda, n, d, [
        ("write_cast_rows bf16", "write_rows", (bf,),
         lambda b: pbd.write_cast_rows(b, chunk, r0),
         lambda b: pbd.write_cast_rows_plain(b, chunk, r0)),
        ("write_cast_rows f32", "write_rows", (f32,),
         lambda b: pbd.write_cast_rows(b, chunk, r0),
         lambda b: pbd.write_cast_rows_plain(b, chunk, r0)),
        ("bin_write_rows", "write_rows", (i8,),
         lambda b: pbd.bin_write_rows(b, chunk, edges, r0),
         lambda b: pbd.bin_write_rows_plain(b, chunk, edges, r0)),
        ("dual_write_rows", "write_rows", (bf, i8),
         lambda a, b: pbd.dual_write_rows(a, b, chunk, edges, r0),
         lambda a, b: pbd.dual_write_rows_plain(a, b, chunk, edges, r0))])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d,r0,view", cs.K12_DEQUANT_CASES)
def test_dequant_write_rows_kernels_on_hostile_edges(cuda, bits, d, r0, view):
    """Every K12-dequant entry against its plain version on hostile edges,
    a sorted feature in six with a dequantized value on one of its
    edges; 4 bits with an odd d and a misaligned chunk take the scalar
    path; 1100 to 2101 features span many 256-feature windows, 2101 at 4
    bits on the scalar path."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    rng = np.random.default_rng(bits * 7 + d + r0)
    c, n = 3000, 3100
    q, scale, lo, _ = _dequant_inputs(rng, c, d, bits)
    e = cs.hostile_edges(rng, d, 31)
    x = pbd.unpack_dequant_plain(torch.from_numpy(q), torch.from_numpy(scale),
                                 torch.from_numpy(lo), bits, d).numpy()
    e[0::6, 5] = x[3, 0::6]
    e[0::6] = np.sort(e[0::6], axis=1)
    q, scale, lo, edges = (torch.from_numpy(a).to(cuda)
                           for a in (q, scale, lo, e))
    if view:
        q = _misaligned(q, cuda)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    key = f"_int{bits}"
    _check_writes(cuda, n, d, [
        ("dequant_write_rows bf16", "dequant_write_rows" + key, (bf,),
         lambda b: pbd.dequant_write_rows(b, q, scale, lo, r0, bits),
         lambda b: pbd.dequant_write_rows_plain(b, q, scale, lo, r0, bits)),
        ("dequant_write_rows f32", "dequant_write_rows" + key, (f32,),
         lambda b: pbd.dequant_write_rows(b, q, scale, lo, r0, bits),
         lambda b: pbd.dequant_write_rows_plain(b, q, scale, lo, r0, bits)),
        ("dequant_bin_write_rows", "dequant_bin_write_rows" + key, (i8,),
         lambda b: pbd.dequant_bin_write_rows(b, q, scale, lo, edges, r0,
                                              bits),
         lambda b: pbd.dequant_bin_write_rows_plain(b, q, scale, lo, edges,
                                                    r0, bits)),
        ("dequant_dual_write_rows", "dequant_dual_write_rows" + key,
         (bf, i8),
         lambda a, b: pbd.dequant_dual_write_rows(a, b, q, scale, lo, edges,
                                                  r0, bits),
         lambda a, b: pbd.dequant_dual_write_rows_plain(
             a, b, q, scale, lo, edges, r0, bits))])


@pytest.mark.parametrize("wire", ["auto", "int8", "int4"])
def test_warm_replay_on_the_card_equals_its_cold_build(cuda, tmp_path, wire):
    """A store through the feature cache on the card: the cold readwrite
    build writes the artifact, the warm build replays it with zero store
    reads, both bit-equal, and equal to the CPU's build from the same
    artifact (the plain versions)."""
    from transmogrifai_tpu_torch.data import columnar_store as pcs
    from transmogrifai_tpu_torch.data import feature_cache as pfc
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    st = pcs.synth_binary_store(str(tmp_path / "s"), 20000, 41, seed=2,
                                chunk_rows=4096)
    edges = st.quantile_edges(32)
    params = pfc.FeatureCacheParams(dir=str(tmp_path / "c"),
                                    policy="readwrite", wire=wire)
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        x, b, s = pbd.dual_device_matrices(st, edges, chunk_rows=4096,
                                           cache=params, return_stats=True,
                                           device=dev)
        out.append((s, x.view(torch.int16).cpu(), b.cpu()))
    assert [o[0].cache for o in out] == ["miss", "hit", "hit"]
    assert out[1][0].read_s == 0.0 and out[1][0].bytes_read == 0
    for _, x, b in out[1:]:
        assert torch.equal(x, out[0][1]) and torch.equal(b, out[0][2])


def test_lockstep_histograms_of_16_learners_on_int8_equal_plain(cuda):
    """K1 over 16 lockstep learners on an int8 matrix (2 class channels of
    bf16-rounded bootstrap counts: integer sums, exact in any order) equals
    `histograms_plain`, at level 0 and at 8 nodes."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    rng = np.random.default_rng(16)
    K, n, d = 16, 65536, 500
    Xb = torch.from_numpy(rng.integers(0, 32, (n, d)).astype(np.int8)) \
        .to(cuda)
    y = rng.integers(0, 2, n)
    boot = rng.poisson(1.0, (K, n)).astype(np.float32)
    V = np.concatenate([np.eye(2, dtype=np.float32)[y][None]
                        * boot[:, :, None], boot[:, :, None]], -1)
    G, H = pbd._value_channels(torch.from_numpy(V).to(cuda))
    for n_nodes in (1, 8):
        node = torch.from_numpy(rng.integers(0, n_nodes, (K, n)).astype(
            np.int32)).to(cuda)
        before = pt.LAUNCHES["histograms"]
        hg, hh = pt.histograms(Xb, node, G, H, n_nodes, 32)
        torch.cuda.synchronize()
        assert pt.LAUNCHES["histograms"] == before + 1
        wg, wh = pt.histograms_plain(Xb, node, G, H, n_nodes, 32)
        assert torch.equal(hg, wg) and torch.equal(hh, wh)


def test_bf16_products_with_f32_output_match_the_widened_product(cuda):
    """`mm_f32` (torch.mm(..., out_dtype=torch.float32) on the card) on one
    HIST_CHUNK_ROWS chunk, both product shapes of the FISTA step, against
    the f32 product of the widened operands (TF32 off): the same exact
    products summed in another order, within 2·K·2^-24·Σ|a||b| per
    entry."""
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(14)
    n, d, gk = pbd.HIST_CHUNK_ROWS, 500, 16
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    Wt = torch.from_numpy(rng.normal(size=(d, gk)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    R = torch.from_numpy(rng.normal(size=(n, gk)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    for a, b in ((X, Wt), (X.T, R)):
        got = pbd.mm_f32(a, b)
        assert got.dtype == torch.float32
        want = torch.mm(a.float(), b.float())
        scale = torch.mm(a.float().abs(), b.float().abs())
        assert ((got - want).abs()
                <= 2 * a.shape[1] * 2.0 ** -24 * scale).all()


def test_big_path_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small store through the builders, the LR grid, the lockstep GBT
    and an 8-tree forest (the same draws injected) on the card and on the
    CPU: matrices bit-equal, trees equal, GBT margins within 2e-6, forest
    leaves equal (integer sums), LR within 1e-2 (the bf16 re-rounding of
    W; see tests/test_torch_bigdata.py)."""
    from transmogrifai_tpu_torch.data import columnar_store as pcs
    from transmogrifai_tpu_torch.parallel import bigdata as pbd
    st = pcs.synth_binary_store(str(tmp_path / "s"), 20000, 40, seed=2,
                                chunk_rows=4096)
    edges = st.quantile_edges(32)
    out = {}
    for dev in ("cpu", "cuda"):
        X16, Xb = pbd.dual_device_matrices(st, edges, chunk_rows=4096,
                                           workers=2, depth=2, device=dev)
        n_pad = X16.shape[0]
        y = np.zeros(n_pad, np.float32)
        y[:st.n_rows] = st.y
        w = (np.arange(n_pad) < st.n_rows).astype(np.float32)
        yd, wd = torch.from_numpy(y).to(dev), torch.from_numpy(w).to(dev)
        lr = pbd.fit_logreg_enet_grids_big(X16, yd, wd, [0.001, 0.01],
                                           [0.01, 0.1], 2, 50)
        gbt, margin = pbd.fit_gbt_big_lockstep(
            Xb, yd, torch.stack([wd, wd * (yd + 1)]), 2, 5, 32, 0.1, 1.0,
            chunk=4096)
        Y1 = torch.nn.functional.one_hot(yd.long(), 2).float()
        # a torch.Generator draws other numbers on the card: inject the
        # CPU's draws on both devices
        draws = pbd.forest_big_draws(4, range(8), n_pad, 40, 6, True, "cpu")
        rf = pbd.fit_forest_big(Xb, Y1, wd, 8, 5, 32, 2, seed=4,
                                chunk=4096, draws=draws)
        out[dev] = [t.cpu() for t in (X16.view(torch.int16), Xb,
                                      lr["W"], margin, gbt["feat"],
                                      gbt["bin"], rf["feat"], rf["bin"],
                                      rf["leaf"])]
    c, g = out["cpu"], out["cuda"]
    assert torch.equal(c[0], g[0]) and torch.equal(c[1], g[1])
    assert (c[2] - g[2]).abs().max() <= 1e-2
    torch.testing.assert_close(g[3], c[3], rtol=0, atol=2e-6)
    for a, b in zip(c[4:], g[4:]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# K1 pieces and few-row nodes, K3's two leaf designs                          #
# --------------------------------------------------------------------------- #

def _plain_dropping(Xb, node, G, H, n_nodes, n_bins):
    """`histograms_plain` with the kernel's rule for bin ids outside [0,
    n_bins): they go to a spare bin that is cut off."""
    spare = torch.where((Xb.long() < 0) | (Xb.long() >= n_bins),
                        torch.full_like(Xb.long(), n_bins), Xb.long())
    hg, hh = pt.histograms_plain(spare, node, G, H, n_nodes, n_bins + 1)
    return hg[..., :n_bins].contiguous(), hh[..., :n_bins].contiguous()


def _assert_within_sum_bound(got, want, mag, rows):
    """Two f32 summation orders of `rows` values each stay within
    2·(rows − 1)·2^-24·Σ|v| of each other."""
    tol = 2 * max(rows - 1, 1) * 2.0 ** -24 * mag
    assert bool(((got - want).abs() <= tol).all())


def _k1_case(rng, P, n, d, n_bins, n_nodes, m, bin_dtype, integer,
             left_out=0.0, dropped=0.0, skew=None):
    hi = n_bins + 3 if dropped else n_bins
    Xb = rng.integers(-2 if dropped else 0, hi, (n, d))
    if dropped:
        keep = rng.random((n, d)) >= dropped
        Xb = np.where(keep, np.clip(Xb, 0, n_bins - 1), Xb)
    Xb = torch.from_numpy(Xb.astype(np.int8 if bin_dtype == torch.int8
                                    else np.int32))
    if skew is None:
        node = rng.integers(0, n_nodes, (P, n))
    else:  # node 0 takes the share `skew`, the rest spread over the others
        node = np.where(rng.random((P, n)) < skew, 0,
                        rng.integers(0, n_nodes, (P, n)))
    if left_out:
        node = np.where(rng.random((P, n)) < left_out, n_nodes, node)
    node = torch.from_numpy(node.astype(np.int32))
    if integer:
        H = torch.from_numpy(rng.poisson(1.0, (P, n)).astype(np.float32))
        G = torch.from_numpy(rng.integers(0, 3, (P, m, n))
                             .astype(np.float32)) * H[:, None, :]
    else:
        G = torch.from_numpy(rng.normal(size=(P, m, n)).astype(np.float32))
        H = torch.from_numpy(rng.uniform(0.05, 1, (P, n)).astype(np.float32))
    return Xb, node, G.contiguous(), H


def _check_k1(cuda, args, n_nodes, n_bins, integer):
    dev_args = [t.to(cuda) for t in args]
    before = pt.LAUNCHES["histograms"]
    hg, hh = pt.histograms(*dev_args, n_nodes, n_bins)
    hg2, hh2 = pt.histograms(*dev_args, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["histograms"] == before + 2
    assert torch.equal(hg, hg2) and torch.equal(hh, hh2)  # run to run
    Xb, node, G, H = dev_args
    wg, wh = _plain_dropping(Xb, node, G, H, n_nodes, n_bins)
    if integer:
        assert torch.equal(hg, wg) and torch.equal(hh, wh)
        return
    rows = int(torch.bincount(node.reshape(-1).long()).max())
    mg, mh = _plain_dropping(Xb, node, G.abs(), H.abs(), n_nodes, n_bins)
    _assert_within_sum_bound(hg, wg, mg, rows)
    _assert_within_sum_bound(hh, wh, mh, rows)


@pytest.mark.parametrize("n_nodes,d,bin_dtype,integer", [
    (1, 40, torch.int8, True), (1, 37, torch.int8, False),
    (3, 40, torch.int32, True), (2, 41, torch.int32, False)])
def test_histograms_of_a_node_cut_into_many_pieces(cuda, n_nodes, d,
                                                   bin_dtype, integer):
    """A node of more than 2^20 rows (dozens of pieces of
    HIST_PIECE_ROWS): integer values equal to the plain version, float
    values within the summation bound and equal run to run; rows left out
    (node id n_nodes) and dropped bin ids across the piece edges."""
    rng = np.random.default_rng(n_nodes * 100 + d)
    n = (1 << 20) + 12345
    args = _k1_case(rng, 2, n, d, 32, n_nodes, 2, bin_dtype, integer,
                    left_out=0.1, dropped=0.01, skew=0.9)
    assert n // pt.HIST_PIECE_ROWS >= 32
    _check_k1(cuda, args, n_nodes, 32, integer)


@pytest.mark.parametrize("n_nodes,n", [(1024, 802), (2048, 1500),
                                       (2048, 3000)])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("bin_dtype", [torch.int8, torch.int32])
def test_histograms_of_mostly_empty_nodes(cuda, n_nodes, n, m, bin_dtype):
    """1024 and 2048 nodes that are mostly empty or hold one row, a few
    above HIST_FEW_ROWS (the piece path beside the few-rows path), rows
    left out and dropped bins: class-count values equal the plain version,
    float values within the summation bound."""
    rng = np.random.default_rng(n_nodes + n + m)
    for integer in (True, False):
        args = _k1_case(rng, 3, n, 52, 32, n_nodes, m, bin_dtype, integer,
                        left_out=0.3, dropped=0.02, skew=0.05)
        _check_k1(cuda, args, n_nodes, 32, integer)


@pytest.mark.parametrize("n_bins", [2, 7, 32, 255])
def test_histograms_bins_that_are_not_a_multiple_of_4(cuda, n_bins):
    """Scalar writes where n_bins % 4 != 0, one feature a thread where 4
    features of every lane do not fit in shared memory (255 bins)."""
    rng = np.random.default_rng(n_bins)
    dtype = torch.int8 if n_bins < 127 else torch.int32
    for n_nodes, n in ((1, 3000), (8, 20000), (64, 700)):
        args = _k1_case(rng, 2, n, 23, n_bins, n_nodes, 2, dtype, True,
                        left_out=0.2, dropped=0.05)
        _check_k1(cuda, args, n_nodes, n_bins, True)


def test_histogram_plan_kernel_writes_the_plain_plan(cuda):
    """The plan K1 writes on the card (`first`, `slot`) equals
    `hist_piece_plan` of the same segments, for nodes of few rows, nodes
    of one piece and nodes of many, and for one node of every row."""
    rng = np.random.default_rng(4)
    n = 3 * pt.HIST_PIECE_ROWS + 77
    for n_nodes, skew in ((1, 0.0), (9, 0.8), (600, 0.3)):
        args = [t.to(cuda) for t in _k1_case(rng, 3, n, 8, 32, n_nodes, 1,
                                              torch.int8, True, skew=skew)]
        plan = []
        pt._histograms_cuda(*args, n_nodes, 32, plan_out=plan)
        seg, first, slot, grid = plan
        want_f, want_s = pt.hist_piece_plan(seg.cpu())
        assert torch.equal(first.cpu(), want_f)
        assert torch.equal(slot.cpu(), want_s)
        assert int(want_f[:, -1].max()) <= grid


def _leaf_case(rng, P, n, L, m, one_leaf=False):
    if one_leaf:
        node = np.full((P, n), L - 1)
    else:  # a skewed spread, every odd leaf empty, a few large ones
        node = np.minimum(rng.geometric(0.05, (P, n)) - 1, L // 2 - 1) * 2
    G = rng.normal(size=(P, m, n)).astype(np.float32)
    H = rng.uniform(0.05, 1.0, (P, n)).astype(np.float32)
    return (torch.from_numpy(node.astype(np.int32)), torch.from_numpy(G),
            torch.from_numpy(H))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("one_leaf", [False, True])
def test_leaf_designs_are_bit_equal_to_row_order_sums(cuda, m, one_leaf):
    """Both leaf designs, and the wrapper's own choice, at the regime
    threshold ± 1 rows: every leaf bit-equal to the CPU's row-order sums,
    for one leaf holding every row and for empty leaves."""
    rng = np.random.default_rng(m + 10 * one_leaf)
    lam, alpha = [1.0, 0.5, 2.0], [0.0, 0.1, 0.0]
    for n in (pt.LEAF_SCAN_MAX_ROWS - 1, pt.LEAF_SCAN_MAX_ROWS,
              pt.LEAF_SCAN_MAX_ROWS + 1):
        node, G, H = _leaf_case(rng, 3, n, 64, m, one_leaf)
        want = pt.leaf_values_plain(node, G, H, 64, lam, alpha)
        nc, Gc, Hc = node.to(cuda), G.to(cuda), H.to(cuda)
        for regime in ("scan", "segments", None):
            got = pt._leaf_values_cuda(nc, Gc, Hc, 64, lam, alpha, regime)
            assert torch.equal(got.cpu(), want), (n, regime)
        assert pt.leaf_regime(n) == (
            "scan" if n <= pt.LEAF_SCAN_MAX_ROWS else "segments")


@pytest.mark.parametrize("P,n,L", [(1, 1, 1), (53, 802, 4096),
                                   (6, 802, 1024), (6, 65536, 1024),
                                   (16, 200000, 64)])
def test_leaf_designs_agree_at_the_main_path_shapes(cuda, P, n, L):
    """The forest, XGB and out-of-core leaf shapes (rows cut to fit the
    CPU's sums): both designs bit-equal to the CPU's row-order sums, scalar
    and per-pair hyperparameters alike."""
    rng = np.random.default_rng(P + n + L)
    node = torch.from_numpy(rng.integers(0, L, (P, n)).astype(np.int32))
    G = torch.from_numpy(rng.poisson(1.0, (P, 2, n)).astype(np.float32))
    H = torch.from_numpy(rng.uniform(0.05, 1.0, (P, n)).astype(np.float32))
    for lam, alpha in ((1e-6, 0.0), ([1.0 + p for p in range(P)], 0.2)):
        want = pt.leaf_values_plain(node, G, H, L, lam, alpha)
        for regime in ("scan", "segments"):
            got = pt._leaf_values_cuda(node.to(cuda), G.to(cuda), H.to(cuda),
                                       L, lam, alpha, regime)
            assert torch.equal(got.cpu(), want), regime


# --------------------------------------------------------------------------- #
# K9-hits, the rank transform and the bucketizers                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("index", range(len(cs.K9_HITS_CASES)),
                         ids=[c[0] for c in cs.K9_HITS_CASES])
def test_corr_hits_kernel_on_hostile_blocks(cuda, index):
    """K9-hits against `corr_hits_plain` on the same block product: ri,
    ci, vals and total bit-equal (the 40 identical columns past a cap of
    512 among them), the same bits twice, one launch a call. Each case's
    block is drawn from a seed of its own, its index."""
    from transmogrifai_tpu_torch import cuda_build
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    name, b, d, a, thr, cap, planted = cs.K9_HITS_CASES[index]
    rng = np.random.default_rng(index)
    C = torch.from_numpy(cs.k9_hits_input(rng, b, d, a, thr, planted))
    want = sc.corr_hits_plain(C, a, thr, cap)
    before = cuda_build.LAUNCHES["corr_hits"]
    got = sc.corr_hits(C.to(cuda), a, thr, cap)
    again = sc.corr_hits(C.to(cuda), a, thr, cap)
    assert cuda_build.LAUNCHES["corr_hits"] - before == 2
    for g, h, w in zip(got, again, want):
        assert cs.bits_equal(g.cpu(), w) and cs.bits_equal(h.cpu(), w)


def test_corr_hits_kernel_on_gram_blocks(cuda):
    """Every block of a real wide-path Gram (2,000 × 3,000 in blocks of
    1,024, planted duplicates and a group past the cap): bit-equal to the
    plain version on the same product, and the fit's pairs equal."""
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    rng = np.random.default_rng(12)
    X = rng.normal(size=(2000, 3000)).astype(np.float32)
    X[:, 900:1000] = X[:, 899:900]  # 101 copies: 5050 pairs, cap 4096
    X[:, 2500] = -2.0 * X[:, 17] + 1.0
    y = (X[:, 0] > 0).astype(np.float32)
    Xc = torch.from_numpy(X).to(cuda)
    blocks = []
    real = sc.corr_hits

    def held(C, a, thr, cap):
        got = real(C, a, thr, cap)
        want = sc.corr_hits_plain(C, a, thr, cap)
        assert all(cs.bits_equal(g, w) for g, w in zip(got, want)), a
        blocks.append(int(want[3]))
        return got

    sc.corr_hits = held
    try:
        corr, pairs = sc._corr_label_and_hits_blocked(
            Xc, torch.from_numpy(y).to(cuda), 0.99, block=256)
    finally:
        sc.corr_hits = real
    assert len(blocks) == 12 and max(blocks) > 16 * 256
    want_corr, want_pairs = sc._corr_label_and_hits_blocked(
        torch.from_numpy(X), torch.from_numpy(y), 0.99, block=256)
    assert {i: [j for j, _ in p] for i, p in pairs.items()} == \
        {i: [j for j, _ in p] for i, p in want_pairs.items()}
    np.testing.assert_allclose(corr, want_corr, atol=1e-5)


@pytest.mark.parametrize("ctype", ["pearson", "spearman"])
def test_wide_fit_on_the_card_matches_the_cpu(cuda, ctype, monkeypatch):
    """The checker's wide path (`_WIDE_D` 16) and its dense path on the
    card: kept indices and drop reasons equal to the CPU's, label
    correlations within 1e-5."""
    import transmogrifai_tpu_torch.types as T
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.stages.base import FitContext
    rng = np.random.default_rng(6)
    n, d = 400, 24
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 13] = X[:, 4]
    X[:, 5] = np.round(X[:, 5])
    X[:, 19] = 1.5
    y = (X[:, 0] + rng.normal(0, 0.5, n) > 0).astype(np.float64)
    cols = [Column(T.RealNN, {"value": y, "mask": np.ones(n, bool)}),
            Column(T.OPVector, X)]
    for wide in (False, True):
        if wide:
            monkeypatch.setattr(sc, "_WIDE_D", 16)
        fits = [sc.SanityChecker(correlation_type=ctype).fit_model(
            cols, FitContext(n_rows=n, seed=0, device=dev))
            for dev in ("cpu", cuda)]
        assert fits[0].indices == fits[1].indices and 13 not in fits[1].indices
        s0, s1 = (f.summary["stats"] for f in fits)
        assert [s["dropped"] for s in s0] == [s["dropped"] for s in s1]
        np.testing.assert_allclose([s["corrLabel"] for s in s1],
                                   [s["corrLabel"] for s in s0], atol=1e-5)


@pytest.mark.parametrize("ctype", ["pearson", "spearman"])
def test_wide_fit_peak_memory_on_the_card(cuda, ctype, monkeypatch):
    """The wide fit's device memory at 50,000 × 4,096 (`_WIDE_D` 1,024,
    blocks of 1,024 columns): Pearson builds U in X's storage, so its
    peak stays near X plus one block product; Spearman holds the ranks
    beside X and no third (n, d) tensor. The allowance covers a column
    chunk's temporaries (2 MB chunks here) and cuBLAS's workspace."""
    import transmogrifai_tpu_torch.types as T
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.stages.base import FitContext
    monkeypatch.setattr(sc, "_WIDE_D", 1024)
    monkeypatch.setattr(sc, "_BLOCK_ENTRIES", 1 << 22)
    monkeypatch.setattr(sc, "_CHUNK_ENTRIES", 1 << 19)
    rng = np.random.default_rng(4)
    n, d = 50_000, 4096
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 3000] = X[:, 7]
    y = (X[:, 0] > 0).astype(np.float64)
    cols = [Column(T.RealNN, {"value": y, "mask": np.ones(n, bool)}),
            Column(T.OPVector, X)]
    x_bytes, c_bytes = X.nbytes, 4 * sc.wide_block(d) * d
    torch.cuda.synchronize(cuda)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    fit = sc.SanityChecker(correlation_type=ctype).fit_model(
        cols, FitContext(n_rows=n, seed=0, device=cuda))
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert 3000 not in fit.indices
    copies = 1 if ctype == "pearson" else 2
    assert peak <= copies * x_bytes + c_bytes + (128 << 20), (peak, x_bytes)


def test_rank_transform_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """Average-tie ranks of ties, one-hot columns, NaN and ±0, whole and
    in column chunks: the card's bits equal the CPU's."""
    from transmogrifai_tpu_torch.automl import sanity_checker as sc
    rng = np.random.default_rng(1)
    A = rng.integers(0, 5, size=(3000, 40)).astype(np.float32)
    A[rng.integers(0, 3000, 50), rng.integers(0, 40, 50)] = np.nan
    A[:, 10] = 0.0
    A[::2, 11] = -0.0
    A[:, 12:30] = rng.normal(size=(3000, 18)).astype(np.float32)
    want = sc._rank_transform(torch.from_numpy(A))
    assert cs.bits_equal(sc._rank_transform(torch.from_numpy(A).to(cuda))
                         .cpu(), want)
    monkeypatch.setattr(sc, "_CHUNK_ENTRIES", 3 * 3000)
    assert cs.bits_equal(sc._rank_transform(torch.from_numpy(A).to(cuda))
                         .cpu(), want)
    y = rng.integers(0, 3, size=(3000, 1)).astype(np.float64)
    assert cs.bits_equal(sc._rank_transform(torch.from_numpy(y).to(cuda))
                         .cpu(), sc._rank_transform(torch.from_numpy(y)))


@pytest.mark.parametrize("splits", [
    [-np.inf, -1.0, 0.1, cs.BUCKET_F64_SPLIT, 5.0, np.inf],
    [-2.0, 0.1, cs.BUCKET_F64_SPLIT, 2.5], [-3.4e38, 0.0, 3.4e38]])
def test_bucketizer_device_apply_on_the_card_equals_the_cpu(cuda, splits):
    """`NumericBucketizerModel` (with the out-of-bounds and null columns)
    and `DecisionTreeBucketizerModel` on the hostile values: equal."""
    import transmogrifai_tpu_torch.types as T
    from transmogrifai_tpu_torch.data.columns import Column
    from transmogrifai_tpu_torch.ops.bucketizers import (
        DecisionTreeBucketizerModel, NumericBucketizerModel)
    vals = cs.bucket_hostile_values()
    x = Column.from_values(T.Real, vals)
    lab = Column.from_values(T.RealNN, [0.0] * len(vals))
    for stage, cols in ((NumericBucketizerModel(splits, track_invalid=True),
                         [x]),
                        (DecisionTreeBucketizerModel(
                            [s for s in splits[1:-1]]), [lab, x])):
        dev = [c.device_value(cuda) for c in cols]
        host = [c.device_value("cpu") for c in cols]
        got = stage.device_apply_with(stage.device_constants(cuda), None, dev)
        want = stage.device_apply_with(stage.device_constants("cpu"), None,
                                       host)
        assert torch.equal(got.cpu(), want)
