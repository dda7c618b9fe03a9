"""The host-side plans of the port's K1 and K3 wrappers, on the CPU.

K1 (`models/trees.py`: `hist_plan_bounds`, `hist_piece_plan`,
`hist_pieces`, `hist_scratch_bytes`) cuts each (pair, node) segment of the
rows grouped by node into pieces of at most `HIST_PIECE_ROWS` rows, leaves
nodes of at most `HIST_FEW_ROWS` rows to its few-rows path, and gives each
piece of a node of several pieces a scratch slot. These tests hold the
plan to its contract: the pieces cover every row of the piece path once
and in order, no piece crosses a segment, the launch grid and the scratch
slots bound what any spread of rows needs, and the byte counts that
`forest_chunk` and `lockstep_width` budget. A CPU model of the kernels'
arithmetic (a histogram per piece, pieces added in piece order) equals the
plain version on integer values, the JAX package's `_histograms` on
integer values, and stays within the f32 summation bound on floats. K3's
leaf pass picks its design by `leaf_regime`.
"""

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import trees as pt
from transmogrifai_tpu_torch.parallel import bigdata as pbd

R = pt.HIST_PIECE_ROWS
S = pt.HIST_FEW_ROWS


def _seg(counts):
    """(P, n_nodes + 1) int32 segments from per-node row counts."""
    c = torch.as_tensor(np.asarray(counts, dtype=np.int64))
    seg = torch.zeros((c.shape[0], c.shape[1] + 1), dtype=torch.int64)
    seg[:, 1:] = torch.cumsum(c, dim=1)
    return seg.to(torch.int32)


SPREADS = {
    "one node of every row": [[5 * R + 17]],
    "nodes just above R": [[R + 1] * 5 + [0, 3]],
    "nodes of exactly R": [[R, R, R, 1, S, S + 1]],
    "mostly empty": [[0] * 1000 + [1, 2, S, S + 1, 2 * R - 1] + [0] * 20],
    "two pairs": [[3, 0, 2 * R + 5, S + 1], [R * 3, 0, 0, 7]],
    "few rows only": [[S] * 8 + [0] * 8],
}


@pytest.mark.parametrize("name", sorted(SPREADS))
def test_pieces_cover_the_piece_rows_once_in_order(name):
    seg = _seg(SPREADS[name])
    P, K = seg.shape[0], seg.shape[1] - 1
    n = int(seg[:, -1].max())
    grid, slots = pt.hist_plan_bounds(n, K)
    first, slot = pt.hist_piece_plan(seg)
    got = pt.hist_pieces(seg, first, slot, grid)
    for p in range(P):
        node, start, end, sl = (got[k][p].tolist()
                                for k in ("node", "start", "end", "slot"))
        pieces = [(k, a, b, s) for k, a, b, s in zip(node, start, end, sl)
                  if k >= 0]
        assert len(pieces) == int(first[p, -1]) <= grid
        # the pieces, in block order, list the piece path's rows in order
        want = [r for k in range(K)
                if int(seg[p, k + 1] - seg[p, k]) > S
                for r in range(int(seg[p, k]), int(seg[p, k + 1]))]
        rows = [r for _, a, b, _ in pieces for r in range(a, b)]
        assert rows == want
        used = []
        for k, a, b, s in pieces:
            assert seg[p, k] <= a < b <= seg[p, k + 1]  # inside its node
            assert b - a <= R
            assert (a - int(seg[p, k])) % R == 0       # fixed boundaries
            n_k = int(seg[p, k + 1] - seg[p, k])
            if n_k > R:
                used.append(s)
            else:
                assert s == -1 and (a, b) == (int(seg[p, k]),
                                              int(seg[p, k + 1]))
        assert used == list(range(int(slot[p, -1])))  # slots in piece order
        assert len(used) <= slots


def test_plan_bounds_hold_for_the_worst_spreads():
    """Random and adversarial spreads: pieces never exceed the grid bound
    and scratch pieces never exceed the slot bound."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        K = int(rng.integers(1, 40))
        n = int(rng.integers(0, 8 * R))
        cuts = np.sort(rng.integers(0, n + 1, K - 1))
        counts = np.diff(np.concatenate([[0], cuts, [n]]))
        seg = _seg([counts])
        first, slot = pt.hist_piece_plan(seg)
        grid, slots = pt.hist_plan_bounds(n, K)
        assert int(first[0, -1]) <= grid
        assert int(slot[0, -1]) <= slots
    for K in (1, 2, 7, 64):  # every node just above R, or just above S
        for size in (R + 1, S + 1):
            n = K * size
            first, slot = pt.hist_piece_plan(_seg([[size] * K]))
            grid, slots = pt.hist_plan_bounds(n, K)
            assert int(first[0, -1]) <= grid and int(slot[0, -1]) <= slots


@pytest.mark.parametrize("n,n_nodes,want", [
    (802, 1024, (24, 0)), (65536, 512, (513, 2)),
    (4_456_448, 1, (136, 136)), (4_456_448, 32, (167, 167)),
    (R, 1, (1, 0)), (R + 1, 1, (2, 2)), (S, 1, (0, 0))])
def test_plan_bounds_at_the_main_path_shapes(n, n_nodes, want):
    assert pt.hist_plan_bounds(n, n_nodes) == want


def test_scratch_bytes_and_the_budgets_that_count_them():
    # no scratch while a pair has at most R rows (the in-memory trainers)
    assert pt.hist_scratch_bytes(53, 802, 1024, 2, 496, 32) == 0
    one = 3 * 500 * 32 * 4
    assert pt.hist_scratch_bytes(16, 4_456_448, 32, 2, 500, 32) \
        == 16 * 167 * one
    # forest_chunk adds a tree's scratch at its deepest level
    base = 3 * 496 * 32 * 4 * 2 ** 12
    _, _, small = pt.forest_chunk(900, 12, 2, 802, 496, 32, "cpu")
    _, _, big = pt.forest_chunk(900, 12, 2, 10 * R, 496, 32, "cpu")
    assert small == base + 802 * 496 * 16
    assert big == base + 10 * R * 496 * 16 + pt.hist_scratch_bytes(
        1, 10 * R, 2 ** 11, 2, 496, 32)
    # lockstep_width: without n as before; with n the scratch counts, and
    # the out-of-core depth-6 batch keeps its 16 learners
    assert pbd.lockstep_width(6, 500, 32, 2, 16) == 16
    assert pbd.lockstep_width(6, 500, 32, 2, 16, n=4_456_448) == 16
    assert pbd.lockstep_width(12, 500, 32, 2, 16, n=4_456_448) == 1
    assert pbd.lockstep_width(10, 500, 32, 1, 16, n=40 * R) < \
        pbd.lockstep_width(10, 500, 32, 1, 16)


@pytest.mark.parametrize("P,n,K", [(3, 1000, 8), (2, 5, 1), (1, 0, 4),
                                   (4, 1 << 20, 3), (16, 300000, 32)])
def test_node_segments_sort_rows_by_node_stably(P, n, K):
    """`node_segments` (a stable sort and a search, no counts on the host)
    gives the stable order and the segments of a plain stable argsort and
    counts."""
    rng = np.random.default_rng(P + n + K)
    node = torch.from_numpy(rng.integers(0, K + 1, (P, n)).astype(np.int32))
    order, seg = pt.node_segments(node, K)
    assert order.dtype == seg.dtype == torch.int32
    want = torch.argsort(node.long(), dim=1, stable=True)
    assert torch.equal(order.long(), want)
    counts = torch.stack([torch.bincount(r.long(), minlength=K + 1)
                          for r in node]) if n else torch.zeros(
        (P, K + 1), dtype=torch.int64)
    assert torch.equal(seg[:, 0].long(), torch.zeros(P, dtype=torch.int64))
    assert torch.equal((seg[:, 1:] - seg[:, :-1]).long(), counts[:, :K])


@pytest.mark.parametrize("n_bins,m,four,rows,want", [
    (32, 2, True, 4_456_448 / 32, (4, 4)),   # out-of-core: old lanes
    (32, 1, True, 65536 / 512, (4, 1)),      # XGB level 9: one lane
    (32, 2, True, 802 / 1024, (4, 1)),       # a deep forest level
    (32, 3, True, 1e6, (4, 3)),              # m = 3: three lanes fit
    (32, 4, True, 1e6, (4, 2)),
    (32, 2, False, 1e6, (1, 4)),             # d % 4 != 0: one feature
    (255, 2, True, 1e6, (1, 2)),             # 4 features do not fit
    (pt.HIST_LANE_ROWS, 1, True, pt.HIST_LANE_ROWS, (1, 1)),
])
def test_piece_block_layout(n_bins, m, four, rows, want):
    """K1's piece block: features a thread and row-lanes, from the shared
    memory budget, d % 4 and the rows a node averages."""
    assert pt._hist_layout(n_bins, m, four, rows) == want


def test_piece_block_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pt._hist_layout(4096, 4, True, 1e6)


def test_leaf_regime_switches_at_its_threshold():
    t = pt.LEAF_SCAN_MAX_ROWS
    assert pt.leaf_regime(t - 1) == pt.leaf_regime(t) == "scan"
    assert pt.leaf_regime(t + 1) == "segments"
    assert pt.leaf_regime(802) == "scan"            # the forest, XGB
    assert pt.leaf_regime(65536) == "segments"
    assert pt.leaf_regime(4_456_448) == "segments"  # the out-of-core path


# --------------------------------------------------------------------------- #
# a CPU model of the kernels' arithmetic                                      #
# --------------------------------------------------------------------------- #

def _piece_model(Xb, node, G, H, n_nodes, n_bins, piece_rows, few_rows):
    """K1 as the kernels cut it: a few-row node summed row by row, every
    piece of another node summed alone (by the plain version), a node's
    pieces added in piece order from 0. Returns (hg, hh)."""
    P, m, n = G.shape
    d = Xb.shape[1]
    order, seg = pt.node_segments(node, n_nodes)
    first, slot = pt.hist_piece_plan(seg, piece_rows, few_rows)
    grid, _ = pt.hist_plan_bounds(n, n_nodes, piece_rows, few_rows)
    pcs = pt.hist_pieces(seg, first, slot, grid, piece_rows)
    hg = torch.zeros((P, m, n_nodes, d, n_bins))
    hh = torch.zeros((P, n_nodes, d, n_bins))
    for p in range(P):
        for k in range(n_nodes):  # the few-rows path: row order
            a, b = int(seg[p, k]), int(seg[p, k + 1])
            if b - a > few_rows:
                continue
            for r in order[p, a:b].tolist():
                f = torch.arange(d)
                hg[p, :, k, f, Xb[r].long()] += G[p, :, r][:, None]
                hh[p, k, f, Xb[r].long()] += H[p, r]
        for q in range(grid):
            k = int(pcs["node"][p, q])
            if k < 0:
                continue
            rows = order[p, int(pcs["start"][p, q]):int(pcs["end"][p, q])]
            sub = torch.full((1, n), n_nodes, dtype=torch.int32)
            sub[0, rows.long()] = k
            g, h = pt.histograms_plain(Xb, sub, G[p:p + 1], H[p:p + 1],
                                       n_nodes, n_bins)
            hg[p, :, k] = hg[p, :, k] + g[0, :, k]
            hh[p, k] = hh[p, k] + h[0, k]
    return hg, hh


@pytest.mark.parametrize("integer", [True, False])
def test_piece_sums_equal_the_plain_version(integer):
    rng = np.random.default_rng(7 + integer)
    P, n, d, B, K = 2, 3000, 6, 8, 5
    Xb = torch.from_numpy(rng.integers(0, B, (n, d)).astype(np.int8))
    node = torch.from_numpy(np.where(rng.random((P, n)) < 0.7, 0,
                                     rng.integers(0, K, (P, n)))
                            .astype(np.int32))
    if integer:
        H = torch.from_numpy(rng.poisson(1.0, (P, n)).astype(np.float32))
        G = torch.from_numpy(rng.integers(0, 2, (P, 2, n))
                             .astype(np.float32)) * H[:, None]
    else:
        G = torch.from_numpy(rng.normal(size=(P, 2, n)).astype(np.float32))
        H = torch.from_numpy(rng.uniform(0.1, 1, (P, n)).astype(np.float32))
    got = _piece_model(Xb, node, G, H, K, B, piece_rows=256, few_rows=40)
    want = pt.histograms_plain(Xb, node, G, H, K, B)
    mag = pt.histograms_plain(Xb, node, G.abs(), H.abs(), K, B)
    for a, b, c in zip(got, want, mag):
        if integer:
            assert torch.equal(a, b)
        else:
            tol = 2 * (n - 1) * 2.0 ** -24 * c
            assert bool(((a - b).abs() <= tol).all())


def test_piece_sums_equal_the_jax_histograms_on_class_counts():
    """The same inputs through the JAX package's `_histograms` (one-hot
    matmuls; class counts are exact in bf16 and f32) and through the CPU
    model of the port's pieces: equal."""
    import jax.numpy as jnp
    from transmogrifai_tpu.models import trees as jt
    rng = np.random.default_rng(11)
    n, d, B, K = 1500, 5, 8, 3
    Xb = rng.integers(0, B, (n, d)).astype(np.int8)
    node = rng.integers(0, K, n).astype(np.int32)
    H = rng.poisson(1.0, n).astype(np.float32)
    G = (np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)] * H[:, None])
    jg, jh = jt._histograms(jt.bins_onehot(jnp.asarray(Xb), B),
                            jnp.asarray(node), jnp.asarray(G),
                            jnp.asarray(H), K)
    got = _piece_model(torch.from_numpy(Xb), torch.from_numpy(node)[None],
                       torch.from_numpy(G.T.copy())[None],
                       torch.from_numpy(H)[None], K, B, piece_rows=128,
                       few_rows=16)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(jg))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(jh))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions (no plan, no
    kernel), and the leaf pass takes scalar or per-pair hyperparameters."""
    rng = np.random.default_rng(3)
    P, n, d, B, K = 2, 200, 4, 8, 4
    Xb = torch.from_numpy(rng.integers(0, B, (n, d)).astype(np.int8))
    node = torch.from_numpy(rng.integers(0, K, (P, n)).astype(np.int32))
    G = torch.from_numpy(rng.normal(size=(P, 1, n)).astype(np.float32))
    H = torch.from_numpy(rng.uniform(0.1, 1, (P, n)).astype(np.float32))
    before = dict(pt.LAUNCHES)
    for a, b in zip(pt.histograms(Xb, node, G, H, K, B),
                    pt.histograms_plain(Xb, node, G, H, K, B)):
        assert torch.equal(a, b)
    for lam in (1.0, [1.0, 2.0], torch.tensor([1.0, 2.0])):
        assert torch.equal(pt.leaf_values(node, G, H, K, lam, 0.1),
                           pt.leaf_values_plain(node, G, H, K, lam, 0.1))
    assert pt.LAUNCHES == before
