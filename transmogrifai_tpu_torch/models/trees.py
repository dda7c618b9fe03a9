"""Tree ensembles: binning (K4), the ensemble walk (K5), the class-tree
walk of softmax boosting (K5-mc) and LOCO's walk of feature-group
ablations (K5-loco), and the fit side of gradient boosting,
random forests and decision trees: histograms (K1), sibling subtraction
(K1-sub), split search (K2), routing and leaf values (K3), the boosting
rounds (binary, regression and softmax), the forest fit and the
GBT/XGBoost/RF/decision-tree estimators.

The port's counterpart of the JAX package's `models/trees.py`. A fitted
ensemble is dense tables: per-feature bin edges (d, n_edges) f32, split
features and split bins (n_trees, depth, width) int32, and leaf values
(n_trees, n_leaves, m) f32. Scoring bins the feature matrix once, then
walks every tree level by level. Fitting grows trees level-wise: per
level, histograms of every node (m value channels — the gradient for
boosting, the classes for a forest — and one weight channel), the best
split of every node, then every row moves one level down.

The JAX package vmaps a fit over (grid config, fold) pairs; here every fit
tensor carries a leading pair axis P instead, and one launch of each
kernel serves all pairs of a level.

Each device program has two forms in this module:

- a kernel written by hand in CUDA C++ for Hopper (`csrc/*.cu`), built
  with `nvcc` and launched through ctypes on the current stream; its
  wrapper counts its launches in `LAUNCHES`;
- a plain PyTorch version of the same arithmetic (`*_plain`), the CPU path
  and the kernel's oracle.

The wrappers pick by the tensor's device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. There is no fallback
from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch.evaluators.device_metrics import (
    binned_aupr, sigmoid)
from transmogrifai_tpu_torch.models.base import (
    Param, PredictionModel, PredictorEstimator, binary_margin_pred, infer_n_classes, per_pair, regression_pred)
from transmogrifai_tpu_torch.parallel.rowshards import RowSplit, rows_of
from transmogrifai_tpu_torch.stages.base import div_const

log = logging.getLogger(__name__)

DEFAULT_MAX_BINS = 32

# --------------------------------------------------------------------------- #
# launch counters (shared by every kernel of the port)                        #
# --------------------------------------------------------------------------- #

LAUNCHES = cuda_build.LAUNCHES
reset_launches = cuda_build.reset_launches
_count = cuda_build.count


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# --------------------------------------------------------------------------- #
# K4: binning                                                                 #
# --------------------------------------------------------------------------- #

def bin_dtype(n_edges: int) -> torch.dtype:
    """int8 bin ids while they fit (n_edges + 1 <= 127), else int32 —
    the JAX package's storage rule."""
    return torch.int8 if n_edges + 1 <= 127 else torch.int32


def bin_features_plain(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) bin ids: the count of edges each value is >= (a broadcast
    compare; NaN compares false, so NaN → bin 0). f16 edges (the
    quantized mode's narrowed tables) are widened to f32 first, as the
    JAX package promotes them."""
    b = (X[:, :, None] >= edges.float()[None, :, :]).sum(-1,
                                                         dtype=torch.int32)
    return b.to(bin_dtype(edges.shape[-1]))


def monotone_edges(edges: torch.Tensor) -> torch.Tensor:
    """(d,) bool: each feature's edges are non-decreasing (e[j] <= e[j+1]
    for every j, false wherever an edge is NaN). The K4 kernel makes this
    test as it stages a feature's edges and counts such a feature by
    binary search (`search_bins_plain`), any other one linearly."""
    e = edges.float()
    return (e[:, :-1] <= e[:, 1:]).all(1)


def search_bins_plain(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) int32: the K4 kernel's binary search, the largest prefix
    length c with X[r, f] >= edges[f, c - 1], by binary lifting from the
    largest power of 2 <= n_edges (NaN stays at 0). It equals the
    broadcast count of `bin_features_plain` wherever the feature's edges
    are non-decreasing, and not in general elsewhere."""
    e = edges.float().T.contiguous()  # (n_edges, d)
    n_edges = e.shape[0]
    c = torch.zeros(X.shape, dtype=torch.int64, device=X.device)
    step = 1 << (n_edges.bit_length() - 1) if n_edges else 0
    while step:
        t = c + step
        v = torch.gather(e, 0, torch.clamp(t, max=n_edges) - 1)
        c = torch.where((t <= n_edges) & (X >= v), t, c)
        step >>= 1
    return c.to(torch.int32)


_BIN_ENTRIES = {(half, dtype): "bin_features_" + ("f16_" if half else "")
                + ("i8" if dtype == torch.int8 else "i32")
                for half in (False, True)
                for dtype in (torch.int8, torch.int32)}
_BIN_ARGS = cuda_build.register(
    "bin_features", _BIN_ENTRIES.values(),
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def _bin_features_cuda(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    # the checks that guard the launch, their messages built only on
    # refusal (an eager call at serving sizes is host-bound)
    if edges.device != X.device:
        raise ValueError(f"bin_features: X on {X.device}, edges on "
                         f"{edges.device}")
    if X.dtype != torch.float32 or edges.dtype not in (torch.float32,
                                                       torch.float16):
        raise ValueError(f"bin_features: needs f32 values and f32 or f16 "
                         f"edges, got {X.dtype}/{edges.dtype}")
    if X.dim() != 2 or edges.dim() != 2 or edges.shape[0] != X.shape[1]:
        raise ValueError(f"bin_features: shapes {tuple(X.shape)} / "
                         f"{tuple(edges.shape)}")
    half = edges.dtype == torch.float16
    n, d = X.shape
    n_edges = edges.shape[1]
    dtype = bin_dtype(n_edges)
    out = X.new_empty((n, d), dtype=dtype)
    if n == 0 or d == 0:
        return out
    X = X.contiguous()
    edges = edges.contiguous()
    name = _BIN_ENTRIES[half, dtype]
    fn = cuda_build.entry("bin_features", name)
    err = cuda_build.launch(X.get_device(), fn, X.data_ptr(),
                            edges.data_ptr(), out.data_ptr(), n, d, n_edges)
    cuda_build.check(name, err)
    _count("bin_features_f16" if half else "bin_features")
    return out


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) int8 bin ids in [0, n_edges] (int32 above 126 edges):
    `Xb[r, f] = #{e : X[r, f] >= edges[f, e]}`, NaN → 0; f32 or f16
    edges. A CUDA tensor launches the K4 kernel (its f16-edge variant for
    f16 edges) or raises; a CPU tensor takes the plain version."""
    _check_device(X, "bin_features")
    if X.is_cuda:
        return _bin_features_cuda(X, edges)
    return bin_features_plain(X, edges)


# --------------------------------------------------------------------------- #
# K5: the ensemble walk                                                       #
# --------------------------------------------------------------------------- #

def _walk_shapes(Xb, feat, bins, leaf):
    """(n_trees, depth, width) of matching walk inputs; the checks format
    their messages only when one fails (the served path calls this every
    batch)."""
    if Xb.dim() != 2:
        raise ValueError(f"tree_walk: Xb must be (n, d), got "
                         f"{tuple(Xb.shape)}")
    if feat.dim() != 3 or feat.shape != bins.shape:
        raise ValueError(f"tree_walk: feat {tuple(feat.shape)} / bin "
                         f"{tuple(bins.shape)} must be equal (n_trees, "
                         f"depth, width)")
    if leaf.dim() != 3 or leaf.shape[0] != feat.shape[0]:
        raise ValueError(f"tree_walk: leaf {tuple(leaf.shape)} must be "
                         f"(n_trees, n_leaves, m)")
    n_trees, depth, width = feat.shape
    if depth > 0 and 2 ** (depth - 1) > width:
        raise ValueError(f"tree_walk: width {width} < 2^(depth-1) at depth "
                         f"{depth}")
    if 2 ** depth > leaf.shape[1]:
        raise ValueError(f"tree_walk: {leaf.shape[1]} leaves < 2^depth at "
                         f"depth {depth}")
    return n_trees, depth, width


def _walk_nodes(Xb: torch.Tensor, feat: torch.Tensor,
                bins: torch.Tensor) -> torch.Tensor:
    """(n_trees, n) leaf index of every row in every tree of tables (n_trees,
    depth, width): all trees walk together, one level at a time, with
    `torch.gather`."""
    n_trees, depth, _ = feat.shape
    n = Xb.shape[0]
    node = torch.zeros((n_trees, n), dtype=torch.long, device=Xb.device)
    rows = torch.arange(n, device=Xb.device)[None, :]
    for level in range(depth):
        f = torch.gather(feat[:, level, :].long(), 1, node)
        b = torch.gather(bins[:, level, :].long(), 1, node)
        node = node * 2 + (Xb[rows, f].long() > b).long()
    return node


def tree_walk_plain(Xb: torch.Tensor, feat: torch.Tensor, bins: torch.Tensor,
                    leaf: torch.Tensor) -> torch.Tensor:
    """(n, m) f32 sum over trees of each row's leaf values. All trees walk
    together, one level at a time, with `torch.gather`; the leaf values
    are then summed in tree order."""
    n_trees, _, _ = _walk_shapes(Xb, feat, bins, leaf)
    n, m = Xb.shape[0], leaf.shape[-1]
    node = _walk_nodes(Xb, feat, bins)
    vals = torch.gather(leaf, 1, node[:, :, None].expand(n_trees, n, m))
    acc = torch.zeros((n, m), dtype=torch.float32, device=Xb.device)
    for t in range(n_trees):
        acc = acc + vals[t]
    return acc


_WALK_ARGS = cuda_build.register(
    "tree_walk", "tree_walk_typed",
    (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) + (ctypes.c_int,) * 10
    + (ctypes.c_void_p,))
cuda_build.register("tree_walk", "tree_walk_plan",
                    (ctypes.c_int64,) + (ctypes.c_int,) * 7
                    + (ctypes.c_void_p,))


def walk_plan(n: int, n_flat: int, d: int, xb_bytes: int, n_cols: int,
              m: int, sms: int, rows: int = 0) -> Tuple[int, bool, int]:
    """(R, staged, TC): the rows a block, whether their Xb is staged and
    the trees a chunk that K5's kernel plans (csrc/tree_walk.cu `plan`)
    for n rows, n_flat trees, d features of xb_bytes each, n_cols output
    columns and m leaf channels a tree on a card of `sms` SMs; `rows`
    forces R. Builds the kernel's library (a card's machine only)."""
    out = (ctypes.c_int * 3)()
    cuda_build.check("tree_walk_plan", cuda_build.entry(
        "tree_walk", "tree_walk_plan")(n, n_flat, d, xb_bytes, n_cols, m,
                                       sms, rows, out))
    return out[0], bool(out[1]), out[2]


def _walk_launch(fname, Xb, feat, bins, leaf, out, *shape_args,
                 rows=None) -> None:
    """Launch K5's entry `fname` over contiguous inputs, with the kernel's
    own plan or `rows` a block."""
    n, d = Xb.shape
    err = cuda_build.launch(
        Xb.get_device(), cuda_build.entry("tree_walk", fname),
        Xb.data_ptr(), feat.data_ptr(), bins.data_ptr(), leaf.data_ptr(),
        out.data_ptr(), n, d, *shape_args, rows or 0,
        *_type_bytes(Xb, feat, bins))
    cuda_build.check(fname, err)


def _check_walk_inputs(fname, Xb, feat, bins, leaf) -> None:
    """The devices and dtypes the walk kernels take: int8/int32 bins, and
    int32 tables or the quantized mode's narrowed ones (int16 features,
    uint8 split bins). Messages are formatted only on a failure."""
    for name, t in (("feat", feat), ("bin", bins), ("leaf", leaf)):
        if t.device != Xb.device:
            raise ValueError(f"{fname}: Xb on {Xb.device}, {name} on "
                             f"{t.device}")
    if Xb.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"{fname}: Xb must be int8 or int32, got {Xb.dtype}")
    if feat.dtype not in (torch.int32, torch.int16) \
            or bins.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"{fname}: feat must be int32 or int16 and bin "
                         f"int32 or uint8, got {feat.dtype}/{bins.dtype}")
    if leaf.dtype != torch.float32:
        raise ValueError(f"{fname}: leaf must be f32, got {leaf.dtype}")


def _narrowed(feat: torch.Tensor, bins: torch.Tensor) -> bool:
    return feat.dtype != torch.int32 or bins.dtype != torch.int32


def _type_bytes(Xb, feat, bins) -> Tuple[int, int, int]:
    return Xb.element_size(), feat.element_size(), bins.element_size()


def _tree_walk_cuda(Xb, feat, bins, leaf, rows=None) -> torch.Tensor:
    _check_walk_inputs("tree_walk", Xb, feat, bins, leaf)
    n_trees, depth, width = _walk_shapes(Xb, feat, bins, leaf)
    n = Xb.shape[0]
    n_leaves, m = leaf.shape[1], leaf.shape[2]
    Xb, feat, bins, leaf = (t.contiguous() for t in (Xb, feat, bins, leaf))
    if n == 0 or m == 0 or n_trees == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=Xb.device)
    out = torch.empty((n, m), dtype=torch.float32, device=Xb.device)
    _walk_launch("tree_walk_typed", Xb, feat, bins, leaf, out, n_trees,
                 depth, width, n_leaves, m, rows=rows)
    _count("tree_walk_narrow" if _narrowed(feat, bins) else "tree_walk")
    return out


def tree_walk(Xb: torch.Tensor, feat: torch.Tensor, bins: torch.Tensor,
              leaf: torch.Tensor) -> torch.Tensor:
    """(n, m) f32: for each row, the sum over trees (in index order) of
    the leaf it reaches. Per level, `node = 2·node + (Xb[r, feat[t, l,
    node]] > bin[t, l, node])`; a split bin equal to n_bins never fires.
    Feature ids must lie in [0, d). A CUDA tensor launches the K5 kernel
    (or raises); a CPU tensor takes the plain version."""
    _check_device(Xb, "tree_walk")
    if Xb.is_cuda:
        return _tree_walk_cuda(Xb, feat, bins, leaf)
    return tree_walk_plain(Xb, feat, bins, leaf)


# --------------------------------------------------------------------------- #
# K5-mc: the class-tree walk of softmax boosting                              #
# --------------------------------------------------------------------------- #

def _walk_classes_shapes(Xb, feat, bins, leaf):
    _require(Xb.dim() == 2, f"tree_walk_classes: Xb must be (n, d), got "
                            f"{tuple(Xb.shape)}")
    _require(feat.dim() == 4 and feat.shape == bins.shape,
             f"tree_walk_classes: feat {tuple(feat.shape)} / bin "
             f"{tuple(bins.shape)} must be equal (rounds, classes, depth, "
             f"width)")
    _require(leaf.dim() == 4 and leaf.shape[:2] == feat.shape[:2]
             and leaf.shape[3] == 1,
             f"tree_walk_classes: leaf {tuple(leaf.shape)} must be (rounds, "
             f"classes, n_leaves, 1)")
    _walk_shapes(Xb, feat.flatten(0, 1), bins.flatten(0, 1),
                 leaf.flatten(0, 1))
    return feat.shape


def tree_walk_classes_plain(Xb: torch.Tensor, feat: torch.Tensor,
                            bins: torch.Tensor,
                            leaf: torch.Tensor) -> torch.Tensor:
    """(n, K) f32: for each row and class k, the sum over rounds (in index
    order) of the leaf it reaches in tree (t, k)."""
    T, K, _, _ = _walk_classes_shapes(Xb, feat, bins, leaf)
    n = Xb.shape[0]
    node = _walk_nodes(Xb, feat.flatten(0, 1), bins.flatten(0, 1))
    vals = torch.gather(leaf.flatten(0, 1)[:, :, 0], 1, node).reshape(
        T, K, n)
    acc = torch.zeros((K, n), dtype=torch.float32, device=Xb.device)
    for t in range(T):
        acc = acc + vals[t]
    return acc.T.contiguous()


_WALK_CLASSES_ARGS = cuda_build.register(
    "tree_walk", "tree_walk_classes_typed",
    (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) + (ctypes.c_int,) * 10
    + (ctypes.c_void_p,))


def _tree_walk_classes_cuda(Xb, feat, bins, leaf,
                            rows=None) -> torch.Tensor:
    _check_walk_inputs("tree_walk_classes", Xb, feat, bins, leaf)
    T, K, depth, width = _walk_classes_shapes(Xb, feat, bins, leaf)
    n = Xb.shape[0]
    Xb, feat, bins, leaf = (t.contiguous() for t in (Xb, feat, bins, leaf))
    if n == 0 or K == 0 or T == 0:
        return torch.zeros((n, K), dtype=torch.float32, device=Xb.device)
    out = torch.empty((n, K), dtype=torch.float32, device=Xb.device)
    _walk_launch("tree_walk_classes_typed", Xb, feat, bins, leaf, out,
                 T, K, depth, width, leaf.shape[2], rows=rows)
    _count("tree_walk_classes")
    return out


def tree_walk_classes(Xb: torch.Tensor, feat: torch.Tensor,
                      bins: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(n, K) f32 per-class sums of a softmax-boosted ensemble: tables
    (rounds, K, depth, width) int32 and leaves (rounds, K, n_leaves, 1)
    f32; out[r, k] = Σ_t leaf[t, k, walk_{t,k}(r)], rounds added in index
    order. A CUDA tensor launches the K5-mc kernel (or raises); a CPU
    tensor takes the plain version."""
    _check_device(Xb, "tree_walk_classes")
    if Xb.is_cuda:
        return _tree_walk_classes_cuda(Xb, feat, bins, leaf)
    return tree_walk_classes_plain(Xb, feat, bins, leaf)


# --------------------------------------------------------------------------- #
# K5-loco: the walk of LOCO's feature-group ablations                         #
# --------------------------------------------------------------------------- #

def loco_groups(masks) -> Tuple[np.ndarray, np.ndarray]:
    """A (G, d) 0/1 group mask as CSR: (offsets (G + 1,), cols) int32,
    each group's columns ascending."""
    m = np.asarray(masks.cpu() if isinstance(masks, torch.Tensor) else masks)
    g_idx, cols = np.nonzero(m != 0)
    offsets = np.zeros(m.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(g_idx, minlength=m.shape[0]), out=offsets[1:])
    return offsets.astype(np.int32), cols.astype(np.int32)


def _loco_shapes(Xb, Xz, feat, bins, leaf, offsets, cols, classes):
    """(n_flat, K, depth, width, n_leaves, m, G) of K5-loco's inputs."""
    _require(Xz.shape == Xb.shape and Xz.dtype == Xb.dtype,
             f"tree_walk_loco: Xz {tuple(Xz.shape)} {Xz.dtype} must match "
             f"Xb {tuple(Xb.shape)} {Xb.dtype}")
    _require(offsets.dim() == 1 and offsets.shape[0] >= 1
             and cols.dim() == 1,
             "tree_walk_loco: offsets (G + 1,) and cols must be 1-d")
    if classes:
        T_, K, depth, width = _walk_classes_shapes(Xb, feat, bins, leaf)
        return T_ * K, K, depth, width, leaf.shape[2], 1, \
            offsets.shape[0] - 1
    n_trees, depth, width = _walk_shapes(Xb, feat, bins, leaf)
    return n_trees, 1, depth, width, leaf.shape[1], leaf.shape[2], \
        offsets.shape[0] - 1


def tree_walk_loco_plain(Xb: torch.Tensor, Xz: torch.Tensor,
                         feat: torch.Tensor, bins: torch.Tensor,
                         leaf: torch.Tensor, offsets: torch.Tensor,
                         cols: torch.Tensor,
                         classes: bool = False) -> torch.Tensor:
    """(G, n, m) — (G, n, K) with `classes` — f32: for each group g, the
    walk (`tree_walk_plain`, or `tree_walk_classes_plain`) of
    `torch.where(mask_g, Xz, Xb)`, the ablation materialized a group at a
    time."""
    _loco_shapes(Xb, Xz, feat, bins, leaf, offsets, cols, classes)
    walk = tree_walk_classes_plain if classes else tree_walk_plain
    d = Xb.shape[1]
    off = offsets.tolist()
    outs = []
    for g in range(len(off) - 1):
        mask = torch.zeros(d, dtype=torch.bool, device=Xb.device)
        mask[cols[off[g]:off[g + 1]].long().to(Xb.device)] = True
        outs.append(walk(torch.where(mask[None, :], Xz, Xb), feat, bins,
                         leaf))
    if not outs:
        width = leaf.shape[1] if classes else leaf.shape[-1]
        return torch.zeros((0, Xb.shape[0], width), dtype=torch.float32,
                           device=Xb.device)
    return torch.stack(outs)


_WALK_LOCO_ARGS = cuda_build.register(
    "tree_walk", "tree_walk_loco_typed",
    (ctypes.c_void_p,) * 8 + (ctypes.c_int64,) + (ctypes.c_int,) * 13
    + (ctypes.c_void_p,))


def _tree_walk_loco_cuda(Xb, Xz, feat, bins, leaf, offsets, cols,
                         classes=False, rows=None) -> torch.Tensor:
    _check_walk_inputs("tree_walk_loco", Xb, feat, bins, leaf)
    n_flat, K, depth, width, n_leaves, m, G = _loco_shapes(
        Xb, Xz, feat, bins, leaf, offsets, cols, classes)
    for name, t in (("Xz", Xz), ("offsets", offsets), ("cols", cols)):
        if t.device != Xb.device:
            raise ValueError(f"tree_walk_loco: Xb on {Xb.device}, {name} "
                             f"on {t.device}")
    if offsets.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError("tree_walk_loco: offsets and cols must be int32")
    n, d = Xb.shape
    Xb, Xz, feat, bins, leaf, offsets, cols = (
        t.contiguous() for t in (Xb, Xz, feat, bins, leaf, offsets, cols))
    out = torch.zeros((G, n, K * m), dtype=torch.float32, device=Xb.device)
    if n == 0 or G == 0 or n_flat == 0 or K * m == 0:
        return out
    for g0 in range(0, G, _MAX_GRID_YZ):
        ng = min(_MAX_GRID_YZ, G - g0)
        err = cuda_build.launch(
            Xb.get_device(), cuda_build.entry("tree_walk",
                                              "tree_walk_loco_typed"),
            Xb.data_ptr(), Xz.data_ptr(), feat.data_ptr(), bins.data_ptr(),
            leaf.data_ptr(), offsets.data_ptr(), cols.data_ptr(),
            out[g0].data_ptr(), n, d, n_flat, K, depth, width, n_leaves, m,
            g0, ng, rows or 0, *_type_bytes(Xb, feat, bins))
        cuda_build.check("tree_walk_loco_typed", err)
        _count("tree_walk_loco")
    return out


def tree_walk_loco(Xb: torch.Tensor, Xz: torch.Tensor, feat: torch.Tensor,
                   bins: torch.Tensor, leaf: torch.Tensor,
                   offsets: torch.Tensor, cols: torch.Tensor,
                   classes: bool = False) -> torch.Tensor:
    """(G, n, m) f32 — (G, n, K) for a softmax ensemble's class tables
    with `classes` — the walk of every group's ablation: out[g] is
    `tree_walk` (`tree_walk_classes`) of Xb with the columns
    cols[offsets[g]:offsets[g + 1]] (ascending) read from Xz, bit for bit.
    With Xb = bin(X) and Xz = bin(X · 0) that is the walk of bin(X · (1 −
    m_g)), LOCO's ablation of group g. A CUDA tensor launches the K5-loco
    kernel (or raises); a CPU tensor takes the plain version."""
    _check_device(Xb, "tree_walk_loco")
    if Xb.is_cuda:
        return _tree_walk_loco_cuda(Xb, Xz, feat, bins, leaf, offsets, cols,
                                    classes)
    return tree_walk_loco_plain(Xb, Xz, feat, bins, leaf, offsets, cols,
                                classes)


# --------------------------------------------------------------------------- #
# K15: one tree as one-hot products                                           #
# --------------------------------------------------------------------------- #

def predict_tree_dense(tree: Dict[str, torch.Tensor],
                       Xb: torch.Tensor) -> torch.Tensor:
    """(n, m) leaf values of one tree (tables `feat` / `bin` (depth,
    width), `leaf` (2^depth, m)) as one-hot products, the JAX package's
    `predict_tree_dense` (models/trees.py:367-410) in plain torch: every
    internal node's selected bin at once, S = Xb · onehot(feat)ᵀ, the
    decisions D = S > bin, a level-by-level 0/1 path product P routing
    each row to its leaf, and P · leaf. It computes in f32 where the JAX
    package multiplies bf16 operands into f32; bin ids and 0/1 products
    are exact in both, and one weight of 1 selects each row's leaf, so the
    result is the same bits (and `tree_walk`'s). K5 (`tree_walk`) serves
    the scoring path; this form is kept for parity."""
    n, d = Xb.shape
    depth = tree["feat"].shape[0]
    feats = torch.cat([tree["feat"][lv][:2 ** lv] for lv in range(depth)]
                      ) if depth else tree["feat"].new_zeros(0)
    bins = torch.cat([tree["bin"][lv][:2 ** lv] for lv in range(depth)]
                     ) if depth else tree["bin"].new_zeros(0)
    F = torch.nn.functional.one_hot(feats.long(), d).to(torch.float32)
    S = Xb.to(torch.float32) @ F.T                           # (n, nodes)
    D = (S > bins[None, :].to(torch.float32)).to(torch.float32)
    P = torch.ones((n, 1), dtype=torch.float32, device=Xb.device)
    off = 0
    for lv in range(depth):
        w = 2 ** lv
        Dlv = D[:, off:off + w]
        # children interleave: node k -> (left 2k, right 2k + 1)
        P = torch.stack([P * (1 - Dlv), P * Dlv], dim=-1).reshape(n, 2 * w)
        off += w
    return P @ tree["leaf"].to(torch.float32)


# --------------------------------------------------------------------------- #
# fit-time binning                                                            #
# --------------------------------------------------------------------------- #

def quantile_bin_edges(X: np.ndarray,
                       max_bins: int = DEFAULT_MAX_BINS) -> np.ndarray:
    """(d, max_bins - 1) ascending bin edges per feature (host, fit time;
    the JAX package's numpy computation, so the edges are equal)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    edges = np.quantile(np.asarray(X, dtype=np.float64), qs, axis=0).T
    return np.ascontiguousarray(edges, dtype=np.float32)


# --------------------------------------------------------------------------- #
# rows grouped by node (the order K1 and K3's leaf pass read)                 #
# --------------------------------------------------------------------------- #

def node_segments(node_idx: torch.Tensor, n_nodes: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(order, seg)` for (P, n) node ids in [0, n_nodes]: order[p] lists
    the rows grouped by node in stable row order, and node k's rows are
    order[p, seg[p, k]:seg[p, k + 1]]. Rows with id n_nodes come after the
    last segment, where no kernel reads them. int32 both. A stable sort of
    each pair's ids and a search of them for every node's first row: no
    count reaches the host, so the call does not wait for the card."""
    P = node_idx.shape[0]
    K = n_nodes + 1
    ids, order = torch.sort(node_idx.to(torch.int32), dim=1, stable=True)
    seg = torch.searchsorted(
        ids, torch.arange(K, dtype=torch.int32, device=node_idx.device)
        .expand(P, K).contiguous(), out_int32=True)
    return order.to(torch.int32), seg


def _fit_shapes(name, Xb, node_idx, G, H):
    _require(Xb.dim() == 2, f"{name}: Xb must be (n, d), got "
                            f"{tuple(Xb.shape)}")
    _require(node_idx.dim() == 2 and node_idx.shape[1] == Xb.shape[0]
             and H.shape == node_idx.shape and G.dim() == 3
             and G.shape[0] == node_idx.shape[0]
             and G.shape[2] == node_idx.shape[1] and G.shape[1] >= 1,
             f"{name}: node_idx {tuple(node_idx.shape)}, G "
             f"{tuple(G.shape)}, H {tuple(H.shape)} must be (P, n), (P, m, "
             f"n) and (P, n) with n = {Xb.shape[0]}, m >= 1")


def _on_device(name, ref, **tensors):
    for key, t in tensors.items():
        if t is not None:
            _require(t.device == ref.device,
                     f"{name}: {key} on {t.device}, expected {ref.device}")


# --------------------------------------------------------------------------- #
# K1: histograms                                                              #
# --------------------------------------------------------------------------- #

def histograms_plain(Xb: torch.Tensor, node_idx: torch.Tensor,
                     G: torch.Tensor, H: torch.Tensor, n_nodes: int,
                     n_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, m, n_nodes, d, n_bins) value and (P, n_nodes, d, n_bins) weight
    histograms: hist_G[p, c, k, f, b] = Σ_r [node[p, r] = k]·[Xb[r, f] =
    b]·G[p, c, r] (hist_H likewise), one `index_add_` per channel; rows
    with node id n_nodes are left out."""
    _fit_shapes("histograms", Xb, node_idx, G, H)
    P, m, n = G.shape
    d = Xb.shape[1]
    dev = Xb.device
    slots = n_nodes + 1  # the last slot takes the rows left out
    cell = ((node_idx.long()
             + torch.arange(P, device=dev)[:, None] * slots)[:, :, None]
            * d + torch.arange(d, device=dev)[None, None, :]) * n_bins \
        + Xb.long()[None, :, :]
    cell = cell.reshape(-1)
    size = P * slots * d * n_bins

    def hist(v):
        src = v.to(torch.float32)[:, :, None].expand(P, n, d).reshape(-1)
        return (torch.zeros(size, dtype=torch.float32, device=dev)
                .index_add_(0, cell, src)
                .reshape(P, slots, d, n_bins)[:, :n_nodes])

    hg = torch.stack([hist(G[:, c]) for c in range(m)], dim=1)
    return hg, hist(H).contiguous()


# K1's plan. A node of more than HIST_FEW_ROWS rows is cut into pieces of
# at most HIST_PIECE_ROWS rows (R), each summed by its own blocks; a node of
# several pieces sums them from a scratch buffer in piece order. R keeps the
# out-of-core level 0 (4.46M rows a learner) at 136 pieces a learner, enough
# blocks for the card, and its scratch within `lockstep_width`'s budget at
# 16 learners; a node of at most R rows (every level of the in-memory
# trainers) is one piece, summed as before. A node of at most
# HIST_FEW_ROWS rows (a deep forest level: most nodes hold 0-3 rows) takes
# the few-rows path, which writes its cells from registers with no shared
# histograms to zero and reduce.
HIST_PIECE_ROWS = 32768
HIST_FEW_ROWS = 32
# rows a node averages from which a piece block runs 4 row-lanes, not 1
HIST_LANE_ROWS = 512


def hist_plan_bounds(n: int, n_nodes: int, piece_rows: Optional[int] = None,
                     few_rows: Optional[int] = None) -> Tuple[int, int]:
    """(pieces, scratch slots) K1 may need a pair for n rows over n_nodes
    nodes, whatever the rows' spread: the launch grid of the piece kernel
    and the scratch buffer are sized by these, so no device count has to
    reach the host. D nodes of c_k > few_rows rows have Σ ⌈c_k / R⌉ ≤ D +
    ⌊(n − D) / R⌋ pieces, which grows with D, and D ≤ min(n_nodes, ⌊n /
    (few_rows + 1)⌋); only nodes of more than R rows use scratch, at most
    min(n_nodes, ⌊n / (R + 1)⌋) of them, with the same count of pieces."""
    piece_rows = piece_rows or HIST_PIECE_ROWS
    few_rows = HIST_FEW_ROWS if few_rows is None else few_rows
    dense = min(n_nodes, n // (few_rows + 1))
    multi = min(n_nodes, n // (piece_rows + 1))
    return (dense + (n - dense) // piece_rows,
            multi + (n - multi) // piece_rows if multi else 0)


def hist_piece_plan(seg: torch.Tensor, piece_rows: Optional[int] = None,
                    few_rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(first, slot)`, each (P, n_nodes + 1) int32, from node segments seg
    (P, n_nodes + 1): first[p, k] counts the pieces of nodes before k (a
    node of c > few_rows rows has ⌈c / R⌉ pieces, a smaller node none: the
    few-rows path takes it), slot[p, k] the pieces before k of nodes with
    more than one piece (their scratch slots). The K1 kernel writes the
    same plan on the card."""
    piece_rows = piece_rows or HIST_PIECE_ROWS
    few_rows = HIST_FEW_ROWS if few_rows is None else few_rows
    cnt = (seg[:, 1:] - seg[:, :-1]).long()
    pieces = torch.where(cnt > few_rows, (cnt + piece_rows - 1) // piece_rows,
                         torch.zeros_like(cnt))
    multi = torch.where(pieces > 1, pieces, torch.zeros_like(pieces))
    first = torch.zeros(seg.shape, dtype=torch.int64, device=seg.device)
    slot = torch.zeros_like(first)
    first[:, 1:] = torch.cumsum(pieces, dim=1)
    slot[:, 1:] = torch.cumsum(multi, dim=1)
    return first.to(torch.int32), slot.to(torch.int32)


def hist_pieces(seg: torch.Tensor, first: torch.Tensor, slot: torch.Tensor,
                grid: int, piece_rows: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """The pieces the K1 piece kernel's blocks q = 0 .. grid − 1 of each
    pair take, as (P, grid) int64 tensors: "node" (−1 past the pair's
    pieces), the rows [start, end) of the node's segment, and the scratch
    "slot" (−1: the node's only piece, written straight to the output).
    The kernel's own arithmetic, in torch."""
    piece_rows = piece_rows or HIST_PIECE_ROWS
    P = seg.shape[0]
    q = torch.arange(grid, device=seg.device).expand(P, grid)
    f = first.long()
    k = torch.searchsorted(f.contiguous(), q.contiguous(), right=True) - 1
    k = torch.clamp(k, max=seg.shape[1] - 2)
    valid = q < f[:, -1:]
    kk = torch.where(valid, k, torch.zeros_like(k))
    j = q - torch.gather(f, 1, kk)
    npieces = torch.gather(f, 1, kk + 1) - torch.gather(f, 1, kk)
    s = seg.long()
    start = torch.gather(s, 1, kk) + j * piece_rows
    end = torch.minimum(start + piece_rows, torch.gather(s, 1, kk + 1))
    sl = torch.where(npieces > 1, torch.gather(slot.long(), 1, kk) + j,
                     torch.full_like(j, -1))
    neg = torch.full_like(j, -1)
    return {"node": torch.where(valid, kk, neg),
            "start": torch.where(valid, start, neg),
            "end": torch.where(valid, end, neg),
            "slot": torch.where(valid, sl, neg)}


def hist_scratch_bytes(P: int, n: int, n_nodes: int, m: int, d: int,
                       n_bins: int, piece_rows: Optional[int] = None) -> int:
    """Bytes of K1's piece scratch for P pairs: (m + 1)·d·n_bins f32 per
    slot (0 while n ≤ R)."""
    _, slots = hist_plan_bounds(n, n_nodes, piece_rows)
    return P * slots * (m + 1) * d * n_bins * 4


_HIST_ARGS = cuda_build.register(
    "histograms", ("histograms_i8", "histograms_i32"),
    (ctypes.c_void_p,) * 10 + (ctypes.c_int64,) + (ctypes.c_int,) * 13
    + (ctypes.c_void_p,))
cuda_build.register("histograms", ("histograms_max_m", "histograms_max_few"),
                    ())
# shared memory one K1 piece block may take: the card's opt-in maximum
_SMEM_BYTES = 232448
# launch grids: pairs on blockIdx.z, nodes on blockIdx.y
_MAX_GRID_YZ = 65535


def hist_channel_groups(m: int, max_m: int
                        ) -> List[Tuple[int, int, Optional[int]]]:
    """K1's launches for m value channels, at most max_m in a launch:
    (first channel, value channels v, the channel in the weight slot or
    None for the weights) each. The first takes channels 0 .. v − 1 and
    the weights; each later one v ≤ max_m channels and the next in the
    weight slot, so every channel and the weights are summed once; no
    later launch is left with a single channel (it would have no value
    channel)."""
    first = min(m, max_m)
    rest = m - first
    if rest % (max_m + 1) == 1:
        first, rest = first - 1, rest + 1
    groups = [(0, first, None)]
    c = first
    while c < m:
        take = min(max_m + 1, m - c)
        groups.append((c, take - 1, c + take - 1))
        c += take
    return groups


def _hist_layout(n_bins: int, m: int, four: bool,
                 rows_per_node: float) -> Tuple[int, int]:
    """(features a thread covers, row-lanes) of a K1 piece block: 4
    features (one aligned load of 4 bins: `four`, d % 4 == 0) while a
    lane's private histograms of m + 1 channels, (m + 1)·(n_bins + 1)·4·32
    f32 (a trash bin included), fit the shared-memory budget, else 1. As
    many lanes as fit, at most 4 (the old kernel's lanes and lane order),
    where nodes average HIST_LANE_ROWS rows or more; else 1, since a
    block's zeroing and lane reduction then cost more than its rows."""
    for feats in ((4, 1) if four else (1,)):
        per_lane = (m + 1) * (n_bins + 1) * feats * 32 * 4
        lanes = min(4 if rows_per_node >= HIST_LANE_ROWS else 1,
                    _SMEM_BYTES // per_lane)
        if lanes >= 1:
            return feats, lanes
    raise ValueError(f"histograms: {m} channels of {n_bins} bins exceed the "
                     f"kernel's shared memory ({_SMEM_BYTES} B)")


def _histograms_cuda(Xb, node_idx, G, H, n_nodes, n_bins, plan_out=None):
    _fit_shapes("histograms", Xb, node_idx, G, H)
    _on_device("histograms", Xb, node_idx=node_idx, G=G, H=H)
    _require(Xb.dtype in (torch.int8, torch.int32),
             f"histograms: Xb must be int8 or int32, got {Xb.dtype}")
    _require(G.dtype == torch.float32 and H.dtype == torch.float32,
             f"histograms: G/H must be f32, got {G.dtype}/{H.dtype}")
    P, m, n = G.shape
    d = Xb.shape[1]
    _require(P <= _MAX_GRID_YZ and n_nodes <= _MAX_GRID_YZ,
             f"histograms: {P} pairs or {n_nodes} nodes exceed the launch "
             f"grid's {_MAX_GRID_YZ}")
    groups = hist_channel_groups(
        m, cuda_build.entry("histograms", "histograms_max_m")())
    grid, n_slots = hist_plan_bounds(n, n_nodes)
    _require(grid <= _MAX_GRID_YZ,
             f"histograms: {grid} pieces a pair exceed the launch grid's "
             f"{_MAX_GRID_YZ}")
    dev = Xb.device
    hg = torch.empty((P, m, n_nodes, d, n_bins), dtype=torch.float32,
                     device=dev)
    hh = torch.empty((P, n_nodes, d, n_bins), dtype=torch.float32,
                     device=dev)
    if hh.numel() == 0:
        return hg, hh
    order, seg = node_segments(node_idx, n_nodes)
    # the plan (`hist_piece_plan`'s arithmetic) is written by the kernel
    first = torch.empty((P, n_nodes + 1), dtype=torch.int32, device=dev)
    slot = torch.empty_like(first)
    widest = max(v + 1 for _, v, _ in groups)
    scratch = (torch.empty((P, n_slots, widest, d, n_bins),
                           dtype=torch.float32, device=dev)
               if n_slots else None)
    Xb, G, H = Xb.contiguous(), G.contiguous(), H.contiguous()
    fname = "histograms_i8" if Xb.dtype == torch.int8 else "histograms_i32"
    fn = cuda_build.entry("histograms", fname)
    four = d % 4 == 0 and Xb.data_ptr() % (4 * Xb.element_size()) == 0
    plane = n_nodes * d * n_bins  # a channel's floats a pair in hg
    for c0, v, slot_c in groups:
        # values c0 .. c0 + v - 1, and in the weight slot the weights
        # (slot_c None) or value channel slot_c
        if slot_c is None:
            h_src, h_out, h_ch = H.data_ptr(), hh.data_ptr(), 1
        else:
            h_src = G.data_ptr() + 4 * slot_c * n
            h_out = hg.data_ptr() + 4 * slot_c * plane
            h_ch = m
        feats, lanes = _hist_layout(n_bins, v, four, n / n_nodes)
        err = cuda_build.launch(
            Xb.get_device(), fn, Xb.data_ptr(), G.data_ptr() + 4 * c0 * n,
            h_src, order.data_ptr(), seg.data_ptr(), first.data_ptr(),
            slot.data_ptr(), hg.data_ptr() + 4 * c0 * plane, h_out,
            None if scratch is None else scratch.data_ptr(), n_slots, P, n,
            d, n_nodes, n_bins, v, lanes, feats, HIST_PIECE_ROWS,
            HIST_FEW_ROWS, grid, m, h_ch)
        cuda_build.check(fname, err)
        _count("histograms")
    if plan_out is not None:  # a test's view of the kernel's plan
        plan_out.extend([seg, first, slot, grid])
    return hg, hh


def histograms(Xb: torch.Tensor, node_idx: torch.Tensor, G: torch.Tensor,
               H: torch.Tensor, n_nodes: int, n_bins: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histograms per (pair, node, feature, bin) for binned Xb (n, d) with
    bin ids in [0, n_bins), node ids (P, n) in [0, n_nodes], m value
    channels G (P, m, n) and weights H (P, n): (P, m, n_nodes, d, n_bins)
    and (P, n_nodes, d, n_bins) f32. A row whose node id is n_nodes is
    left out (the sibling-subtraction path's rows routed left); the kernel
    drops a bin id outside [0, n_bins), the plain version raises. A CUDA
    tensor launches the K1 kernel (or raises); a CPU tensor takes the
    plain version."""
    _check_device(Xb, "histograms")
    if Xb.is_cuda:
        return _histograms_cuda(Xb, node_idx, G, H, n_nodes, n_bins)
    return histograms_plain(Xb, node_idx, G, H, n_nodes, n_bins)


# --------------------------------------------------------------------------- #
# K1-sub: sibling subtraction                                                 #
# --------------------------------------------------------------------------- #

def sibling_subtract_plain(hg: torch.Tensor, hh: torch.Tensor,
                           hg_r: torch.Tensor, hh_r: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Children's histograms from the parents' (P, m, K, d, B) / (P, K, d,
    B) and the right children's of the same shapes: node k → (left 2k =
    parent − right, right 2k + 1), as (P, m, 2K, d, B) / (P, 2K, d, B)."""
    def interleave(parent, right):
        *lead, K, d, B = parent.shape
        return torch.stack([parent - right, right], dim=-3).reshape(
            *lead, 2 * K, d, B)
    return interleave(hg, hg_r), interleave(hh, hh_r)


_SUB_ARGS = cuda_build.register(
    "sibling_subtract", "sibling_subtract",
    (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int64,) * 3 + (ctypes.c_void_p,))


def _sibling_subtract_cuda(hg, hh, hg_r, hh_r):
    _on_device("sibling_subtract", hg, hh=hh, hg_r=hg_r, hh_r=hh_r)
    _require(all(t.dtype == torch.float32 for t in (hg, hh, hg_r, hh_r)),
             "sibling_subtract: histograms must be f32")
    _require(hg.dim() == 5 and hg_r.shape == hg.shape
             and hh_r.shape == hh.shape
             and hh.shape == hg.shape[:1] + hg.shape[2:],
             f"sibling_subtract: shapes {tuple(hg.shape)}, "
             f"{tuple(hh.shape)}, {tuple(hg_r.shape)}, {tuple(hh_r.shape)} "
             "must be (P, m, K, d, B) twice and (P, K, d, B) twice")
    P, m, K, d, B = hg.shape
    cg = torch.empty((P, m, 2 * K, d, B), dtype=torch.float32,
                     device=hg.device)
    ch = torch.empty((P, 2 * K, d, B), dtype=torch.float32, device=hg.device)
    if ch.numel() == 0:
        return cg, ch
    hg, hh, hg_r, hh_r = (t.contiguous() for t in (hg, hh, hg_r, hh_r))
    err = cuda_build.launch(
        hg.get_device(), cuda_build.entry("sibling_subtract",
                                          "sibling_subtract"),
        hg.data_ptr(), hg_r.data_ptr(), cg.data_ptr(), P * m, hh.data_ptr(),
        hh_r.data_ptr(), ch.data_ptr(), P, K, d * B)
    cuda_build.check("sibling_subtract", err)
    _count("sibling_subtract")
    return cg, ch


def sibling_subtract(hg: torch.Tensor, hh: torch.Tensor, hg_r: torch.Tensor,
                     hh_r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The next level's histograms from this level's (value (P, m, K, d,
    B), weight (P, K, d, B)) and those of the rows routed right, grouped
    by parent: children interleaved as (left 2k = parent − right, right
    2k + 1). A CUDA tensor launches the K1-sub kernel (or raises); a CPU
    tensor takes the plain version."""
    _check_device(hg, "sibling_subtract")
    if hg.is_cuda:
        return _sibling_subtract_cuda(hg, hh, hg_r, hh_r)
    return sibling_subtract_plain(hg, hh, hg_r, hh_r)


# --------------------------------------------------------------------------- #
# K2: split search                                                            #
# --------------------------------------------------------------------------- #

def _running_sum(h: torch.Tensor) -> torch.Tensor:
    """Sequential f32 running sum over the last axis (bin by bin, as the
    K2 kernel adds)."""
    out = torch.empty_like(h)
    acc = torch.zeros_like(h[..., 0])
    for b in range(h.shape[-1]):
        acc = acc + h[..., b]
        out[..., b] = acc
    return out


def _score(g: torch.Tensor, h: torch.Tensor, lam: torch.Tensor
           ) -> torch.Tensor:
    """(Σ_c g_c²) / (h + λ) with the class terms added in channel order
    (axis 1 of g), as the K2 kernel adds them."""
    num = g[:, 0] * g[:, 0]
    for c in range(1, g.shape[1]):
        num = num + g[:, c] * g[:, c]
    return num / (h + lam)


def _search_nodes(hg, hh, n_bins, lam, mcw, fmask):
    """(best feature, best bin, best gain) per node of item histograms
    (N, m, nodes, d, B) / (N, nodes, d, B), with per-item λ and
    min_child_weight (N,) and feature mask (N, d) or None."""
    N, m, n_nodes, d, _ = hg.shape
    lam = lam[:, None, None, None]
    mcw = mcw[:, None, None, None]
    cg = _running_sum(hg)
    ch = _running_sum(hh)
    tg = cg[..., -1:]
    th = ch[..., -1:]
    rh = th - ch
    gain = (_score(cg, ch, lam) + _score(tg - cg, rh, lam)) \
        - _score(tg, th, lam)
    valid = (ch >= mcw) & (rh >= mcw)
    if fmask is not None:
        valid = valid & fmask[:, None, :, None]
    gain = torch.where(valid, gain, torch.full_like(gain, -float("inf")))
    flat = gain.reshape(N, n_nodes, d * n_bins)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    return ((best // n_bins).to(torch.int32),
            (best % n_bins).to(torch.int32), best_gain, th[:, :, 0, 0])


def _flags_view(name, t, P, width, kind):
    """A flag table's (P, ≥ width) uint8 or bool view, unit inner stride."""
    if (t.dtype not in (torch.uint8, torch.bool) or t.dim() != 2
            or t.shape[0] != P or t.shape[1] < width
            or (t.shape[1] > 1 and t.stride(1) != 1)):
        raise ValueError(f"{name}: {kind} must be ({P}, >= {width}) uint8 "
                         f"or bool with unit inner stride, got "
                         f"{tuple(t.shape)} {t.dtype} {t.stride()}")


def _split_out(name, out, P, n_nodes, dev):
    """The (feature, bin) tables K2 writes: new ones, or the caller's two
    (P, n_nodes) int32 views with one row stride and unit inner stride."""
    if out is None:
        feat = torch.empty((P, n_nodes), dtype=torch.int32, device=dev)
        return feat, torch.empty_like(feat)
    feat, bins = out
    if not (feat.dtype == bins.dtype == torch.int32
            and feat.shape == bins.shape == (P, n_nodes)
            and feat.stride() == bins.stride()
            and (n_nodes == 1 or feat.stride(1) == 1)
            and feat.device == bins.device == dev):
        raise ValueError(f"{name}: out must be two ({P}, {n_nodes}) int32 "
                         f"tensors on {dev} with equal strides and unit "
                         f"inner stride")
    return feat, bins


def split_search_plain(hg, hh, n_bins: int, reg_lambda: Param,
                       min_child_weight: Param, min_gain: Param,
                       min_gain_norm: Param,
                       feature_mask: Optional[torch.Tensor], level: int,
                       active_depth: Optional[Param],
                       live: Optional[torch.Tensor] = None,
                       out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       mark: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, n_nodes) int32 split feature and split bin per node (bin =
    n_bins where the node does not split) from (P, m, n_nodes, d, n_bins)
    value and (P, n_nodes, d, n_bins) weight histograms; the arithmetic of
    the K2 kernel, step for step. The nodes of `live` (flags (P, n_nodes);
    without it, the nodes with a non-zero cell) are searched; every other
    node gets one search of a zero histogram per pair, which is what the
    full search of an empty node computes. `out` and `mark` as in
    `split_search`."""
    P, n_nodes, d, _ = hh.shape
    dev = hh.device
    lam = per_pair(reg_lambda, P, dev)
    mcw = per_pair(min_child_weight, P, dev)
    fm = None if feature_mask is None else feature_mask.to(torch.bool)
    if live is None:
        searched = (hh != 0).flatten(2).any(2) | (hg != 0).transpose(1, 2) \
            .flatten(2).any(2)
    else:
        _flags_view("split_search", live, P, n_nodes, "live")
        searched = live[:, :n_nodes].to(torch.bool)
    if bool(searched.all()):
        bf, bb, best_gain, th0 = _search_nodes(hg, hh, n_bins, lam, mcw, fm)
    else:
        zg = hg.new_zeros((P,) + hg.shape[1:2] + (1,) + hg.shape[3:])
        zf, zb, zgain, zth = _search_nodes(zg, hh.new_zeros(
            (P, 1) + hh.shape[2:]), n_bins, lam, mcw, fm)
        bf, bb = zf.expand(P, n_nodes).clone(), zb.expand(P, n_nodes).clone()
        best_gain = zgain.expand(P, n_nodes).clone()
        th0 = zth.expand(P, n_nodes).clone()
        pi, ki = torch.nonzero(searched, as_tuple=True)
        if pi.numel():
            lf, lb, lgain, lth = _search_nodes(
                hg[pi, :, ki][:, :, None], hh[pi, ki][:, None], n_bins,
                lam[pi], mcw[pi], None if fm is None else fm[pi])
            bf[pi, ki], bb[pi, ki] = lf[:, 0], lb[:, 0]
            best_gain[pi, ki], th0[pi, ki] = lgain[:, 0], lth[:, 0]
    thr = torch.maximum(per_pair(min_gain, P, dev)[:, None],
                        per_pair(min_gain_norm, P, dev)[:, None] * th0)
    splits = best_gain > thr
    if active_depth is not None:
        splits = splits & (level < per_pair(active_depth, P, dev,
                                            torch.int32))[:, None]
    bb = torch.where(splits, bb, torch.full_like(bb, n_bins))
    if mark is not None:  # the kernel marks the nodes it searches
        _flags_view("split_search", mark, P, 2 * n_nodes, "mark")
        left = mark[:, 0:2 * n_nodes:2]
        on = (torch.ones_like(left, dtype=torch.bool) if live is None
              else searched)
        left[on] = 1
    if out is not None:
        feat, bins = _split_out("split_search", out, P, n_nodes, dev)
        feat.copy_(bf)
        bins.copy_(bb)
        return feat, bins
    return bf, bb


_SPLIT_ARGS = cuda_build.register(
    "split_search", "split_search",
    (ctypes.c_void_p,) * 9 + (ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int64) + (ctypes.c_int,) * 6
    + (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p))


def _split_shapes(hg, hh, n_bins):
    if not (hg.dim() == 5 and hh.dim() == 4
            and hh.shape == hg.shape[:1] + hg.shape[2:]
            and hg.shape[-1] == n_bins):
        raise ValueError(
            f"split_search: hist shapes {tuple(hg.shape)} / "
            f"{tuple(hh.shape)} must be (P, m, nodes, d, {n_bins}) / (P, "
            f"nodes, d, {n_bins})")


def _split_search_cuda(hg, hh, n_bins, reg_lambda, min_child_weight,
                       min_gain, min_gain_norm, feature_mask, level,
                       active_depth, live=None, out=None, mark=None):
    # the checks that guard the launch, their messages built only on
    # refusal (a level's call is host-bound at small shapes)
    _split_shapes(hg, hh, n_bins)
    if hg.dtype != torch.float32 or hh.dtype != torch.float32:
        raise ValueError("split_search: histograms must be f32")
    P, m, n_nodes, d, _ = hg.shape
    dev = hh.device
    for key, t in (("hh", hh), ("feature_mask", feature_mask),
                   ("live", live), ("mark", mark)):
        if t is not None and t.device != hg.device:
            raise ValueError(f"split_search: {key} on {t.device}, expected "
                             f"{hg.device}")
    lam = per_pair(reg_lambda, P, dev)
    mcw = per_pair(min_child_weight, P, dev)
    mg = per_pair(min_gain, P, dev)
    mgn = per_pair(min_gain_norm, P, dev)
    fm = None
    if feature_mask is not None:
        if feature_mask.shape != (P, d):
            raise ValueError(f"split_search: feature_mask "
                             f"{tuple(feature_mask.shape)} must be ({P}, {d})")
        fm = feature_mask  # a bool's bytes are the kernel's 0 / 1 flags
        if fm.dtype not in _FLAG_TYPES or not fm.is_contiguous():
            fm = fm.to(torch.uint8).contiguous()
    ad = (per_pair(active_depth, P, dev, torch.int32)
          if active_depth is not None else None)
    feat, bins = _split_out("split_search", out, P, n_nodes, dev)
    if feat.numel() == 0 or d == 0:
        return feat, bins
    if live is not None:
        _flags_view("split_search", live, P, n_nodes, "live")
    if mark is not None:
        _flags_view("split_search", mark, P, 2 * n_nodes, "mark")
    if m < 1:
        raise ValueError("split_search: no value channel")
    if P > _MAX_GRID_YZ:
        raise ValueError(f"split_search: {P} pairs exceed the launch grid's "
                         f"{_MAX_GRID_YZ}")
    hg, hh = hg.contiguous(), hh.contiguous()
    err = cuda_build.launch(
        hg.get_device(), cuda_build.entry("split_search", "split_search"),
        hg.data_ptr(), hh.data_ptr(), lam.data_ptr(), mcw.data_ptr(),
        mg.data_ptr(), mgn.data_ptr(), None if fm is None else fm.data_ptr(),
        None if ad is None else ad.data_ptr(),
        None if live is None else live.data_ptr(),
        0 if live is None else live.stride(0),
        None if mark is None else mark.data_ptr(),
        0 if mark is None else mark.stride(0), P, level, n_nodes, d, n_bins,
        m, feat.data_ptr(), bins.data_ptr(), feat.stride(0))
    cuda_build.check("split_search", err)
    _count("split_search" if live is None else "split_search_live")
    return feat, bins


def split_search(hg: torch.Tensor, hh: torch.Tensor, n_bins: int,
                 reg_lambda: Param, min_child_weight: Param,
                 min_gain: Param, min_gain_norm: Param,
                 feature_mask: Optional[torch.Tensor], level: int,
                 active_depth: Optional[Param],
                 live: Optional[torch.Tensor] = None,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 mark: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (feature, bin) per node of each pair from value histograms
    (P, m, nodes, d, bins) and weight histograms (P, nodes, d, bins): the
    gain Σ_c g_c² / (h + λ) over the left running sums (XGBoost's at m =
    1, Gini's for a forest's class channels), `min_child_weight` validity
    and the feature mask (P, d) as -inf, the first index winning ties over
    the flat d·bins axis (a NaN gain the largest), and bin = n_bins where
    the best gain is not above max(min_gain, min_gain_norm · the node's
    weight) or level >= active_depth. Each hyperparameter is one value or
    one per pair.

    `live` (P, nodes) uint8/bool flags: only these nodes are searched, and
    every other one, whose histograms must be all zero, gets the pair's
    search of a zero histogram (the live set; without it every node is
    searched). `out`: two (P, nodes) int32 views written in place (a
    level's row of the learner's tables), returned. `mark` (P, 2·nodes)
    flags: each searched node j sets mark[:, 2j] (its left child, on the
    subtraction path). A CUDA tensor launches the K2 kernel (or raises),
    counted as `split_search_live` with `live`; a CPU tensor takes the
    plain version."""
    _check_device(hg, "split_search")
    if hg.is_cuda:
        return _split_search_cuda(hg, hh, n_bins, reg_lambda,
                                  min_child_weight, min_gain, min_gain_norm,
                                  feature_mask, level, active_depth, live,
                                  out, mark)
    _split_shapes(hg, hh, n_bins)
    return split_search_plain(hg, hh, n_bins, reg_lambda, min_child_weight,
                              min_gain, min_gain_norm, feature_mask, level,
                              active_depth, live, out, mark)


# --------------------------------------------------------------------------- #
# K3: routing and leaf values                                                 #
# --------------------------------------------------------------------------- #

def route_level_plain(Xb: torch.Tensor, node_idx: torch.Tensor,
                      feat: torch.Tensor, bins: torch.Tensor,
                      occupied: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(P, n) int32 node ids one level down: 2·node + (Xb[r, feat[p,
    node]] > bin[p, node]); with `occupied`, sets occupied[p, child] = 1
    for every row's child."""
    node = node_idx.long()
    f = torch.gather(feat.long(), 1, node)
    b = torch.gather(bins.long(), 1, node)
    rows = torch.arange(Xb.shape[0], device=Xb.device)[None, :]
    x = Xb[rows, f].long()
    child = node * 2 + (x > b).long()
    if occupied is not None:
        _flags_view("route_level", occupied, node.shape[0],
                    2 * feat.shape[1], "occupied")
        occupied.scatter_(1, child, torch.ones_like(child,
                                                    dtype=occupied.dtype))
    return child.to(torch.int32)


_ROUTE_ARGS = cuda_build.register(
    "route_leaves", ("route_level_i8", "route_level_i32"),
    (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) + (ctypes.c_void_p,) * 3
    + (ctypes.c_int64,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


_ROUTE_ENTRIES = {torch.int8: "route_level_i8", torch.int32: "route_level_i32"}
_I32 = torch.int32
_FLAG_TYPES = (torch.uint8, torch.bool)


def _route_level_cuda(Xb, node_idx, feat, bins, occupied=None, out=None):
    # compound checks guard the launch, shapes read once and messages built
    # only on refusal (a level's call is host-bound at small shapes)
    index = Xb.get_device()
    fname = _ROUTE_ENTRIES.get(Xb.dtype)
    xs, ns, fs = Xb.shape, node_idx.shape, feat.shape
    if not (fname is not None and len(xs) == 2 and len(ns) == 2
            and len(fs) == 2 and ns[1] == xs[0] and fs[0] == ns[0]
            and bins.shape == fs and feat.dtype is _I32
            and bins.dtype is _I32 and node_idx.dtype is _I32
            and node_idx.get_device() == index
            and feat.get_device() == index and bins.get_device() == index):
        raise ValueError(
            f"route_level: Xb {Xb.dtype} {tuple(xs)} on {Xb.device}, "
            f"node_idx {node_idx.dtype} {tuple(ns)} on {node_idx.device}, "
            f"feat / bin {feat.dtype} {tuple(fs)} / {bins.dtype} "
            f"{tuple(bins.shape)} on {feat.device} / {bins.device}: needs "
            f"int8 or int32 Xb (n, d), int32 node ids (P, n) and int32 "
            f"tables (P, n_nodes) on one device")
    P, n = ns
    nodes = fs[1]
    if out is None:
        out = torch.empty(ns, dtype=_I32, device=Xb.device)
    elif not (out.dtype is _I32 and out.shape == ns
              and out.get_device() == index and out.is_contiguous()
              and out.data_ptr() != node_idx.data_ptr()):
        raise ValueError(f"route_level: out must be a contiguous ({P}, {n}) "
                         f"int32 tensor on {Xb.device} apart from node_idx")
    if P == 0 or n == 0:
        return out
    occ_ptr, occ_stride = None, 0
    if occupied is not None:
        os_, ost = occupied.shape, occupied.stride()
        if not (occupied.dtype in _FLAG_TYPES and len(os_) == 2
                and os_[0] == P and os_[1] >= 2 * nodes
                and (os_[1] == 1 or ost[1] == 1)
                and occupied.get_device() == index):
            raise ValueError(f"route_level: occupied must be ({P}, >= "
                             f"{2 * nodes}) uint8 or bool with unit inner "
                             f"stride on {Xb.device}, got {tuple(os_)} "
                             f"{occupied.dtype} {ost} on {occupied.device}")
        occ_ptr, occ_stride = occupied.data_ptr(), ost[0]
    fst = feat.stride()
    if bins.stride() != fst or (nodes > 1 and fst[1] != 1):
        feat, bins = feat.contiguous(), bins.contiguous()
        fst = feat.stride()
    if not Xb.is_contiguous():
        Xb = Xb.contiguous()
    if not node_idx.is_contiguous():
        node_idx = node_idx.contiguous()
    err = cuda_build.launch(
        index, cuda_build.entry("route_leaves", fname), Xb.data_ptr(),
        feat.data_ptr(), bins.data_ptr(), fst[0], node_idx.data_ptr(),
        out.data_ptr(), occ_ptr, occ_stride, P, n, xs[1], nodes)
    cuda_build.check(fname, err)
    _count("route_level")
    return out


def route_level(Xb: torch.Tensor, node_idx: torch.Tensor, feat: torch.Tensor,
                bins: torch.Tensor, occupied: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, n) int32 node ids after one level of routing with this level's
    (P, n_nodes) split tables (views with a row stride are read in place),
    written out of place: into `out` (a (P, n) int32 buffer apart from
    node_idx) or a new tensor. With `occupied` ((P, ≥ 2·n_nodes) uint8 or
    bool, unit inner stride, zeroed by the caller), every row's child is
    flagged: the next level's live set for `split_search`. A CUDA tensor
    launches the K3 routing kernel (or raises); a CPU tensor takes the
    plain version."""
    if Xb.is_cuda:
        return _route_level_cuda(Xb, node_idx, feat, bins, occupied, out)
    _check_device(Xb, "route_level")
    got = route_level_plain(Xb, node_idx, feat, bins, occupied)
    return got if out is None else out.copy_(got)


def _leaf_formula(g, h, reg_lambda, alpha):
    """g (P, L, m), h (P, L): sign(g)·max(|g| − α, 0) / (h + λ)."""
    P = g.shape[0]
    lam = per_pair(reg_lambda, P, g.device)[:, None]
    a = per_pair(alpha, P, g.device)[:, None, None]
    g = torch.sign(g) * torch.clamp(torch.abs(g) - a, min=0.0)
    return g / (h + lam)[:, :, None]


def leaf_sums_plain(node_idx: torch.Tensor, G: torch.Tensor,
                    H: torch.Tensor, n_leaves: int) -> torch.Tensor:
    """(P, n_leaves, m + 1) f32 per-leaf sums: Σ G_c for each channel c,
    then Σ H (`index_add_`)."""
    P, m, n = G.shape
    flat = (node_idx.long() + torch.arange(
        P, device=G.device)[:, None] * n_leaves).reshape(-1)

    def sums(v):
        return (torch.zeros(P * n_leaves, dtype=torch.float32,
                            device=G.device)
                .index_add_(0, flat, v.to(torch.float32).reshape(-1))
                .reshape(P, n_leaves))

    return torch.stack([sums(G[:, c]) for c in range(m)] + [sums(H)],
                       dim=-1)


def leaf_values_plain(node_idx: torch.Tensor, G: torch.Tensor,
                      H: torch.Tensor, n_leaves: int, reg_lambda: Param,
                      alpha: Param) -> torch.Tensor:
    """(P, n_leaves, m) f32 leaf values: per-leaf Σ G_c and Σ H
    (`leaf_sums_plain`), the L1 soft threshold and G_c / (H + λ)."""
    s = leaf_sums_plain(node_idx, G, H, n_leaves)
    return _leaf_formula(s[..., :-1], s[..., -1], reg_lambda, alpha)


# K3's leaf pass reads the node ids directly (the scan design: a warp per 32
# leaves, no sort) while a pair has at most this many rows, and sorts the
# rows by leaf first (`node_segments`, then a warp per leaf) above it.
LEAF_SCAN_MAX_ROWS = 2048


def leaf_regime(n: int) -> str:
    """"scan" or "segments": the design K3's leaf pass takes for n rows a
    pair. Both give the same bits (one row-order chain per leaf)."""
    return "scan" if n <= LEAF_SCAN_MAX_ROWS else "segments"


_LEAF_ARGS = cuda_build.register(
    "route_leaves", "leaf_values",
    (ctypes.c_void_p,) * 6 + (ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_float, ctypes.c_void_p)
    + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
cuda_build.register("route_leaves", "leaf_values_max_m", ())


def _leaf_param(v: Param, P: int, dev) -> Tuple[Optional[torch.Tensor],
                                                 float]:
    """A per-pair hyperparameter as the kernel takes it: one Python value
    (no tensor to build) or a (P,) f32 tensor on the device."""
    if isinstance(v, (int, float)):
        return None, float(v)
    return per_pair(v, P, dev), 0.0


def _leaf_values_cuda(node_idx, G, H, n_leaves, reg_lambda, alpha,
                      regime=None):
    _on_device("leaf_values", node_idx, G=G, H=H)
    _require(G.dtype == torch.float32 and H.dtype == torch.float32,
             "leaf_values: G/H must be f32")
    _require(H.shape == node_idx.shape and G.dim() == 3
             and G.shape[0] == node_idx.shape[0]
             and G.shape[2] == node_idx.shape[1],
             f"leaf_values: node_idx {tuple(node_idx.shape)}, G "
             f"{tuple(G.shape)}, H {tuple(H.shape)} must be (P, n), (P, m, "
             "n) and (P, n)")
    P, m, n = G.shape
    dev = G.device
    lam, lam_v = _leaf_param(reg_lambda, P, dev)
    a, a_v = _leaf_param(alpha, P, dev)
    leaf = torch.empty((P, n_leaves, m), dtype=torch.float32, device=dev)
    if leaf.numel() == 0:
        return leaf
    regime = regime or leaf_regime(n)
    node_idx = node_idx.to(torch.int32).contiguous()
    order = seg = None
    if regime == "segments":
        order, seg = node_segments(node_idx, n_leaves)
    G, H = G.contiguous(), H.contiguous()
    max_m = cuda_build.entry("route_leaves", "leaf_values_max_m")()
    fn = cuda_build.entry("route_leaves", "leaf_values")
    parts = []
    for c0 in range(0, m, max_m):  # channels in launches of at most max_m
        Gc = G if m <= max_m else G[:, c0:c0 + max_m].contiguous()
        out = leaf if m <= max_m else torch.empty(
            (P, n_leaves, Gc.shape[1]), dtype=torch.float32, device=dev)
        err = cuda_build.launch(
            G.get_device(), fn, Gc.data_ptr(), H.data_ptr(),
            node_idx.data_ptr(), None if order is None else order.data_ptr(),
            None if seg is None else seg.data_ptr(),
            None if lam is None else lam.data_ptr(), lam_v,
            None if a is None else a.data_ptr(), a_v, out.data_ptr(), P, n,
            n_leaves, Gc.shape[1])
        cuda_build.check("leaf_values", err)
        _count("leaf_values")
        parts.append(out)
    return leaf if m <= max_m else torch.cat(parts, dim=2)


_LEAF_SUMS_ARGS = cuda_build.register(
    "route_leaves", "leaf_sums",
    (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


def _leaf_sums_cuda(node_idx, G, H, n_leaves, regime=None):
    _on_device("leaf_sums", node_idx, G=G, H=H)
    _require(G.dtype == torch.float32 and H.dtype == torch.float32,
             "leaf_sums: G/H must be f32")
    _require(H.shape == node_idx.shape and G.dim() == 3
             and G.shape[0] == node_idx.shape[0]
             and G.shape[2] == node_idx.shape[1],
             f"leaf_sums: node_idx {tuple(node_idx.shape)}, G "
             f"{tuple(G.shape)}, H {tuple(H.shape)} must be (P, n), (P, m, "
             "n) and (P, n)")
    P, m, n = G.shape
    dev = G.device
    out = torch.empty((P, n_leaves, m + 1), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    regime = regime or leaf_regime(n)
    node_idx = node_idx.to(torch.int32).contiguous()
    order = seg = None
    if regime == "segments":
        order, seg = node_segments(node_idx, n_leaves)
    G, H = G.contiguous(), H.contiguous()
    max_m = cuda_build.entry("route_leaves", "leaf_values_max_m")()
    fn = cuda_build.entry("route_leaves", "leaf_sums")
    for c0 in range(0, m, max_m):  # channels in launches of at most max_m
        c = min(max_m, m - c0)
        Gc = G if m <= max_m else G[:, c0:c0 + c].contiguous()
        part = out if m <= max_m else torch.empty(
            (P, n_leaves, c + 1), dtype=torch.float32, device=dev)
        err = cuda_build.launch(
            G.get_device(), fn, Gc.data_ptr(), H.data_ptr(),
            node_idx.data_ptr(), None if order is None else order.data_ptr(),
            None if seg is None else seg.data_ptr(), part.data_ptr(), P, n,
            n_leaves, c)
        cuda_build.check("leaf_sums", err)
        _count("leaf_sums")
        if part is not out:  # the weights' sums come with every launch
            out[:, :, c0:c0 + c] = part[:, :, :c]
            out[:, :, m] = part[:, :, c]
    return out


def leaf_sums(node_idx: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
              n_leaves: int) -> torch.Tensor:
    """(P, n_leaves, m + 1) f32 per-leaf sums from final node ids (P, n),
    values G (P, m, n) and weights H (P, n): Σ G_c per channel, then Σ H,
    each adding the leaf's rows in row order. K3's leaf pass without the
    formula: a tree grown over row shards adds the shards' sums and
    applies `_leaf_formula` to the total. A CUDA tensor launches K3's
    leaf-sums entry in the design `leaf_regime` picks (or raises); a CPU
    tensor takes the plain version."""
    _check_device(G, "leaf_sums")
    if G.is_cuda:
        return _leaf_sums_cuda(node_idx, G, H, n_leaves)
    return leaf_sums_plain(node_idx, G, H, n_leaves)


def leaf_values(node_idx: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
                n_leaves: int, reg_lambda: Param, alpha: Param
                ) -> torch.Tensor:
    """(P, n_leaves, m) f32 leaf values from final node ids (P, n), values
    G (P, m, n) and weights H (P, n): g_c = Σ G_c, h = Σ H per leaf, g_c ←
    sign(g_c)·max(|g_c| − α, 0), leaf_c = g_c / (h + λ); each sum adds
    the leaf's rows in row order. A CUDA tensor launches the K3 leaf kernel
    in the design `leaf_regime` picks (or raises); a CPU tensor takes the
    plain version."""
    _check_device(G, "leaf_values")
    if G.is_cuda:
        return _leaf_values_cuda(node_idx, G, H, n_leaves, reg_lambda, alpha)
    return leaf_values_plain(node_idx, G, H, n_leaves, reg_lambda, alpha)


# --------------------------------------------------------------------------- #
# the level-wise learner                                                      #
# --------------------------------------------------------------------------- #

# depth from which a tree is grown with sibling subtraction (the JAX
# package's gate in its exact-f32 mode, the only mode the port has)
_SUBTRACT_MIN_DEPTH = 12

_TIMERS: List[List[Dict]] = []


@contextlib.contextmanager
def level_times():
    """Inside the block, every growth on the card (`grow_trees`, and the
    big path's lockstep learners through it) records CUDA events around
    each level's K1, K2 and K3 launches and around its leaf pass (over
    shards: every shard's launches and the sums on the lead). Yields a
    list that holds, once the block exits (it synchronizes), one dict per
    level: {"K", "level", "nodes", "histograms_ms", "split_search_ms",
    "route_level_ms"}, and one per growth with "leaf_values_ms"."""
    rec: List[Dict] = []
    _TIMERS.append(rec)
    try:
        yield rec
    finally:
        _TIMERS.pop()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for r in rec:
            for name, (a, b) in r.pop("_events", {}).items():
                r[f"{name}_ms"] = a.elapsed_time(b)


def _timed(rec: Optional[Dict], name: str, fn):
    if rec is None:
        return fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    rec.setdefault("_events", {})[name] = (a, b)
    return out


def _histograms_chunked(Xb, node_K, G, H, n_nodes, n_bins, chunk=None):
    """K1 over all rows on the card; on the CPU with a `chunk`, the plain
    version summed over row chunks of `chunk` (it builds (P, chunk, d)
    cell ids; the big path bounds its working set so)."""
    if Xb.is_cuda or chunk is None:
        return histograms(Xb, node_K, G, H, n_nodes, n_bins)
    n = Xb.shape[0]
    hg = hh = None
    for r0 in range(0, n, chunk):
        sl = slice(r0, r0 + chunk)
        cg, ch = histograms(Xb[sl], node_K[:, sl].contiguous(),
                            G[:, :, sl].contiguous(), H[:, sl].contiguous(),
                            n_nodes, n_bins)
        hg, hh = (cg, ch) if hg is None else (hg + cg, hh + ch)
    return hg, hh


def grow_trees(Xb, G, H, max_depth: int, n_bins: int,
               reg_lambda: Param = 1.0, min_child_weight: Param = 1.0,
               min_gain: Param = 0.0,
               feature_mask: Optional[torch.Tensor] = None,
               active_depth: Optional[Param] = None, alpha: Param = 0.0,
               min_gain_norm: Param = 0.0, live: bool = True,
               chunk: Optional[int] = None,
               subtract: Optional[bool] = None
               ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Grow one fixed-depth tree per pair from m value channels G (P, m, n)
    and weights H (P, n) (the JAX package's `grow_tree`, vmapped). Returns
    ({"feat": (P, depth, 2^depth) int32, "bin": (P, depth, 2^depth) int32
    (n_bins = no split), "leaf": (P, 2^depth, m) f32}, final node ids (P,
    n) int32).

    Below depth 12 every level builds its histograms directly (K1). From
    depth 12 on, as in the JAX package's f32 mode, the root's histograms
    are built once and each level below builds only those of the rows
    routed right, grouped by parent (K1 with the left rows left out), and
    derives the children by sibling subtraction (K1-sub): left = parent −
    right.

    Each level's split search (K2) writes straight into the tables and,
    with `live`, searches only the level's live set: the nodes K3's
    routing flagged as holding rows, and with subtraction also the left
    child of every node searched a level up (parent − right can leave a
    rounding residue without rows); every other node's histograms are
    zero. The flags live on the device, so no level waits for the card.
    `live=False` searches every node (the same tables).

    Xb may be a `parallel.rowshards.RowSplit`: G and H are then lists of
    each row shard's part (rows last), on its device, and the node ids
    come back as such a list. Per level K1 runs on each shard and the partial
    histograms are added on the lead in shard order; K2 (and K1-sub) run
    on the lead over the live set OR-ed from the shards' flags; the
    level's tables go out to the shards once and K3 routes each shard's
    rows into that shard's own flags. The leaves are K3's leaf sums of
    each shard, added on the lead, with the formula applied to the total.
    Of one shard (a tensor, or a split of one), every launch is as it
    was, K3's fused leaf pass included.

    The big path's lockstep learners (`parallel/bigdata.py`) grow through
    here with `subtract=False` (every level's histograms built directly,
    as the JAX package's big path does) and `chunk` (on the CPU the plain
    K1 runs by row chunks); `level_times` records each level's launches on
    the card."""
    split = isinstance(Xb, RowSplit)
    shards, Xb = rows_of(Xb)
    if not split:
        G, H = [G], [H]
    sharded = shards.n_shards > 1
    P = H[0].shape[0]
    dev = shards.lead
    max_nodes = 2 ** max_depth
    node = shards.map(lambda h: torch.zeros(h.shape, dtype=torch.int32,
                                            device=h.device), H)
    spare = shards.map(torch.empty_like, node)  # routing writes, reads node
    feats = torch.zeros((P, max_depth, max_nodes), dtype=torch.int32,
                        device=dev)
    bins = torch.full((P, max_depth, max_nodes), n_bins, dtype=torch.int32,
                      device=dev)
    # per-level flags of the live set, zeroed with the tables; a shard of
    # several routes into its own level buffer, OR-ed into these
    flags = (torch.zeros((P, max_depth, max_nodes), dtype=torch.uint8,
                         device=dev) if live and max_depth > 1 else None)
    occ = (shards.map(lambda h: torch.empty((P, max_nodes),
                                            dtype=torch.uint8,
                                            device=h.device), H)
           if sharded and flags is not None else None)
    # the hyperparameters as (P,) tensors once, not once a level
    lam = per_pair(reg_lambda, P, dev)
    mcw = per_pair(min_child_weight, P, dev)
    mg = per_pair(min_gain, P, dev)
    mgn = per_pair(min_gain_norm, P, dev)
    ad = (None if active_depth is None
          else per_pair(active_depth, P, dev, torch.int32))

    def hist(ids, n_nodes):
        parts = shards.map(lambda xb, nd, g, h: _histograms_chunked(
            xb, nd, g, h, n_nodes, n_bins, chunk), Xb, ids, G, H)
        return (shards.sum([p[0] for p in parts]),
                shards.sum([p[1] for p in parts]))

    timers = _TIMERS[-1] if (_TIMERS and dev.type == "cuda") else None
    if subtract is None:
        subtract = max_depth >= _SUBTRACT_MIN_DEPTH
    if subtract:
        hg, hh = hist(node, 1)
    for level in range(max_depth):
        n_nodes = 2 ** level
        rec = None
        if timers is not None:
            rec = {"K": P, "level": level, "nodes": n_nodes}
            timers.append(rec)
        if not subtract:
            hg, hh = _timed(rec, "histograms", lambda: hist(node, n_nodes))
        here = (feats[:, level, :n_nodes], bins[:, level, :n_nodes])
        nxt = (flags[:, level + 1, :2 * n_nodes]
               if flags is not None and level + 1 < max_depth else None)
        searched = (flags[:, level, :n_nodes]
                    if level and flags is not None else None)
        _timed(rec, "split_search", lambda: split_search(
            hg, hh, n_bins, lam, mcw, mg, mgn, feature_mask, level, ad,
            live=searched, out=here, mark=nxt if subtract else None))
        if nxt is None:
            into = [None] * shards.n_shards
        elif sharded:
            into = shards.map(lambda o: o[:, :2 * n_nodes].zero_(), occ)
        else:
            into = [nxt]

        def route():
            routed = shards.map(
                lambda xb, nd, f, b, o, out: route_level(
                    xb, nd, f, b, occupied=o, out=out),
                Xb, node, shards.broadcast(here[0]),
                shards.broadcast(here[1]), into, spare)
            if sharded and nxt is not None:
                shards.any(into, out=nxt)
            return routed
        node, spare = _timed(rec, "route_level", route), node
        if subtract and level + 1 < max_depth:
            # the rows routed right, by parent; the left rows are left out
            parent = shards.map(lambda nd: torch.where(
                (nd & 1).bool(), nd >> 1, torch.full_like(nd, n_nodes)),
                node)
            hg_r, hh_r = hist(parent, n_nodes)
            hg, hh = sibling_subtract(hg, hh, hg_r, hh_r)
            del hg_r, hh_r
        else:
            del hg, hh
    tables = {"feat": feats, "bin": bins}
    rec = None
    if timers is not None:
        rec = {"K": P, "leaves": max_nodes}
        timers.append(rec)
    if not sharded:
        tables["leaf"] = _timed(rec, "leaf_values", lambda: leaf_values(
            node[0], G[0], H[0], max_nodes, reg_lambda, alpha))
        return tables, node if split else node[0]

    def leaves():
        sums = shards.sum(shards.map(
            lambda nd, g, h: leaf_sums(nd, g, h, max_nodes), node, G, H))
        return _leaf_formula(sums[..., :-1], sums[..., -1], reg_lambda,
                             alpha)
    tables["leaf"] = _timed(rec, "leaf_values", leaves)
    return tables, node


# --------------------------------------------------------------------------- #
# Random forest: trees of every (config, fold) pair along P                   #
# --------------------------------------------------------------------------- #

# share of the card's free memory one chunk of trees may take
_FOREST_MEM_SHARE = 0.5
# the chunk budget on the CPU (the plain versions' histograms)
_FOREST_CPU_BUDGET = 2 << 30

_INJECTED_DRAWS: List[Any] = []


@contextlib.contextmanager
def injected_forest_draws(draws):
    """Test hook: inside the block every `fit_forest` call that is given no
    `draws` takes these instead of its own — a pair (bootstrap counts
    (n_trees, n), feature masks (n_trees, d)), or a function of (seed,
    n_trees, n, d) returning one — e.g. the JAX package's threefry draws,
    so that a whole workflow's forests can be held to the JAX package's."""
    _INJECTED_DRAWS.append(draws)
    try:
        yield
    finally:
        _INJECTED_DRAWS.pop()


def forest_draws(n_trees: int, n: int, d: int, seed: int,
                 subsample_features: bool = True, bootstrap: bool = True,
                 device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per tree: Poisson(1) bootstrap counts (n_trees, n) f32 and a mask
    of ⌊√d⌋ features (n_trees, d) bool (the uniform scores at or below
    their (⌊√d⌋)-th smallest), drawn from a `torch.Generator` seeded with
    `seed`. The JAX package draws the same distributions from threefry
    keys, so forests match it at the metric level, or exactly when its
    draws are injected (`draws=` / `injected_forest_draws`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ones = torch.ones((n_trees, n), dtype=torch.float32, device=device)
    boot = torch.poisson(ones, generator=gen) if bootstrap else ones
    if subsample_features:
        n_sub = max(int(np.sqrt(d)), 1)
        scores = torch.rand((n_trees, d), generator=gen, device=device)
        thresh = torch.sort(scores, dim=1).values[:, n_sub - 1:n_sub]
        mask = scores <= thresh
    else:
        mask = torch.ones((n_trees, d), dtype=torch.bool, device=device)
    return boot, mask


def forest_chunk(n_trees_total: int, max_depth: int, m: int, n_rows: int,
                 d: int, n_bins: int, device,
                 n_shards: int = 1) -> Tuple[int, int, int]:
    """(trees per launch, the byte budget, bytes per tree): the histograms
    alive at a tree's deepest level are (m + 1)·d·n_bins f32 per node,
    2^depth nodes' worth with subtraction (children, parents and right
    children together), plus K1's piece scratch at that level (none while
    n_rows ≤ HIST_PIECE_ROWS). Grown over `n_shards` row shards (n_rows
    the largest shard's), the lead also holds every shard's partial
    histograms of a level before they are added: 2^(depth − 1) nodes'
    worth each. The budget is a share of the card's free memory (that of
    the caching allocator included), or a fixed one on the CPU."""
    dev = torch.device(device)
    per_tree = (m + 1) * d * n_bins * 4 * 2 ** max_depth
    if n_shards > 1:
        per_tree += n_shards * (m + 1) * d * n_bins * 4 \
            * 2 ** max(max_depth - 1, 0)
    per_tree += n_shards * hist_scratch_bytes(
        1, n_rows, 2 ** max(max_depth - 1, 0), m, d, n_bins)
    if dev.type != "cuda":  # the plain K1's (P, n, d) cell ids and values
        per_tree += n_rows * d * 16
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        budget = int(_FOREST_MEM_SHARE * (free + cached))
    else:
        budget = _FOREST_CPU_BUDGET
    chunk = max(1, min(n_trees_total, _MAX_GRID_YZ, budget // per_tree))
    return chunk, budget, per_tree


def fit_forest(Xb, Y: torch.Tensor, w: torch.Tensor,
               n_trees: int, max_depth: int, n_bins: int, seed: int,
               subsample_features: bool = True,
               min_child_weight: Param = 1.0,
               active_depth: Optional[Param] = None, bootstrap: bool = True,
               min_gain: Param = 0.0, draws=None
               ) -> Dict[str, torch.Tensor]:
    """Random forests of Q (config, fold) pairs over one binned matrix Xb
    (n, d): labels as Y (n, m) (one-hot classes), row weights w (Q, n)
    (or (n,)), and per-pair min_child_weight, min_gain (the normalized
    gain threshold) and active_depth. Returns {"feat", "bin": (Q, n_trees,
    depth, 2^depth) int32, "leaf": (Q, n_trees, 2^depth, m) f32}.

    The JAX package's `fit_forest`, vmapped over pairs: tree t of pair q
    grows on values G = Y·boot_t·w_q and weights H = boot_t·w_q with
    λ = 1e-6, the feature mask of tree t, and the pair's thresholds. Every
    pair sees the same n_trees draws (the JAX package keys them by the
    seed alone); `draws=(boot (n_trees, n), mask (n_trees, d))` replaces
    them — a test hook that feeds in the JAX package's draws. The trees of
    all pairs lie along the kernels' pair axis, in chunks that fit
    `forest_chunk`'s byte budget, which the call logs.

    Over a `parallel.rowshards.RowSplit` Xb (the row shards' binned
    parts), Y and w stay whole on the lead: the draws are made there at
    the real n (a draw at any other n would move every tree's stream),
    and the bootstrap columns, w and Y go to the shards once; each
    chunk's trees grow over the shards (`grow_trees`)."""
    shards, parts = rows_of(Xb)
    Xb = RowSplit(shards, parts)
    dev = shards.lead
    n, d = shards.n, parts[0].shape[1]
    m = Y.shape[1]
    w = w[None, :] if w.dim() == 1 else w
    Q = w.shape[0]
    # a tree without bootstrap or feature sampling draws nothing
    if draws is None and _INJECTED_DRAWS and (bootstrap
                                              or subsample_features):
        draws = _INJECTED_DRAWS[-1]
        if callable(draws):
            draws = draws(int(seed), n_trees, n, d)
    if draws is None:
        boot, mask = forest_draws(n_trees, n, d, seed, subsample_features,
                                  bootstrap, dev)
    else:
        boot, mask = (torch.as_tensor(np.array(a) if not isinstance(
            a, torch.Tensor) else a).to(dev) for a in draws)
        _require(boot.shape == (n_trees, n) and mask.shape == (n_trees, d),
                 f"fit_forest: draws {tuple(boot.shape)} / "
                 f"{tuple(mask.shape)} must be ({n_trees}, {n}) / "
                 f"({n_trees}, {d})")
        boot, mask = boot.to(torch.float32), mask.to(torch.bool)
    mcw = per_pair(min_child_weight, Q, dev)
    mgn = per_pair(min_gain, Q, dev)
    ad = (per_pair(active_depth, Q, dev, torch.int32)
          if active_depth is not None else None)
    Yt = Y.to(torch.float32).T.contiguous()  # (m, n)
    boot_s, w_s, Yt_s = (shards.split(t, 1) for t in (boot, w, Yt))
    total = Q * n_trees
    chunk, budget, per_tree = forest_chunk(
        total, max_depth, m, max(shards.sizes), d, n_bins, dev,
        shards.n_shards)
    log.info("fit_forest: %d trees at depth %d in %d chunks of %d (budget "
             "%d bytes, %d per tree)", total, max_depth, -(-total // chunk),
             chunk, budget, per_tree)
    parts: List[Dict[str, torch.Tensor]] = []
    for s in range(0, total, chunk):
        idx = torch.arange(s, min(s + chunk, total), device=dev)
        q, t = idx // n_trees, idx % n_trees
        H = shards.map(lambda b, wk, qk, tk: (b[tk] * wk[qk]).contiguous(),
                       boot_s, w_s, shards.broadcast(q), shards.broadcast(t))
        G = shards.map(lambda y, h: (y[None, :, :] * h[:, None, :])
                       .contiguous(), Yt_s, H)
        tree, _ = grow_trees(
            Xb, G, H, max_depth, n_bins, reg_lambda=1e-6,
            min_child_weight=mcw[q], min_gain=0.0, feature_mask=mask[t],
            active_depth=None if ad is None else ad[q],
            min_gain_norm=mgn[q])
        parts.append(tree)
    return {k: torch.cat([p[k] for p in parts]).reshape(
        (Q, n_trees) + parts[0][k].shape[1:]) for k in ("feat", "bin", "leaf")}


# --------------------------------------------------------------------------- #
# Gradient boosting (XGBoost-style second order), P fits at once              #
# --------------------------------------------------------------------------- #

def gbt_val_loss(margin: torch.Tensor, y: torch.Tensor, val_w: torch.Tensor,
                 eval_metric: str = "logloss",
                 objective: str = "logistic") -> torch.Tensor:
    """(P,) per-round early-stopping metric of margins on the held-out
    rows, MINIMIZED: for binary margins the negated binned AuPR over 512
    sigmoid buckets (K8) with "aupr", else the weighted logloss; for the
    squared objective the weighted MSE."""
    vs = torch.clamp(val_w.sum(1), min=1.0)
    if objective != "logistic":
        return (((margin - y) ** 2) * val_w).sum(1) / vs
    if eval_metric == "aupr":
        return -binned_aupr(margin, y, val_w, 512, from_margin=True)
    ll = torch.nn.functional.softplus(margin) - y * margin
    return (ll * val_w).sum(1) / vs


def fit_gbt_pairs(Xb, y: torch.Tensor, w: torch.Tensor,
                  n_rounds: int, max_depth: int, n_bins: int,
                  learning_rate: Param, reg_lambda: Param,
                  min_child_weight: Param = 1.0,
                  active_depth: Optional[Param] = None, gamma: Param = 0.0,
                  alpha: Param = 0.0, subsample: Param = 1.0,
                  colsample: Param = 1.0, seed: int = 0,
                  val_w: Optional[torch.Tensor] = None,
                  early_stopping_rounds: int = 0, min_gain_norm: Param = 0.0,
                  eval_metric: str = "logloss", keep_trees: bool = False,
                  objective: str = "logistic",
                  margin0: Optional[torch.Tensor] = None):
    """Boost P binary or regression GBT fits at once over one binned
    matrix Xb (n, d): labels y (n,), row weights w (P, n) and, for early
    stopping, held-out weights val_w (P, n). Every hyperparameter is one
    value or one per pair. Returns (trees, margin (P, n), since (P,));
    `trees` is {"feat", "bin": (P, rounds, depth, 2^depth) int32, "leaf":
    (P, rounds, 2^depth, 1) f32} with `keep_trees`, else None.

    The JAX package's `_gbt_scan` from a zero margin (or from `margin0`
    (P, n), a warm start's resident margin): per round, for the
    "logistic" objective gradients g = (p − y)·w and hessians
    max(p(1 − p), 1e-6)·w of the sigmoid margin, for "squared" g =
    (margin − y)·w and h = w; one tree per pair on (−g, h), margin += lr ·
    leaf[node]. With early stopping, a
    round that starts with since >= early_stopping_rounds grows a zeroed
    tree (the margin freezes), and the loop ends once every pair has
    stopped: the rounds left would add only zeroed trees.

    Row and feature sampling (rates below 1) draw from a `torch.Generator`
    seeded with `seed`, not from the JAX package's threefry stream, so such
    fits match the JAX package at the metric level only.

    Over a `parallel.rowshards.RowSplit` Xb (the row shards' binned
    parts), y, w and val_w stay whole on the lead:
    margins, gradients and hessians live on each shard (the row draws are
    made at the real n on the lead and split), the trees grow over the
    shards (`grow_trees`), and the early-stopping loss runs on the
    margins gathered to the lead. The returned margin is gathered."""
    shards, parts = rows_of(Xb)
    Xb = RowSplit(shards, parts)
    P, n = w.shape
    dev = shards.lead
    d = parts[0].shape[1]
    esr = int(early_stopping_rounds) if val_w is not None else 0
    # every hyperparameter on the device once, not at every level
    lr = per_pair(learning_rate, P, dev)[:, None]
    sub = per_pair(subsample, P, dev)
    col = per_pair(colsample, P, dev)
    reg_lambda, min_child_weight, gamma, alpha, min_gain_norm = (
        per_pair(v, P, dev) for v in (reg_lambda, min_child_weight, gamma,
                                      alpha, min_gain_norm))
    if active_depth is not None:
        active_depth = per_pair(active_depth, P, dev, torch.int32)
    gen = None
    if bool((sub < 1.0).any()) or bool((col < 1.0).any()):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    margin = (torch.zeros((P, n), dtype=torch.float32, device=dev)
              if margin0 is None else margin0.to(torch.float32).clone())
    margin, y_s, w_s = shards.split(margin, 1), shards.split(y), \
        shards.split(w, 1)
    lr_s = shards.broadcast(lr)
    best = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((P,), dtype=torch.int32, device=dev)
    kept: List[Dict[str, torch.Tensor]] = []
    if objective not in ("logistic", "squared"):
        raise ValueError(f"fit_gbt_pairs: unknown objective {objective!r}")

    def grads(mg, yk, wk):
        if objective == "logistic":
            p = sigmoid(mg)
            return -((p - yk) * wk), torch.clamp(p * (1 - p), min=1e-6) * wk
        return -((mg - yk) * wk), wk

    for _ in range(n_rounds):
        G, H = zip(*shards.map(grads, margin, y_s, w_s))
        fmask = None
        if gen is not None:
            rows = shards.split((torch.rand((P, n), generator=gen,
                                            device=dev)
                                 < sub[:, None]).to(torch.float32), 1)
            G = shards.map(torch.mul, G, rows)
            H = shards.map(torch.mul, H, rows)
            fmask = torch.rand((P, d), generator=gen, device=dev) \
                < col[:, None]
        tree, node = grow_trees(
            Xb, [g[:, None, :] for g in G], list(H),
            max_depth, n_bins, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight, min_gain=gamma,
            feature_mask=fmask, active_depth=active_depth, alpha=alpha,
            min_gain_norm=min_gain_norm)
        if esr > 0:
            live = (since < esr).to(torch.float32)
            tree["leaf"] = tree["leaf"] * live[:, None, None]
        margin = shards.map(
            lambda mg, l, leaf, nd: mg + l * torch.gather(
                leaf[:, :, 0], 1, nd.long()),
            margin, lr_s, shards.broadcast(tree["leaf"]), node)
        if keep_trees:
            kept.append(tree)
        if esr > 0:
            m = gbt_val_loss(shards.gather(margin, 1), y, val_w, eval_metric,
                             objective)
            improved = m < best - 1e-7
            since = torch.where(since >= esr, since,
                                torch.where(improved,
                                            torch.zeros_like(since),
                                            since + 1))
            best = torch.minimum(best, m)
            if bool((since >= esr).all()):
                break
    trees = None
    if keep_trees:
        trees = {k: torch.stack([t[k] for t in kept], 1)
                 for k in ("feat", "bin", "leaf")}
    return trees, shards.gather(margin, 1), since


def fit_gbt_multiclass_pairs(Xb, y: torch.Tensor,
                             w: torch.Tensor, n_rounds: int, max_depth: int,
                             n_bins: int, n_classes: int,
                             learning_rate: Param, reg_lambda: Param,
                             min_child_weight: Param = 1.0,
                             active_depth: Optional[Param] = None,
                             gamma: Param = 0.0, alpha: Param = 0.0,
                             subsample: Param = 1.0, colsample: Param = 1.0,
                             seed: int = 0, min_gain_norm: Param = 0.0,
                             keep_trees: bool = False):
    """Softmax boosting of P fits at once over one binned matrix Xb (n, d):
    labels y (n,) in 0..K-1, row weights w (P, n), every hyperparameter one
    value or one per pair. Returns (trees, margin (P, n, K)); `trees` is
    {"feat", "bin": (P, rounds, K, depth, 2^depth) int32, "leaf": (P,
    rounds, K, 2^depth, 1) f32} with `keep_trees`, else None.

    The JAX package's `fit_gbt_multiclass` (XGBoost's multi:softprob):
    per round, from the softmax p of the margin, gradients (p − Y)·w and
    hessians max(p(1 − p), 1e-6)·w; one tree per class on (−g, h), all P·K
    trees of the round grown together along `grow_trees`' pair axis; margin
    += lr · leaf at each row's final node. Every round runs: no early
    stopping. A round's row and feature draws (rates below 1, from a
    `torch.Generator` seeded with `seed`, so such fits match the JAX
    package at the metric level only) are shared by its K classes.

    Over a `RowSplit` Xb, as `fit_gbt_pairs`: y and w stay whole on the
    lead, and the margins live on the shards; the returned margin is
    gathered."""
    shards, parts = rows_of(Xb)
    Xb = RowSplit(shards, parts)
    P, n = w.shape
    K = int(n_classes)
    dev = shards.lead
    d = parts[0].shape[1]

    def classes(v, dtype=torch.float32):
        return per_pair(v, P, dev, dtype).repeat_interleave(K)

    lr = per_pair(learning_rate, P, dev)[:, None, None]
    sub = per_pair(subsample, P, dev)
    col = per_pair(colsample, P, dev)
    reg_lambda, min_child_weight, gamma, alpha, min_gain_norm = (
        classes(v) for v in (reg_lambda, min_child_weight, gamma, alpha,
                             min_gain_norm))
    if active_depth is not None:
        active_depth = classes(active_depth, torch.int32)
    gen = None
    if bool((sub < 1.0).any()) or bool((col < 1.0).any()):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    Y_s = shards.split(torch.nn.functional.one_hot(y.long(), K)
                       .to(torch.float32))
    w_s = shards.split(w, 1)
    lr_s = shards.broadcast(lr)
    margin = shards.map(lambda wk: torch.zeros(
        (P, wk.shape[1], K), dtype=torch.float32, device=wk.device), w_s)
    kept: List[Dict[str, torch.Tensor]] = []

    def grads(mg, Yk, wk):
        p = torch.softmax(mg, dim=2)
        return (-((p - Yk) * wk[:, :, None]),
                torch.clamp(p * (1.0 - p), min=1e-6) * wk[:, :, None])

    for _ in range(n_rounds):
        G, H = zip(*shards.map(grads, margin, Y_s, w_s))
        fmask = None
        if gen is not None:
            rows = shards.split((torch.rand((P, n), generator=gen,
                                            device=dev)
                                 < sub[:, None]).to(torch.float32), 1)
            G = shards.map(lambda g, r: g * r[:, :, None], G, rows)
            H = shards.map(lambda h, r: h * r[:, :, None], H, rows)
            fmask = (torch.rand((P, d), generator=gen, device=dev)
                     < col[:, None]).repeat_interleave(K, 0)
        Gk = shards.map(lambda g: g.permute(0, 2, 1).reshape(
            P * K, 1, g.shape[1]), G)
        Hk = shards.map(lambda h: h.permute(0, 2, 1).reshape(
            P * K, h.shape[1]).contiguous(), H)
        tree, node = grow_trees(
            Xb, Gk, Hk, max_depth, n_bins,
            reg_lambda=reg_lambda, min_child_weight=min_child_weight,
            min_gain=gamma, feature_mask=fmask, active_depth=active_depth,
            alpha=alpha, min_gain_norm=min_gain_norm)
        margin = shards.map(
            lambda mg, l, leaf, nd: mg + l * torch.gather(
                leaf[:, :, 0], 1, nd.long()).reshape(
                    P, K, nd.shape[1]).permute(0, 2, 1),
            margin, lr_s, shards.broadcast(tree["leaf"]), node)
        if keep_trees:
            kept.append({k: v.reshape((P, K) + v.shape[1:])
                         for k, v in tree.items()})
    trees = None
    if keep_trees:
        trees = {k: torch.stack([t[k] for t in kept], 1)
                 for k in ("feat", "bin", "leaf")}
    return trees, shards.gather(margin, 1)


def _pick_rounds_per_dispatch(n_estimators: int, ideal: int) -> int:
    """Largest divisor of `n_estimators` <= `ideal` (the JAX package's
    chunking rule, kept because it fixes the shipped model's round
    count)."""
    ideal = max(1, min(ideal, n_estimators))
    best = max(d for d in range(1, ideal + 1) if n_estimators % d == 0)
    return best if best * 2 >= ideal else ideal


def _default_rounds_per_dispatch(n: int, d: int, n_estimators: int,
                                 max_depth: int, n_bins: int) -> int:
    """The JAX package's rounds per dispatch. The port boosts without
    dispatch chunks, but the refit rounds its probe's stopping round up to
    a multiple of this, so the shipped model has the same tree count."""
    unit = n * (2 ** min(max_depth, 14)) * d * n_bins
    return _pick_rounds_per_dispatch(
        n_estimators, max(1, int(2.5e13 // max(unit, 1))))


# --------------------------------------------------------------------------- #
# prediction assembly (as in the JAX package)                                 #
# --------------------------------------------------------------------------- #

def _f32(x: float) -> float:
    """`x` rounded to f32, as a Python scalar: a tensor op with it rounds
    it to the tensor's f32 once, and no tensor is made on the device (a
    CUDA graph captures no host-to-device copy)."""
    return float(np.float32(x))


def predict_gbt_margin(trees: Dict[str, torch.Tensor], Xb: torch.Tensor,
                       learning_rate: float) -> torch.Tensor:
    """(n,) boosting margin: learning_rate · Σ_t leaf."""
    s = tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"])[:, 0]
    return _f32(learning_rate) * s


def predict_gbt_multiclass_margin(trees: Dict[str, torch.Tensor],
                                  Xb: torch.Tensor,
                                  learning_rate: float) -> torch.Tensor:
    """(n, K) softmax-boosting margin of trees (rounds, K, ...):
    learning_rate · Σ_t leaf (K5-mc)."""
    s = tree_walk_classes(Xb, trees["feat"], trees["bin"], trees["leaf"])
    return _f32(learning_rate) * s


def gbt_multiclass_pred_from_margin(margin: torch.Tensor
                                    ) -> Dict[str, torch.Tensor]:
    probs = torch.softmax(margin, dim=-1)
    return {"prediction": torch.argmax(probs, -1).to(torch.float32),
            "rawPrediction": margin, "probability": probs}


def predict_forest(trees: Dict[str, torch.Tensor],
                   Xb: torch.Tensor) -> torch.Tensor:
    """(n, m) mean per-tree prediction."""
    s = tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"])
    return div_const(s, trees["feat"].shape[0])


def gbt_pred_from_margin(margin: torch.Tensor,
                         objective: str) -> Dict[str, torch.Tensor]:
    if objective == "logistic":
        return binary_margin_pred(margin)
    return regression_pred(margin)


def forest_classification_sums(s: torch.Tensor,
                               n_trees: int) -> Dict[str, torch.Tensor]:
    """The Prediction dict of a forest's summed class leaves (n, m)."""
    probs = div_const(s, n_trees)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    return {"prediction": torch.argmax(probs, -1).to(torch.float32),
            "rawPrediction": probs, "probability": probs}


def forest_classification_pred(trees: Dict[str, torch.Tensor],
                               Xb: torch.Tensor) -> Dict[str, torch.Tensor]:
    return forest_classification_sums(
        tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"]),
        trees["feat"].shape[0])


def forest_regression_pred(trees: Dict[str, torch.Tensor],
                           Xb: torch.Tensor) -> Dict[str, torch.Tensor]:
    return regression_pred(predict_forest(trees, Xb)[:, 0])


# --------------------------------------------------------------------------- #
# warm-start refits                                                           #
# --------------------------------------------------------------------------- #

def warm_tree_compatible(warm: Dict, X, n_classes: Optional[int] = None,
                         max_bins: Optional[int] = None) -> bool:
    """Whether a tree warm-start payload fits the incoming data (the JAX
    package's rule): the resident bin edges match the feature width, the
    estimator's `max_bins` covers every resident bin id, and for
    classification the resident leaves cover every observed class.
    False: the caller fits cold."""
    edges = np.asarray(warm["edges"])
    d = int(X.shape[1])
    if int(edges.shape[0]) != d:
        log.info("tree warm refit: feature width changed (%d -> %d); "
                 "fitting cold", int(edges.shape[0]), d)
        return False
    if max_bins is not None and int(edges.shape[1]) + 1 > int(max_bins):
        log.info("tree warm refit: resident edges bin to %d buckets but "
                 "the estimator's max_bins is %d; fitting cold",
                 int(edges.shape[1]) + 1, int(max_bins))
        return False
    if n_classes is not None:
        leaf = np.asarray(warm["trees"]["leaf"])
        if int(leaf.shape[-1]) < int(n_classes):
            log.info("tree warm refit: resident leaves are %d-class but "
                     "the data has %d classes; fitting cold",
                     int(leaf.shape[-1]), int(n_classes))
            return False
    return True


def warm_refit_forest(est, warm: Dict, X: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor, ctx, classification: bool
                      ) -> Dict[str, np.ndarray]:
    """Forest warm refit (the JAX package's `warm_refit_forest`): grow
    replacement trees on the delta rows (the last `warm["delta_rows"]`
    rows, all rows without it) under the resident bin edges, and swap
    them in for the oldest trees, so the ensemble keeps its size.
    `warm["n_new"]` trees, else round(n_trees · delta / n), at least one.
    The replacements draw with seed + n_trees (fresh draws)."""
    dev = X.device
    edges = torch.as_tensor(np.asarray(warm["edges"], np.float32),
                            device=dev)
    old = {k: np.asarray(v) for k, v in warm["trees"].items()}
    n_trees = int(old["feat"].shape[0])
    n = int(X.shape[0])
    delta = int(warm.get("delta_rows") or 0)
    if not (0 < delta <= n):
        delta = n
    n_new = int(warm.get("n_new") or 0)
    if n_new <= 0:
        n_new = max(1, round(n_trees * delta / max(n, 1)))
    n_new = min(n_new, n_trees)
    Xb = bin_features(X[-delta:], edges)
    yd, wd = y[-delta:], w[-delta:]
    if classification:
        Y = torch.nn.functional.one_hot(
            yd.long(), int(old["leaf"].shape[-1])).to(torch.float32)
    else:
        Y = yd[:, None]
    seed = (ctx.seed if ctx is not None else 0) + n_trees
    new = fit_forest(Xb, Y, wd, n_new, est.max_depth, est.max_bins, seed,
                     est.subsample_features, est._effective_mcw(),
                     min_gain=est.min_info_gain)
    return {k: np.concatenate([old[k][n_new:], new[k][0].cpu().numpy()])
            for k in ("feat", "bin", "leaf")}


def warm_refit_gbt(est, warm: Dict, X: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor, ctx, objective: str
                   ) -> Dict[str, np.ndarray]:
    """GBT warm refit (the JAX package's `warm_refit_gbt`): continue
    boosting from the resident ensemble's margin under its bin edges and
    learning rate, and append the new rounds' trees: `warm["n_new"]`
    rounds, else n_estimators // 4, at least one, at most up to twice
    n_estimators in all; no early stopping. Row and feature sampling draw
    with seed + the resident round count."""
    dev = X.device
    edges = torch.as_tensor(np.asarray(warm["edges"], np.float32),
                            device=dev)
    old = {k: np.asarray(v) for k, v in warm["trees"].items()}
    n_old = int(old["feat"].shape[0])
    lr = float(warm.get("learning_rate", est.learning_rate))
    Xb = bin_features(X, edges)
    margin0 = predict_gbt_margin(
        {k: torch.from_numpy(np.array(v)).to(dev) for k, v in old.items()},
        Xb, lr)
    n_extra = int(warm.get("n_new") or 0)
    if n_extra <= 0:
        n_extra = max(1, est.n_estimators // 4)
    n_extra = min(n_extra, max(1, 2 * int(est.n_estimators) - n_old))
    seed = (ctx.seed if ctx is not None else 0) + n_old
    new, _, _ = fit_gbt_pairs(
        Xb, y, w[None, :], n_extra, est.max_depth, est.max_bins, lr,
        est.reg_lambda, est._effective_mcw(), gamma=est.gamma,
        alpha=est.alpha, subsample=est.subsample,
        colsample=est.colsample_bytree, seed=seed,
        min_gain_norm=est.min_info_gain, eval_metric=est.eval_metric,
        keep_trees=True, objective=objective, margin0=margin0[None, :])
    return {k: np.concatenate([old[k], new[k][0].cpu().numpy()])
            for k in ("feat", "bin", "leaf")}


# --------------------------------------------------------------------------- #
# stage classes                                                               #
# --------------------------------------------------------------------------- #

class TreeEnsemble(torch.nn.Module):
    """A fitted ensemble's tables as buffers; `forward(X)` bins the raw
    feature matrix (K4) and returns the binned matrix for the walk."""

    def __init__(self, edges: np.ndarray, trees: Dict[str, np.ndarray]):
        super().__init__()
        feat = np.asarray(trees["feat"], dtype=np.int32)
        d = np.asarray(edges).shape[0]
        flat = feat.reshape((-1,) + feat.shape[-2:])
        for level in range(flat.shape[1]):
            used = flat[:, level, :2 ** level]
            if used.size and (used.min() < 0 or used.max() >= d):
                raise ValueError(
                    f"tree tables name features outside [0, {d}) at "
                    f"level {level}")
        self.register_buffer("edges", torch.as_tensor(
            np.asarray(edges, dtype=np.float32)))
        self.register_buffer("feat", torch.as_tensor(feat))
        self.register_buffer("bin", torch.as_tensor(
            np.asarray(trees["bin"], dtype=np.int32)))
        self.register_buffer("leaf", torch.as_tensor(
            np.asarray(trees["leaf"], dtype=np.float32)))

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        return {"feat": self.feat, "bin": self.bin, "leaf": self.leaf}

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return bin_features(X, self.edges)


class _TreeModelBase(PredictionModel):
    def __init__(self, edges=None, trees=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.edges = np.asarray(edges, dtype=np.float32)
        self.trees = {k: np.asarray(v) for k, v in trees.items()}

    def get_params(self):
        return {"edges": self.edges, "trees": dict(self.trees)}

    def device_constants(self, device):
        return TreeEnsemble(self.edges, self.trees).to(device)

    def narrow_device_constants(self, consts: TreeEnsemble) -> TreeEnsemble:
        """The quantized mode's tables (models/trees.py:999 of the JAX
        package): split features int16 when d < 2^15 and split bins uint8
        when there are at most 255 edges (both lossless), edges f16
        (lossy at f16's precision, inside the mode's stated tolerance);
        leaves stay f32. K4 and K5 read them in their narrowed variants."""
        d, n_edges = consts.edges.shape
        if d < (1 << 15):
            consts.feat = consts.feat.to(torch.int16)
        if n_edges <= 255:
            consts.bin = consts.bin.to(torch.uint8)
        consts.edges = consts.edges.to(torch.float16)
        return consts

    def predict(self, consts: TreeEnsemble, X):
        return self._apply_tables(consts.tables, consts(X))

    # the family's walk (K5) and its reduction of the sums to predictions
    _classes = False

    def _walk(self, trees, Xb):
        return tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"])

    def _from_sums(self, trees, s):
        raise NotImplementedError(type(self).__name__)

    def _apply_tables(self, trees, Xb):
        return self._from_sums(trees, self._walk(trees, Xb))

    def loco_scores(self, X: torch.Tensor, masks) -> Dict[str, torch.Tensor]:
        """The Prediction dict of every group's ablation X · (1 − m_g),
        over G·n rows (group-major), for (G, d) 0/1 group masks `masks`:
        K4 bins X and X · 0 once, K5-loco walks every group's ablation
        from them (no ablated copy of X is made), and the family's own
        reduction turns the sums into predictions — the bits of
        `predict_arrays` on the materialized ablations."""
        consts = self.device_constants(X.device)
        trees = consts.tables
        Xb, Xz = consts(X), consts(X * 0.0)
        offsets, cols = loco_groups(masks)
        s = tree_walk_loco(
            Xb, Xz, trees["feat"], trees["bin"], trees["leaf"],
            torch.as_tensor(offsets, device=X.device),
            torch.as_tensor(cols, device=X.device), classes=self._classes)
        return self._from_sums(trees, s.reshape(-1, s.shape[-1]))


class ForestClassificationModel(_TreeModelBase):
    def _from_sums(self, trees, s):
        return forest_classification_sums(s, trees["feat"].shape[0])


class ForestRegressionModel(_TreeModelBase):
    def _from_sums(self, trees, s):
        return regression_pred(div_const(s, trees["feat"].shape[0])[:, 0])


class GBTClassificationModel(_TreeModelBase):
    def __init__(self, edges=None, trees=None, learning_rate: float = 0.1,
                 uid: Optional[str] = None):
        super().__init__(edges=edges, trees=trees, uid=uid)
        self.learning_rate = learning_rate

    def get_params(self):
        params = super().get_params()
        params["learning_rate"] = self.learning_rate
        return params

    _objective = "logistic"

    def _from_sums(self, trees, s):
        return gbt_pred_from_margin(_f32(self.learning_rate) * s[:, 0],
                                    self._objective)


class GBTRegressionModel(GBTClassificationModel):
    _objective = "squared"


class GBTMulticlassModel(GBTClassificationModel):
    """Softmax boosting: trees stacked (rounds, classes, ...), scored by
    K5-mc."""

    _classes = True

    def _walk(self, trees, Xb):
        return tree_walk_classes(Xb, trees["feat"], trees["bin"],
                                 trees["leaf"])

    def _from_sums(self, trees, s):
        return gbt_multiclass_pred_from_margin(
            _f32(self.learning_rate) * s)


# --------------------------------------------------------------------------- #
# estimators                                                                  #
# --------------------------------------------------------------------------- #

class _TreeEstimatorBase(PredictorEstimator):
    def _edges_binned(self, X: torch.Tensor, ctx
                      ) -> Tuple[np.ndarray, torch.Tensor]:
        edges = quantile_bin_edges(X.cpu().numpy(), self.max_bins)
        Xb = bin_features(X, torch.as_tensor(edges, device=X.device))
        return edges, Xb


class OpRandomForestClassifier(_TreeEstimatorBase):
    """Spark RandomForestClassifier parameter surface (the JAX package's
    `OpRandomForestClassifier`): `min_info_gain` is the normalized gain
    threshold and `min_instances_per_node` the child-weight bound, grid
    axes of the default sweep. k classes grow trees on k class channels.
    A warm start (`init_params` {"edges", "trees"} of a fitted forest)
    replaces the oldest trees with trees grown on the delta rows
    (`warm_refit_forest`)."""

    _bootstrap = True  # Poisson(1) row counts per tree; decision trees: no
    _warm_refit = True  # decision trees fit cold, as in the JAX package

    def __init__(self, n_trees: int = 20, max_depth: int = 5,
                 max_bins: int = DEFAULT_MAX_BINS,
                 min_child_weight: float = 1.0,
                 subsample_features: bool = True, min_info_gain: float = 0.0,
                 min_instances_per_node: float = 1.0,
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(uid=uid, n_trees=n_trees, max_depth=max_depth,
                         max_bins=max_bins, min_child_weight=min_child_weight,
                         subsample_features=subsample_features,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         n_classes=n_classes)
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_child_weight = min_child_weight
        self.subsample_features = subsample_features
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.n_classes = n_classes

    def _effective_mcw(self) -> float:
        return max(float(self.min_child_weight),
                   float(self.min_instances_per_node))

    def fit_arrays(self, X, y, w, ctx):
        k = self.n_classes or infer_n_classes(y.cpu().numpy())
        warm = self._warm_forest(X, y, w, ctx, k)
        if warm is not None:
            return ForestClassificationModel(*warm)
        Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
        return ForestClassificationModel(*self._fit_forest(X, Y, w, ctx))

    def _warm_forest(self, X, y, w, ctx, n_classes=None):
        """(edges, trees) of the warm refit when `init_params` holds a
        compatible resident forest, else None (a cold fit)."""
        warm = self.init_params
        if (not self._warm_refit or warm is None or "trees" not in warm
                or not warm_tree_compatible(warm, X, n_classes=n_classes,
                                            max_bins=self.max_bins)):
            return None
        return (np.asarray(warm["edges"], np.float32),
                warm_refit_forest(self, warm, X, y, w, ctx,
                                  classification=n_classes is not None))

    def _fit_forest(self, X, Y, w, ctx):
        edges, Xb = self._edges_binned(X, ctx)
        trees = fit_forest(Xb, Y, w, self.n_trees, self.max_depth,
                           self.max_bins, ctx.seed if ctx is not None else 0,
                           self.subsample_features, self._effective_mcw(),
                           bootstrap=self._bootstrap,
                           min_gain=self.min_info_gain)
        return edges, {k2: v[0].cpu().numpy() for k2, v in trees.items()}


class OpRandomForestRegressor(OpRandomForestClassifier):
    """Random forest regression (the JAX package's
    `OpRandomForestRegressor`): the label as the one value channel, so each
    leaf is the bootstrap-weighted mean label of its rows."""

    def fit_arrays(self, X, y, w, ctx):
        warm = self._warm_forest(X, y, w, ctx)
        if warm is not None:
            return ForestRegressionModel(*warm)
        return ForestRegressionModel(*self._fit_forest(X, y[:, None], w,
                                                       ctx))


class OpDecisionTreeClassifier(OpRandomForestClassifier):
    """One deterministic tree: no bootstrap, all features, λ = 1e-6 (the
    JAX package's `OpDecisionTreeClassifier`)."""

    _bootstrap = False
    _warm_refit = False

    def __init__(self, max_depth: int = 5, max_bins: int = DEFAULT_MAX_BINS,
                 min_child_weight: float = 1.0, min_info_gain: float = 0.0,
                 min_instances_per_node: float = 1.0,
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(n_trees=1, max_depth=max_depth, max_bins=max_bins,
                         min_child_weight=min_child_weight,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         subsample_features=False, n_classes=n_classes,
                         uid=uid)
        self.params = {"max_depth": max_depth, "max_bins": max_bins,
                       "min_child_weight": min_child_weight,
                       "min_info_gain": min_info_gain,
                       "min_instances_per_node": min_instances_per_node,
                       "n_classes": n_classes}


class OpDecisionTreeRegressor(OpRandomForestRegressor):
    """One deterministic regression tree (the JAX package's
    `OpDecisionTreeRegressor`)."""

    _bootstrap = False
    _warm_refit = False

    def __init__(self, max_depth: int = 5, max_bins: int = DEFAULT_MAX_BINS,
                 min_child_weight: float = 1.0, min_info_gain: float = 0.0,
                 min_instances_per_node: float = 1.0,
                 uid: Optional[str] = None):
        super().__init__(n_trees=1, max_depth=max_depth, max_bins=max_bins,
                         min_child_weight=min_child_weight,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         subsample_features=False, uid=uid)
        self.params = {"max_depth": max_depth, "max_bins": max_bins,
                       "min_child_weight": min_child_weight,
                       "min_info_gain": min_info_gain,
                       "min_instances_per_node": min_instances_per_node}


class OpGBTClassifier(_TreeEstimatorBase):
    """Gradient-boosted classifier, XGBoost-style second order (the JAX
    package's `OpGBTClassifier`): binary by the sigmoid margin, k > 2
    classes by softmax boosting (K trees per round, every round, no early
    stopping). A binary or regression warm start (`init_params` {"edges",
    "trees", "learning_rate"} of a fitted GBT) continues boosting from the
    resident margin (`warm_refit_gbt`); a multiclass one, one at twice
    n_estimators rounds or an incompatible one fits cold, as in the JAX
    package."""

    # the refit's early-stopping holdout: a seeded 20% of the rows
    _ES_EVAL_FRACTION = 0.2
    _objective = "logistic"
    _model_cls = GBTClassificationModel

    def __init__(self, n_estimators: int = 20, max_depth: int = 3,
                 learning_rate: float = 0.1, reg_lambda: float = 1.0,
                 max_bins: int = DEFAULT_MAX_BINS,
                 min_child_weight: float = 1.0, gamma: float = 0.0,
                 alpha: float = 0.0, subsample: float = 1.0,
                 colsample_bytree: float = 1.0,
                 early_stopping_rounds: int = 0, min_info_gain: float = 0.0,
                 min_instances_per_node: float = 1.0,
                 eval_metric: str = "logloss",
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(uid=uid, n_estimators=n_estimators,
                         max_depth=max_depth, learning_rate=learning_rate,
                         reg_lambda=reg_lambda, max_bins=max_bins,
                         min_child_weight=min_child_weight, gamma=gamma,
                         alpha=alpha, subsample=subsample,
                         colsample_bytree=colsample_bytree,
                         early_stopping_rounds=early_stopping_rounds,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         eval_metric=eval_metric, n_classes=n_classes)
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.max_bins = max_bins
        self.min_child_weight = min_child_weight
        self.gamma = gamma
        self.alpha = alpha
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.early_stopping_rounds = early_stopping_rounds
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.eval_metric = eval_metric
        self.n_classes = n_classes

    def _effective_mcw(self) -> float:
        return max(float(self.min_child_weight),
                   float(self.min_instances_per_node))

    def _fit(self, Xb, y, w, n_rounds, seed, val_w=None, esr=0,
             eval_metric="logloss"):
        trees, _, _ = fit_gbt_pairs(
            Xb, y, w[None, :], n_rounds, self.max_depth, self.max_bins,
            self.learning_rate, self.reg_lambda, self._effective_mcw(),
            gamma=self.gamma, alpha=self.alpha, subsample=self.subsample,
            colsample=self.colsample_bytree, seed=seed,
            val_w=None if val_w is None else val_w[None, :],
            early_stopping_rounds=esr, min_gain_norm=self.min_info_gain,
            eval_metric=eval_metric, keep_trees=True,
            objective=self._objective)
        return {k: v[0] for k, v in trees.items()}

    def fit_arrays(self, X, y, w, ctx):
        k = (self.n_classes or infer_n_classes(y.cpu().numpy())
             if self._objective == "logistic" else 2)
        warm = self.init_params
        if warm is not None and "trees" in warm:
            n_resident = int(np.asarray(warm["trees"]["feat"]).shape[0])
            if k > 2:
                log.info("GBT warm refit: the multiclass stacked-round "
                         "layout has no margin continuation; fitting cold")
            elif n_resident >= 2 * self.n_estimators:
                log.info("GBT warm refit: resident ensemble at the 2x "
                         "growth cap (%d rounds, n_estimators=%d); fitting "
                         "cold", n_resident, self.n_estimators)
            elif warm_tree_compatible(warm, X, max_bins=self.max_bins):
                trees = warm_refit_gbt(self, warm, X, y, w, ctx,
                                       self._objective)
                return self._model_cls(
                    np.asarray(warm["edges"], np.float32), trees,
                    float(warm.get("learning_rate", self.learning_rate)))
        edges, Xb = self._edges_binned(X, ctx)
        seed = ctx.seed if ctx is not None else 0
        if k > 2:  # softmax boosting: every round, no early stopping
            trees, _ = fit_gbt_multiclass_pairs(
                Xb, y, w[None, :], self.n_estimators, self.max_depth,
                self.max_bins, k, self.learning_rate, self.reg_lambda,
                self._effective_mcw(), gamma=self.gamma, alpha=self.alpha,
                subsample=self.subsample, colsample=self.colsample_bytree,
                seed=seed, min_gain_norm=self.min_info_gain,
                keep_trees=True)
            return GBTMulticlassModel(
                edges, {k2: v[0].cpu().numpy() for k2, v in trees.items()},
                self.learning_rate)
        esr = int(self.early_stopping_rounds or 0)
        n_rounds = self.n_estimators
        rounds: Dict[str, int] = {}
        if esr > 0:
            # pass 1: a seeded 20% holdout picks the round count; the
            # probe model is thrown away (the reference's refit trains on
            # all rows)
            rng = np.random.default_rng(seed)
            hold = torch.as_tensor(
                rng.uniform(size=Xb.shape[0]) < self._ES_EVAL_FRACTION,
                dtype=torch.float32, device=X.device)
            probe = self._fit(Xb, y, (1.0 - hold) * w, self.n_estimators,
                              seed, val_w=hold * w, esr=esr,
                              eval_metric=self.eval_metric)
            # stopped rounds grow zeroed trees: the stopping round is the
            # last live tree's index + 1
            leaf = probe["leaf"].cpu().numpy()
            live = np.any(leaf != 0, axis=tuple(range(1, leaf.ndim)))
            n_live = int(np.flatnonzero(live).max()) + 1 if live.any() else 1
            rpd = _default_rounds_per_dispatch(
                Xb.shape[0], Xb.shape[1], self.n_estimators, self.max_depth,
                self.max_bins)
            n_rounds = min(-(-n_live // rpd) * rpd, self.n_estimators)
            rounds["probe_live"] = n_live
        # pass 2 (or the only pass): the shipped model, all rows
        trees = self._fit(Xb, y, w, n_rounds, seed)
        rounds["shipped"] = n_rounds
        model = self._model_cls(
            edges, {k2: v.cpu().numpy() for k2, v in trees.items()},
            self.learning_rate)
        model.refit_rounds = rounds
        return model


class OpXGBoostClassifier(OpGBTClassifier):
    """XGBoost parameter surface (eta / gamma / alpha / lambda / subsample
    / colsample_bytree / min_child_weight), binary objective; early
    stopping evaluates the reference's maximized aucpr by default."""

    def __init__(self, n_estimators: int = 50, max_depth: int = 6,
                 eta: float = 0.3, reg_lambda: float = 1.0,
                 max_bins: int = DEFAULT_MAX_BINS,
                 min_child_weight: float = 1.0, gamma: float = 0.0,
                 alpha: float = 0.0, subsample: float = 1.0,
                 colsample_bytree: float = 1.0,
                 early_stopping_rounds: int = 0, min_info_gain: float = 0.0,
                 min_instances_per_node: float = 1.0,
                 eval_metric: str = "aupr",
                 n_classes: Optional[int] = None, uid: Optional[str] = None):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         learning_rate=eta, reg_lambda=reg_lambda,
                         max_bins=max_bins, min_child_weight=min_child_weight,
                         gamma=gamma, alpha=alpha, subsample=subsample,
                         colsample_bytree=colsample_bytree,
                         early_stopping_rounds=early_stopping_rounds,
                         min_info_gain=min_info_gain,
                         min_instances_per_node=min_instances_per_node,
                         eval_metric=eval_metric, n_classes=n_classes,
                         uid=uid)
        self.params["eta"] = eta
        self.params.pop("learning_rate", None)


class OpGBTRegressor(OpGBTClassifier):
    """Spark-style GBT regression: the squared objective from a zero
    margin (the JAX package's `OpGBTRegressor`)."""

    _objective = "squared"
    _model_cls = GBTRegressionModel


class OpXGBoostRegressor(OpXGBoostClassifier):
    """The XGBoost parameter surface with the squared objective (the JAX
    package's `OpXGBoostRegressor`)."""

    _objective = "squared"
    _model_cls = GBTRegressionModel
