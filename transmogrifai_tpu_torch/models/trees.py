"""Tree ensembles: binning (K4), the ensemble walk (K5), and the fit side
of gradient boosting: histograms (K1), split search (K2), routing and leaf
values (K3), the boosting rounds and the GBT/XGBoost estimators.

The port's counterpart of the JAX package's `models/trees.py`. A fitted
ensemble is dense tables: per-feature bin edges (d, n_edges) f32, split
features and split bins (n_trees, depth, width) int32, and leaf values
(n_trees, n_leaves, m) f32. Scoring bins the feature matrix once, then
walks every tree level by level. Fitting grows trees level-wise: per
level, gradient/hessian histograms of every node, the best split of every
node, then every row moves one level down.

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

import ctypes
import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch.evaluators.device_metrics import (
    binned_aupr, sigmoid)
from transmogrifai_tpu_torch.models.base import (
    PredictionModel, PredictorEstimator, infer_n_classes)

log = logging.getLogger(__name__)

DEFAULT_MAX_BINS = 32

# --------------------------------------------------------------------------- #
# launch counters (shared by every kernel of the port)                        #
# --------------------------------------------------------------------------- #

LAUNCHES = cuda_build.LAUNCHES
reset_launches = cuda_build.reset_launches
_count = cuda_build.count


def _stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


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
    compare; NaN compares false, so NaN → bin 0)."""
    b = (X[:, :, None] >= edges[None, :, :]).sum(-1, dtype=torch.int32)
    return b.to(bin_dtype(edges.shape[-1]))


_BIN_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_BIN_MAX_EDGES = 384  # FEAT_TILE * n_edges * 4 B within 48 KB of shared memory


def _bin_features_cuda(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    _require(edges.device == X.device,
             f"bin_features: X on {X.device}, edges on {edges.device}")
    _require(X.dtype == torch.float32 and edges.dtype == torch.float32,
             f"bin_features: needs f32 inputs, got {X.dtype}/{edges.dtype}")
    _require(X.dim() == 2 and edges.dim() == 2
             and edges.shape[0] == X.shape[1],
             f"bin_features: shapes {tuple(X.shape)} / {tuple(edges.shape)}")
    n, d = X.shape
    n_edges = edges.shape[1]
    _require(n_edges <= _BIN_MAX_EDGES,
             f"bin_features: {n_edges} edges exceed the kernel's "
             f"{_BIN_MAX_EDGES}")
    X = X.contiguous()
    edges = edges.contiguous()
    dtype = bin_dtype(n_edges)
    out = torch.empty((n, d), dtype=dtype, device=X.device)
    if n == 0 or d == 0:
        return out
    lib = cuda_build.load("bin_features")
    fname = "bin_features_i8" if dtype == torch.int8 else "bin_features_i32"
    fn = cuda_build.declare(lib, fname, _BIN_ARGS)
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), edges.data_ptr(), out.data_ptr(), n, d,
                 n_edges, _stream_ptr(X))
    cuda_build.check(fname, err)
    _count("bin_features")
    return out


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, d) int8 bin ids in [0, n_edges] (int32 above 126 edges):
    `Xb[r, f] = #{e : X[r, f] >= edges[f, e]}`, NaN → 0. A CUDA tensor
    launches the K4 kernel (or raises); a CPU tensor takes the plain
    version."""
    _check_device(X, "bin_features")
    if X.is_cuda:
        return _bin_features_cuda(X, edges)
    return bin_features_plain(X, edges)


# --------------------------------------------------------------------------- #
# K5: the ensemble walk                                                       #
# --------------------------------------------------------------------------- #

def _walk_shapes(Xb, feat, bins, leaf):
    _require(Xb.dim() == 2, f"tree_walk: Xb must be (n, d), got "
                            f"{tuple(Xb.shape)}")
    _require(feat.dim() == 3 and feat.shape == bins.shape,
             f"tree_walk: feat {tuple(feat.shape)} / bin "
             f"{tuple(bins.shape)} must be equal (n_trees, depth, width)")
    _require(leaf.dim() == 3 and leaf.shape[0] == feat.shape[0],
             f"tree_walk: leaf {tuple(leaf.shape)} must be (n_trees, "
             f"n_leaves, m)")
    n_trees, depth, width = feat.shape
    _require(depth == 0 or 2 ** (depth - 1) <= width,
             f"tree_walk: width {width} < 2^(depth-1) at depth {depth}")
    _require(2 ** depth <= leaf.shape[1],
             f"tree_walk: {leaf.shape[1]} leaves < 2^depth at depth {depth}")
    return n_trees, depth, width


def tree_walk_plain(Xb: torch.Tensor, feat: torch.Tensor, bins: torch.Tensor,
                    leaf: torch.Tensor) -> torch.Tensor:
    """(n, m) f32 sum over trees of each row's leaf values. All trees walk
    together, one level at a time, with `torch.gather`; the leaf values
    are then summed in tree order."""
    n_trees, depth, _ = _walk_shapes(Xb, feat, bins, leaf)
    n, m = Xb.shape[0], leaf.shape[-1]
    node = torch.zeros((n_trees, n), dtype=torch.long, device=Xb.device)
    rows = torch.arange(n, device=Xb.device)[None, :]
    for level in range(depth):
        f = torch.gather(feat[:, level, :].long(), 1, node)
        b = torch.gather(bins[:, level, :].long(), 1, node)
        node = node * 2 + (Xb[rows, f].long() > b).long()
    vals = torch.gather(leaf, 1, node[:, :, None].expand(n_trees, n, m))
    acc = torch.zeros((n, m), dtype=torch.float32, device=Xb.device)
    for t in range(n_trees):
        acc = acc + vals[t]
    return acc


_WALK_ARGS = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int64,) + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _tree_walk_cuda(Xb, feat, bins, leaf) -> torch.Tensor:
    for name, t in (("feat", feat), ("bin", bins), ("leaf", leaf)):
        _require(t.device == Xb.device,
                 f"tree_walk: Xb on {Xb.device}, {name} on {t.device}")
    _require(Xb.dtype in (torch.int8, torch.int32),
             f"tree_walk: Xb must be int8 or int32, got {Xb.dtype}")
    _require(feat.dtype == torch.int32 and bins.dtype == torch.int32,
             f"tree_walk: feat/bin must be int32, got {feat.dtype}/"
             f"{bins.dtype}")
    _require(leaf.dtype == torch.float32,
             f"tree_walk: leaf must be f32, got {leaf.dtype}")
    n_trees, depth, width = _walk_shapes(Xb, feat, bins, leaf)
    n, d = Xb.shape
    n_leaves, m = leaf.shape[1], leaf.shape[2]
    Xb, feat, bins, leaf = (t.contiguous() for t in (Xb, feat, bins, leaf))
    if n == 0 or m == 0 or n_trees == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=Xb.device)
    out = torch.empty((n, m), dtype=torch.float32, device=Xb.device)
    lib = cuda_build.load("tree_walk")
    max_m = cuda_build.declare(lib, "tree_walk_max_m", ())()
    fname = "tree_walk_i8" if Xb.dtype == torch.int8 else "tree_walk_i32"
    fn = cuda_build.declare(lib, fname, _WALK_ARGS)
    with torch.cuda.device(Xb.device):
        stream = _stream_ptr(Xb)
        for c0 in range(0, m, max_m):
            err = fn(Xb.data_ptr(), feat.data_ptr(), bins.data_ptr(),
                     leaf.data_ptr(), out.data_ptr(), n, d, n_trees, depth,
                     width, n_leaves, m, c0, min(max_m, m - c0), stream)
            cuda_build.check(fname, err)
            _count("tree_walk")
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
    """`(order, seg)` for (P, n) node ids in [0, n_nodes): order[p] lists
    the rows grouped by node in stable row order, and node k's rows are
    order[p, seg[p, k]:seg[p, k + 1]]. int32 both."""
    P, n = node_idx.shape
    order = torch.argsort(node_idx, dim=1, stable=True).to(torch.int32)
    flat = (node_idx.long() + torch.arange(
        P, device=node_idx.device)[:, None] * n_nodes).reshape(-1)
    counts = torch.bincount(flat, minlength=P * n_nodes).reshape(P, n_nodes)
    seg = torch.zeros((P, n_nodes + 1), dtype=torch.int64,
                      device=node_idx.device)
    seg[:, 1:] = torch.cumsum(counts, dim=1)
    return order.contiguous(), seg.to(torch.int32).contiguous()


def _fit_shapes(name, Xb, node_idx, G, H):
    _require(Xb.dim() == 2, f"{name}: Xb must be (n, d), got "
                            f"{tuple(Xb.shape)}")
    _require(node_idx.dim() == 2 and node_idx.shape[1] == Xb.shape[0]
             and G.shape == node_idx.shape and H.shape == node_idx.shape,
             f"{name}: node_idx {tuple(node_idx.shape)}, G "
             f"{tuple(G.shape)}, H {tuple(H.shape)} must all be (P, n) "
             f"with n = {Xb.shape[0]}")


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
    """(P, n_nodes, d, n_bins) f32 gradient and hessian histograms:
    hist[p, k, f, b] = Σ_r [node[p, r] = k]·[Xb[r, f] = b]·G[p, r], one
    `index_add_` per histogram."""
    _fit_shapes("histograms", Xb, node_idx, G, H)
    P, n = node_idx.shape
    d = Xb.shape[1]
    dev = Xb.device
    cell = ((node_idx.long()
             + torch.arange(P, device=dev)[:, None] * n_nodes)[:, :, None]
            * d + torch.arange(d, device=dev)[None, None, :]) * n_bins \
        + Xb.long()[None, :, :]
    cell = cell.reshape(-1)
    size = P * n_nodes * d * n_bins
    out = []
    for v in (G, H):
        src = v.to(torch.float32)[:, :, None].expand(P, n, d).reshape(-1)
        out.append(torch.zeros(size, dtype=torch.float32, device=dev)
                   .index_add_(0, cell, src)
                   .reshape(P, n_nodes, d, n_bins))
    return out[0], out[1]


_HIST_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_SMEM_BYTES = 48 * 1024


def _hist_lanes(n_bins: int) -> int:
    """Row-lanes per K1 block: as many as fit their private histograms in
    48 KB of shared memory, at most 4."""
    per_lane = 2 * n_bins * 33 * 4
    lanes = min(4, _SMEM_BYTES // per_lane)
    _require(lanes >= 1, f"histograms: {n_bins} bins exceed the kernel's "
                         f"shared memory ({_SMEM_BYTES // (2 * 33 * 4)} bins)")
    return lanes


def _histograms_cuda(Xb, node_idx, G, H, n_nodes, n_bins):
    _fit_shapes("histograms", Xb, node_idx, G, H)
    _on_device("histograms", Xb, node_idx=node_idx, G=G, H=H)
    _require(Xb.dtype in (torch.int8, torch.int32),
             f"histograms: Xb must be int8 or int32, got {Xb.dtype}")
    _require(G.dtype == torch.float32 and H.dtype == torch.float32,
             f"histograms: G/H must be f32, got {G.dtype}/{H.dtype}")
    P, n = node_idx.shape
    d = Xb.shape[1]
    lanes = _hist_lanes(n_bins)
    hg = torch.empty((P, n_nodes, d, n_bins), dtype=torch.float32,
                     device=Xb.device)
    hh = torch.empty_like(hg)
    if hg.numel() == 0:
        return hg, hh
    order, seg = node_segments(node_idx, n_nodes)
    Xb, G, H = Xb.contiguous(), G.contiguous(), H.contiguous()
    lib = cuda_build.load("histograms")
    fname = "histograms_i8" if Xb.dtype == torch.int8 else "histograms_i32"
    fn = cuda_build.declare(lib, fname, _HIST_ARGS)
    with torch.cuda.device(Xb.device):
        err = fn(Xb.data_ptr(), G.data_ptr(), H.data_ptr(), order.data_ptr(),
                 seg.data_ptr(), hg.data_ptr(), hh.data_ptr(), P, n, d,
                 n_nodes, n_bins, lanes, _stream_ptr(Xb))
    cuda_build.check(fname, err)
    _count("histograms")
    return hg, hh


def histograms(Xb: torch.Tensor, node_idx: torch.Tensor, G: torch.Tensor,
               H: torch.Tensor, n_nodes: int, n_bins: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, n_nodes, d, n_bins) f32 histograms of G and H per (pair, node,
    feature, bin) for binned Xb (n, d) with bin ids in [0, n_bins), node
    ids (P, n) in [0, n_nodes) and values G, H (P, n) (the kernel drops a
    bin id outside that range; the plain version raises). A CUDA tensor
    launches the K1 kernel (or raises); a CPU tensor takes the plain
    version."""
    _check_device(Xb, "histograms")
    if Xb.is_cuda:
        return _histograms_cuda(Xb, node_idx, G, H, n_nodes, n_bins)
    return histograms_plain(Xb, node_idx, G, H, n_nodes, n_bins)


# --------------------------------------------------------------------------- #
# K2: split search                                                            #
# --------------------------------------------------------------------------- #

Param = Union[float, int, Sequence[float], torch.Tensor]


def per_pair(v: Param, P: int, device, dtype=torch.float32) -> torch.Tensor:
    """A hyperparameter as a (P,) tensor: one value for every pair, or one
    per pair."""
    t = torch.as_tensor(v, dtype=dtype, device=device)
    if t.dim() == 0:
        t = t.expand(P)
    _require(t.shape == (P,), f"per-pair parameter of shape "
                              f"{tuple(t.shape)}, expected ({P},)")
    return t.contiguous()


def _running_sum(h: torch.Tensor) -> torch.Tensor:
    """Sequential f32 running sum over the last axis (bin by bin, as the
    K2 kernel adds)."""
    out = torch.empty_like(h)
    acc = torch.zeros_like(h[..., 0])
    for b in range(h.shape[-1]):
        acc = acc + h[..., b]
        out[..., b] = acc
    return out


def split_search_plain(hg, hh, n_bins: int, reg_lambda: Param,
                       min_child_weight: Param, min_gain: Param,
                       min_gain_norm: Param,
                       feature_mask: Optional[torch.Tensor], level: int,
                       active_depth: Optional[Param]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, n_nodes) int32 split feature and split bin per node (bin =
    n_bins where the node does not split) from (P, n_nodes, d, n_bins)
    histograms; the arithmetic of the K2 kernel, step for step."""
    P, n_nodes, d, _ = hh.shape
    dev = hh.device
    lam = per_pair(reg_lambda, P, dev)[:, None, None, None]
    mcw = per_pair(min_child_weight, P, dev)[:, None, None, None]
    cg = _running_sum(hg)
    ch = _running_sum(hh)
    tg = cg[..., -1:]
    th = ch[..., -1:]
    rg = tg - cg
    rh = th - ch
    gain = ((cg * cg) / (ch + lam) + (rg * rg) / (rh + lam)) \
        - (tg * tg) / (th + lam)
    valid = (ch >= mcw) & (rh >= mcw)
    if feature_mask is not None:
        valid = valid & feature_mask.to(torch.bool)[:, None, :, None]
    gain = torch.where(valid, gain, torch.full_like(gain, -float("inf")))
    flat = gain.reshape(P, n_nodes, d * n_bins)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    bf = (best // n_bins).to(torch.int32)
    bb = (best % n_bins).to(torch.int32)
    thr = torch.maximum(per_pair(min_gain, P, dev)[:, None],
                        per_pair(min_gain_norm, P, dev)[:, None]
                        * th[:, :, 0, 0])
    splits = best_gain > thr
    if active_depth is not None:
        splits = splits & (level < per_pair(active_depth, P, dev,
                                            torch.int32))[:, None]
    bb = torch.where(splits, bb, torch.full_like(bb, n_bins))
    return bf, bb


_SPLIT_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,) * 3


def _split_search_cuda(hg, hh, n_bins, reg_lambda, min_child_weight,
                       min_gain, min_gain_norm, feature_mask, level,
                       active_depth):
    _require(hg.dim() == 4 and hg.shape == hh.shape
             and hg.shape[-1] == n_bins,
             f"split_search: hist shapes {tuple(hg.shape)} / "
             f"{tuple(hh.shape)} must be equal (P, nodes, d, {n_bins})")
    _require(hg.dtype == torch.float32 and hh.dtype == torch.float32,
             "split_search: histograms must be f32")
    _on_device("split_search", hg, hh=hh, feature_mask=feature_mask)
    P, n_nodes, d, _ = hh.shape
    dev = hh.device
    lam = per_pair(reg_lambda, P, dev)
    mcw = per_pair(min_child_weight, P, dev)
    mg = per_pair(min_gain, P, dev)
    mgn = per_pair(min_gain_norm, P, dev)
    fm = None
    if feature_mask is not None:
        _require(feature_mask.shape == (P, d),
                 f"split_search: feature_mask {tuple(feature_mask.shape)} "
                 f"must be ({P}, {d})")
        fm = feature_mask.to(torch.uint8).contiguous()
    ad = (per_pair(active_depth, P, dev, torch.int32)
          if active_depth is not None else None)
    feat = torch.empty((P, n_nodes), dtype=torch.int32, device=dev)
    bins = torch.empty_like(feat)
    if feat.numel() == 0:
        return feat, bins
    hg, hh = hg.contiguous(), hh.contiguous()
    lib = cuda_build.load("split_search")
    fn = cuda_build.declare(lib, "split_search", _SPLIT_ARGS)
    with torch.cuda.device(dev):
        err = fn(hg.data_ptr(), hh.data_ptr(), lam.data_ptr(),
                 mcw.data_ptr(), mg.data_ptr(), mgn.data_ptr(),
                 fm.data_ptr() if fm is not None else None,
                 ad.data_ptr() if ad is not None else None,
                 P, level, n_nodes, d, n_bins, feat.data_ptr(),
                 bins.data_ptr(), _stream_ptr(hg))
    cuda_build.check("split_search", err)
    _count("split_search")
    return feat, bins


def split_search(hg: torch.Tensor, hh: torch.Tensor, n_bins: int,
                 reg_lambda: Param, min_child_weight: Param,
                 min_gain: Param, min_gain_norm: Param,
                 feature_mask: Optional[torch.Tensor], level: int,
                 active_depth: Optional[Param]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (feature, bin) per node of each pair: XGBoost gain over the
    left running sums, `min_child_weight` validity and the feature mask
    (P, d) as -inf, the first index winning ties over the flat d·bins
    axis, and bin = n_bins where the best gain is not above max(min_gain,
    min_gain_norm · the node's weight) or level >= active_depth. Each
    hyperparameter is one value or one per pair. A CUDA tensor launches
    the K2 kernel (or raises); a CPU tensor takes the plain version."""
    _check_device(hg, "split_search")
    if hg.is_cuda:
        return _split_search_cuda(hg, hh, n_bins, reg_lambda,
                                  min_child_weight, min_gain, min_gain_norm,
                                  feature_mask, level, active_depth)
    return split_search_plain(hg, hh, n_bins, reg_lambda, min_child_weight,
                              min_gain, min_gain_norm, feature_mask, level,
                              active_depth)


# --------------------------------------------------------------------------- #
# K3: routing and leaf values                                                 #
# --------------------------------------------------------------------------- #

def route_level_plain(Xb: torch.Tensor, node_idx: torch.Tensor,
                      feat: torch.Tensor, bins: torch.Tensor
                      ) -> torch.Tensor:
    """(P, n) int32 node ids one level down: 2·node + (Xb[r, feat[p,
    node]] > bin[p, node])."""
    node = node_idx.long()
    f = torch.gather(feat.long(), 1, node)
    b = torch.gather(bins.long(), 1, node)
    rows = torch.arange(Xb.shape[0], device=Xb.device)[None, :]
    x = Xb[rows, f].long()
    return (node * 2 + (x > b).long()).to(torch.int32)


_ROUTE_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,)


def _route_level_cuda(Xb, node_idx, feat, bins):
    _on_device("route_level", Xb, node_idx=node_idx, feat=feat, bins=bins)
    _require(Xb.dtype in (torch.int8, torch.int32),
             f"route_level: Xb must be int8 or int32, got {Xb.dtype}")
    _require(feat.dtype == torch.int32 and bins.dtype == torch.int32
             and node_idx.dtype == torch.int32,
             "route_level: node_idx, feat and bin must be int32")
    _require(node_idx.dim() == 2 and node_idx.shape[1] == Xb.shape[0]
             and feat.shape == bins.shape and feat.dim() == 2
             and feat.shape[0] == node_idx.shape[0],
             f"route_level: node_idx {tuple(node_idx.shape)}, feat "
             f"{tuple(feat.shape)}, bin {tuple(bins.shape)}")
    P, n = node_idx.shape
    out = node_idx.clone().contiguous()
    if out.numel() == 0:
        return out
    Xb, feat, bins = Xb.contiguous(), feat.contiguous(), bins.contiguous()
    lib = cuda_build.load("route_leaves")
    fname = "route_level_i8" if Xb.dtype == torch.int8 else "route_level_i32"
    fn = cuda_build.declare(lib, fname, _ROUTE_ARGS)
    with torch.cuda.device(Xb.device):
        err = fn(Xb.data_ptr(), feat.data_ptr(), bins.data_ptr(),
                 out.data_ptr(), P, n, Xb.shape[1], feat.shape[1],
                 _stream_ptr(Xb))
    cuda_build.check(fname, err)
    _count("route_level")
    return out


def route_level(Xb: torch.Tensor, node_idx: torch.Tensor, feat: torch.Tensor,
                bins: torch.Tensor) -> torch.Tensor:
    """(P, n) int32 node ids after one level of routing with this level's
    (P, n_nodes) split tables. A CUDA tensor launches the K3 routing
    kernel (or raises); a CPU tensor takes the plain version."""
    _check_device(Xb, "route_level")
    if Xb.is_cuda:
        return _route_level_cuda(Xb, node_idx, feat, bins)
    return route_level_plain(Xb, node_idx, feat, bins)


def _leaf_formula(g, h, reg_lambda, alpha):
    P = g.shape[0]
    lam = per_pair(reg_lambda, P, g.device)[:, None]
    a = per_pair(alpha, P, g.device)[:, None]
    g = torch.sign(g) * torch.clamp(torch.abs(g) - a, min=0.0)
    return g / (h + lam)


def leaf_values_plain(node_idx: torch.Tensor, G: torch.Tensor,
                      H: torch.Tensor, n_leaves: int, reg_lambda: Param,
                      alpha: Param) -> torch.Tensor:
    """(P, n_leaves) f32 leaf values: per-leaf Σ G and Σ H (`index_add_`),
    the L1 soft threshold and G / (H + λ)."""
    P, n = node_idx.shape
    flat = (node_idx.long() + torch.arange(
        P, device=G.device)[:, None] * n_leaves).reshape(-1)
    sums = []
    for v in (G, H):
        sums.append(torch.zeros(P * n_leaves, dtype=torch.float32,
                                device=G.device)
                    .index_add_(0, flat, v.to(torch.float32).reshape(-1))
                    .reshape(P, n_leaves))
    return _leaf_formula(sums[0], sums[1], reg_lambda, alpha)


_LEAF_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)


def _leaf_values_cuda(node_idx, G, H, n_leaves, reg_lambda, alpha):
    _on_device("leaf_values", node_idx, G=G, H=H)
    _require(G.dtype == torch.float32 and H.dtype == torch.float32,
             "leaf_values: G/H must be f32")
    _require(G.shape == node_idx.shape and H.shape == node_idx.shape,
             f"leaf_values: node_idx {tuple(node_idx.shape)}, G "
             f"{tuple(G.shape)}, H {tuple(H.shape)} must be equal (P, n)")
    P, n = node_idx.shape
    dev = G.device
    lam = per_pair(reg_lambda, P, dev)
    a = per_pair(alpha, P, dev)
    leaf = torch.empty((P, n_leaves), dtype=torch.float32, device=dev)
    if leaf.numel() == 0:
        return leaf
    order, seg = node_segments(node_idx, n_leaves)
    G, H = G.contiguous(), H.contiguous()
    lib = cuda_build.load("route_leaves")
    fn = cuda_build.declare(lib, "leaf_values", _LEAF_ARGS)
    with torch.cuda.device(dev):
        err = fn(G.data_ptr(), H.data_ptr(), order.data_ptr(),
                 seg.data_ptr(), lam.data_ptr(), a.data_ptr(),
                 leaf.data_ptr(), P, n, n_leaves, _stream_ptr(G))
    cuda_build.check("leaf_values", err)
    _count("leaf_values")
    return leaf


def leaf_values(node_idx: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
                n_leaves: int, reg_lambda: Param, alpha: Param
                ) -> torch.Tensor:
    """(P, n_leaves) f32 XGBoost leaf values from final node ids (P, n):
    g = Σ G, h = Σ H per leaf, g ← sign(g)·max(|g| − α, 0), leaf = g /
    (h + λ). A CUDA tensor launches the K3 leaf kernel (or raises); a CPU
    tensor takes the plain version."""
    _check_device(G, "leaf_values")
    if G.is_cuda:
        return _leaf_values_cuda(node_idx, G, H, n_leaves, reg_lambda, alpha)
    return leaf_values_plain(node_idx, G, H, n_leaves, reg_lambda, alpha)


# --------------------------------------------------------------------------- #
# the level-wise learner                                                      #
# --------------------------------------------------------------------------- #

_SUBTRACT_MIN_DEPTH = 12


def grow_trees(Xb: torch.Tensor, G: torch.Tensor, H: torch.Tensor,
               max_depth: int, n_bins: int, reg_lambda: Param = 1.0,
               min_child_weight: Param = 1.0, min_gain: Param = 0.0,
               feature_mask: Optional[torch.Tensor] = None,
               active_depth: Optional[Param] = None, alpha: Param = 0.0,
               min_gain_norm: Param = 0.0
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Grow one fixed-depth tree per pair from values G and weights H
    (P, n) (the JAX package's `grow_tree` with m = 1 and direct
    histograms at every level). Returns ({"feat": (P, depth, 2^depth)
    int32, "bin": (P, depth, 2^depth) int32 (n_bins = no split), "leaf":
    (P, 2^depth, 1) f32}, final node ids (P, n) int32)."""
    if max_depth >= _SUBTRACT_MIN_DEPTH:
        raise NotImplementedError(
            f"max_depth {max_depth}: histogram subtraction at depth >= "
            f"{_SUBTRACT_MIN_DEPTH} is not ported yet (ROADMAP.md, "
            "training slice, queued)")
    P, n = G.shape
    dev = Xb.device
    max_nodes = 2 ** max_depth
    node = torch.zeros((P, n), dtype=torch.int32, device=dev)
    feats = torch.zeros((P, max_depth, max_nodes), dtype=torch.int32,
                        device=dev)
    bins = torch.full((P, max_depth, max_nodes), n_bins, dtype=torch.int32,
                      device=dev)
    for level in range(max_depth):
        n_nodes = 2 ** level
        hg, hh = histograms(Xb, node, G, H, n_nodes, n_bins)
        bf, bb = split_search(hg, hh, n_bins, reg_lambda, min_child_weight,
                              min_gain, min_gain_norm, feature_mask, level,
                              active_depth)
        del hg, hh
        feats[:, level, :n_nodes] = bf
        bins[:, level, :n_nodes] = bb
        node = route_level(Xb, node, bf, bb)
    leaf = leaf_values(node, G, H, max_nodes, reg_lambda, alpha)
    return {"feat": feats, "bin": bins, "leaf": leaf[:, :, None]}, node


# --------------------------------------------------------------------------- #
# Gradient boosting (XGBoost-style second order), P fits at once              #
# --------------------------------------------------------------------------- #

def gbt_val_loss(margin: torch.Tensor, y: torch.Tensor, val_w: torch.Tensor,
                 eval_metric: str = "logloss") -> torch.Tensor:
    """(P,) per-round early-stopping metric of binary margins on the
    held-out rows, MINIMIZED: the negated binned AuPR over 512 sigmoid
    buckets (K8) for "aupr", else the weighted logloss."""
    if eval_metric == "aupr":
        return -binned_aupr(margin, y, val_w, 512, from_margin=True)
    vs = torch.clamp(val_w.sum(1), min=1.0)
    ll = torch.nn.functional.softplus(margin) - y * margin
    return (ll * val_w).sum(1) / vs


def fit_gbt_pairs(Xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  n_rounds: int, max_depth: int, n_bins: int,
                  learning_rate: Param, reg_lambda: Param,
                  min_child_weight: Param = 1.0,
                  active_depth: Optional[Param] = None, gamma: Param = 0.0,
                  alpha: Param = 0.0, subsample: Param = 1.0,
                  colsample: Param = 1.0, seed: int = 0,
                  val_w: Optional[torch.Tensor] = None,
                  early_stopping_rounds: int = 0, min_gain_norm: Param = 0.0,
                  eval_metric: str = "logloss", keep_trees: bool = False):
    """Boost P binary GBT fits at once over one binned matrix Xb
    (n, d): labels y (n,), row weights w (P, n) and, for early stopping,
    held-out weights val_w (P, n). Every hyperparameter is one value or
    one per pair. Returns (trees, margin (P, n), since (P,)); `trees` is
    {"feat", "bin": (P, rounds, depth, 2^depth) int32, "leaf": (P, rounds,
    2^depth, 1) f32} with `keep_trees`, else None.

    The JAX package's `_gbt_scan`: per round, gradients g = (p − y)·w and
    hessians max(p(1 − p), 1e-6)·w of the sigmoid margin, one tree per
    pair on (−g, h), margin += lr · leaf[node]. With early stopping, a
    round that starts with since >= early_stopping_rounds grows a zeroed
    tree (the margin freezes), and the loop ends once every pair has
    stopped: the rounds left would add only zeroed trees.

    Row and feature sampling (rates below 1) draw from a `torch.Generator`
    seeded with `seed`, not from the JAX package's threefry stream, so such
    fits match the JAX package at the metric level only."""
    P, n = w.shape
    dev = Xb.device
    d = Xb.shape[1]
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
    margin = torch.zeros((P, n), dtype=torch.float32, device=dev)
    best = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((P,), dtype=torch.int32, device=dev)
    kept: List[Dict[str, torch.Tensor]] = []
    for _ in range(n_rounds):
        p = sigmoid(margin)
        G = -((p - y) * w)
        H = torch.clamp(p * (1 - p), min=1e-6) * w
        fmask = None
        if gen is not None:
            rows = (torch.rand((P, n), generator=gen, device=dev)
                    < sub[:, None]).to(torch.float32)
            G, H = G * rows, H * rows
            fmask = torch.rand((P, d), generator=gen, device=dev) \
                < col[:, None]
        tree, node = grow_trees(
            Xb, G, H, max_depth, n_bins, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight, min_gain=gamma,
            feature_mask=fmask, active_depth=active_depth, alpha=alpha,
            min_gain_norm=min_gain_norm)
        if esr > 0:
            live = (since < esr).to(torch.float32)
            tree["leaf"] = tree["leaf"] * live[:, None, None]
        margin = margin + lr * torch.gather(tree["leaf"][:, :, 0], 1,
                                            node.long())
        if keep_trees:
            kept.append(tree)
        if esr > 0:
            m = gbt_val_loss(margin, y, val_w, eval_metric)
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
    return trees, margin, since


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

def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def predict_gbt_margin(trees: Dict[str, torch.Tensor], Xb: torch.Tensor,
                       learning_rate: float) -> torch.Tensor:
    """(n,) boosting margin: learning_rate · Σ_t leaf."""
    s = tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"])[:, 0]
    return _f32(learning_rate, s) * s


def predict_forest(trees: Dict[str, torch.Tensor],
                   Xb: torch.Tensor) -> torch.Tensor:
    """(n, m) mean per-tree prediction."""
    s = tree_walk(Xb, trees["feat"], trees["bin"], trees["leaf"])
    return s / _f32(float(trees["feat"].shape[0]), s)


def gbt_pred_from_margin(margin: torch.Tensor,
                         objective: str) -> Dict[str, torch.Tensor]:
    if objective == "logistic":
        p1 = torch.sigmoid(margin)
        return {"prediction": (margin > 0).to(torch.float32),
                "rawPrediction": torch.stack([-margin, margin], 1),
                "probability": torch.stack([1 - p1, p1], dim=1)}
    return {"prediction": margin, "rawPrediction": margin[:, None],
            "probability": margin.new_zeros((margin.shape[0], 0))}


def forest_classification_pred(trees: Dict[str, torch.Tensor],
                               Xb: torch.Tensor) -> Dict[str, torch.Tensor]:
    probs = predict_forest(trees, Xb)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    return {"prediction": torch.argmax(probs, -1).to(torch.float32),
            "rawPrediction": probs, "probability": probs}


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
        for level in range(feat.shape[1]):
            used = feat[:, level, :2 ** level]
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

    def predict(self, consts: TreeEnsemble, X):
        return self._apply_tables(consts.tables, consts(X))

    def _apply_tables(self, trees, Xb):
        raise NotImplementedError(type(self).__name__)


class ForestClassificationModel(_TreeModelBase):
    def _apply_tables(self, trees, Xb):
        return forest_classification_pred(trees, Xb)


class GBTClassificationModel(_TreeModelBase):
    def __init__(self, edges=None, trees=None, learning_rate: float = 0.1,
                 uid: Optional[str] = None):
        super().__init__(edges=edges, trees=trees, uid=uid)
        self.learning_rate = learning_rate

    def get_params(self):
        params = super().get_params()
        params["learning_rate"] = self.learning_rate
        return params

    def _apply_tables(self, trees, Xb):
        margin = predict_gbt_margin(trees, Xb, self.learning_rate)
        return gbt_pred_from_margin(margin, "logistic")


# --------------------------------------------------------------------------- #
# estimators                                                                  #
# --------------------------------------------------------------------------- #

class _TreeEstimatorBase(PredictorEstimator):
    def _edges_binned(self, X: torch.Tensor, ctx
                      ) -> Tuple[np.ndarray, torch.Tensor]:
        edges = quantile_bin_edges(X.cpu().numpy(), self.max_bins)
        Xb = bin_features(X, torch.as_tensor(edges, device=X.device))
        return edges, Xb


class OpGBTClassifier(_TreeEstimatorBase):
    """Gradient-boosted binary classifier, XGBoost-style second order
    (the JAX package's `OpGBTClassifier`; multiclass boosting and warm
    starts are not ported yet)."""

    # the refit's early-stopping holdout: a seeded 20% of the rows
    _ES_EVAL_FRACTION = 0.2

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
            eval_metric=eval_metric, keep_trees=True)
        return {k: v[0] for k, v in trees.items()}

    def fit_arrays(self, X, y, w, ctx):
        k = self.n_classes or infer_n_classes(y.cpu().numpy())
        if k > 2:
            raise NotImplementedError(
                "multiclass GBT boosting is not ported yet (ROADMAP.md, "
                "queue 1, item 9)")
        if self.init_params is not None:
            raise NotImplementedError(
                "GBT warm starts are not ported yet (ROADMAP.md, queue 1)")
        edges, Xb = self._edges_binned(X, ctx)
        seed = ctx.seed if ctx is not None else 0
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
        model = GBTClassificationModel(
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
