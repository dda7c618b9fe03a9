"""Tree-ensemble scoring: feature binning (K4) and the ensemble walk (K5).

The port's counterpart of the predict side of the JAX package's
`models/trees.py`. A fitted ensemble is dense tables: per-feature bin
edges (d, n_edges) f32, split features and split bins (n_trees, depth,
width) int32, and leaf values (n_trees, n_leaves, m) f32. Scoring bins the
feature matrix once, then walks every tree level by level.

Each device program has two forms in this module:

- a kernel written by hand in CUDA C++ for Hopper (`csrc/bin_features.cu`,
  `csrc/tree_walk.cu`), built with `nvcc` and launched through ctypes on
  the current stream; its wrapper counts its launches in `LAUNCHES`;
- a plain PyTorch version of the same arithmetic (`*_plain`), the CPU path
  and the kernel's oracle.

The wrappers `bin_features` and `tree_walk` pick by the tensor's device: a
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch.models.base import PredictionModel

# --------------------------------------------------------------------------- #
# launch counters                                                             #
# --------------------------------------------------------------------------- #

LAUNCHES: Dict[str, int] = {"bin_features": 0, "tree_walk": 0}
_launch_lock = threading.Lock()


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


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

    def _apply_tables(self, trees, Xb):
        margin = predict_gbt_margin(trees, Xb, self.learning_rate)
        return gbt_pred_from_margin(margin, "logistic")
