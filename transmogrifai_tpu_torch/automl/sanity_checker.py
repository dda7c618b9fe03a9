"""SanityChecker: automated feature validation before model selection.

The port's counterpart of the JAX package's `automl/sanity_checker.py`.
The fit computes column moments and the correlations of [X | y] on the
fit's device (K9: column reductions and Gram matmuls, plain torch; past
`_WIDE_D` columns the Gram runs block by block and the pairs above
`max_feature_corr` come out of each block through the hand kernel
K9-hits, `csrc/corr_hits.cu`), the categorical contingency statistics on
the host, and drops columns by the reference's rules: variance below
`min_variance`; |corr(feature, label)| above `max_correlation` or below
`min_correlation`; |corr| with an earlier kept column above
`max_feature_corr` (the later column drops); a categorical group's
Cramér's V above `max_cramers_v`; rule confidence above
`max_rule_confidence` at support above `min_required_rule_support`.
Spearman correlation is Pearson's over average-tie ranks, computed on
the fit's device (`_rank_transform`). The fitted model is a static column
gather of the kept indices.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)

# reference defaults (SanityChecker.scala:561-578)
CHECK_SAMPLE = 1.0
SAMPLE_LOWER_LIMIT = 1_000
SAMPLE_UPPER_LIMIT = 1_000_000
MAX_CORRELATION = 0.95
MAX_FEATURE_CORR = 0.99
MIN_CORRELATION = 0.0
MIN_VARIANCE = 1e-5
MAX_CRAMERS_V = 0.95
MAX_RULE_CONFIDENCE = 1.0
MIN_REQUIRED_RULE_SUPPORT = 1.0
# feature count beyond which the (d, d) correlation matrix never exists
_WIDE_D = 8192
# entries of one block product of the wide path (512 MB in f32)
_BLOCK_ENTRIES = 1 << 27
# elements of one column chunk of X (the rank transform's sort, the
# sums of squares), so no second (n, d) temporary exists beside X
_CHUNK_ENTRIES = 1 << 25

log = logging.getLogger(__name__)


@dataclass
class ColumnStats:
    name: str
    mean: float
    variance: float
    min: float
    max: float
    corr_label: float
    cramers_v: Optional[float]
    mutual_info: Optional[float] = None
    max_rule_confidence: Optional[float] = None
    support: Optional[float] = None
    dropped: List[str] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "name": self.name, "mean": self.mean, "variance": self.variance,
            "min": self.min, "max": self.max, "corrLabel": self.corr_label,
            "cramersV": self.cramers_v, "mutualInfo": self.mutual_info,
            "maxRuleConfidence": self.max_rule_confidence,
            "support": self.support, "dropped": self.dropped,
        }


@dataclass
class CategoricalGroupStats:
    group: str
    cramers_v: float
    mutual_info: float
    pointwise_mutual_info: Dict[str, List[float]]
    max_rule_confidences: List[float]
    supports: List[float]

    def to_json(self) -> Dict:
        return {
            "group": self.group, "cramersV": self.cramers_v,
            "mutualInfo": self.mutual_info,
            "pointwiseMutualInfo": self.pointwise_mutual_info,
            "maxRuleConfidences": self.max_rule_confidences,
            "supports": self.supports,
        }


@dataclass
class SanityCheckerSummary:
    n_rows: int
    stats: List[ColumnStats]
    kept_indices: List[int]
    dropped_indices: List[int]
    correlation_type: str = "pearson"
    sample_fraction: float = 1.0
    categorical_stats: List[CategoricalGroupStats] = field(
        default_factory=list)

    def to_json(self) -> Dict:
        return {
            "n_rows": self.n_rows,
            "stats": [s.to_json() for s in self.stats],
            "kept": self.kept_indices, "dropped": self.dropped_indices,
            "correlationType": self.correlation_type,
            "sampleFraction": self.sample_fraction,
            "categoricalStats": [c.to_json() for c in self.categorical_stats],
        }


# --------------------------------------------------------------------------- #
# K9: column reductions and the Gram correlation (plain torch)                #
# --------------------------------------------------------------------------- #

def _column_chunks(X: torch.Tensor):
    """(first column, view) of X (n, d) in column chunks of about
    `_CHUNK_ENTRIES` elements: a chunk's temporaries, and the staging
    buffers of the card's reductions over rows, stay a fraction of X."""
    n, d = X.shape
    width = max(1, _CHUNK_ENTRIES // max(n, 1))
    for c0 in range(0, d, width):
        yield c0, X[:, c0:c0 + width]


def _column_reductions(X: torch.Tensor, y: Optional[torch.Tensor] = None
                       ) -> Dict[str, np.ndarray]:
    """Per-column f32 sums, sums of squares, min and max, in column
    chunks; with the label y also its sum, sum of squares and X^T y."""
    n, d = X.shape
    out = {k: torch.zeros(d, dtype=X.dtype, device=X.device)
           for k in ("sx", "sxx", "min", "max")}
    for c0, Xc in _column_chunks(X):
        c1 = c0 + Xc.shape[1]
        out["sx"][c0:c1] = Xc.sum(0)
        out["sxx"][c0:c1] = (Xc * Xc).sum(0)
        if n:
            out["min"][c0:c1] = Xc.amin(0)
            out["max"][c0:c1] = Xc.amax(0)
    if y is not None:
        out.update({"sy": y.sum(), "syy": (y * y).sum(), "sxy": X.T @ y})
    return {k: v.cpu().numpy() for k, v in out.items()}


def _corr_matrix(Z: torch.Tensor) -> np.ndarray:
    """Full correlation matrix of (n, k) via one Gram matmul (f32, as in
    the JAX package). Columns with zero variance correlate as 0."""
    n = Z.shape[0]
    Zc = Z - Z.mean(0)
    cov = (Zc.T @ Zc).cpu().numpy() / max(n - 1, 1)
    sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
    denom = np.outer(sd, sd)
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = np.where(denom > 0, cov / denom, 0.0)
    return corr


def _rank_transform(A: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks per column of A (n, k), f32 on A's device, as
    pandas' `rank(method="average")` gives them (the JAX package's
    `_rank_transform`): a tie group at sorted positions i..j takes
    (i + j)/2 + 1; NaN stays NaN and is left out of the ranking. Exact in
    f32 up to 2^23 rows. Columns go in chunks of about `_CHUNK_ENTRIES`
    elements, so the sort's int64 indices stay a fraction of A."""
    n, k = A.shape
    out = torch.empty((n, k), dtype=torch.float32, device=A.device)
    if n == 0 or k == 0:
        return out
    pos = torch.arange(n, device=A.device)[:, None]
    for c0, Ac in _column_chunks(A):
        vals, order = torch.sort(Ac, dim=0, stable=True)
        starts = torch.ones(vals.shape, dtype=torch.bool, device=A.device)
        starts[1:] = vals[1:] != vals[:-1]
        ends = torch.ones_like(starts)
        ends[:-1] = starts[1:]
        first = torch.where(starts, pos, 0).cummax(0).values
        last = torch.where(ends, pos, n).flip(0).cummin(0).values.flip(0)
        ranks = (first + last + 2).to(torch.float32) * 0.5
        ranks.masked_fill_(torch.isnan(vals), float("nan"))
        out[:, c0:c0 + Ac.shape[1]].scatter_(0, order, ranks)
    return out


# --------------------------------------------------------------------------- #
# K9-hits: a block's feature pairs above the threshold (hand CUDA kernel)     #
# --------------------------------------------------------------------------- #

def corr_hits_plain(C: torch.Tensor, a: int, thr: float, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The hits |C[r, j]| > thr with j < a + r and a + r < d of one block
    product C (b, d) f32, rows the columns a.. of the checker: the first
    `cap` of them in row-major order as (ri, ci) int64 (-1 past the last
    hit) and vals = C[ri, ci] (index -1 reading C[b - 1, d - 1], as in
    the JAX package), and the count of every hit (int64, 0-dim)."""
    b, d = C.shape
    rows = a + torch.arange(b, device=C.device)[:, None]
    cols = torch.arange(d, device=C.device)[None, :]
    mask = (C.abs() > thr) & (cols < rows) & (rows < d)
    total = mask.sum()
    nz = mask.nonzero()
    k = min(cap, nz.shape[0])
    ri = torch.full((cap,), -1, dtype=torch.int64, device=C.device)
    ci = torch.full((cap,), -1, dtype=torch.int64, device=C.device)
    ri[:k] = nz[:k, 0]
    ci[:k] = nz[:k, 1]
    return ri, ci, C[ri, ci], total


cuda_build.register(
    "corr_hits", "corr_hits",
    (ctypes.c_void_p,) + (ctypes.c_int64,) * 3
    + (ctypes.c_float, ctypes.c_int64) + (ctypes.c_void_p,) * 6)


def _corr_hits_cuda(C, a, thr, cap):
    if C.dtype != torch.float32 or C.dim() != 2:
        raise ValueError(
            f"corr_hits: C must be a 2-d f32 tensor, got {C.dtype} "
            f"{tuple(C.shape)}")
    b, d = C.shape
    if cap < 0 or a < 0 or b == 0 or d == 0:
        raise ValueError(f"corr_hits: a = {a}, cap = {cap} must be >= 0 "
                         f"and C {tuple(C.shape)} non-empty")
    dev = C.device
    ri = torch.empty(cap, dtype=torch.int64, device=dev)
    ci = torch.empty(cap, dtype=torch.int64, device=dev)
    vals = torch.empty(cap, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    C = C.contiguous()
    scratch = torch.empty(b, dtype=torch.int64, device=dev)
    err = cuda_build.launch(
        C.get_device(), cuda_build.entry("corr_hits", "corr_hits"),
        C.data_ptr(), b, d, a, thr, cap, scratch.data_ptr(), ri.data_ptr(),
        ci.data_ptr(), vals.data_ptr(), total.data_ptr())
    cuda_build.check("corr_hits", err)
    cuda_build.count("corr_hits")
    return ri, ci, vals, total


def corr_hits(C: torch.Tensor, a: int, thr: float, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """`corr_hits_plain`'s outputs for one block product C (b, d): a CUDA
    tensor launches the K9-hits kernel (or raises), bit-equal to the plain
    version; a CPU tensor takes the plain version."""
    if C.is_cuda:
        return _corr_hits_cuda(C, a, thr, cap)
    if C.device.type != "cpu":
        raise ValueError(f"corr_hits: unsupported device {C.device}")
    return corr_hits_plain(C, a, thr, cap)


def wide_block(d: int) -> int:
    """Columns a block of the wide path: max(128, min(d, 2^27 // d)), so
    a block product holds at most `_BLOCK_ENTRIES` entries."""
    return max(128, min(d, _BLOCK_ENTRIES // max(d, 1)))


def _corr_label_and_hits_blocked(
        Cx: torch.Tensor, cy: torch.Tensor, thr: float,
        block: Optional[int] = None, inplace: bool = False
        ) -> Tuple[np.ndarray, Dict[int, List[Tuple[int, float]]]]:
    """The wide path (d > `_WIDE_D`): the label correlations and the
    sparse set of feature pairs with |corr| > thr, from the Gram product
    block by block, so the (d, d) matrix never exists. U = (Cx − mean) /
    ‖Cx − mean‖ per column (the sum-of-squares norm; 0 where it is 0),
    corr_y = Uᵀ·uy; per block of columns a..a + b, C = U_bᵀ·U (f32
    `torch.matmul`, TF32 off) and `corr_hits` takes the first
    cap = 16·block hits of j < i in row-major order, as the JAX package's
    `jnp.nonzero(size=cap)` does; a block with more logs the JAX
    package's truncation warning. `block` defaults to `wide_block(d)`.
    With `inplace` U is built in Cx's storage (the caller's working
    copy), else in one new (n, d) tensor.

    Returns (corr_y (d,) f64, {i: [(j, corr_ij), ...] sorted, j < i})."""
    n, d = Cx.shape
    U = Cx if inplace else Cx.clone()
    for _, Uc in _column_chunks(U):
        Uc.sub_(Uc.mean(0))
        sd = torch.linalg.vector_norm(Uc, dim=0)
        live = sd > 0
        Uc.div_(torch.where(live, sd, 1.0)).masked_fill_(~live, 0.0)
    yc = cy - cy.mean()
    ysd = torch.sqrt(torch.clamp_min((yc * yc).sum(), 0.0))
    uy = torch.where(ysd > 0, yc / torch.where(ysd > 0, ysd, 1.0), 0.0)
    corr_y = (U.T @ uy).double().cpu().numpy()

    if block is None:
        block = wide_block(d)
    cap = 16 * block  # duplicates are sparse; truncation is logged
    pairs: Dict[int, List[Tuple[int, float]]] = {}
    for a in range(0, d, block):
        C = U[:, a:a + block].T @ U
        ri, ci, vals, total = (t.cpu().numpy()
                               for t in corr_hits(C, a, thr, cap))
        del C
        k = int((ri >= 0).sum())
        if int(total) > cap:
            log.warning(
                "feature-feature corr: %d hits in block %d..%d truncated "
                "to %d — raise max_feature_corr or lower the hash width",
                int(total), a, min(a + block, d), cap)
        for t in range(k):
            i, j = int(ri[t]) + a, int(ci[t])
            if i < d:
                pairs.setdefault(i, []).append((j, float(vals[t])))
    for i in pairs:
        pairs[i].sort()
    return corr_y, pairs


# --------------------------------------------------------------------------- #
# host statistics                                                             #
# --------------------------------------------------------------------------- #

def _label_onehot(y: np.ndarray, max_card: int,
                  force: Optional[bool] = None) -> Optional[np.ndarray]:
    """One-hot label for contingency tests, or None if not categorical."""
    if force is False:
        return None
    yi = np.round(y).astype(np.int64)
    if force is not True and not np.allclose(y, yi, atol=1e-6):
        return None
    levels = np.unique(yi)
    if len(levels) < 2 or (force is not True and len(levels) > max_card):
        return None
    lut = {v: i for i, v in enumerate(levels.tolist())}
    idx = np.array([lut[v] for v in yi.tolist()])
    oh = np.zeros((len(y), len(levels)), dtype=np.float32)
    oh[np.arange(len(y)), idx] = 1.0
    return oh


def cramers_v(contingency: np.ndarray) -> float:
    """Cramér's V from a levels × labels count table, empty rows/cols
    filtered first."""
    cont = contingency[contingency.sum(1) > 0][:, contingency.sum(0) > 0]
    if cont.shape[0] < 2 or cont.shape[1] < 2:
        return 0.0
    n = cont.sum()
    if n == 0:
        return 0.0
    row = cont.sum(axis=1, keepdims=True)
    col = cont.sum(axis=0, keepdims=True)
    expected = row @ col / n
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(expected > 0,
                        (cont - expected) ** 2 / expected, 0.0).sum()
    denom = n * (min(cont.shape) - 1)
    return float(np.sqrt(chi2 / denom)) if denom > 0 else 0.0


def contingency_stats(cont: np.ndarray) -> Dict:
    """PMI / mutual info / association-rule confidences from a levels ×
    labels table."""
    total = cont.sum()
    row = cont.sum(axis=1)
    col = cont.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.where(
            (cont > 0) & (row[:, None] > 0) & (col[None, :] > 0),
            np.log2(np.maximum(cont, 1e-99) * total
                    / np.maximum(row[:, None] * col[None, :], 1e-99)),
            0.0)
        mi = float((pmi * cont / max(total, 1)).sum())
        conf = np.where(row > 0, cont.max(axis=1) / np.maximum(row, 1), 0.0)
    supports = (row / max(total, 1)).tolist()
    pmi_map = {str(j): pmi[:, j].tolist() for j in range(cont.shape[1])}
    return {"cramers_v": cramers_v(cont), "mutual_info": mi,
            "pmi": pmi_map, "max_confidences": conf.tolist(),
            "supports": supports}


# --------------------------------------------------------------------------- #
# stages                                                                      #
# --------------------------------------------------------------------------- #

class _KeptIndices(torch.nn.Module):
    """The kept column indices as a long buffer on the scoring device."""

    def __init__(self, indices: Sequence[int]):
        super().__init__()
        self.register_buffer("idx", torch.as_tensor(
            np.asarray(indices, dtype=np.int64)))


class SanityCheckerModel(Transformer):
    """Fitted checker: keeps the columns `indices` of the (label, vector)
    input's vector, in that order."""

    out_type = T.OPVector

    def __init__(self, indices: Sequence[int], meta: Optional[Dict] = None,
                 summary: Optional[Dict] = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.indices = list(int(i) for i in indices)
        self._meta_json = (meta.to_json() if isinstance(meta, VectorMetadata)
                           else meta)
        self.summary = summary

    def device_constants(self, device):
        return _KeptIndices(self.indices).to(device)

    def device_apply_with(self, consts, enc, dev):
        return dev[-1].index_select(1, consts.idx)

    def output_meta(self) -> Optional[VectorMetadata]:
        if self._meta_json is None:
            return None
        return VectorMetadata.from_json(self._meta_json)

    def get_params(self):
        return {"indices": self.indices, "meta": self._meta_json,
                "summary": self.summary}


class SanityChecker(Estimator):
    """(RealNN label, OPVector) → the cleaned OPVector (drop rules in the
    module docstring)."""

    in_types = (T.RealNN, T.OPVector)
    out_type = T.OPVector

    def __init__(self, max_correlation: float = MAX_CORRELATION,
                 min_correlation: float = MIN_CORRELATION,
                 max_feature_corr: float = MAX_FEATURE_CORR,
                 min_variance: float = MIN_VARIANCE,
                 max_cramers_v: float = MAX_CRAMERS_V,
                 max_rule_confidence: float = MAX_RULE_CONFIDENCE,
                 min_required_rule_support: float = MIN_REQUIRED_RULE_SUPPORT,
                 correlation_type: str = "pearson",
                 check_sample: float = CHECK_SAMPLE,
                 sample_lower_limit: int = SAMPLE_LOWER_LIMIT,
                 sample_upper_limit: int = SAMPLE_UPPER_LIMIT,
                 sample_seed: int = 42,
                 remove_bad_features: bool = True,
                 categorical_label: Optional[bool] = None,
                 categorical_label_max_card: int = 30,
                 uid: Optional[str] = None):
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError("correlation_type must be pearson or spearman")
        super().__init__(
            uid=uid, max_correlation=max_correlation,
            min_correlation=min_correlation,
            max_feature_corr=max_feature_corr, min_variance=min_variance,
            max_cramers_v=max_cramers_v,
            max_rule_confidence=max_rule_confidence,
            min_required_rule_support=min_required_rule_support,
            correlation_type=correlation_type, check_sample=check_sample,
            sample_lower_limit=sample_lower_limit,
            sample_upper_limit=sample_upper_limit, sample_seed=sample_seed,
            remove_bad_features=remove_bad_features,
            categorical_label=categorical_label,
            categorical_label_max_card=categorical_label_max_card)
        self.max_correlation = max_correlation
        self.min_correlation = min_correlation
        self.max_feature_corr = max_feature_corr
        self.min_variance = min_variance
        self.max_cramers_v = max_cramers_v
        self.max_rule_confidence = max_rule_confidence
        self.min_required_rule_support = min_required_rule_support
        self.correlation_type = correlation_type
        self.check_sample = check_sample
        self.sample_lower_limit = sample_lower_limit
        self.sample_upper_limit = sample_upper_limit
        self.sample_seed = sample_seed
        self.remove_bad_features = remove_bad_features
        self.categorical_label = categorical_label
        self.categorical_label_max_card = categorical_label_max_card

    def _sample_rows(self, n: int) -> Optional[np.ndarray]:
        """Row subsample for the statistics pass; None = every row."""
        target = n
        if self.check_sample < 1.0:
            target = int(n * self.check_sample)
        target = min(target, self.sample_upper_limit)
        target = max(target, min(n, self.sample_lower_limit))
        if target >= n:
            return None
        rng = np.random.default_rng(self.sample_seed)
        return np.sort(rng.choice(n, size=target, replace=False))

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        label_col, vec_col = cols
        y_np = np.asarray(label_col.data["value"], dtype=np.float64)
        X_np = np.array(vec_col.data, dtype=np.float32)
        n_total = X_np.shape[0]
        sample_idx = self._sample_rows(n_total)
        if sample_idx is not None:
            X_np = X_np[sample_idx]
            y_np = y_np[sample_idx]
        n, d = X_np.shape
        X = torch.as_tensor(X_np, device=ctx.device)
        # Spearman = Pearson over average-tie ranks: `Cx`/`cy` are the
        # correlation inputs; the stats report the raw-X moments either way
        spearman = self.correlation_type == "spearman"
        if spearman:
            Cx = _rank_transform(X)
            cy = _rank_transform(torch.as_tensor(
                y_np[:, None], device=ctx.device))[:, 0]
        else:
            Cx = X
            cy = torch.as_tensor(y_np.astype(np.float32), device=ctx.device)
        need_ff = self.max_feature_corr < 1.0
        if need_ff:  # corr comes from the Gram pass; only raw moments here
            red = _column_reductions(X)
        else:        # the label terms ride the same reduction pass
            redc = _column_reductions(Cx, cy)
            red = _column_reductions(X) if spearman else redc
        mean = red["sx"] / max(n, 1)
        var = (red["sxx"] - n * mean ** 2) / max(n - 1, 1)
        var = np.maximum(var, 0.0)
        hit_pairs: Dict[int, List[Tuple[int, float]]] = {}
        if need_ff and d > _WIDE_D:
            # wide X: the blocked Gram, label corr + sparse duplicate
            # pairs, no (d, d) matrix. The raw moments are taken, so U
            # takes Cx's storage: the ranks', or X's on the card (on the
            # CPU X shares X_np, which the contingency statistics read)
            del X
            corr, hit_pairs = _corr_label_and_hits_blocked(
                Cx, cy, self.max_feature_corr,
                inplace=spearman or Cx.is_cuda)
            feat_corr = None
        elif need_ff:
            corr_all = _corr_matrix(torch.cat([Cx, cy[:, None]], 1))
            corr = corr_all[:d, d]
            feat_corr = corr_all[:d, :d]
        else:
            # duplicates check off: the label terms of one reduction pass
            cmean = redc["sx"] / max(n, 1)
            cvar = np.maximum(
                (redc["sxx"] - n * cmean ** 2) / max(n - 1, 1), 0.0)
            y_mean = redc["sy"] / max(n, 1)
            y_var = max(
                (redc["syy"] - n * y_mean ** 2) / max(n - 1, 1), 0.0)
            cov = (redc["sxy"] - n * cmean * y_mean) / max(n - 1, 1)
            denom = np.sqrt(cvar * y_var)
            with np.errstate(divide="ignore", invalid="ignore"):
                corr = np.where(denom > 0, cov / denom, 0.0)
            feat_corr = None
        X = Cx = None

        meta = vec_col.meta
        names = (meta.column_names() if meta is not None
                 else [f"col_{i}" for i in range(d)])

        group_stats: Dict[int, Tuple[str, Dict]] = {}
        cat_groups: List[CategoricalGroupStats] = []
        if meta is not None:
            oh = _label_onehot(y_np, self.categorical_label_max_card,
                               force=self.categorical_label)
            if oh is not None:
                groups: Dict[str, List[int]] = {}
                for i, c in enumerate(meta.columns):
                    if c.indicator_value is not None:
                        groups.setdefault(c.grouping_key(), []).append(i)
                for key, idxs in groups.items():
                    cont = X_np[:, idxs].T.astype(np.float64) @ oh
                    cs = contingency_stats(cont)
                    cat_groups.append(CategoricalGroupStats(
                        group=key, cramers_v=cs["cramers_v"],
                        mutual_info=cs["mutual_info"],
                        pointwise_mutual_info=cs["pmi"],
                        max_rule_confidences=cs["max_confidences"],
                        supports=cs["supports"]))
                    for li, i in enumerate(idxs):
                        group_stats[i] = (key, {
                            "cramers_v": cs["cramers_v"],
                            "mutual_info": cs["mutual_info"],
                            "conf": cs["max_confidences"][li],
                            "support": cs["supports"][li]})

        if feat_corr is not None and d > 1:
            hit = np.abs(np.tril(feat_corr, k=-1)) > self.max_feature_corr
            for i in np.flatnonzero(hit.any(axis=1)):
                hit_pairs[int(i)] = [(int(j), float(feat_corr[i, j]))
                                     for j in np.flatnonzero(hit[i])]

        stats: List[ColumnStats] = []
        kept: List[int] = []
        dropped_so_far: set = set()
        for i in range(d):
            reasons: List[str] = []
            if var[i] < self.min_variance:
                reasons.append(f"variance {var[i]:.2e} < {self.min_variance}")
            ac = abs(float(corr[i]))
            if ac > self.max_correlation:
                reasons.append(f"label corr {ac:.3f} > {self.max_correlation}")
            elif self.min_correlation > 0 and ac < self.min_correlation:
                reasons.append(f"label corr {ac:.3f} < {self.min_correlation}")
            for j, cij in hit_pairs.get(i, ()):
                if j not in dropped_so_far:
                    reasons.append(
                        f"corr {cij:.3f} with column "
                        f"{names[j]!r} > {self.max_feature_corr}")
                    break
            gs = group_stats.get(i)
            gv = mi = conf = sup = None
            if gs is not None:
                _, s = gs
                gv, mi = s["cramers_v"], s["mutual_info"]
                conf, sup = s["conf"], s["support"]
                if gv > self.max_cramers_v:
                    reasons.append(f"cramersV {gv:.3f} > {self.max_cramers_v}")
                if (conf > self.max_rule_confidence
                        and sup > self.min_required_rule_support):
                    reasons.append(
                        f"rule confidence {conf:.3f} > "
                        f"{self.max_rule_confidence} at support {sup:.3f}")
            stats.append(ColumnStats(
                name=names[i], mean=float(mean[i]), variance=float(var[i]),
                min=float(red["min"][i]), max=float(red["max"][i]),
                corr_label=float(corr[i]), cramers_v=gv, mutual_info=mi,
                max_rule_confidence=conf, support=sup, dropped=reasons))
            if not reasons or not self.remove_bad_features:
                kept.append(i)
            elif reasons:
                dropped_so_far.add(i)

        if not kept:  # never drop everything
            kept = list(range(d))
            for s in stats:
                s.dropped.append("retained: all columns flagged")

        kept_set = set(kept)
        summary = SanityCheckerSummary(
            n_rows=n, stats=stats, kept_indices=kept,
            dropped_indices=[i for i in range(d) if i not in kept_set],
            correlation_type=self.correlation_type,
            sample_fraction=n / max(n_total, 1),
            categorical_stats=cat_groups)
        sel_meta = meta.select(kept) if meta is not None else None
        return SanityCheckerModel(kept, meta=sel_meta,
                                  summary=summary.to_json())
