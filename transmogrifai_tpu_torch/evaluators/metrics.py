"""Binary, multiclass and regression metrics on the host (numpy).

The port's copy of the JAX package's `evaluators/metrics.py` (its
binary, multiclass and regression parts): AuROC is the exact Mann-Whitney
rank statistic with tie correction; AuPR is the trapezoid area over the
tie-grouped PR curve with the (r=0, p=1) start point; multiclass metrics
are support-weighted averages over the confusion matrix. Metric arrays are
small next to the scoring that produced them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class BinaryClassificationMetrics:
    precision: float
    recall: float
    f1: float
    auroc: float
    aupr: float
    error: float
    tp: int
    tn: int
    fp: int
    fn: int

    def to_json(self) -> Dict:
        return {
            "Precision": self.precision, "Recall": self.recall, "F1": self.f1,
            "AuROC": self.auroc, "AuPR": self.aupr, "Error": self.error,
            "TP": self.tp, "TN": self.tn, "FP": self.fp, "FN": self.fn,
        }


def auroc_score(y: np.ndarray, scores: np.ndarray) -> float:
    """Exact AuROC via rank statistic with average ranks for ties."""
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.0
    order = np.argsort(scores, kind="mergesort")
    s_sorted = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0  # average rank, 1-based
        i = j + 1
    r_pos = ranks[y > 0.5].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def aupr_score(y: np.ndarray, scores: np.ndarray) -> float:
    """Trapezoid area under the tie-grouped PR curve, with the (r=0, p=1)
    starting point (Spark BinaryClassificationMetrics convention)."""
    n_pos = float(y.sum())
    if n_pos == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    y_sorted = y[order]
    s_sorted = scores[order]
    # group ties: indices where the threshold changes
    boundaries = np.nonzero(np.diff(s_sorted))[0]
    idx = np.concatenate([boundaries, [len(s_sorted) - 1]])
    tp = np.cumsum(y_sorted)[idx]
    n_at = idx + 1.0
    precision = tp / n_at
    recall = tp / n_pos
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[1.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * (p[1:] + p[:-1]) / 2.0))


def binary_metrics(y_true, scores, threshold: float = 0.5) -> BinaryClassificationMetrics:
    y = np.asarray(y_true, dtype=np.float64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    pred = (s >= threshold).astype(np.float64)
    tp = int(((pred == 1) & (y == 1)).sum())
    tn = int(((pred == 0) & (y == 0)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    error = (fp + fn) / max(len(y), 1)
    return BinaryClassificationMetrics(
        precision=precision, recall=recall, f1=f1,
        auroc=auroc_score(y, s), aupr=aupr_score(y, s), error=error,
        tp=tp, tn=tn, fp=fp, fn=fn)


# --------------------------------------------------------------------------- #
# multiclass                                                                  #
# --------------------------------------------------------------------------- #

@dataclass
class MultiClassificationMetrics:
    precision: float   # weighted
    recall: float      # weighted
    f1: float          # weighted
    error: float
    confusion: List[List[int]]

    def to_json(self) -> Dict:
        return {"Precision": self.precision, "Recall": self.recall,
                "F1": self.f1, "Error": self.error,
                "Confusion": self.confusion}


def multiclass_metrics(y_true, y_pred, n_classes: Optional[int] = None
                       ) -> MultiClassificationMetrics:
    y = np.asarray(y_true, dtype=np.int64).ravel()
    p = np.asarray(y_pred, dtype=np.int64).ravel()
    k = n_classes or int(max(y.max(initial=0), p.max(initial=0))) + 1
    conf = np.zeros((k, k), dtype=np.int64)
    np.add.at(conf, (y, p), 1)
    tp = np.diag(conf).astype(np.float64)
    support = conf.sum(axis=1).astype(np.float64)
    pred_count = conf.sum(axis=0).astype(np.float64)
    prec_c = np.divide(tp, pred_count, out=np.zeros(k), where=pred_count > 0)
    rec_c = np.divide(tp, support, out=np.zeros(k), where=support > 0)
    f1_c = np.divide(2 * prec_c * rec_c, prec_c + rec_c,
                     out=np.zeros(k), where=(prec_c + rec_c) > 0)
    w = support / max(support.sum(), 1.0)
    err = 1.0 - tp.sum() / max(len(y), 1)
    return MultiClassificationMetrics(
        precision=float((prec_c * w).sum()), recall=float((rec_c * w).sum()),
        f1=float((f1_c * w).sum()), error=float(err), confusion=conf.tolist())


# --------------------------------------------------------------------------- #
# regression                                                                  #
# --------------------------------------------------------------------------- #

@dataclass
class RegressionMetrics:
    rmse: float
    mse: float
    mae: float
    r2: float
    signed_percentage_errors: List[int] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {"RMSE": self.rmse, "MSE": self.mse, "MAE": self.mae,
                "R2": self.r2,
                "SignedPercentageErrorHistogram":
                    self.signed_percentage_errors}


_SPE_BINS = np.array([-np.inf, -100, -50, -25, -10, -5, 0, 5, 10, 25, 50,
                      100, np.inf])


def regression_metrics(y_true, y_pred) -> RegressionMetrics:
    y = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.asarray(y_pred, dtype=np.float64).ravel()
    err = p - y
    mse = float(np.mean(err ** 2)) if len(y) else 0.0
    mae = float(np.mean(np.abs(err))) if len(y) else 0.0
    ss_res = float((err ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum()) if len(y) else 0.0
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        spe = np.where(y != 0, 100.0 * err / np.abs(y),
                       np.sign(err) * np.inf)
    hist = np.histogram(spe[np.isfinite(spe)], bins=_SPE_BINS)[0]
    return RegressionMetrics(
        rmse=float(np.sqrt(mse)), mse=mse, mae=mae, r2=r2,
        signed_percentage_errors=hist.tolist())
