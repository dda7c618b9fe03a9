"""Evaluation metrics on the host (numpy, f64).

The port's copy of the JAX package's `evaluators/metrics.py`: AuROC is
the exact Mann-Whitney rank statistic with tie correction; AuPR is the
trapezoid area over the tie-grouped PR curve with the (r=0, p=1) start
point; multiclass metrics are support-weighted averages over the
confusion matrix; then the binary threshold curves, the multiclass topN
threshold counts and per-category misclassifications, the bin-score
calibration metrics (`BinScoreEvaluator`) and the forecast metrics
(`ForecastEvaluator`). Metric arrays are small next to the scoring that
produced them.
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


# --------------------------------------------------------------------------- #
# binary threshold curves (BinaryThresholdMetrics, OpBinaryClassification    #
# Evaluator.scala:223)                                                        #
# --------------------------------------------------------------------------- #

@dataclass
class BinaryThresholdMetrics:
    thresholds: List[float]
    precision_by_threshold: List[float]
    recall_by_threshold: List[float]
    false_positive_rate_by_threshold: List[float]

    def to_json(self) -> Dict:
        return {"thresholds": self.thresholds,
                "precisionByThreshold": self.precision_by_threshold,
                "recallByThreshold": self.recall_by_threshold,
                "falsePositiveRateByThreshold": self.false_positive_rate_by_threshold}


def binary_threshold_metrics(y_true, scores, num_bins: int = 100
                             ) -> BinaryThresholdMetrics:
    """PR/ROC curves over up-to-`num_bins` tie-grouped score thresholds
    (Spark downsamples the curve the same way)."""
    y = np.asarray(y_true, dtype=np.float64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    order = np.argsort(-s, kind="mergesort")
    ys, ss = y[order], s[order]
    boundaries = np.nonzero(np.diff(ss))[0]
    idx = np.concatenate([boundaries, [len(ss) - 1]]) if len(ss) else np.array([], np.int64)
    if len(idx) > num_bins:
        idx = idx[np.linspace(0, len(idx) - 1, num_bins).astype(np.int64)]
    tp = np.cumsum(ys)[idx]
    n_at = idx + 1.0
    fp = n_at - tp
    precision = np.divide(tp, n_at, out=np.zeros_like(tp), where=n_at > 0)
    recall = tp / n_pos if n_pos > 0 else np.zeros_like(tp)
    fpr = fp / n_neg if n_neg > 0 else np.zeros_like(fp)
    return BinaryThresholdMetrics(
        thresholds=s[order][idx].tolist(),
        precision_by_threshold=precision.tolist(),
        recall_by_threshold=recall.tolist(),
        false_positive_rate_by_threshold=fpr.tolist())


# --------------------------------------------------------------------------- #
# multiclass topN / topK threshold metrics                                    #
# (OpMultiClassificationEvaluator.scala:59-400)                               #
# --------------------------------------------------------------------------- #

@dataclass
class MulticlassThresholdMetrics:
    top_ns: List[int]
    thresholds: List[float]
    correct_counts: Dict[int, List[int]]
    incorrect_counts: Dict[int, List[int]]
    no_prediction_counts: Dict[int, List[int]]

    def to_json(self) -> Dict:
        return {"topNs": self.top_ns, "thresholds": self.thresholds,
                "correctCounts": {str(k): v for k, v in self.correct_counts.items()},
                "incorrectCounts": {str(k): v for k, v in self.incorrect_counts.items()},
                "noPredictionCounts": {str(k): v for k, v in self.no_prediction_counts.items()}}


def multiclass_threshold_metrics(y_true, probabilities,
                                 top_ns=(1, 3), n_thresholds: int = 10
                                 ) -> MulticlassThresholdMetrics:
    """For each topN and confidence threshold: counts of rows whose true
    label is in the topN classes AND max prob ≥ threshold (correct), in the
    topN but below threshold (noPrediction), or not in topN (incorrect —
    threshold-gated like the reference)."""
    y = np.asarray(y_true, dtype=np.int64).ravel()
    p = np.asarray(probabilities, dtype=np.float64)
    n = len(y)
    thresholds = np.linspace(0.0, 0.9, n_thresholds)
    maxp = p.max(axis=1) if n else np.array([])
    order = np.argsort(-p, axis=1)
    correct, incorrect, nopred = {}, {}, {}
    for topn in top_ns:
        in_topn = (order[:, :topn] == y[:, None]).any(axis=1) if n else np.array([], bool)
        c_list, i_list, np_list = [], [], []
        for thr in thresholds:
            confident = maxp >= thr
            c_list.append(int((in_topn & confident).sum()))
            i_list.append(int((~in_topn & confident).sum()))
            np_list.append(int((~confident).sum()))
        correct[topn], incorrect[topn], nopred[topn] = c_list, i_list, np_list
    return MulticlassThresholdMetrics(
        top_ns=list(top_ns), thresholds=thresholds.tolist(),
        correct_counts=correct, incorrect_counts=incorrect,
        no_prediction_counts=nopred)


def misclassifications_per_category(y_true, y_pred, min_support: int = 10,
                                    max_categories: int = 100) -> List[Dict]:
    """Per true-class error breakdown (reference's
    `misclassificationsPerCategory` with minSupport filtering)."""
    y = np.asarray(y_true, dtype=np.int64).ravel()
    p = np.asarray(y_pred, dtype=np.int64).ravel()
    out = []
    classes, counts = np.unique(y, return_counts=True)
    keep = classes[counts >= min_support][:max_categories]
    for c in keep:
        sel = y == c
        wrong = p[sel][p[sel] != c]
        wrong_classes, wrong_counts = np.unique(wrong, return_counts=True)
        out.append({
            "category": int(c), "support": int(sel.sum()),
            "error": float(len(wrong)) / max(int(sel.sum()), 1),
            "misclassifiedTo": {int(w): int(k) for w, k in
                                zip(wrong_classes, wrong_counts)}})
    return out


# --------------------------------------------------------------------------- #
# bin score / calibration (OpBinScoreEvaluator.scala:53)                      #
# --------------------------------------------------------------------------- #

@dataclass
class BinScoreMetrics:
    bin_centers: List[float]
    number_of_data_points: List[int]
    average_score: List[float]
    average_conversion_rate: List[float]
    brier_score: float

    def to_json(self) -> Dict:
        return {"binCenters": self.bin_centers,
                "numberOfDataPoints": self.number_of_data_points,
                "averageScore": self.average_score,
                "averageConversionRate": self.average_conversion_rate,
                "BrierScore": self.brier_score}


def bin_score_metrics(y_true, scores, num_bins: int = 10) -> BinScoreMetrics:
    y = np.asarray(y_true, dtype=np.float64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    which = np.clip(np.digitize(s, edges[1:-1]), 0, num_bins - 1)
    counts = np.bincount(which, minlength=num_bins)
    sum_s = np.bincount(which, weights=s, minlength=num_bins)
    sum_y = np.bincount(which, weights=y, minlength=num_bins)
    nz = np.maximum(counts, 1)
    brier = float(np.mean((s - y) ** 2)) if len(y) else 0.0
    return BinScoreMetrics(
        bin_centers=((edges[:-1] + edges[1:]) / 2).tolist(),
        number_of_data_points=counts.tolist(),
        average_score=(sum_s / nz).tolist(),
        average_conversion_rate=(sum_y / nz).tolist(),
        brier_score=brier)


# --------------------------------------------------------------------------- #
# forecast (OpForecastEvaluator.scala:59)                                     #
# --------------------------------------------------------------------------- #

@dataclass
class ForecastMetrics:
    smape: float
    seasonal_error: float
    mase: float

    def to_json(self) -> Dict:
        return {"SMAPE": self.smape, "SeasonalError": self.seasonal_error,
                "MASE": self.mase}


def forecast_metrics(y_true, y_pred, seasonal_window: int = 1) -> ForecastMetrics:
    """SMAPE + seasonal naive error + MASE over a time-ordered series."""
    y = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.asarray(y_pred, dtype=np.float64).ravel()
    denom = np.abs(y) + np.abs(p)
    smape = float(2.0 * np.mean(
        np.divide(np.abs(p - y), denom, out=np.zeros_like(denom), where=denom > 0)))
    m = seasonal_window
    if len(y) > m:
        seasonal_err = float(np.mean(np.abs(y[m:] - y[:-m])))
    else:
        seasonal_err = 0.0
    mae = float(np.mean(np.abs(p - y))) if len(y) else 0.0
    mase = mae / seasonal_err if seasonal_err > 0 else 0.0
    return ForecastMetrics(smape=smape, seasonal_error=seasonal_err, mase=mase)
