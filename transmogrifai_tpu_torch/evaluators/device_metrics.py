"""Masked metrics on the device, for the batched sweep and early stopping.

The port's counterpart of the JAX package's `evaluators/device_metrics.py`.
Folds are 0/1 row masks over a fixed training matrix, so a metric takes
(y, scores, mask) and a masked row contributes zero weight everywhere; the
values equal the host metrics (`evaluators/metrics.py`) on the unmasked
rows.

`aupr_dev`, `auroc_dev` and `binary_confusion_dev` are plain torch (sort,
searchsorted, cumsum). The binned AuPR (`binned_aupr`, used by
`aupr_binned_dev` and by the boosting rounds' early-stopping metric) has
two forms: a kernel written by hand in CUDA C++ (`csrc/binned_aupr.cu`,
K8) and a plain PyTorch version (`binned_aupr_plain`). The wrapper picks by
the tensor's device: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from transmogrifai_tpu_torch import cuda_build


def auroc_dev(y: torch.Tensor, scores: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Tie-averaged Mann-Whitney AuROC over masked rows."""
    wpos = mask * y
    wneg = mask * (1.0 - y)
    order = torch.argsort(scores, stable=True)
    s = scores[order]
    wp = wpos[order]
    wn = wneg[order]
    cumn = torch.cat([torch.zeros(1, dtype=s.dtype, device=s.device),
                      torch.cumsum(wn, 0)])
    left = torch.searchsorted(s, s, side="left")
    right = torch.searchsorted(s, s, side="right")
    below = cumn[left]
    tied = cumn[right] - cumn[left]
    num = (wp * (below + 0.5 * tied)).sum()
    n_pos = wpos.sum()
    n_neg = wneg.sum()
    ok = (n_pos > 0) & (n_neg > 0)
    val = num / torch.clamp(n_pos * n_neg, min=1e-30)
    return torch.where(ok, val, torch.zeros_like(val))


def aupr_dev(y: torch.Tensor, scores: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Trapezoid area under the tie-grouped PR curve with the (r=0, p=1)
    start point (aupr_score parity)."""
    wpos = mask * y
    neg_s = -scores
    order = torch.argsort(neg_s, stable=True)
    s_asc = neg_s[order]
    wp = wpos[order]
    w = mask[order]
    cum_tp = torch.cumsum(wp, 0)
    cum_n = torch.cumsum(w, 0)
    # every index maps to its tie group's END (last index of an equal score)
    right = torch.searchsorted(s_asc, s_asc, side="right") - 1
    tp = cum_tp[right]
    n_at = cum_n[right]
    n_pos = wpos.sum()
    prec = torch.where(n_at > 0, tp / torch.clamp(n_at, min=1e-30),
                       torch.ones_like(tp))
    rec = tp / torch.clamp(n_pos, min=1e-30)
    r = torch.cat([torch.zeros(1, dtype=rec.dtype, device=rec.device), rec])
    p = torch.cat([torch.ones(1, dtype=prec.dtype, device=prec.device), prec])
    area = ((r[1:] - r[:-1]) * (p[1:] + p[:-1]) * 0.5).sum()
    return torch.where(n_pos > 0, area, torch.zeros_like(area))


def binary_confusion_dev(y, scores, mask,
                         threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Weighted TP/TN/FP/FN and the derived point metrics at `threshold`."""
    pred = (scores >= threshold).to(scores.dtype)
    pos = (y > 0.5).to(scores.dtype)
    tp = (pred * pos * mask).sum()
    fp = (pred * (1 - pos) * mask).sum()
    fn = ((1 - pred) * pos * mask).sum()
    tn = ((1 - pred) * (1 - pos) * mask).sum()
    n = torch.clamp(mask.sum(), min=1.0)
    zero = torch.zeros_like(tp)
    precision = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-30),
                            zero)
    recall = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1e-30),
                         zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall
                     / torch.clamp(precision + recall, min=1e-30), zero)
    error = (fp + fn) / n
    return {"Precision": precision, "Recall": recall, "F1": f1,
            "Error": error, "TP": tp, "TN": tn, "FP": fp, "FN": fn}


# --------------------------------------------------------------------------- #
# K8: binned AuPR                                                             #
# --------------------------------------------------------------------------- #

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in the input's precision: the formula XLA uses
    for the logistic function (the exp itself is each library's own)."""
    return 1.0 / (1.0 + torch.exp(-x))


def score_bins(m: torch.Tensor, n_bins: int,
               from_margin: bool) -> torch.Tensor:
    """The bucket of each score: min(int(s · n_bins), n_bins − 1) with s =
    sigmoid(m) (margins) or m (scores), clipped to [0, 1] (NaN → 0)."""
    s = sigmoid(m) if from_margin else m
    s = torch.clamp(torch.nan_to_num(s, nan=0.0), 0.0, 1.0)
    return torch.clamp((s * n_bins).to(torch.int32), max=n_bins - 1)


def _shapes(m, y, w):
    if m.dim() != 2 or w.shape != m.shape or y.shape != m.shape[1:]:
        raise ValueError(
            f"binned_aupr: margins {tuple(m.shape)} and weights "
            f"{tuple(w.shape)} must be (P, n), labels {tuple(y.shape)} (n,)")


def binned_aupr_plain(m: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      n_bins: int, from_margin: bool) -> torch.Tensor:
    """(P,) f32 AuPR over n_bins score buckets: `bincount` histograms of
    w·y and w, reversed running sums, the PR trapezoid from (r = 0,
    p = 1) summed in f64 and rounded once; 0 without positives."""
    _shapes(m, y, w)
    P, n = m.shape
    b = score_bins(m, n_bins, from_margin).long() + torch.arange(
        P, device=m.device)[:, None] * n_bins
    hp = torch.bincount(b.reshape(-1), weights=(w * y).reshape(-1),
                        minlength=P * n_bins).reshape(P, n_bins)
    ha = torch.bincount(b.reshape(-1), weights=w.reshape(-1),
                        minlength=P * n_bins).reshape(P, n_bins)
    tp = torch.cumsum(hp.double().flip(1), 1)
    n_at = torch.cumsum(ha.double().flip(1), 1)
    n_pos = tp[:, -1:]
    prec = torch.where(n_at > 0, tp / torch.clamp(n_at, min=1e-300),
                       torch.ones_like(tp))
    rec = torch.where(n_pos > 0, tp / torch.clamp(n_pos, min=1e-300),
                      torch.zeros_like(tp))
    zeros = torch.zeros((P, 1), dtype=torch.float64, device=m.device)
    r = torch.cat([zeros, rec], 1)
    p = torch.cat([zeros + 1.0, prec], 1)
    area = ((r[:, 1:] - r[:, :-1]) * (p[:, 1:] + p[:, :-1]) * 0.5).sum(1)
    area = torch.where(n_pos[:, 0] > 0, area, torch.zeros_like(area))
    return area.to(torch.float32)


_AUPR_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p,) * 2
_AUPR_MAX_BINS = 6144  # two f32 histograms within 48 KB of shared memory


def _binned_aupr_cuda(m, y, w, n_bins, from_margin):
    _shapes(m, y, w)
    for name, t in (("labels", y), ("weights", w)):
        if t.device != m.device:
            raise ValueError(f"binned_aupr: margins on {m.device}, {name} "
                             f"on {t.device}")
    if not all(t.dtype == torch.float32 for t in (m, y, w)):
        raise ValueError("binned_aupr: margins, labels and weights must be "
                         "f32")
    if not 1 <= n_bins <= _AUPR_MAX_BINS:
        raise ValueError(f"binned_aupr: n_bins {n_bins} outside [1, "
                         f"{_AUPR_MAX_BINS}]")
    P, n = m.shape
    out = torch.zeros(P, dtype=torch.float32, device=m.device)
    if P == 0:
        return out
    m, y, w = m.contiguous(), y.contiguous(), w.contiguous()
    lib = cuda_build.load("binned_aupr")
    fn = cuda_build.declare(lib, "binned_aupr", _AUPR_ARGS)
    with torch.cuda.device(m.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(m.device).cuda_stream)
        err = fn(m.data_ptr(), y.data_ptr(), w.data_ptr(), P, n, n_bins,
                 int(bool(from_margin)), out.data_ptr(), stream)
    cuda_build.check("binned_aupr", err)
    cuda_build.count("binned_aupr")
    return out


def binned_aupr(m: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                n_bins: int, from_margin: bool) -> torch.Tensor:
    """(P,) f32 sort-free AuPR of P score rows (margins through the
    sigmoid with `from_margin`, else scores clipped to [0, 1]) over
    n_bins buckets, with row weights w (P, n) and labels y (n,). A CUDA
    tensor launches the K8 kernel (or raises); a CPU tensor takes the
    plain version."""
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"binned_aupr: unsupported device {m.device}")
    if m.is_cuda:
        return _binned_aupr_cuda(m, y, w, n_bins, from_margin)
    return binned_aupr_plain(m, y, w, n_bins, from_margin)


def aupr_binned_dev(y: torch.Tensor, scores: torch.Tensor,
                    mask: torch.Tensor, n_bins: int = 4096) -> torch.Tensor:
    """Sort-free AuPR over `n_bins` score buckets (scores in [0, 1])."""
    return binned_aupr(scores[None, :], y, mask[None, :], n_bins,
                       from_margin=False)[0]


def _binary_scores(pred: Dict[str, torch.Tensor]) -> torch.Tensor:
    prob = pred.get("probability")
    if prob is not None and prob.dim() == 2 and prob.shape[1] >= 2:
        return prob[:, 1]
    return pred["prediction"]


def make_device_metric(evaluator, n_classes=None):
    """metric_fn(y, pred_dict, val_mask) -> scalar for the sweep, for a
    binary evaluator; other evaluators are not ported yet."""
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator)

    if not isinstance(evaluator, BinaryClassificationEvaluator):
        raise NotImplementedError(
            f"{type(evaluator).__name__}: only the binary evaluator is "
            "ported (ROADMAP.md, queue 1, item 6)")
    metric = evaluator.default_metric
    threshold = evaluator.threshold

    def fn(y, pred, mask):
        s = _binary_scores(pred)
        if metric == "AuPR":
            return aupr_dev(y, s, mask)
        if metric == "AuROC":
            return auroc_dev(y, s, mask)
        return binary_confusion_dev(y, s, mask, threshold)[metric]
    return fn
