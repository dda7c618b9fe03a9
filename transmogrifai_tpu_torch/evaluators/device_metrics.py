"""Masked metrics on the device, for the batched sweep and early stopping.

The port's counterpart of the JAX package's `evaluators/device_metrics.py`.
Folds are 0/1 row masks over a fixed training matrix, so a metric takes
(y, scores, mask) and a masked row contributes zero weight everywhere; the
values equal the host metrics (`evaluators/metrics.py`) on the unmasked
rows.

`aupr_dev`, `auroc_dev` and `binary_confusion_dev` are plain torch (sort,
searchsorted, cumsum). Three device programs have two forms each: a
kernel written by hand in CUDA C++ and a plain PyTorch version (`*_plain`):

- the binned AuPR (`binned_aupr`, K8; `csrc/binned_aupr.cu`), used by
  `aupr_binned_dev` and by the boosting rounds' early-stopping metric;
- the masked confusion counts of P (config, fold) pairs
  (`confusion_counts`, K8-mc; `csrc/eval_metrics.cu`), under
  `multiclass_dev`;
- the masked regression sums of P pairs (`regression_moments`, K8-reg;
  `csrc/eval_metrics.cu`), under `regression_dev`.

The wrappers pick by the tensor's device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

`make_device_metric` gives the sweep one metric call per group of pairs:
metric_fn(y, preds, masks) → (P,) values, one launch of K8-mc or K8-reg
for all P pairs of a multiclass or regression group.
"""

from __future__ import annotations

import ctypes
import functools
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


def bucket_sigmoid(m: torch.Tensor) -> torch.Tensor:
    """The f32 score of a margin for bucketing: 1 / (1 + exp(−m)) in f64,
    rounded to f32 once. An f32 exp differs by an ulp or two between
    libraries and between the vector and scalar paths of one library, so
    a score within an ulp of a bucket edge could land on either side from
    one process to the next; the f64 formula rounds to the nearest f32
    score everywhere but within 2^-29 of an f32 rounding boundary. The
    K8 kernel computes the same."""
    return (1.0 / (1.0 + torch.exp(-m.to(torch.float64)))).to(torch.float32)


def score_bins(m: torch.Tensor, n_bins: int,
               from_margin: bool) -> torch.Tensor:
    """The bucket of each score: min(int(s · n_bins), n_bins − 1) with s =
    `bucket_sigmoid(m)` (margins) or m (scores), clipped to [0, 1]
    (NaN → 0)."""
    s = bucket_sigmoid(m) if from_margin else m
    s = torch.clamp(torch.nan_to_num(s, nan=0.0), 0.0, 1.0)
    return torch.clamp((s * n_bins).to(torch.int32), max=n_bins - 1)


def _shapes(m, y, w):
    if m.dim() != 2 or w.shape != m.shape or y.shape != m.shape[1:]:
        raise ValueError(
            f"binned_aupr: margins {tuple(m.shape)} and weights "
            f"{tuple(w.shape)} must be (P, n), labels {tuple(y.shape)} (n,)")


def _pair_bins(m, n_bins, from_margin):
    P = m.shape[0]
    return score_bins(m, n_bins, from_margin).long() + torch.arange(
        P, device=m.device)[:, None] * n_bins


def _pr_area(hp: torch.Tensor, ha: torch.Tensor) -> torch.Tensor:
    """(P,) f32 AuPR from (P, n_bins) bucket sums: reversed running sums,
    the PR trapezoid from (r = 0, p = 1) summed in f64 and rounded once;
    0 without positives."""
    P = hp.shape[0]
    tp = torch.cumsum(hp.double().flip(1), 1)
    n_at = torch.cumsum(ha.double().flip(1), 1)
    n_pos = tp[:, -1:]
    prec = torch.where(n_at > 0, tp / torch.clamp(n_at, min=1e-300),
                       torch.ones_like(tp))
    rec = torch.where(n_pos > 0, tp / torch.clamp(n_pos, min=1e-300),
                      torch.zeros_like(tp))
    zeros = torch.zeros((P, 1), dtype=torch.float64, device=hp.device)
    r = torch.cat([zeros, rec], 1)
    p = torch.cat([zeros + 1.0, prec], 1)
    area = ((r[:, 1:] - r[:, :-1]) * (p[:, 1:] + p[:, :-1]) * 0.5).sum(1)
    area = torch.where(n_pos[:, 0] > 0, area, torch.zeros_like(area))
    return area.to(torch.float32)


def binned_aupr_plain(m: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      n_bins: int, from_margin: bool) -> torch.Tensor:
    """(P,) f32 AuPR over n_bins score buckets: `bincount` histograms of
    w·y and w, reversed running sums, the PR trapezoid from (r = 0,
    p = 1) summed in f64 and rounded once; 0 without positives."""
    _shapes(m, y, w)
    P, n = m.shape
    b = _pair_bins(m, n_bins, from_margin).reshape(-1)
    hp = torch.bincount(b, weights=(w * y).reshape(-1),
                        minlength=P * n_bins).reshape(P, n_bins)
    ha = torch.bincount(b, weights=w.reshape(-1),
                        minlength=P * n_bins).reshape(P, n_bins)
    return _pr_area(hp, ha)


# blocks of 1024 threads the H100's 132 SMs hold at once; rows a block at
# least, so that zeroing and writing out its histogram stays small beside
# its rows; the scratch of the blocks' partial histograms at most
_AUPR_BLOCKS = 2 * 132
_AUPR_MIN_ROWS = 16384
_AUPR_SCRATCH_BYTES = 1 << 28


def aupr_row_blocks(P: int, n: int, n_bins: int):
    """(G, chunk): the K8 kernel splits each pair's rows into G ranges of
    `chunk` rows, one block a range, fixed from the shapes alone (no
    device count): P × G fills the card where the rows allow. G is at
    most n // `_AUPR_MIN_ROWS`, so with G > 1 every range but the last
    holds chunk ≥ `_AUPR_MIN_ROWS` rows; G = 1 below 2 × `_AUPR_MIN_ROWS`
    rows a pair or from 133 pairs on."""
    G = max(1, min(_AUPR_BLOCKS // max(P, 1), n // _AUPR_MIN_ROWS,
                   _AUPR_SCRATCH_BYTES // (8 * max(P, 1) * n_bins)))
    return G, -(-n // G)


def binned_aupr_blocks_plain(m: torch.Tensor, y: torch.Tensor,
                             w: torch.Tensor, n_bins: int, from_margin: bool,
                             blocks: int) -> torch.Tensor:
    """The K8 kernel's partition in plain PyTorch: each pair's rows cut
    into `blocks` ranges of ⌈n / blocks⌉ rows, each range's f32
    histograms summed in range order, then `binned_aupr_plain`'s curve.
    Bit-equal to `binned_aupr_plain` wherever the f32 bucket sums are
    exact (integer-valued weights below 2^24)."""
    _shapes(m, y, w)
    P, n = m.shape
    chunk = -(-n // blocks)
    b = _pair_bins(m, n_bins, from_margin)
    hp = torch.zeros(P * n_bins, dtype=torch.float32, device=m.device)
    ha = torch.zeros_like(hp)
    for g in range(blocks):
        sl = slice(g * chunk, min(n, (g + 1) * chunk))
        bg = b[:, sl].reshape(-1)
        hp = hp + torch.bincount(bg, weights=(w[:, sl] * y[sl]).reshape(-1),
                                 minlength=P * n_bins)
        ha = ha + torch.bincount(bg, weights=w[:, sl].reshape(-1),
                                 minlength=P * n_bins)
    return _pr_area(hp.reshape(P, n_bins), ha.reshape(P, n_bins))


# m, y, w; P, n, n_bins, from_margin, G, chunk; part, out, stream
_AUPR_ARGS = cuda_build.register(
    "binned_aupr", "binned_aupr",
    (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 3)
cuda_build.register("binned_aupr", "binned_aupr_shared_max_bins", ())


def _binned_aupr_cuda(m, y, w, n_bins, from_margin):
    _shapes(m, y, w)
    for name, t in (("labels", y), ("weights", w)):
        if t.device != m.device:
            raise ValueError(f"binned_aupr: margins on {m.device}, {name} "
                             f"on {t.device}")
    if not all(t.dtype == torch.float32 for t in (m, y, w)):
        raise ValueError("binned_aupr: margins, labels and weights must be "
                         "f32")
    if n_bins < 1:
        raise ValueError(f"binned_aupr: n_bins {n_bins} < 1")
    P, n = m.shape
    out = m.new_empty(P)
    if P == 0:
        return out
    m, y, w = m.contiguous(), y.contiguous(), w.contiguous()
    fn = cuda_build.entry("binned_aupr", "binned_aupr")
    G, chunk = aupr_row_blocks(P, n, n_bins)
    part = None
    # above the kernel's shared-memory limit a block's histograms live in
    # the scratch whatever G is (the kernel refuses a launch without it)
    if G > 1 or n_bins > cuda_build.entry(
            "binned_aupr", "binned_aupr_shared_max_bins")():
        part = m.new_empty(P * G * 2 * n_bins)
    err = cuda_build.launch(
        m.get_device(), fn, m.data_ptr(), y.data_ptr(), w.data_ptr(), P, n,
        n_bins, int(bool(from_margin)), G, chunk,
        None if part is None else part.data_ptr(), out.data_ptr())
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


# --------------------------------------------------------------------------- #
# K8-mc: masked confusion counts, K8-reg: masked regression sums             #
# --------------------------------------------------------------------------- #

# the H100's SMs, and what one holds: warps, blocks, shared memory (a block
# may take 227 KB of it); a K8-mc block's warps; rows a block at least, 16
# a thread of K8-reg's 256 (fewer lost on the card: a block's fixed cost,
# its reductions and its cross-block sums, outweighed its rows; in
# global-scratch mode at least an eighth of a block's cells, so that
# zeroing and summing them stays small beside its rows); the scratch of the
# blocks' partials at most. Within those, the plans give every SM as many
# blocks as it holds, in one wave.
_SMS = 132
_SM_WARPS = 64
_SM_BLOCKS = 32
_SM_SMEM_BYTES = 228 * 1024
_CONF_WARPS = 8
_CONF_SMEM_BYTES = 227 * 1024
_EVAL_MIN_ROWS = 4096
_EVAL_SCRATCH_BYTES = 1 << 28
_REG_WARPS = 8  # K8-reg's 256 threads a block
_MAX_GRID_Y = 65535  # pairs on blockIdx.y


@functools.lru_cache(maxsize=4096)
def confusion_plan(P: int, n: int, k: int):
    """(G, chunk, warps, shared) of the K8-mc launch: each pair's rows in
    G ranges of `chunk` rows, one block of `warps` warps a range; each
    warp's f64 histogram of k·k cells in shared memory (`shared`, while a
    block holds `warps` of them: k ≤ 170) or, one warp a block, in its
    slice of the scratch. Fixed from the shapes alone: P × G blocks fill
    the SMs (as many as an SM holds, in one wave) where the rows allow,
    G = 1 for small inputs."""
    cells = k * k
    warps = min(_CONF_WARPS, _CONF_SMEM_BYTES // (8 * cells))
    shared = warps >= 1
    warps = max(warps, 1)
    if shared:  # an SM's blocks by warps and by shared memory (+1 KB each)
        per_sm = min(_SM_WARPS // warps, _SM_BLOCKS,
                     _SM_SMEM_BYTES // (warps * 8 * cells + 1024))
        min_rows = _EVAL_MIN_ROWS
    else:
        per_sm, min_rows = _SM_BLOCKS, max(_EVAL_MIN_ROWS, cells // 8)
    G = max(1, min(_SMS * per_sm // max(P, 1), n // min_rows,
                   _EVAL_SCRATCH_BYTES // (8 * max(P, 1) * cells)))
    return G, -(-n // G), warps, shared


@functools.lru_cache(maxsize=4096)
def moments_row_blocks(P: int, n: int):
    """(G, chunk) of the K8-reg launch: each pair's rows in G ranges of
    `chunk` rows, one block a range, P × G blocks filling the SMs where the
    rows allow (G = 1: one launch, both passes in the pair's block)."""
    G = max(1, min(_SMS * (_SM_WARPS // _REG_WARPS) // max(P, 1),
                   n // _EVAL_MIN_ROWS))
    return G, -(-n // G)


# y, pred, mask; P, n, k, G, chunk, warps, shared; part, out, stream
cuda_build.register("eval_metrics", "confusion_counts",
                    (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7
                    + (ctypes.c_void_p,) * 3)
# pred, y, mask; P, n, G, chunk; part, out, stream
cuda_build.register("eval_metrics", "regression_moments",
                    (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                    + (ctypes.c_void_p,) * 3)


def _eval_shapes(name, y, pred, mask):
    if pred.dim() != 2 or mask.shape != pred.shape \
            or y.shape != pred.shape[1:]:
        raise ValueError(
            f"{name}: predictions {tuple(pred.shape)} and masks "
            f"{tuple(mask.shape)} must be (P, n), labels {tuple(y.shape)} "
            "(n,)")


def confusion_counts_plain(y: torch.Tensor, pred: torch.Tensor,
                           mask: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k, k) f32: conf[p, y, pred[p]] summed over the rows' mask[p]
    weights, labels and predictions clipped to [0, k − 1]; one `bincount`
    over pair-offset cells, summed in f64 and rounded once."""
    _eval_shapes("confusion_counts", y, pred, mask)
    P, n = pred.shape
    yi = torch.clamp(y.long(), 0, k - 1)
    pi = torch.clamp(pred.long(), 0, k - 1)
    cell = (torch.arange(P, device=pred.device)[:, None] * (k * k)
            + yi[None, :] * k + pi)
    conf = torch.bincount(cell.reshape(-1),
                          weights=mask.reshape(-1).to(torch.float64),
                          minlength=P * k * k)
    return conf.to(torch.float32).reshape(P, k, k)


def _confusion_counts_cuda(y, pred, mask, k):
    _eval_shapes("confusion_counts", y, pred, mask)
    for name, t in (("labels", y), ("masks", mask)):
        if t.device != pred.device:
            raise ValueError(f"confusion_counts: predictions on "
                             f"{pred.device}, {name} on {t.device}")
    if y.dtype != torch.int32 or pred.dtype != torch.int32 \
            or mask.dtype != torch.float32:
        raise ValueError("confusion_counts: labels and predictions must be "
                         "int32, masks f32")
    if k < 1:
        raise ValueError(f"confusion_counts: {k} classes, fewer than 1")
    P, n = pred.shape
    if P > _MAX_GRID_Y:
        raise ValueError(f"confusion_counts: {P} pairs exceed the launch "
                         f"grid's {_MAX_GRID_Y}")
    out = torch.empty((P, k, k), dtype=torch.float32, device=pred.device)
    if P == 0:
        return out
    y, pred, mask = y.contiguous(), pred.contiguous(), mask.contiguous()
    G, chunk, warps, shared = confusion_plan(P, n, k)
    part = (torch.empty(P * G * k * k, dtype=torch.float64,
                        device=pred.device)
            if G > 1 or not shared else None)
    err = cuda_build.launch(
        pred.get_device(), cuda_build.entry("eval_metrics",
                                            "confusion_counts"),
        y.data_ptr(), pred.data_ptr(), mask.data_ptr(), P, n, k, G, chunk,
        warps, int(shared), None if part is None else part.data_ptr(),
        out.data_ptr())
    cuda_build.check("confusion_counts", err)
    cuda_build.count("confusion_counts")
    return out


def confusion_counts(y: torch.Tensor, pred: torch.Tensor,
                     mask: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k, k) f32 masked confusion counts of P prediction rows pred
    (P, n) int32 against labels y (n,) int32, with row weights mask (P, n)
    f32, labels and predictions clipped to [0, k − 1], any k ≥ 1. A CUDA
    tensor launches the K8-mc kernel (or raises); a CPU tensor takes the
    plain version."""
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"confusion_counts: unsupported device "
                         f"{pred.device}")
    if pred.is_cuda:
        return _confusion_counts_cuda(y, pred, mask, k)
    return confusion_counts_plain(y, pred, mask, k)


def regression_moments_plain(pred: torch.Tensor, y: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """(P, 5) f32 per pair: [Σw, Σe², Σ|e|, Σy·w, Σt²·w] with e = (pred −
    y)·w and t = y − ȳ, ȳ = f32(Σy·w) / max(f32(Σw), 1): the elementwise
    terms in f32 as the JAX formula rounds them, each sum in f64 rounded
    once."""
    _eval_shapes("regression_moments", y, pred, mask)
    e = (pred - y) * mask

    def total(v):
        return v.to(torch.float64).sum(1).to(torch.float32)

    sw, syw = total(mask), total(y * mask)
    ybar = syw / torch.clamp(sw, min=1.0)
    t = y[None, :] - ybar[:, None]
    return torch.stack([sw, total(e * e), total(torch.abs(e)), syw,
                        total((t * t) * mask)], dim=1)


def _regression_moments_cuda(pred, y, mask):
    _eval_shapes("regression_moments", y, pred, mask)
    for name, t in (("labels", y), ("masks", mask)):
        if t.device != pred.device:
            raise ValueError(f"regression_moments: predictions on "
                             f"{pred.device}, {name} on {t.device}")
    if not all(t.dtype == torch.float32 for t in (pred, y, mask)):
        raise ValueError("regression_moments: predictions, labels and "
                         "masks must be f32")
    P, n = pred.shape
    if P > _MAX_GRID_Y:
        raise ValueError(f"regression_moments: {P} pairs exceed the launch "
                         f"grid's {_MAX_GRID_Y}")
    out = torch.empty((P, 5), dtype=torch.float32, device=pred.device)
    if P == 0:
        return out
    pred, y, mask = pred.contiguous(), y.contiguous(), mask.contiguous()
    G, chunk = moments_row_blocks(P, n)
    # the blocks' f64 sums (4 of pass 1, 1 of pass 2), then P uint32
    # arrival counters
    part = (torch.empty(5 * P * G + -(-P // 2), dtype=torch.float64,
                        device=pred.device) if G > 1 else None)
    err = cuda_build.launch(
        pred.get_device(), cuda_build.entry("eval_metrics",
                                            "regression_moments"),
        pred.data_ptr(), y.data_ptr(), mask.data_ptr(), P, n, G, chunk,
        None if part is None else part.data_ptr(), out.data_ptr())
    cuda_build.check("regression_moments", err)
    cuda_build.count("regression_moments")
    return out


def regression_moments(pred: torch.Tensor, y: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """(P, 5) f32 masked sums of P prediction rows pred (P, n) against
    labels y (n,) with row weights mask (P, n), all f32 (see
    `regression_moments_plain`). A CUDA tensor launches the K8-reg kernel
    (or raises); a CPU tensor takes the plain version."""
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"regression_moments: unsupported device "
                         f"{pred.device}")
    if pred.is_cuda:
        return _regression_moments_cuda(pred, y, mask)
    return regression_moments_plain(pred, y, mask)


def _as_pairs(v: torch.Tensor) -> torch.Tensor:
    return v[None, :] if v.dim() == 1 else v


def multiclass_dev(y: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
                   n_classes: int) -> Dict[str, torch.Tensor]:
    """Weighted-average Precision/Recall/F1 and Error of P pairs' class
    predictions pred (P, n) (or (n,)) over the masked confusion counts
    (K8-mc): (P,) values each ((), for one row of predictions).
    `n_classes` is an upper bound: an empty class has no support weight."""
    one = pred.dim() == 1
    pred, mask = _as_pairs(pred), _as_pairs(mask)
    conf = confusion_counts(y.to(torch.int32), pred.to(torch.int32),
                            mask.to(torch.float32), n_classes)
    tp = torch.diagonal(conf, dim1=1, dim2=2)
    support = conf.sum(2)
    pred_count = conf.sum(1)
    zero = torch.zeros_like(tp)
    prec_c = torch.where(pred_count > 0,
                         tp / torch.clamp(pred_count, min=1e-30), zero)
    rec_c = torch.where(support > 0, tp / torch.clamp(support, min=1e-30),
                        zero)
    f1_c = torch.where(prec_c + rec_c > 0,
                       2 * prec_c * rec_c
                       / torch.clamp(prec_c + rec_c, min=1e-30), zero)
    w = support / torch.clamp(support.sum(1, keepdim=True), min=1.0)
    err = 1.0 - tp.sum(1) / torch.clamp(mask.sum(1), min=1.0)
    out = {"Precision": (prec_c * w).sum(1), "Recall": (rec_c * w).sum(1),
           "F1": (f1_c * w).sum(1), "Error": err}
    return {k: v[0] for k, v in out.items()} if one else out


def regression_dev(y: torch.Tensor, pred: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted RMSE/MSE/MAE/R2 of P pairs' predictions pred (P, n) (or
    (n,)) from the masked sums (K8-reg): (P,) values each ((), for one row
    of predictions)."""
    one = pred.dim() == 1
    pred, mask = _as_pairs(pred), _as_pairs(mask)
    mom = regression_moments(pred.to(torch.float32), y.to(torch.float32),
                             mask.to(torch.float32))
    n = torch.clamp(mom[:, 0], min=1.0)
    mse = mom[:, 1] / n
    ss_tot = mom[:, 4]
    r2 = torch.where(ss_tot > 0,
                     1.0 - mom[:, 1] / torch.clamp(ss_tot, min=1e-30),
                     torch.zeros_like(ss_tot))
    out = {"RMSE": torch.sqrt(mse), "MSE": mse, "MAE": mom[:, 2] / n,
           "R2": r2}
    return {k: v[0] for k, v in out.items()} if one else out


def _binary_scores(pred: Dict[str, torch.Tensor]) -> torch.Tensor:
    prob = pred.get("probability")
    if prob is not None and prob.dim() == 2 and prob.shape[1] >= 2:
        return prob[:, 1]
    return pred["prediction"]


def make_device_metric(evaluator, n_classes=None):
    """metric_fn(y, preds, masks) -> (P,) values for the sweep: `preds` is
    one prediction dict per pair and `masks` (P, n) the pairs' validation
    rows. A multiclass or regression group takes one launch of K8-mc or
    K8-reg for all its pairs; the binary metrics sort per pair."""
    from transmogrifai_tpu_torch.evaluators.evaluators import (
        BinaryClassificationEvaluator, MultiClassificationEvaluator,
        RegressionEvaluator)

    metric = evaluator.default_metric
    if isinstance(evaluator, BinaryClassificationEvaluator):
        threshold = evaluator.threshold

        def one(y, pred, mask):
            s = _binary_scores(pred)
            if metric == "AuPR":
                return aupr_dev(y, s, mask)
            if metric == "AuROC":
                return auroc_dev(y, s, mask)
            return binary_confusion_dev(y, s, mask, threshold)[metric]

        def fn(y, preds, masks):
            return torch.stack([one(y, p, m) for p, m in zip(preds, masks)])
        return fn
    if isinstance(evaluator, MultiClassificationEvaluator):
        if n_classes is None:
            raise ValueError("make_device_metric: the multiclass metric "
                             "needs n_classes")

        def fn(y, preds, masks):
            pred = torch.stack([p["prediction"] for p in preds])
            return multiclass_dev(y, pred, masks, n_classes)[metric]
        return fn
    if isinstance(evaluator, RegressionEvaluator):
        def fn(y, preds, masks):
            pred = torch.stack([p["prediction"] for p in preds])
            return regression_dev(y, pred, masks)[metric]
        return fn
    raise NotImplementedError(
        f"{type(evaluator).__name__}: only the binary, multiclass and "
        "regression evaluators are ported")
