"""String label indexing and its inverse (the port's counterpart of the
JAX package's `ops/indexers.py`): `OpStringIndexer` and
`OpStringIndexerNoFilter` map a Text column to RealNN indices, labels
ordered by descending count with ties broken by the label; building and
applying the vocabulary is host work, and the index column then moves to
the device as a value/mask pair. `OpIndexToString` and
`PredictionDeIndexer` map indices and predicted classes back to labels
(host text results).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, HostTransformer, Transformer)

ERROR, SKIP, KEEP = "error", "skip", "keep"


class StringIndexerModel(Transformer):
    """Fitted vocabulary: label → index (descending-count order). An
    unseen label raises (`error`), is masked out (`skip`) or takes the
    index len(labels) (`keep`)."""

    in_types = (T.Text,)
    out_type = T.RealNN
    jittable = False  # the input is a host text column

    def __init__(self, labels: Sequence[str], handle_invalid: str = ERROR,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.labels = list(labels)
        self.handle_invalid = handle_invalid
        self._index: Dict[str, int] = {
            lbl: i for i, lbl in enumerate(self.labels)}

    def host_prepare(self, cols):
        vals = cols[0].data
        n = len(vals)
        idx = np.zeros(n, dtype=np.float64)
        mask = np.ones(n, dtype=bool)
        unseen = float(len(self.labels))
        for i, v in enumerate(vals):
            if v is None:
                mask[i] = False
                continue
            j = self._index.get(v)
            if j is None:
                if self.handle_invalid == ERROR:
                    raise ValueError(
                        f"Unseen label {v!r} in {self.operation_name}")
                if self.handle_invalid == SKIP:
                    mask[i] = False
                else:  # KEEP
                    idx[i] = unseen
            else:
                idx[i] = float(j)
        return {"value": idx, "mask": mask}

    def device_apply(self, enc, dev):
        return {"value": enc["value"].to(torch.float32),
                "mask": enc["mask"].to(torch.float32)}

    def get_params(self):
        return {"labels": self.labels, "handle_invalid": self.handle_invalid}


class OpStringIndexer(Estimator):
    """Text → RealNN index; labels ordered by descending frequency, ties
    by the label."""

    in_types = (T.Text,)
    out_type = T.RealNN

    def __init__(self, handle_invalid: str = ERROR, uid: Optional[str] = None):
        if handle_invalid not in (ERROR, SKIP, KEEP):
            raise ValueError("handle_invalid must be one of error/skip/keep")
        super().__init__(uid=uid, handle_invalid=handle_invalid)
        self.handle_invalid = handle_invalid

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        counts: Dict[str, int] = {}
        for v in cols[0].data:
            if v is not None:
                counts[v] = counts.get(v, 0) + 1
        labels = sorted(counts, key=lambda lbl: (-counts[lbl], lbl))
        return StringIndexerModel(labels, self.handle_invalid)


class OpStringIndexerNoFilter(OpStringIndexer):
    """Unseen labels take the extra index len(labels)
    (OpStringIndexerNoFilter.scala)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(handle_invalid=KEEP, uid=uid)


def _indexer_labels(stage, labels: Optional[List[str]]) -> List[str]:
    """Explicit labels, else those of the StringIndexerModel that made the
    stage's first input."""
    if labels is not None:
        return labels
    origin = stage.input_features[0].origin_stage
    if isinstance(origin, StringIndexerModel):
        return origin.labels
    raise ValueError(f"{stage.operation_name} needs labels= or a "
                     "StringIndexerModel parent")


class OpIndexToString(HostTransformer):
    """RealNN index → Text, through explicit labels or those of the
    StringIndexerModel that produced the index; an index outside them
    gives `unseen_name`."""

    in_types = (T.OPNumeric,)
    out_type = T.Text

    def __init__(self, labels: Optional[Sequence[str]] = None,
                 unseen_name: str = "UnseenLabel", uid: Optional[str] = None):
        super().__init__(uid=uid, labels=list(labels) if labels else None,
                         unseen_name=unseen_name)
        self.labels = list(labels) if labels else None
        self.unseen_name = unseen_name

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        labels = _indexer_labels(self, self.labels)
        v = np.asarray(to_host(cols[0].data["value"]), dtype=np.float64)
        m = np.asarray(to_host(cols[0].data["mask"])).astype(bool)
        out = np.empty(len(v), dtype=object)
        for i in range(len(v)):
            if m[i]:
                j = int(v[i])
                out[i] = (labels[j] if 0 <= j < len(labels)
                          else self.unseen_name)
            else:
                out[i] = None
        return Column(T.Text, out)


class PredictionDeIndexer(HostTransformer):
    """(indexed response, Prediction) → Text: the predicted class as its
    original label (PredictionDeIndexer.scala); None outside the labels."""

    in_types = (T.OPNumeric, T.Prediction)
    out_type = T.Text

    def __init__(self, labels: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, labels=list(labels) if labels else None)
        self.labels = list(labels) if labels else None

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        labels = _indexer_labels(self, self.labels)
        pred = np.asarray(to_host(cols[1].data["prediction"]),
                          dtype=np.float64)
        out = np.empty(len(pred), dtype=object)
        for i, p in enumerate(pred):
            j = int(p)
            out[i] = labels[j] if 0 <= j < len(labels) else None
        return Column(T.Text, out)
