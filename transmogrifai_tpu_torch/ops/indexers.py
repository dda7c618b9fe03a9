"""String label indexing (the port's counterpart of the JAX package's
`ops/indexers.py`, `StringIndexerModel` and `OpStringIndexer`): a Text
column → RealNN indices, labels ordered by descending count with ties
broken by the label. Building and applying the vocabulary is host work;
the index column then moves to the device as a value/mask pair.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)

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
