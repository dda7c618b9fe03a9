"""Categorical pivots: the host-side helpers of the JAX package's
`ops/categorical.py` (which `SmartTextModel` and `SmartTextVectorizer`
use too) and its `OneHotVectorizer` / `OneHotModel`, the transmogrifier's
encoder of the PickList-like (pivot) group: per feature the top-K levels,
an OTHER column and a null indicator."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)


def top_k_levels(counter: Counter, top_k: int, min_support: int) -> List[str]:
    """Most frequent levels, count-desc then lexicographic for
    determinism."""
    eligible = [(c, lvl) for lvl, c in counter.items() if c >= min_support]
    eligible.sort(key=lambda t: (-t[0], t[1]))
    return [lvl for _, lvl in eligible[:top_k]]


def pivot_encode_ids(values, lut: Dict[str, int], k: int) -> np.ndarray:
    """Map level strings → ids with OTHER=k, NULL=k+1. None and float NaN
    are both missing."""
    out = np.full(len(values), k + 1, dtype=np.int32)  # NULL id
    for i, v in enumerate(values):
        if v is not None and v == v:
            out[i] = lut.get(v, k)
    return out


def one_hot_np(ids: np.ndarray, k: int, track_nulls: bool) -> np.ndarray:
    """Host-side dense pivot block: k levels + OTHER (+ NULL if tracked)."""
    block = np.zeros((len(ids), k + 2), dtype=np.float32)
    block[np.arange(len(ids)), ids] = 1.0
    return block if track_nulls else block[:, : k + 1]


class OneHotModel(Transformer):
    """Fitted pivot: per feature K level columns + OTHER + null
    indicator. The level ids are host work; the one-hot block is built on
    the device."""

    out_type = T.OPVector

    def __init__(self, vocabs: Sequence[Sequence[str]],
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocabs = [list(v) for v in vocabs]
        self.track_nulls = track_nulls
        self._lookups = [
            {lvl: i for i, lvl in enumerate(v)} for v in self.vocabs]

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        return [pivot_encode_ids(c.data, self._lookups[i],
                                 len(self.vocabs[i]))
                for i, c in enumerate(cols)]

    def device_apply(self, enc, dev):
        outs = []
        for i, ids in enumerate(enc):
            k = len(self.vocabs[i])
            oh = torch.nn.functional.one_hot(ids.long(), k + 2).to(
                torch.float32)  # levels + OTHER + NULL
            outs.append(oh if self.track_nulls else oh[:, : k + 1])
        return torch.cat(outs, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f, vocab in zip(self.input_features, self.vocabs):
            for lvl in list(vocab) + [OTHER_INDICATOR] + (
                    [NULL_INDICATOR] if self.track_nulls else []):
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=f.name, indicator_value=lvl))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"vocabs": self.vocabs, "track_nulls": self.track_nulls}


class OneHotVectorizer(Estimator):
    """N categorical text features → a top-K pivot each (count-descending
    levels with at least `min_support` rows, ties by the level)."""

    in_types = (T.Text, Ellipsis)
    out_type = T.OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        vocabs = []
        for c in cols:
            counter = Counter(s for s in c.data if s is not None)
            vocabs.append(top_k_levels(counter, self.top_k,
                                       self.min_support))
        return OneHotModel(vocabs, self.track_nulls)
