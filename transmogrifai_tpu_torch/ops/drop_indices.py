"""DropIndicesByTransformer: drop vector columns by a metadata predicate.

The port's counterpart of the JAX package's `ops/drop_indices.py`
(DropIndicesByTransformer.scala): the predicate receives each column's
`VectorColumnMetadata`, and the columns it matches are removed. The
kept indices resolve from the input's metadata (the column's in a
transform, the input stage's in the compiled scorer) and the device part
is one column gather.

A saved model holds the predicate by name, so it must be a registered
(`utils.fnser.extract_fn`) or importable module-level function: the port
saves no pickled functions (F8 in ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.stages.base import ConstantArrays, Transformer
from transmogrifai_tpu_torch.utils.fnser import decode_fn, encode_fn


class DropIndicesByTransformer(Transformer):
    """OPVector → OPVector without the columns whose metadata matches
    `predicate`."""

    in_types = (T.OPVector,)
    out_type = T.OPVector

    def __init__(self, predicate: Callable, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.predicate = decode_fn(predicate)
        self._indices = None
        self._meta = None

    def _resolve(self, meta: Optional[VectorMetadata], d: int) -> None:
        if meta is None or meta.size != d:
            raise ValueError(
                "DropIndicesByTransformer requires vector column metadata")
        keep = [i for i, c in enumerate(meta.columns)
                if not self.predicate(c)]
        if not keep:
            raise ValueError("predicate matched every column")
        self._indices = keep
        self._meta = meta.select(keep)

    def _input_meta(self) -> Optional[VectorMetadata]:
        stage = self.input_features[0].origin_stage
        return stage.output_meta() if isinstance(stage, Transformer) \
            else None

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        c = cols[0]
        if c is not None:  # a transform: the column carries its metadata
            self._resolve(c.meta, int(np.shape(c.data)[1]))
        return None

    def device_constants(self, device):
        if self._indices is None:
            meta = self._input_meta()
            self._resolve(meta, meta.size if meta is not None else -1)
        return ConstantArrays([np.asarray(self._indices,
                                          dtype=np.int64)]).to(device)

    def device_apply_with(self, consts, enc, dev):
        return torch.index_select(dev[0], 1, consts[0])

    def output_meta(self) -> Optional[VectorMetadata]:
        if self._meta is None and self.input_features:
            meta = self._input_meta()
            if meta is not None:
                self._resolve(meta, meta.size)
        return self._meta

    def get_params(self):
        return {"predicate": encode_fn(self.predicate)}
