"""VectorsCombiner: N OPVector features → one, with metadata union
(the port's counterpart of the JAX package's `ops/combiner.py`).

The combined column's metadata is the union of the metadata of the
columns it combines, so it describes the data even when those columns
come from models other than the graph's (workflow-level CV's fold
refits, whose one-hot and hashing widths follow the fold's rows). The
JAX package unions its input stages' metadata instead, which there are
the globally fitted ones: a fold's SanityChecker then reads columns past
the fold's matrix (ROADMAP, F17)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.stages.base import Transformer


class VectorsCombiner(Transformer):
    in_types = (T.OPVector, Ellipsis)
    out_type = T.OPVector

    def device_apply(self, enc, dev):
        return torch.cat(list(dev), dim=1)

    def transform(self, cols: Sequence[Column], device) -> Column:
        out = super().transform(cols, device)
        metas = [c.meta for c in cols]
        if all(m is not None for m in metas):
            out.meta = VectorMetadata.union(self.output_name(), metas)
        return out

    def output_meta(self) -> Optional[VectorMetadata]:
        metas = []
        for f in self.input_features:
            stage = f.origin_stage
            m = stage.output_meta() if isinstance(stage, Transformer) else None
            if m is None:
                return None  # an input with unknown lineage poisons the union
            metas.append(m)
        return VectorMetadata.union(self.output_name(), metas)
