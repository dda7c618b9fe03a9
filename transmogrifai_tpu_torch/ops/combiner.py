"""VectorsCombiner: N OPVector features → one, with metadata union
(the port's counterpart of the JAX package's `ops/combiner.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.stages.base import Transformer


class VectorsCombiner(Transformer):
    in_types = (T.OPVector, Ellipsis)
    out_type = T.OPVector

    def device_apply(self, enc, dev):
        return torch.cat(list(dev), dim=1)

    def output_meta(self) -> Optional[VectorMetadata]:
        metas = []
        for f in self.input_features:
            stage = f.origin_stage
            m = stage.output_meta() if isinstance(stage, Transformer) else None
            if m is None:
                return None  # an input with unknown lineage poisons the union
            metas.append(m)
        return VectorMetadata.union(self.output_name(), metas)
