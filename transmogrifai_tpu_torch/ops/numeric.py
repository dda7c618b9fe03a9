"""Numeric vectorizers (scoring side): impute + null-indicator encoding.

The port's counterpart of the fitted models in the JAX package's
`ops/numeric.py`. Each input contributes `[filled value, null
indicator]` columns, computed as `v·m + fill·(1 − m)` and `1 − m` in f32
from the scalar column's value/mask pair — the same arithmetic on the
same f32 values, so the outputs agree with the JAX package exactly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import Transformer


class _NumericModelBase(Transformer):
    """Fitted numeric vectorizer: fill + optional null-indicator columns."""

    out_type = T.OPVector

    def __init__(self, fill_values: Sequence[float], track_nulls: bool = True,
                 descriptor: Optional[str] = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill_values = np.asarray(fill_values, dtype=np.float32)
        self.track_nulls = track_nulls
        self.descriptor = descriptor

    def device_apply(self, enc, dev):
        cols = []
        for i, d in enumerate(dev):
            v, m = d["value"], d["mask"]
            fill = torch.tensor(self.fill_values[i], dtype=torch.float32,
                                device=v.device)
            cols.append(v * m + fill * (1.0 - m))
            if self.track_nulls:
                cols.append(1.0 - m)
        return torch.stack(cols, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            cols.append(VectorColumnMetadata(
                parent_name=f.name, parent_type=f.ftype.__name__,
                descriptor_value=self.descriptor))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()


class RealVectorizerModel(_NumericModelBase):
    pass


class IntegralVectorizerModel(_NumericModelBase):
    pass


class BinaryVectorizerModel(_NumericModelBase):
    pass
