"""SanityCheckerModel (scoring side): a static column gather of the kept
indices — the port's counterpart of the fitted model in the JAX package's
`automl/sanity_checker.py`."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.stages.base import Transformer


class SanityCheckerModel(Transformer):
    """Fitted checker: keeps the columns `indices` of the (label, vector)
    input's vector, in that order."""

    out_type = T.OPVector

    def __init__(self, indices: Sequence[int], meta: Optional[Dict] = None,
                 summary: Optional[Dict] = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.indices = list(int(i) for i in indices)
        self._meta_json = (meta.to_json() if isinstance(meta, VectorMetadata)
                           else meta)
        self.summary = summary

    def device_apply(self, enc, dev):
        X = dev[-1]
        idx = torch.as_tensor(self.indices, dtype=torch.long, device=X.device)
        return X.index_select(1, idx)

    def output_meta(self) -> Optional[VectorMetadata]:
        if self._meta_json is None:
            return None
        return VectorMetadata.from_json(self._meta_json)
