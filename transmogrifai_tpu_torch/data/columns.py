"""Columnar physical representation of typed feature data.

This is where the row-level type lattice (`transmogrifai_tpu_torch.types`) meets
arrays. Each `Column` holds one feature's values for a whole batch in the
layout best suited to its kind:

- scalar (OPNumeric):  float64/int64 `value` + bool `mask` (True = present)
- text:                object ndarray of str|None
- list/set/geo:        object ndarray of list/frozenset
- map:                 object ndarray of dict
- vector (OPVector):   dense (n, d) float32 array + `VectorMetadata`
- prediction:          dict of arrays {prediction (n,), probability (n,k),
                       rawPrediction (n,k)}

The device contract: `Column.device_value(device)` returns the pytree of
torch tensors a stage's `device_apply` consumes, placed on `device` —
strings and other host-only kinds return None and must be encoded by a
stage's `host_prepare` (see stages.base). Host data stays numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.metadata import VectorMetadata

SCALAR, TEXT, LIST, MAP, VECTOR, PREDICTION = (
    "scalar", "text", "list", "map", "vector", "prediction")


def kind_of(ftype: type) -> str:
    if not (isinstance(ftype, type) and issubclass(ftype, T.FeatureType)):
        raise TypeError(f"{ftype!r} is not a FeatureType class")
    if issubclass(ftype, T.Prediction):
        return PREDICTION
    if issubclass(ftype, T.OPMap):
        return MAP
    if issubclass(ftype, T.OPVector):
        return VECTOR
    if issubclass(ftype, (T.OPList, T.OPSet)):
        return LIST
    if issubclass(ftype, T.OPNumeric):
        return SCALAR
    if issubclass(ftype, T.Text):
        return TEXT
    raise TypeError(f"No columnar kind for {ftype.__name__}")


def _is_integral(ftype: type) -> bool:
    return issubclass(ftype, T.Integral)


@dataclass
class Column:
    """One feature's values for a batch, in columnar layout."""

    ftype: type
    data: Any
    meta: Optional[VectorMetadata] = None

    @property
    def kind(self) -> str:
        return kind_of(self.ftype)

    def __len__(self) -> int:
        k = self.kind
        if k == SCALAR:
            return int(self.data["value"].shape[0])
        if k == VECTOR:
            return int(self.data.shape[0])
        if k == PREDICTION:
            return int(self.data["prediction"].shape[0])
        return int(self.data.shape[0])

    # ------------------------------------------------------------------ #
    # construction                                                       #
    # ------------------------------------------------------------------ #

    @staticmethod
    def from_values(ftype: type, values: Sequence[Any]) -> "Column":
        """Build a column from raw python values (each may be a FeatureType
        instance or a plain value acceptable to `ftype`)."""
        k = kind_of(ftype)
        n = len(values)

        def unwrap(v):
            if isinstance(v, T.FeatureType):
                return v.value
            return ftype(v).value  # validate via the type

        if k == SCALAR:
            dtype = np.int64 if _is_integral(ftype) else np.float64
            arr = np.asarray(values)
            if arr.dtype != object:
                # fast path: typed numeric storage (Dataset keeps numeric
                # columns as float arrays with NaN for missing)
                f = arr.astype(np.float64, copy=False)
                mask = ~np.isnan(f)
                if issubclass(ftype, T.NonNullable) and not mask.all():
                    raise T.FeatureTypeError(
                        f"{ftype.__name__} cannot be empty "
                        f"({int((~mask).sum())} missing values)")
                out = np.where(mask, f, 0.0).astype(dtype)
                return Column(ftype, {"value": out, "mask": mask})
            out = np.zeros(n, dtype=dtype)
            mask = np.zeros(n, dtype=bool)
            for i, v in enumerate(values):
                u = unwrap(v)
                if u is not None:
                    out[i] = u
                    mask[i] = True
            return Column(ftype, {"value": out, "mask": mask})
        if k == VECTOR:
            rows = [np.asarray(unwrap(v), dtype=np.float32) for v in values]
            if n == 0:
                return Column(ftype, np.zeros((0, 0), dtype=np.float32))
            width = max((r.size for r in rows), default=0)
            arr = np.zeros((n, width), dtype=np.float32)
            for i, r in enumerate(rows):
                arr[i, : r.size] = r
            return Column(ftype, arr)
        if k == PREDICTION:
            preds = [T.Prediction(unwrap(v)) for v in values]
            width = max((len(p.probability) for p in preds), default=0)
            rwidth = max((len(p.raw_prediction) for p in preds), default=0)
            data = {
                "prediction": np.array([p.prediction for p in preds], dtype=np.float64),
                "probability": np.zeros((n, width), dtype=np.float64),
                "rawPrediction": np.zeros((n, rwidth), dtype=np.float64),
            }
            for i, p in enumerate(preds):
                pr, rw = p.probability, p.raw_prediction
                data["probability"][i, : len(pr)] = pr
                data["rawPrediction"][i, : len(rw)] = rw
            return Column(ftype, data)
        # host-object kinds; str/None text cells skip FeatureType
        # construction — the per-value validation round-trip dominated
        # host encode at scale
        arr = np.empty(n, dtype=object)
        if k == TEXT:
            for i, v in enumerate(values):
                arr[i] = v if (v is None or type(v) is str) else unwrap(v)
        else:
            for i, v in enumerate(values):
                u = unwrap(v)
                arr[i] = None if (u is None or len(u) == 0) else u
        return Column(ftype, arr)

    @staticmethod
    def vector(arr, meta: VectorMetadata) -> "Column":
        return Column(T.OPVector, arr, meta=meta)

    # ------------------------------------------------------------------ #
    # access                                                             #
    # ------------------------------------------------------------------ #

    def to_values(self) -> List[T.FeatureType]:
        """Row-level typed values (tests and local scoring), as the JAX
        package's `Column.to_values` gives them."""
        k = self.kind
        n = len(self)
        if k == SCALAR:
            val = to_host(self.data["value"])
            mask = to_host(self.data["mask"])
            return [self.ftype(val[i].item() if mask[i] else None)
                    for i in range(n)]
        if k == VECTOR:
            arr = to_host(self.data)
            return [T.OPVector(arr[i]) for i in range(n)]
        if k == PREDICTION:
            d = {key: to_host(a) for key, a in self.data.items()}
            return [T.Prediction.build(
                float(d["prediction"][i]),
                raw_prediction=np.asarray(d["rawPrediction"][i]).tolist(),
                probability=np.asarray(d["probability"][i]).tolist())
                for i in range(n)]
        return [self.ftype(self.data[i]) for i in range(n)]

    def take(self, idx) -> "Column":
        """Row subset (numpy fancy index or bool mask)."""
        k = self.kind
        if k == SCALAR:
            return Column(self.ftype, {
                "value": np.asarray(self.data["value"])[idx],
                "mask": np.asarray(self.data["mask"])[idx]})
        if k == PREDICTION:
            return Column(self.ftype, {key: np.asarray(a)[idx]
                                       for key, a in self.data.items()})
        if k == VECTOR:
            return Column(self.ftype, to_host(self.data)[idx],
                          meta=self.meta)
        return Column(self.ftype, self.data[idx])

    def host_value(self):
        """The numpy pytree a device stage consumes, before it moves to the
        device (the JAX package's `device_value`); None for host-only
        kinds. Scalars become f32 value/mask pairs (value 0 where
        missing), vectors an (n, d) array, predictions a dict of
        arrays."""
        k = self.kind
        if k == SCALAR:
            v = np.asarray(self.data["value"], dtype=np.float64)
            m = np.asarray(self.data["mask"])
            return {"value": np.where(m, v, 0.0).astype(np.float32),
                    "mask": m.astype(np.float32)}
        if k == VECTOR:
            return to_host(self.data)
        if k == PREDICTION:
            return {key: to_host(a) for key, a in self.data.items()}
        return None

    def device_value(self, device):
        """`host_value()` as tensors on `device` (vector and prediction
        data already on a device move from there); None for host-only
        kinds."""
        k = self.kind
        if k == VECTOR:
            return _to_tensor(self.data, device)
        if k == PREDICTION:
            return {key: _to_tensor(a, device) for key, a in self.data.items()}
        hv = self.host_value()
        if hv is None:
            return None
        return {key: _to_tensor(a, device) for key, a in hv.items()}

def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def to_host(a) -> np.ndarray:
    """numpy view of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
