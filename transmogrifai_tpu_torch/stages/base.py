"""Stage abstraction: typed, lazily-wired transformers (scoring side).

The port's counterpart of the JAX package's `stages/base.py`. A fitted
`Transformer` splits into `host_prepare(columns) -> enc` (string/object
work, numpy) and `device_apply(enc, device_inputs) -> tensors` (torch ops
on the inputs' device). The compiled scorer moves each `enc` to the
scoring device before `device_apply` runs, so every device stage sees
tensors on one device.

Stages that hold large fitted arrays return them from
`device_constants(device)` as an `nn.Module` placed on that device; the
scorer builds it once and threads it back into `device_apply_with`.

The port keeps its OWN `StageRegistry`: the JAX package's registry is
keyed by bare class name, and the port's classes carry the same names,
so sharing one registry would let a process that loads both packages
resolve one package's saved stages to the other's classes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import (
    PREDICTION, SCALAR, VECTOR, Column, kind_of, to_host)
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.utils.uid import UID


class StageRegistry:
    """The port's class registry for stage deserialization."""

    _classes: Dict[str, type] = {}

    @classmethod
    def register(cls, stage_cls: type) -> None:
        cls._classes[stage_cls.__name__] = stage_cls

    @classmethod
    def get(cls, name: str) -> type:
        try:
            return cls._classes[name]
        except KeyError:
            raise KeyError(
                f"Stage class {name!r} is not ported to "
                f"transmogrifai_tpu_torch") from None


class Stage:
    """Base: wired inputs, one output feature, a uid."""

    out_type: type = T.OPVector

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or UID(type(self))
        self.input_features: Tuple = ()
        self._output = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        StageRegistry.register(cls)

    @property
    def operation_name(self) -> str:
        return type(self).__name__

    def output_ftype(self) -> type:
        return self.out_type

    def output_name(self) -> str:
        base = "-".join(f.name for f in self.input_features) or "raw"
        return f"{base}_{self.operation_name}_{self.uid}"

    def get_output(self):
        from transmogrifai_tpu_torch.features.feature import Feature
        if self._output is None:
            if not self.input_features:
                raise RuntimeError(
                    f"{self.operation_name}: no inputs wired")
            is_resp = all(f.is_response for f in self.input_features)
            self._output = Feature(
                name=self.output_name(), ftype=self.output_ftype(),
                origin_stage=self, parents=self.input_features,
                is_response=is_resp)
        return self._output

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid!r})"


def to_device(enc: Any, device) -> Any:
    """Move a host pytree (numpy arrays in dicts/lists) onto `device` as
    tensors; non-array leaves pass through."""
    if isinstance(enc, dict):
        return {k: to_device(v, device) for k, v in enc.items()}
    if isinstance(enc, (list, tuple)):
        return type(enc)(to_device(v, device) for v in enc)
    if isinstance(enc, np.ndarray):
        return torch.as_tensor(enc, device=device)
    if isinstance(enc, torch.Tensor):
        return enc.to(device)
    return enc


class Transformer(Stage):
    """A fitted, row-parallel operation."""

    jittable = True  # device_apply is tensor code the scorer may fuse

    def host_prepare(self, cols: Sequence[Optional[Column]]) -> Any:
        """Host-side encode of object-kind inputs → pytree of np arrays."""
        return None

    def device_apply(self, enc: Any, dev: Sequence[Any]) -> Any:
        """Tensor compute over the encoded + parent device values."""
        raise NotImplementedError(type(self).__name__)

    def device_constants(self, device) -> Optional[torch.nn.Module]:
        """Large fitted arrays as an `nn.Module` on `device` (built once
        by the scorer), or None when the stage holds nothing big."""
        return None

    def device_apply_with(self, consts: Any, enc: Any,
                          dev: Sequence[Any]) -> Any:
        return self.device_apply(enc, dev)

    def output_meta(self) -> Optional[VectorMetadata]:
        return None

    def transform(self, cols: Sequence[Column], device) -> Column:
        enc = to_device(self.host_prepare(cols), device)
        dev = [c.device_value(device) for c in cols]
        consts = self.device_constants(device)
        out = (self.device_apply_with(consts, enc, dev) if consts is not None
               else self.device_apply(enc, dev))
        return self._wrap(out)

    def _wrap(self, dev: Any) -> Column:
        out_t = self.output_ftype()
        k = kind_of(out_t)
        if k == VECTOR:
            return Column.vector(to_host(dev), self.output_meta())
        if k == SCALAR:
            return Column(out_t, {
                "value": to_host(dev["value"]).astype(np.float64),
                "mask": to_host(dev["mask"]).astype(bool)})
        if k == PREDICTION:
            return Column(out_t, {key: to_host(a) for key, a in dev.items()})
        raise TypeError(
            f"{self.operation_name}: device output cannot have host kind {k}")


class HostTransformer(Transformer):
    """Transformer producing host-kind output (text/list/map) — runs
    eagerly on the host in both scoring paths."""

    jittable = False

    def transform(self, cols: Sequence[Column], device) -> Column:
        raise NotImplementedError(type(self).__name__)


# Column kinds that never cross to the device (see data/columns.py).
HOST_KINDS = ("text", "list", "map")


def is_host_stage(stage) -> bool:
    """The host/device segmentation rule of the compiled scorer: a
    Transformer runs on the host when it subclasses HostTransformer OR
    sets jittable=False."""
    return isinstance(stage, Transformer) and (
        isinstance(stage, HostTransformer) or not stage.jittable)


class FeatureGeneratorStage(Stage):
    """Arity-0 origin of every raw feature: extracts one typed column from
    a Dataset, either a named column or a per-record extract function."""

    def __init__(self, name: str, ftype: type,
                 extract: Optional[Callable[[Dict[str, Any]], Any]] = None,
                 column: Optional[str] = None, is_response: bool = False,
                 null_fill: Any = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        from transmogrifai_tpu_torch.utils.fnser import decode_fn
        self.feature_name = name
        self.ftype = ftype
        self.extract = decode_fn(extract)
        self.column = column if column is not None else (
            name if extract is None else None)
        self.is_response = is_response
        self.null_fill = null_fill

    def output_ftype(self) -> type:
        return self.ftype

    def output_name(self) -> str:
        return self.feature_name

    def get_output(self):
        from transmogrifai_tpu_torch.features.feature import Feature
        if self._output is None:
            self._output = Feature(
                name=self.feature_name, ftype=self.ftype, origin_stage=self,
                parents=(), is_response=self.is_response)
        return self._output

    def materialize(self, dataset, allow_missing_response: bool = False
                    ) -> Column:
        if self.extract is not None:
            values = [self.extract(row) for row in dataset.to_rows()]
            return Column.from_values(self.ftype, values)
        if self.column not in dataset.columns:
            if self.is_response and allow_missing_response:
                # scoring data without the label column: a
                # type-appropriate placeholder
                fill = 0.0 if issubclass(self.ftype, T.OPNumeric) else None
                return Column.from_values(self.ftype, [fill] * len(dataset))
            raise KeyError(
                f"Raw feature {self.feature_name!r}: column {self.column!r} "
                f"not in dataset {dataset.names()}")
        values = dataset.column(self.column)
        if self.null_fill is not None:
            if values.dtype != object:  # typed numeric storage: NaN = missing
                values = np.where(np.isnan(values.astype(np.float64)),
                                  float(self.null_fill), values)
            else:
                values = np.array(
                    [self.null_fill if v is None else v for v in values],
                    dtype=object)
        return Column.from_values(self.ftype, values)
