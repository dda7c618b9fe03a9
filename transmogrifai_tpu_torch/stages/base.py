"""Stage abstraction: typed, lazily-wired estimators and transformers.

The port's counterpart of the JAX package's `stages/base.py`. An
`Estimator` learns its params in `fit(cols, ctx)` and returns the fitted
`Transformer`, which takes over the estimator's output feature. A fitted
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

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import (
    PREDICTION, SCALAR, VECTOR, Column, kind_of, to_host)
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.utils.uid import UID


@dataclass
class FitContext:
    """Per-fit environment: row count, rng seed and the device the fit's
    tensors live on. `child(salt)` derives a stage's context with the JAX
    package's seed rule, so seeded host draws (the GBT refit's holdout)
    are the same rows in both packages.

    `cv_refit` is set by the workflow only on the ModelSelector's context
    under workflow-level CV (`Workflow.with_workflow_cv()`): a callable
    `fold_rows -> (n_total, d) feature matrix` that refits the
    pre-selector feature DAG on the given rows. `child` does not carry
    it."""

    n_rows: int
    seed: int = 42
    device: Any = "cpu"
    cv_refit: Any = None

    def child(self, salt: int) -> "FitContext":
        return FitContext(self.n_rows, self.seed * 1000003 + salt,
                          self.device)


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
    """Base: typed inputs, one output feature, serializable params.

    `in_types` is a tuple of FeatureType classes for fixed arity, or
    (elem_type, Ellipsis) for variadic same-type inputs; None disables
    checking."""

    in_types: Optional[Tuple] = None
    out_type: type = T.OPVector

    def __init__(self, uid: Optional[str] = None, **params):
        self.uid = uid or UID(type(self))
        self.params: Dict[str, Any] = params
        self.input_features: Tuple = ()
        self._output = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        StageRegistry.register(cls)

    @property
    def operation_name(self) -> str:
        return type(self).__name__

    def set_input(self, *features) -> "Stage":
        self._check_inputs(features)
        self.input_features = tuple(features)
        self._output = None
        return self

    def _check_inputs(self, features: Sequence) -> None:
        spec = self.in_types
        if spec is None:
            return
        if len(spec) == 2 and spec[1] is Ellipsis:
            elem = spec[0]
            for f in features:
                if elem is not None and not issubclass(f.ftype, elem):
                    raise TypeError(
                        f"{self.operation_name} requires inputs of type "
                        f"{elem.__name__}; got {f.ftype.__name__} "
                        f"({f.name})")
            return
        if len(features) != len(spec):
            raise TypeError(f"{self.operation_name} requires {len(spec)} "
                            f"inputs, got {len(features)}")
        for f, t in zip(features, spec):
            if t is not None and not issubclass(f.ftype, t):
                raise TypeError(
                    f"{self.operation_name} input {f.name!r}: expected "
                    f"{t.__name__}, got {f.ftype.__name__}")

    def output_ftype(self) -> type:
        return self.out_type

    def output_name(self) -> str:
        base = "-".join(f.name for f in self.input_features) or "raw"
        return f"{base}_{self.operation_name}_{self.uid}"

    def get_params(self) -> Dict[str, Any]:
        """JSON-serializable constructor params, as the JAX package saves
        them (override to extend)."""
        return dict(self.params)

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


_scoring = threading.local()


@contextlib.contextmanager
def compiled_scoring() -> Iterator[None]:
    """Marks device code run by the compiled scorer (`div_const`)."""
    prev = getattr(_scoring, "on", False)
    _scoring.on = True
    try:
        yield
    finally:
        _scoring.on = prev


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a fitted constant c, rounded as the JAX package rounds
    it: inside the compiled scorer as x · (1/c), the f32 reciprocal of
    the f32 constant, since XLA rewrites a division by a constant in the
    JAX package's jitted scoring program into that product; elsewhere
    (stage transforms at fit time, run op by op there) as a true f32
    division."""
    c32 = np.float32(c)
    if getattr(_scoring, "on", False):
        return x * float(np.float32(1.0) / c32)
    return x / float(c32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a·b + c for f32 tensors, rounded once to f32 (a fused multiply-add):
    the product is exact in f64, the sum is rounded to f64 with the
    rounding error kept (two-sum), and an inexact f64 sum is made odd in
    its last bit (rounding to odd) so that the final rounding to f32 is
    the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def mul_add_const(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """a·x + b for fitted constants a and b, rounded as the JAX package
    rounds it: inside the compiled scorer once, as a fused multiply-add
    (XLA's CPU program contracts a·x + b into one), elsewhere as the
    product rounded and then the sum."""
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    if getattr(_scoring, "on", False):
        return fma_f32(x, torch.full_like(x, a32), torch.full_like(x, b32))
    return a32 * x + b32


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

    def narrow_device_constants(self, consts: Any) -> Any:
        """The quantized scoring mode's view of `device_constants`: the
        same module with its heavy tables in narrower dtypes, chosen from
        shapes only (never values), widened back to f32 where they are
        used. Default: unchanged (nothing to narrow)."""
        return consts

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


class Estimator(Stage):
    """Unfitted stage: `fit` learns params and returns the fitted
    Transformer, which keeps this estimator's uid and takes over its
    output feature (the estimator→model swap)."""

    def fit(self, cols: Sequence[Column], ctx: FitContext) -> Transformer:
        model = self.fit_model(cols, ctx)
        model.uid = self.uid
        model.input_features = self.input_features
        out = self.get_output()
        out.origin_stage = model
        model._output = out
        model._estimator = self
        return model

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        raise NotImplementedError(type(self).__name__)


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

    def get_params(self) -> Dict[str, Any]:
        from transmogrifai_tpu_torch.utils.fnser import encode_fn
        return {"name": self.feature_name, "ftype": self.ftype.__name__,
                "extract": encode_fn(self.extract), "column": self.column,
                "is_response": self.is_response, "null_fill": self.null_fill}

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
