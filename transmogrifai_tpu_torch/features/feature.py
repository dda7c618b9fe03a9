"""Feature DAG nodes and the raw-feature builders.

The port's counterpart of the JAX package's `features/feature.py`: a
Feature is a typed handle on a column that exists once a workflow
materializes its DAG. `FeatureBuilder.Real("x").from_column("x")
.as_predictor()` (and likewise for every feature type) builds one raw
feature, `FeatureBuilder.from_dataset` those of a dataset's schema; DSL
methods such as `sanity_check` are
attached by `transmogrifai_tpu_torch.dsl`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.utils.uid import UID


class Feature:
    """A typed node in the lazy feature DAG (FeatureLike/Feature)."""

    __slots__ = ("name", "ftype", "is_response", "origin_stage", "parents",
                 "uid", "distributions")

    def __init__(self, name: str, ftype: type, origin_stage,
                 parents: Tuple["Feature", ...] = (), is_response: bool = False,
                 uid: Optional[str] = None):
        if not (isinstance(ftype, type) and issubclass(ftype, T.FeatureType)):
            raise TypeError(f"ftype must be a FeatureType class, got {ftype!r}")
        self.name = name
        self.ftype = ftype
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents = tuple(parents)
        self.uid = uid or UID("Feature")
        self.distributions: List[Any] = []  # set by RawFeatureFilter

    @property
    def is_raw(self) -> bool:
        return len(self.parents) == 0

    def raw_features(self) -> List["Feature"]:
        """All raw ancestors, depth-first, deduped (FeatureLike.scala:345)."""
        seen: Dict[str, Feature] = {}

        def visit(f: "Feature") -> None:
            if f.is_raw:
                seen.setdefault(f.uid, f)
                return
            for p in f.parents:
                visit(p)

        visit(self)
        return list(seen.values())

    def traverse(self) -> List["Feature"]:
        """All features in this subtree (self included), parents first."""
        out: List[Feature] = []
        seen = set()

        def visit(f: "Feature") -> None:
            if f.uid in seen:
                return
            seen.add(f.uid)
            for p in f.parents:
                visit(p)
            out.append(f)

        visit(self)
        return out

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature<{self.ftype.__name__}>({self.name!r}, {kind})"

    # Equality is identity (each node is unique in the DAG); hash by uid.
    def __hash__(self) -> int:
        return hash(self.uid)


class _TypedBuilder:
    """`FeatureBuilder.Real("age")`-style factory (FeatureBuilder.scala):
    a named dataset column or a per-record extract function, as a
    predictor or the response, with the monoid an aggregating reader
    folds its events by (`aggregate`)."""

    def __init__(self, name: str, ftype: type):
        self.name = name
        self.ftype = ftype
        self._extract: Optional[Callable[[Dict[str, Any]], Any]] = None
        self._column: Optional[str] = None
        self._aggregator = None
        self._aggregate_window = None

    def extract(self, fn: Callable[[Dict[str, Any]], Any]
                ) -> "_TypedBuilder":
        self._extract = fn
        return self

    def from_column(self, column: str) -> "_TypedBuilder":
        self._column = column
        return self

    def aggregate(self, aggregator, window: Optional[int] = None
                  ) -> "_TypedBuilder":
        """The monoid (`aggregators.py`) an aggregating reader folds this
        feature's events with, and its own time window in ms."""
        self._aggregator = aggregator
        self._aggregate_window = window
        return self

    def _build(self, is_response: bool) -> Feature:
        from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage
        stage = FeatureGeneratorStage(
            name=self.name, ftype=self.ftype, extract=self._extract,
            column=self._column, is_response=is_response)
        if self._aggregator is not None:
            stage.params["aggregator"] = self._aggregator
            stage.params["aggregate_window"] = self._aggregate_window
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class _FeatureBuilderMeta(type):
    def __getattr__(cls, type_name: str):
        try:
            ftype = T.feature_type_by_name(type_name)
        except T.FeatureTypeError:
            raise AttributeError(type_name) from None

        def make(name: str) -> _TypedBuilder:
            return _TypedBuilder(name, ftype)

        return make


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """Raw feature factories: `FeatureBuilder.Real("age").from_column(
    "age").as_predictor()`, or from a dataset's schema
    (`FeatureBuilder.from_dataset`, FeatureBuilder.scala `fromDataFrame`)."""

    @staticmethod
    def from_dataset(dataset, response: str,
                     response_type: type = T.RealNN,
                     ignore: Sequence[str] = ()
                     ) -> Tuple[List[Feature], Feature]:
        """Typed raw features of every schema column but `response` (and
        `ignore`); the response column becomes a `response_type` feature
        (default RealNN, with missing values filled by 0)."""
        from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage
        if response not in dataset.schema:
            raise KeyError(f"Response column {response!r} not in dataset")
        preds: List[Feature] = []
        for name, ftype in dataset.schema.items():
            if name == response or name in ignore:
                continue
            stage = FeatureGeneratorStage(name=name, ftype=ftype,
                                          column=name)
            preds.append(stage.get_output())
        resp_src = dataset.schema[response]
        null_fill = 0.0 if (issubclass(response_type, T.RealNN)
                            and not issubclass(resp_src, T.RealNN)) else None
        stage = FeatureGeneratorStage(
            name=response, ftype=response_type, column=response,
            is_response=True, null_fill=null_fill)
        return preds, stage.get_output()
