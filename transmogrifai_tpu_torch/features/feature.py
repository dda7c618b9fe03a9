"""Feature DAG nodes (scoring side).

The port's counterpart of the JAX package's `features/feature.py`: a
Feature is a typed handle on a column that exists once a model
materializes its DAG. Loading a saved model rebuilds these nodes; the
training-side builders and DSL are not part of this slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.utils.uid import UID


class Feature:
    """A typed node in the lazy feature DAG (FeatureLike/Feature)."""

    __slots__ = ("name", "ftype", "is_response", "origin_stage", "parents",
                 "uid")

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

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature<{self.ftype.__name__}>({self.name!r}, {kind})"

    # Equality is identity (each node is unique in the DAG); hash by uid.
    def __hash__(self) -> int:
        return hash(self.uid)
