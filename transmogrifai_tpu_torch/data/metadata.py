"""Vector column metadata — the lineage of every slot in a feature vector.

Reference parity: `features/.../utils/spark/OpVectorMetadata.scala` /
`OpVectorColumnMetadata` / `OpVectorColumnHistory`. Each column of an
engineered vector records which raw feature produced it, any categorical
grouping/indicator value, and a descriptor (e.g. imputed-mean vs null
indicator). SanityChecker drop decisions, ModelInsights and LOCO grouping
all key off this metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

NULL_INDICATOR = "NullIndicatorValue"
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class VectorColumnMetadata:
    """One slot of an engineered vector (OpVectorColumnMetadata)."""

    parent_name: str                      # raw/derived feature this slot came from
    parent_type: str                      # FeatureType class name
    grouping: Optional[str] = None        # e.g. map key or categorical group
    indicator_value: Optional[str] = None  # e.g. one-hot level, NULL_INDICATOR, OTHER
    descriptor_value: Optional[str] = None  # e.g. "x_HourOfDay", "lat"
    index: int = 0                        # slot index within the combined vector

    def column_name(self) -> str:
        parts = [self.parent_name]
        for p in (self.grouping, self.indicator_value, self.descriptor_value):
            if p is not None:
                parts.append(p)
        return "_".join(parts) + f"_{self.index}"

    def grouping_key(self) -> str:
        """Group slots that belong to one logical feature."""
        if self.grouping is not None:
            return f"{self.parent_name}_{self.grouping}"
        return self.parent_name

    def to_json(self) -> Dict:
        return {
            "parent_name": self.parent_name, "parent_type": self.parent_type,
            "grouping": self.grouping, "indicator_value": self.indicator_value,
            "descriptor_value": self.descriptor_value, "index": self.index,
        }

    @staticmethod
    def from_json(d: Dict) -> "VectorColumnMetadata":
        return VectorColumnMetadata(**d)


@dataclass(frozen=True)
class VectorMetadata:
    """Metadata for a whole engineered vector (OpVectorMetadata)."""

    name: str
    columns: Tuple[VectorColumnMetadata, ...] = ()

    @property
    def size(self) -> int:
        return len(self.columns)

    def with_indices(self) -> "VectorMetadata":
        cols = tuple(replace(c, index=i) for i, c in enumerate(self.columns))
        return VectorMetadata(self.name, cols)

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        cols = tuple(replace(self.columns[i], index=j)
                     for j, i in enumerate(indices))
        return VectorMetadata(self.name, cols)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    @staticmethod
    def union(name: str, metas: Sequence["VectorMetadata"]) -> "VectorMetadata":
        cols: List[VectorColumnMetadata] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMetadata(name, tuple(cols)).with_indices()

    def to_json(self) -> Dict:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: Dict) -> "VectorMetadata":
        return VectorMetadata(
            d["name"], tuple(VectorColumnMetadata.from_json(c) for c in d["columns"]))
