"""Host-side columnar dataset.

The workflow's input currency: an in-memory dict of named columns, each a
numpy array (object arrays for text/collections, float64 with NaN for
missing numerics). The port's copy of the JAX package's `data/dataset.py`
keeps its pure-python CSV path (the same type inference, cell parsing and
numeric storage) and a rows/columns builder for the serving wire; it has
no pyarrow and no native CSV parser.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from transmogrifai_tpu_torch import types as T


_TRUE = {"true", "t", "yes", "y"}
_FALSE = {"false", "f", "no", "n"}
_MISSING = {"", "na", "n/a", "null", "none", "nan"}


def _infer_ftype(values: Iterable[Optional[str]]) -> type:
    """Infer a feature type from string cells: Integral → Real → Binary → Text."""
    saw_any = False
    could_int = could_float = could_bool = True
    for s in values:
        if s is None:
            continue
        saw_any = True
        ls = s.strip().lower()
        if could_bool and ls not in _TRUE and ls not in _FALSE:
            could_bool = False
        if could_int:
            try:
                int(s)
            except ValueError:
                could_int = False
        if not could_int and could_float:
            try:
                float(s)
            except ValueError:
                could_float = False
        if not (could_int or could_float or could_bool):
            return T.Text
    if not saw_any:
        return T.Text
    if could_bool:
        return T.Binary
    if could_int:
        return T.Integral
    if could_float:
        return T.Real
    return T.Text


def _parse_cell(s: Optional[str], ftype: type) -> Any:
    if s is None:
        return None
    if isinstance(s, str) and s.strip().lower() in _MISSING:
        return None
    if issubclass(ftype, T.Binary):
        ls = s.strip().lower()
        if ls in _TRUE:
            return True
        if ls in _FALSE:
            return False
        return bool(float(s))
    if issubclass(ftype, T.Integral):
        try:
            return int(s)  # exact for big ints (no float64 round-trip)
        except ValueError:
            return int(float(s))
    if issubclass(ftype, T.OPNumeric):
        return float(s)
    return s


@dataclass
class Dataset:
    """Named columns + a schema of feature types.

    Physical storage: numeric (OPNumeric-typed) columns are float64 arrays
    with NaN marking missing values — zero-copy into Column materialization
    and cheap to shard; all other kinds are object arrays (str/list/set/
    dict with None for missing)."""

    columns: Dict[str, np.ndarray]
    schema: Dict[str, type]

    def __post_init__(self):
        lengths = {len(a) for a in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"Ragged columns: {sorted(lengths)}")
        self._rows_cache: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        for a in self.columns.values():
            return len(a)
        return 0

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def names(self) -> List[str]:
        return list(self.columns)

    def take(self, idx) -> "Dataset":
        return Dataset({k: v[idx] for k, v in self.columns.items()}, dict(self.schema))

    def with_column(self, name: str, values: np.ndarray,
                    ftype: type) -> "Dataset":
        cols = dict(self.columns)
        cols[name] = values
        schema = dict(self.schema)
        schema[name] = ftype
        return Dataset(cols, schema)

    @staticmethod
    def concat(parts: Sequence["Dataset"]) -> "Dataset":
        """Row-wise concatenation of same-schema datasets (streaming
        micro-batch coalescing). Schemas must agree per column, not
        just by name: two same-named columns with different ftypes
        would otherwise concatenate silently into a batch whose dtype
        depends on which request came first."""
        if len(parts) == 1:
            return parts[0]
        first = parts[0]
        for p in parts[1:]:
            if set(p.columns) != set(first.columns):
                raise ValueError(
                    f"concat: column mismatch {sorted(first.columns)} vs "
                    f"{sorted(p.columns)}")
            mismatched = {
                k: (first.schema.get(k), p.schema.get(k))
                for k in first.columns
                if p.schema.get(k) is not first.schema.get(k)}
            if mismatched:
                raise ValueError(
                    "concat: schema ftype mismatch for "
                    + ", ".join(
                        f"{k!r} ({a.__name__ if a else None} vs "
                        f"{b.__name__ if b else None})"
                        for k, (a, b) in sorted(mismatched.items())))
        cols = {k: np.concatenate([p.columns[k] for p in parts])
                for k in first.columns}
        return Dataset(cols, dict(first.schema))

    def to_rows(self) -> List[Dict[str, Any]]:
        """Row-dict view; cached since every extract-fn feature re-reads it.
        Numeric NaNs surface as None (the row-level missing convention)."""
        if self._rows_cache is None:
            names = self.names()
            cols = {}
            for k in names:
                a = self.columns[k]
                if a.dtype != object:
                    obj = a.astype(object)
                    obj[np.isnan(a.astype(np.float64))] = None
                    cols[k] = obj
                else:
                    cols[k] = a
            self._rows_cache = [
                {k: cols[k][i] for k in names} for i in range(len(self))
            ]
        return self._rows_cache

    # ------------------------------------------------------------------ #
    # constructors                                                       #
    # ------------------------------------------------------------------ #

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]],
                  schema: Optional[Mapping[str, type]] = None) -> "Dataset":
        """Row dicts → Dataset: columns in first-seen key order, schema
        types where given and inferred from the python values elsewhere,
        numeric columns packed to float64+NaN storage (the semantics of
        the JAX package's `Dataset.from_rows`)."""
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        cols: Dict[str, List[Any]] = {
            k: [r.get(k) for r in rows] for k in keys}
        return Dataset.from_columns(cols, schema)

    @staticmethod
    def from_columns(columns: Mapping[str, Sequence[Any]],
                     schema: Optional[Mapping[str, type]] = None
                     ) -> "Dataset":
        """``{name: [values...]}`` → Dataset with no row pivot; the same
        typing and storage as `from_rows`."""
        cols: Dict[str, np.ndarray] = {}
        sch = dict(schema) if schema else {}
        for k, values in columns.items():
            arr = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):
                arr[i] = v.value if isinstance(v, T.FeatureType) else v
            if k not in sch:
                sch[k] = _infer_py_type(arr)
            if issubclass(sch[k], T.OPNumeric):
                arr = _to_numeric_storage(arr)
            cols[k] = arr
        return Dataset(cols, {k: sch[k] for k in cols})

    @staticmethod
    def from_csv(path_or_buf, schema: Optional[Mapping[str, type]] = None,
                 delimiter: str = ",") -> "Dataset":
        """Read a headered CSV; infer Integral/Real/Binary/Text per column
        unless a schema is given (CSVAutoReaders.scala analogue)."""
        if isinstance(path_or_buf, (str,)):
            f = open(path_or_buf, "r", newline="")
            close = True
        else:
            f, close = path_or_buf, False
        try:
            reader = csv.reader(f, delimiter=delimiter)
            try:
                header = next(reader)
            except StopIteration:
                return Dataset({}, {})
            raw: List[List[Optional[str]]] = [[] for _ in header]
            for row in reader:
                for j in range(len(header)):
                    cell = row[j] if j < len(row) else ""
                    raw[j].append(None if cell.strip().lower() in _MISSING else cell)
        finally:
            if close:
                f.close()
        sch: Dict[str, type] = {}
        cols: Dict[str, np.ndarray] = {}
        for j, name in enumerate(header):
            ftype = (schema or {}).get(name) or _infer_ftype(raw[j])
            sch[name] = ftype
            arr = np.empty(len(raw[j]), dtype=object)
            for i, cell in enumerate(raw[j]):
                arr[i] = _parse_cell(cell, ftype)
            if issubclass(ftype, T.OPNumeric):
                arr = _to_numeric_storage(arr)
            cols[name] = arr
        return Dataset(cols, sch)

def _to_numeric_storage(arr: np.ndarray) -> np.ndarray:
    """Object array of numbers/None → float64 with NaN for missing.

    Integers beyond float64's exact range (±2^53) keep object storage so
    large IDs / epoch-nanos don't silently lose precision."""
    out = np.empty(len(arr), dtype=np.float64)
    for i, v in enumerate(arr):
        if v is None:
            out[i] = np.nan
        else:
            if isinstance(v, int) and abs(v) > (1 << 53):
                return arr  # exact-int column: stay object
            out[i] = float(v)
    return out


def _infer_py_type(arr: np.ndarray) -> type:
    for v in arr:
        if v is None:
            continue
        if isinstance(v, bool):
            return T.Binary
        if isinstance(v, int):
            return T.Integral
        if isinstance(v, float):
            return T.Real
        if isinstance(v, str):
            return T.Text
        if isinstance(v, (list, tuple)):
            if len(v) and isinstance(v[0], str):
                return T.TextList
            try:
                T.Geolocation._convert(list(v))
                return T.Geolocation
            except T.FeatureTypeError:
                return T.DateList  # generic numeric list
        if isinstance(v, (set, frozenset)):
            return T.MultiPickList
        if isinstance(v, dict):
            return T.TextMap
    return T.Text
