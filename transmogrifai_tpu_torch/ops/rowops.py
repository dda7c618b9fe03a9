"""Generic per-row feature ops: alias, map, filter, exists, replace,
occurs, and small text and set measures.

The port's counterpart of the JAX package's `ops/rowops.py` (the
reference's `AliasTransformer.scala`, `ToOccurTransformer.scala`, the
generic DSL of `RichFeature.scala`, `TextLenTransformer.scala`,
`JaccardSimilarity.scala`, `NGramSimilarity.scala`). Every stage here is a
host transformer: it maps Python values row by row, as the reference maps
them with Scala lambdas, and a numeric output becomes a scalar column that
later device stages read.

Saving a stage that holds a function (`LambdaMap`, `FilterTransformer`,
`ExistsTransformer`, `ToOccurTransformer`) writes the function's registry
name or module reference (`utils/fnser.py`). The JAX package also pickles
lambdas and closures; the port cannot (its card machine has no
cloudpickle), so saving a model whose function is a lambda raises there,
while training and scoring it in process work. Register the function with
`@extract_fn(name)` or define it at module level to save the model.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import SCALAR, Column
from transmogrifai_tpu_torch.stages.base import HostTransformer
from transmogrifai_tpu_torch.utils.fnser import decode_fn, encode_fn


def _values_of(col: Column):
    """Host Python values (None = missing) of any column kind."""
    if col.kind == SCALAR:
        v = np.asarray(col.data["value"])
        m = np.asarray(col.data["mask"]).astype(bool)
        return [float(v[i]) if m[i] else None for i in range(len(v))]
    return list(col.data)


class AliasTransformer(HostTransformer):
    """Rename a feature without changing its values."""

    in_types = None

    def __init__(self, name: str, uid: Optional[str] = None):
        super().__init__(uid=uid, name=name)
        self.name = name

    def output_name(self) -> str:
        return self.name

    def output_ftype(self) -> type:
        return self.input_features[0].ftype

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        c = cols[0]
        return Column(c.ftype, c.data, c.meta)


class LambdaMap(HostTransformer):
    """feature.map(fn): an arbitrary row map to `out_type`."""

    in_types = None

    def __init__(self, fn: Callable[[Any], Any], out_type: type,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fn = decode_fn(fn)
        self._out = (out_type if isinstance(out_type, type)
                     else T.feature_type_by_name(out_type))

    def output_ftype(self) -> type:
        return self._out

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        vals = _values_of(cols[0])
        return Column.from_values(self._out, [self.fn(v) for v in vals])

    def get_params(self):
        return {"fn": encode_fn(self.fn), "out_type": self._out.__name__}


class FilterTransformer(HostTransformer):
    """Keep the value where `predicate(value)` holds, else missing."""

    in_types = None

    def __init__(self, predicate: Callable[[Any], bool],
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.predicate = decode_fn(predicate)

    def output_ftype(self) -> type:
        return self.input_features[0].ftype

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        vals = _values_of(cols[0])
        kept = [v if (v is not None and self.predicate(v)) else None
                for v in vals]
        return Column.from_values(self.input_features[0].ftype, kept)

    def get_params(self):
        return {"predicate": encode_fn(self.predicate)}


class ExistsTransformer(HostTransformer):
    """feature.exists(pred) → Binary."""

    in_types = None
    out_type = T.Binary

    def __init__(self, predicate: Callable[[Any], bool],
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.predicate = decode_fn(predicate)

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        vals = _values_of(cols[0])
        return Column.from_values(
            T.Binary, [bool(v is not None and self.predicate(v))
                       for v in vals])

    def get_params(self):
        return {"predicate": encode_fn(self.predicate)}


class ReplaceTransformer(HostTransformer):
    """Replace values equal to `old` with `new`."""

    in_types = None

    def __init__(self, old: Any, new: Any, uid: Optional[str] = None):
        super().__init__(uid=uid, old=old, new=new)
        self.old, self.new = old, new

    def output_ftype(self) -> type:
        return self.input_features[0].ftype

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        vals = _values_of(cols[0])
        return Column.from_values(
            self.input_features[0].ftype,
            [self.new if v == self.old else v for v in vals])


class ToOccurTransformer(HostTransformer):
    """Non-empty (by `match_fn`) → 1.0, else 0.0."""

    in_types = None
    out_type = T.RealNN

    def __init__(self, match_fn: Optional[Callable[[Any], bool]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.match_fn = decode_fn(match_fn)

    def get_params(self):
        return {"match_fn": encode_fn(self.match_fn)}

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        def occurs(v):
            if v is None:
                return False
            if self.match_fn is not None:
                return bool(self.match_fn(v))
            if isinstance(v, (list, tuple, set, frozenset, dict, str)):
                return len(v) > 0
            return True

        return Column.from_values(
            T.RealNN, [1.0 if occurs(v) else 0.0
                       for v in _values_of(cols[0])])


class SubstringTransformer(HostTransformer):
    """(text, text) → Binary: does input 2 contain input 1?"""

    in_types = (T.Text, T.Text)
    out_type = T.Binary

    def __init__(self, ignore_case: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, ignore_case=ignore_case)
        self.ignore_case = ignore_case

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = []
        for needle, hay in zip(cols[0].data, cols[1].data):
            if needle is None or hay is None:
                out.append(None)
            elif self.ignore_case:
                out.append(needle.lower() in hay.lower())
            else:
                out.append(needle in hay)
        return Column.from_values(T.Binary, out)


class TextLenTransformer(HostTransformer):
    """Text (or a text list) → Integral total length."""

    in_types = None
    out_type = T.Integral

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = []
        for v in _values_of(cols[0]):
            if v is None:
                out.append(0)
            elif isinstance(v, str):
                out.append(len(v))
            else:
                out.append(sum(len(s) for s in v))
        return Column.from_values(T.Integral, out)


class JaccardSimilarity(HostTransformer):
    """(set, set) → RealNN |∩|/|∪| (both empty → 1)."""

    in_types = (T.OPSet, T.OPSet)
    out_type = T.RealNN

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = []
        for a, b in zip(cols[0].data, cols[1].data):
            sa = set(a) if a else set()
            sb = set(b) if b else set()
            union = sa | sb
            out.append(1.0 if not union else len(sa & sb) / len(union))
        return Column.from_values(T.RealNN, out)


def _ngrams(s: str, n: int) -> set:
    s = f" {s} "
    if len(s) < n:
        return {s}
    return {s[i:i + n] for i in range(len(s) - n + 1)}


class NGramSimilarity(HostTransformer):
    """(text, text) → RealNN character n-gram Jaccard similarity (0 when
    either side is empty)."""

    in_types = (T.Text, T.Text)
    out_type = T.RealNN

    def __init__(self, n: int = 3, uid: Optional[str] = None):
        super().__init__(uid=uid, n=n)
        self.n = int(n)

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = []
        for a, b in zip(cols[0].data, cols[1].data):
            if not a or not b:
                out.append(0.0)
                continue
            ga, gb = _ngrams(a.lower(), self.n), _ngrams(b.lower(), self.n)
            union = ga | gb
            out.append(len(ga & gb) / len(union) if union else 0.0)
        return Column.from_values(T.RealNN, out)
