"""Transmogrify: automated type-driven feature engineering.

The port's counterpart of the JAX package's `automl/transmogrify.py`:
group the input features by type, apply each type's default encoder, and
combine the results into one OPVector with `VectorsCombiner`. The
encoders of the Real, RealNN, Integral, Binary, pivot (PickList and its
kin) and Text groups are ported, and OPVector features join the combiner
as they are; a feature of any other group raises and names the group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.ops.categorical import OneHotVectorizer
from transmogrifai_tpu_torch.ops.combiner import VectorsCombiner
from transmogrifai_tpu_torch.ops.numeric import (
    BinaryVectorizer, IntegralVectorizer, RealNNVectorizer, RealVectorizer)
from transmogrifai_tpu_torch.ops.text import SmartTextVectorizer


@dataclass(frozen=True)
class TransmogrifierDefaults:
    """Transmogrifier.scala:52-90 defaults (as in the JAX package)."""

    num_hash_features: int = 512
    top_k: int = 20
    min_support: int = 10
    max_cardinality: int = 100
    track_nulls: bool = True
    fill_numeric: str = "mean"
    circular_date_periods: Tuple[str, ...] = (
        "HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear")


_PIVOT_TYPES = (T.PickList, T.ComboBox, T.Country, T.State, T.City,
                T.PostalCode, T.Street, T.ID)
_SMART_TEXT_TYPES = (T.TextArea, T.Text)
_PORTED_GROUPS = ("realnn", "real", "integral", "binary", "pivot",
                  "smart_text", "vector")


def _group_features(features: Sequence) -> Dict[str, List]:
    """The JAX package's grouping rule, group for group."""
    groups: Dict[str, List] = {}
    for f in features:
        ft = f.ftype
        if issubclass(ft, T.RealNN):
            key = "realnn"
        elif issubclass(ft, T.Binary):
            key = "binary"
        elif issubclass(ft, (T.Date, T.DateTime)):
            key = "date"
        elif issubclass(ft, T.Integral):
            key = "integral"
        elif issubclass(ft, T.Real):
            key = "real"
        elif issubclass(ft, T.Email):
            key = "email"
        elif issubclass(ft, T.URL):
            key = "url"
        elif issubclass(ft, T.Phone):
            key = "phone"
        elif issubclass(ft, T.Base64):
            key = "base64"
        elif issubclass(ft, _PIVOT_TYPES):
            key = "pivot"
        elif issubclass(ft, _SMART_TEXT_TYPES):
            key = "smart_text"
        elif issubclass(ft, T.MultiPickList):
            key = "multipicklist"
        elif issubclass(ft, T.TextList):
            key = "textlist"
        elif issubclass(ft, T.Geolocation):
            key = "geo"
        elif issubclass(ft, T.OPVector):
            key = "vector"
        elif issubclass(ft, T.OPMap):
            key = "map"
        else:
            raise TypeError(f"transmogrify: no default encoder for "
                            f"{ft.__name__} ({f.name})")
        groups.setdefault(key, []).append(f)
    return groups


def transmogrify(features: Sequence,
                 defaults: Optional[TransmogrifierDefaults] = None):
    """Apply per-type default encoders and combine into one OPVector
    feature (lazily: nothing executes until a workflow trains)."""
    d = defaults or TransmogrifierDefaults()
    groups = _group_features(features)
    for key, members in groups.items():
        if key not in _PORTED_GROUPS:
            raise NotImplementedError(
                f"transmogrify: the {key!r} group "
                f"({', '.join(f.name for f in members)}) has no ported "
                "encoder yet (ROADMAP.md, queue 1: the rest of the op "
                "library and transmogrify's other groups)")
    vectors = []
    if "realnn" in groups:
        vectors.append(RealNNVectorizer().set_input(
            *groups["realnn"]).get_output())
    if "real" in groups:
        vectors.append(RealVectorizer(
            fill_value=d.fill_numeric, track_nulls=d.track_nulls
        ).set_input(*groups["real"]).get_output())
    if "integral" in groups:
        vectors.append(IntegralVectorizer(
            track_nulls=d.track_nulls).set_input(
                *groups["integral"]).get_output())
    if "binary" in groups:
        vectors.append(BinaryVectorizer(
            track_nulls=d.track_nulls).set_input(
                *groups["binary"]).get_output())
    if "pivot" in groups:
        vectors.append(OneHotVectorizer(
            top_k=d.top_k, min_support=d.min_support,
            track_nulls=d.track_nulls).set_input(
                *groups["pivot"]).get_output())
    if "smart_text" in groups:
        vectors.append(SmartTextVectorizer(
            max_cardinality=d.max_cardinality, top_k=d.top_k,
            min_support=d.min_support, num_features=d.num_hash_features,
            track_nulls=d.track_nulls).set_input(
                *groups["smart_text"]).get_output())
    if "vector" in groups:  # already vectors: combined as they are
        vectors.extend(groups["vector"])
    if not vectors:
        raise ValueError("transmogrify: no input features")
    return VectorsCombiner().set_input(*vectors).get_output()
