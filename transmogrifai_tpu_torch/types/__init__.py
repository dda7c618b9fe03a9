"""The feature type lattice.

Reference parity: `features/src/main/scala/com/salesforce/op/features/types/`
(`FeatureType.scala:44-176`, `Numerics.scala:40-150`, `Text.scala:50-303`,
`Lists.scala`, `Sets.scala`, `Maps.scala:40-394`, `Geolocation.scala`,
`OPVector.scala`, `FeatureTypeDefaults.scala`).

Every feature type wraps an optional value: "missing" is represented in-band
(`None` / empty collection), so stages can reason about nulls uniformly.
The lattice is *semantic*, not physical — it drives automatic encoder choice
in `transmogrify` and type-checking of stage wiring. On device the physical
representation is columnar (see `transmogrifai_tpu_torch.data.columns`); these
classes are the row-level / scalar view used by extract functions, local
scoring, and the test kit.
"""

from __future__ import annotations

import math
import numbers
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

__all__ = [
    # base + traits
    "FeatureType", "NonNullable", "SingleResponse", "MultiResponse",
    "Categorical", "Location", "FeatureTypeError",
    # numerics
    "OPNumeric", "Real", "RealNN", "Binary", "Integral", "Percent",
    "Currency", "Date", "DateTime",
    # text
    "Text", "Email", "Base64", "Phone", "ID", "URL", "TextArea",
    "PickList", "ComboBox", "Country", "State", "City", "PostalCode", "Street",
    # collections
    "OPCollection", "OPList", "OPSet", "OPVector", "TextList", "DateList",
    "DateTimeList", "MultiPickList", "Geolocation",
    # maps
    "OPMap", "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap",
    "URLMap", "TextAreaMap", "PickListMap", "ComboBoxMap", "CountryMap",
    "StateMap", "CityMap", "PostalCodeMap", "StreetMap", "GeolocationMap",
    "BinaryMap", "IntegralMap", "RealMap", "PercentMap", "CurrencyMap",
    "DateMap", "DateTimeMap", "MultiPickListMap", "NameStats", "Prediction",
    # registry / factory
    "feature_type_by_name", "all_feature_types", "from_value",
]


class FeatureTypeError(TypeError):
    """Raised when a value cannot be represented by the requested feature type."""


# ---------------------------------------------------------------------------
# Base + traits (FeatureType.scala:44-176)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}


class FeatureType:
    """Root of the lattice. Wraps a (possibly missing) value.

    Subclasses define `_convert(raw) -> canonical value` and `empty_value`.
    Equality is type + value; hashability allows use in sets/dict keys.
    """

    __slots__ = ("_value",)
    empty_value: Any = None

    def __init__(self, value: Any = None):
        self._value = self._convert(value)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REGISTRY[cls.__name__] = cls

    # -- conversion ---------------------------------------------------------
    @classmethod
    def _convert(cls, value: Any) -> Any:
        raise NotImplementedError

    # -- accessors ----------------------------------------------------------
    @property
    def value(self) -> Any:
        return self._value

    @property
    def v(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        return self._value == self.empty_value or self._value is None

    @property
    def is_nullable(self) -> bool:
        return not isinstance(self, NonNullable)

    @classmethod
    def empty(cls) -> "FeatureType":
        return cls(cls.empty_value)

    # -- dunder -------------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self._equals(other)

    def _equals(self, other: "FeatureType") -> bool:
        return self._value == other._value

    def __hash__(self) -> int:
        v = self._value
        if isinstance(v, (list, np.ndarray)):
            v = tuple(np.asarray(v).ravel().tolist())
        elif isinstance(v, set):
            v = frozenset(v)
        elif isinstance(v, dict):
            v = tuple(sorted(v.items()))
        return hash((type(self).__name__, v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"


class NonNullable:
    """Trait: the value may never be empty (FeatureType.scala:122)."""


class SingleResponse:
    """Trait marker (FeatureType.scala:145)."""


class MultiResponse:
    """Trait marker (FeatureType.scala:150)."""


class Categorical:
    """Trait: finite unordered domain (FeatureType.scala:155)."""


class Location:
    """Trait: geographic semantic (FeatureType.scala:140)."""


# ---------------------------------------------------------------------------
# Numerics (Numerics.scala:40-150)
# ---------------------------------------------------------------------------

class OPNumeric(FeatureType):
    """Abstract numeric; value is Optional[number]."""

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, FeatureType):
            value = value.value
            if value is None:
                return None
        if isinstance(value, bool):
            return cls._coerce(int(value))
        if isinstance(value, numbers.Number):
            if isinstance(value, float) and math.isnan(value):
                return None
            return cls._coerce(value)
        raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")

    @classmethod
    def _coerce(cls, n):
        return float(n)

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)


class Real(OPNumeric):
    """Optional double."""


class RealNN(Real, NonNullable):
    """Non-nullable double (Numerics.scala — RealNN)."""

    @classmethod
    def _convert(cls, value):
        v = super()._convert(value)
        if v is None:
            raise FeatureTypeError("RealNN cannot be empty")
        return v


class Binary(OPNumeric, SingleResponse, Categorical):
    """Optional boolean."""

    @classmethod
    def _coerce(cls, n):
        return bool(n)

    def to_double(self) -> Optional[float]:
        return None if self._value is None else float(self._value)


class Integral(OPNumeric):
    """Optional int64."""

    @classmethod
    def _coerce(cls, n):
        return int(n)


class Percent(Real):
    """Real constrained to percentage semantics."""


class Currency(Real):
    """Real with currency semantics."""


class Date(Integral):
    """Epoch milliseconds (day semantics). Accepts ISO-8601 strings
    ('2020-05-01', '2020-05-01 12:30[:45]', 'T' separator too) — the
    reference's converter likewise parses temporal strings into epoch ms
    (`FeatureTypeSparkConverter.scala` date handling)."""

    @classmethod
    def _convert(cls, value):
        if isinstance(value, str):
            import datetime as _dt
            s = value.strip()
            if not s:
                return None
            for fmt in ("%Y-%m-%d", "%Y-%m-%d %H:%M", "%Y-%m-%d %H:%M:%S",
                        "%Y-%m-%dT%H:%M", "%Y-%m-%dT%H:%M:%S"):
                try:
                    d = _dt.datetime.strptime(s, fmt)
                    d = d.replace(tzinfo=_dt.timezone.utc)
                    return int(d.timestamp() * 1000)
                except ValueError:
                    continue
            raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")
        return super()._convert(value)


class DateTime(Date):
    """Epoch milliseconds (instant semantics)."""


# ---------------------------------------------------------------------------
# Text family (Text.scala:50-303)
# ---------------------------------------------------------------------------

class Text(FeatureType):
    """Optional string."""

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        if isinstance(value, FeatureType):
            value = value.value
            if value is None:
                return None
        if isinstance(value, str):
            return value
        if isinstance(value, (bytes, bytearray)):
            return value.decode("utf-8", "replace")
        raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")


class Email(Text):
    """Email address; `prefix`/`domain` accessors mirror RichTextFeature."""

    def _split(self) -> Optional[Tuple[str, str]]:
        if self.is_empty or "@" not in self._value:
            return None
        prefix, _, domain = self._value.rpartition("@")
        if not prefix or not domain:
            return None
        return prefix, domain

    @property
    def prefix(self) -> Optional[str]:
        s = self._split()
        return s[0] if s else None

    @property
    def domain(self) -> Optional[str]:
        s = self._split()
        return s[1] if s else None


class Base64(Text):
    """Base64-encoded binary blob."""


class Phone(Text):
    """Phone number string."""


class ID(Text):
    """Opaque identifier."""


class URL(Text):
    """URL; domain/protocol accessors (Text.scala:169)."""

    @property
    def domain(self) -> Optional[str]:
        if self.is_empty:
            return None
        v = self._value
        rest = v.split("://", 1)[1] if "://" in v else v
        host = rest.split("/", 1)[0].split("?", 1)[0]
        return host or None

    @property
    def protocol(self) -> Optional[str]:
        if self.is_empty or "://" not in self._value:
            return None
        return self._value.split("://", 1)[0] or None

    @property
    def is_valid(self) -> bool:
        p = self.protocol
        return p in ("http", "https", "ftp") and bool(self.domain)


class TextArea(Text):
    """Long-form text."""


class PickList(Text, SingleResponse, Categorical):
    """Single-select categorical string."""


class ComboBox(Text):
    """Semi-open categorical string."""


class Country(Text, Location):
    pass


class State(Text, Location):
    pass


class City(Text, Location):
    pass


class PostalCode(Text, Location):
    pass


class Street(Text, Location):
    pass


# ---------------------------------------------------------------------------
# Collections (Lists.scala, Sets.scala, OPVector.scala, Geolocation.scala)
# ---------------------------------------------------------------------------

class OPCollection(FeatureType):
    """Abstract collection; empty collection == missing."""


class OPList(OPCollection):
    empty_value: List = []

    @classmethod
    def _convert(cls, value):
        if value is None:
            return []
        if isinstance(value, FeatureType):
            value = value.value
        if isinstance(value, (list, tuple, np.ndarray)):
            return [cls._elem(x) for x in value]
        raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")

    @classmethod
    def _elem(cls, x):
        return x

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0

    def __len__(self):
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


class TextList(OPList):
    @classmethod
    def _elem(cls, x):
        if not isinstance(x, str):
            raise FeatureTypeError(f"TextList element {x!r} is not a string")
        return x


class DateList(OPList):
    @classmethod
    def _elem(cls, x):
        if isinstance(x, bool) or not isinstance(x, numbers.Number):
            raise FeatureTypeError(f"DateList element {x!r} is not numeric")
        return int(x)


class DateTimeList(DateList):
    pass


class Geolocation(OPList, Location):
    """(lat, lon, accuracy) triple (Geolocation.scala)."""

    @classmethod
    def _convert(cls, value):
        v = super()._convert(value)
        if v and len(v) != 3:
            raise FeatureTypeError(f"Geolocation requires [lat, lon, accuracy], got {v!r}")
        if v:
            lat, lon, acc = float(v[0]), float(v[1]), float(v[2])
            if not (-90.0 <= lat <= 90.0):
                raise FeatureTypeError(f"Latitude {lat} out of range")
            if not (-180.0 <= lon <= 180.0):
                raise FeatureTypeError(f"Longitude {lon} out of range")
            return [lat, lon, acc]
        return v

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self._value else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self._value else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self._value else None


class OPSet(OPCollection):
    empty_value: frozenset = frozenset()

    @classmethod
    def _convert(cls, value):
        if value is None:
            return frozenset()
        if isinstance(value, FeatureType):
            value = value.value
        if isinstance(value, str):
            raise FeatureTypeError(f"{cls.__name__} cannot hold a bare string {value!r}")
        if isinstance(value, Iterable):
            return frozenset(value)
        raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0

    def __len__(self):
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


class MultiPickList(OPSet, MultiResponse, Categorical):
    """Multi-select categorical set of strings."""


class OPVector(OPCollection):
    """Dense numeric vector — the physical feature-engineering currency.

    Wraps a 1-D float array (reference wraps `ml.linalg.Vector`,
    OPVector.scala). Columnar equivalent is an (n, d) array + metadata.
    """

    empty_value = None

    @classmethod
    def _convert(cls, value):
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        if isinstance(value, FeatureType):
            value = value.value
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1:
            raise FeatureTypeError(f"OPVector requires 1-D data, got shape {arr.shape}")
        return arr

    @property
    def is_empty(self) -> bool:
        return self._value.size == 0

    def _equals(self, other) -> bool:
        return self._value.shape == other._value.shape and bool(
            np.array_equal(self._value, other._value))

    def __len__(self):
        return int(self._value.size)


# ---------------------------------------------------------------------------
# Maps (Maps.scala:40-394) — record-of-named-values per scalar type
# ---------------------------------------------------------------------------

class OPMap(FeatureType):
    """Abstract map String -> element; empty map == missing."""

    empty_value: Dict = {}
    _elem_type: Optional[type] = None  # FeatureType used to validate elements

    @classmethod
    def _convert(cls, value):
        if value is None:
            return {}
        if isinstance(value, FeatureType):
            value = value.value
        if not isinstance(value, dict):
            raise FeatureTypeError(f"{cls.__name__} cannot hold {value!r}")
        out = {}
        for k, v in value.items():
            if not isinstance(k, str):
                raise FeatureTypeError(f"{cls.__name__} key {k!r} is not a string")
            out[k] = cls._elem(v)
        return out

    @classmethod
    def _elem(cls, v):
        if cls._elem_type is None:
            return v
        return cls._elem_type._convert(v)

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0

    def __len__(self):
        return len(self._value)

    def __getitem__(self, k):
        return self._value[k]

    def get(self, k, default=None):
        return self._value.get(k, default)

    def keys(self):
        return self._value.keys()

    def items(self):
        return self._value.items()


class TextMap(OPMap):
    _elem_type = Text


class EmailMap(TextMap):
    _elem_type = Email


class Base64Map(TextMap):
    _elem_type = Base64


class PhoneMap(TextMap):
    _elem_type = Phone


class IDMap(TextMap):
    _elem_type = ID


class URLMap(TextMap):
    _elem_type = URL


class TextAreaMap(TextMap):
    _elem_type = TextArea


class PickListMap(TextMap, Categorical):
    _elem_type = PickList


class ComboBoxMap(TextMap):
    _elem_type = ComboBox


class CountryMap(TextMap, Location):
    _elem_type = Country


class StateMap(TextMap, Location):
    _elem_type = State


class CityMap(TextMap, Location):
    _elem_type = City


class PostalCodeMap(TextMap, Location):
    _elem_type = PostalCode


class StreetMap(TextMap, Location):
    _elem_type = Street


class BinaryMap(OPMap, Categorical):
    _elem_type = Binary


class IntegralMap(OPMap):
    _elem_type = Integral


class RealMap(OPMap):
    _elem_type = Real


class PercentMap(RealMap):
    _elem_type = Percent


class CurrencyMap(RealMap):
    _elem_type = Currency


class DateMap(IntegralMap):
    _elem_type = Date


class DateTimeMap(DateMap):
    _elem_type = DateTime


class MultiPickListMap(OPMap, MultiResponse, Categorical):
    _elem_type = MultiPickList

    @classmethod
    def _elem(cls, v):
        return MultiPickList._convert(v)  # rejects bare strings like OPSet does


class GeolocationMap(OPMap, Location):
    @classmethod
    def _elem(cls, v):
        return Geolocation._convert(v)


class NameStats(TextMap):
    """Name-detection result map (Maps.scala — NameStats keys)."""

    IS_NAME = "isName"
    ORIGINAL = "originalValue"
    GENDER = "gender"


class Prediction(RealMap, NonNullable):
    """Model output map with reserved keys (Maps.scala:339-394).

    Keys: `prediction` (required), `probability_{i}`, `rawPrediction_{i}`.
    """

    PREDICTION = "prediction"
    RAW = "rawPrediction"
    PROB = "probability"

    _KEY_RE = None  # compiled lazily below

    @classmethod
    def _convert(cls, value):
        import re
        v = super()._convert(value)
        if cls.PREDICTION not in v:
            raise FeatureTypeError("Prediction map must contain key 'prediction'")
        if Prediction._KEY_RE is None:
            Prediction._KEY_RE = re.compile(
                f"^({re.escape(cls.RAW)}|{re.escape(cls.PROB)})_\\d+$")
        for k in v:
            if k != cls.PREDICTION and not Prediction._KEY_RE.match(k):
                raise FeatureTypeError(f"Prediction map key {k!r} not allowed")
        return v

    @property
    def prediction(self) -> float:
        return float(self._value[self.PREDICTION])

    def _keyed(self, prefix: str) -> List[float]:
        ks = sorted(
            (k for k in self._value if k.startswith(prefix + "_")),
            key=lambda k: int(k.rsplit("_", 1)[1]))
        return [float(self._value[k]) for k in ks]

    @property
    def probability(self) -> List[float]:
        return self._keyed(self.PROB)

    @property
    def raw_prediction(self) -> List[float]:
        return self._keyed(self.RAW)

    @classmethod
    def build(cls, prediction: float, raw_prediction: Iterable[float] = (),
              probability: Iterable[float] = ()) -> "Prediction":
        m: Dict[str, float] = {cls.PREDICTION: float(prediction)}
        for i, x in enumerate(raw_prediction):
            m[f"{cls.RAW}_{i}"] = float(x)
        for i, x in enumerate(probability):
            m[f"{cls.PROB}_{i}"] = float(x)
        return cls(m)


# ---------------------------------------------------------------------------
# Registry / factory (FeatureType.scala:176, FeatureTypeFactory.scala)
# ---------------------------------------------------------------------------

def feature_type_by_name(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise FeatureTypeError(f"Unknown feature type {name!r}") from None


def all_feature_types() -> Dict[str, type]:
    return dict(_REGISTRY)


def from_value(ftype: type, value: Any) -> FeatureType:
    """Runtime construction of `ftype` from a raw python value."""
    if isinstance(value, ftype):
        return value
    return ftype(value)
