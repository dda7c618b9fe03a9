"""Avro Object Container Files: the codec, the FeatureType mapping, and
Dataset reads and writes.

The port's copy of the JAX package's `data/avro.py` (standard library and
numpy only): the container's header (magic, a metadata map with
`avro.schema` and `avro.codec`, a 16-byte sync marker), then
length-prefixed blocks under the null or deflate codec, each a run of
binary-encoded records. Schemas: every primitive, record, enum, array,
map, union, fixed, named-type references with namespaces, and the
timestamp logical types. Recursive schemas are not supported.

Two places where the port writes what the JAX package refuses (with
"no union branch"), and otherwise the same bytes:

- a numpy scalar inside a union (a map value taken from numpy storage)
  is matched as the python value it holds;
- `GeolocationMap` and `MultiPickListMap` columns get a typed map schema
  (values an array of doubles, an array of strings), where the JAX
  package's generic map-value union has no array branch. Sets are written
  sorted and read back as sets.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

MAGIC = b"Obj\x01"


# --------------------------------------------------------------------------- #
# binary primitives                                                           #
# --------------------------------------------------------------------------- #

def _read_long(buf: io.BytesIO) -> int:
    """Zigzag varint (Avro int and long share the encoding)."""
    b = buf.read(1)
    if b and b[0] < 0x80:  # one byte: |n| < 64
        return (b[0] >> 1) ^ -(b[0] & 1)
    buf.seek(-len(b), 1)
    shift, acc = 0, 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


_ONE_BYTE = [bytes([i]) for i in range(0x80)]


def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)  # zigzag
    if 0 <= n < 0x80:
        out.write(_ONE_BYTE[n])
        return
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# --------------------------------------------------------------------------- #
# schema-driven decode                                                        #
# --------------------------------------------------------------------------- #

class _Names:
    def __init__(self):
        self.types: Dict[str, Any] = {}


def _resolve(schema: Any, names: _Names) -> Any:
    if isinstance(schema, str) and schema in names.types:
        return names.types[schema]
    return schema


def _decoder(schema: Any, names: _Names) -> Callable[[io.BytesIO], Any]:
    """Compile a schema into a decode closure (one dispatch at build time,
    not per record)."""
    schema = _resolve(schema, names)
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return lambda b: None
        if t == "boolean":
            return lambda b: b.read(1) != b"\x00"
        if t in ("int", "long"):
            return _read_long
        if t == "float":
            return lambda b: struct.unpack("<f", b.read(4))[0]
        if t == "double":
            return lambda b: struct.unpack("<d", b.read(8))[0]
        if t == "bytes":
            return _read_bytes
        if t == "string":
            return lambda b: _read_bytes(b).decode("utf-8")
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union
        branches = [_decoder(s, names) for s in schema]

        def du(b, branches=branches):
            return branches[_read_long(b)](b)
        return du
    t = schema["type"]
    if t in ("record", "error"):
        names.types[schema.get("name", "")] = schema
        fields = [(f["name"], None) for f in schema["fields"]]
        decs = [_decoder(f["type"], names) for f in schema["fields"]]
        fnames = [n for n, _ in fields]

        def dr(b, fnames=fnames, decs=decs):
            return {n: d(b) for n, d in zip(fnames, decs)}
        return dr
    if t == "enum":
        names.types[schema.get("name", "")] = schema
        symbols = schema["symbols"]
        return lambda b: symbols[_read_long(b)]
    if t == "fixed":
        names.types[schema.get("name", "")] = schema
        size = int(schema["size"])
        return lambda b: b.read(size)
    if t == "array":
        item = _decoder(schema["items"], names)

        def da(b, item=item):
            out = []
            while True:
                n = _read_long(b)
                if n == 0:
                    return out
                if n < 0:
                    n = -n
                    _read_long(b)  # block byte size (skippable)
                for _ in range(n):
                    out.append(item(b))
        return da
    if t == "map":
        val = _decoder(schema["values"], names)

        def dm(b, val=val):
            out = {}
            while True:
                n = _read_long(b)
                if n == 0:
                    return out
                if n < 0:
                    n = -n
                    _read_long(b)
                for _ in range(n):
                    k = _read_bytes(b).decode("utf-8")  # key BEFORE value:
                    out[k] = val(b)  # d[k]=v evaluates the RHS first
        return dm
    return _decoder(t, names)  # {"type": "string", ...} wrapper form


# --------------------------------------------------------------------------- #
# schema-driven encode                                                        #
# --------------------------------------------------------------------------- #

def _encoder(schema: Any, names: _Names) -> Callable[[io.BytesIO, Any], None]:
    schema = _resolve(schema, names)
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return lambda o, v: None
        if t == "boolean":
            return lambda o, v: o.write(b"\x01" if v else b"\x00")
        if t in ("int", "long"):
            return lambda o, v: _write_long(o, int(v))
        if t == "float":
            return lambda o, v: o.write(struct.pack("<f", float(v)))
        if t == "double":
            return lambda o, v: o.write(struct.pack("<d", float(v)))
        if t == "bytes":
            return lambda o, v: _write_bytes(o, bytes(v))
        if t == "string":
            return lambda o, v: _write_bytes(o, str(v).encode("utf-8"))
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union: first matching branch
        branches = [(_resolve(s, names), _encoder(s, names)) for s in schema]

        def matches(s, v) -> bool:
            bt = s if isinstance(s, str) else s.get("type")
            if v is None:
                return bt == "null"
            if isinstance(v, bool):
                return bt == "boolean"
            if isinstance(v, int):
                return bt in ("long", "int", "double", "float")
            if isinstance(v, float):
                return bt in ("double", "float")
            if isinstance(v, str):
                return bt in ("string", "enum")
            if isinstance(v, bytes):
                return bt in ("bytes", "fixed")
            if isinstance(v, (list, tuple)):
                return bt == "array"
            if isinstance(v, dict):
                return bt in ("map", "record")
            return False

        def exact(s, v) -> bool:
            """Exact-type branch preference: a python int must pick long/int
            over a widening double branch regardless of union order, or
            integral map values lose typing (and exactness above 2^53)."""
            bt = s if isinstance(s, str) else s.get("type")
            if isinstance(v, bool):
                return bt == "boolean"
            if isinstance(v, int):
                return bt in ("long", "int")
            return False

        chosen: Dict[type, Tuple[bytes, Callable]] = {}

        def pick(v):
            """The first exact branch, else the first matching one: both
            rules read the value's type alone, so the pick is cached per
            type."""
            for pred in (exact, matches):
                for i, (s, enc) in enumerate(branches):
                    if pred(s, v):
                        head = io.BytesIO()
                        _write_long(head, i)
                        return head.getvalue(), enc
            raise ValueError(f"no union branch for {type(v).__name__}")

        def eu(o, v, branches=branches):
            if isinstance(v, np.generic):  # numpy scalars match as python
                v = v.item()
            hit = chosen.get(type(v))
            if hit is None:
                hit = chosen[type(v)] = pick(v)
            o.write(hit[0])
            hit[1](o, v)
        return eu
    t = schema["type"]
    if t in ("record", "error"):
        names.types[schema.get("name", "")] = schema
        encs = [(f["name"], _encoder(f["type"], names))
                for f in schema["fields"]]

        def er(o, v, encs=encs):
            for n, enc in encs:
                enc(o, v.get(n))
        return er
    if t == "enum":
        names.types[schema.get("name", "")] = schema
        index = {s: i for i, s in enumerate(schema["symbols"])}
        return lambda o, v: _write_long(o, index[v])
    if t == "fixed":
        names.types[schema.get("name", "")] = schema
        return lambda o, v: o.write(bytes(v))
    if t == "array":
        item = _encoder(schema["items"], names)

        def ea(o, v, item=item):
            if v:
                _write_long(o, len(v))
                for x in v:
                    item(o, x)
            _write_long(o, 0)
        return ea
    if t == "map":
        val = _encoder(schema["values"], names)

        def em(o, v, val=val):
            if v:
                _write_long(o, len(v))
                for k, x in v.items():
                    _write_bytes(o, str(k).encode("utf-8"))
                    val(o, x)
            _write_long(o, 0)
        return em
    return _encoder(t, names)


# --------------------------------------------------------------------------- #
# container file                                                              #
# --------------------------------------------------------------------------- #

def read_container(path: str) -> Tuple[Any, List[Any]]:
    """→ (schema, records). Codec: null or deflate (raw, per spec)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:
            n = -n
            _read_long(buf)
        for _ in range(n):
            k = _read_bytes(buf).decode("utf-8")
            meta[k] = _read_bytes(buf)
    sync = buf.read(16)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    dec = _decoder(schema, _Names())
    records: List[Any] = []
    while buf.tell() < len(data):
        count = _read_long(buf)
        size = _read_long(buf)
        block = buf.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        bb = io.BytesIO(block)
        for _ in range(count):
            records.append(dec(bb))
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch (corrupt block)")
    return schema, records


def write_container(path: str, schema: Any, records: List[Any],
                    codec: str = "deflate", block_records: int = 4096) -> None:
    enc = _encoder(schema, _Names())
    sync = os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8")}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode("utf-8"))
        _write_bytes(out, v)
    _write_long(out, 0)
    out.write(sync)
    for start in range(0, len(records), block_records):
        chunk = records[start:start + block_records]
        bb = io.BytesIO()
        for r in chunk:
            enc(bb, r)
        payload = bb.getvalue()
        if codec == "deflate":
            co = zlib.compressobj(9, zlib.DEFLATED, -15)
            payload = co.compress(payload) + co.flush()
        _write_long(out, len(chunk))
        _write_long(out, len(payload))
        out.write(payload)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


# --------------------------------------------------------------------------- #
# FeatureType mapping                                                         #
# --------------------------------------------------------------------------- #

def register_named_types(schema: Any, names: _Names,
                         enclosing_ns: Optional[str] = None) -> None:
    """Register every named type (record, enum, fixed) under its short
    name and its namespace-qualified full name, recursively, so that
    references inside array items, map values and nested fields resolve
    in a schema-only walk. A nested type without its own `namespace`
    takes the enclosing one."""
    if isinstance(schema, list):
        for s in schema:
            register_named_types(s, names, enclosing_ns)
        return
    if not isinstance(schema, dict):
        return
    t = schema.get("type")
    ns = schema.get("namespace", enclosing_ns)
    if t in ("record", "error", "enum", "fixed") and schema.get("name"):
        names.types[schema["name"]] = schema
        if ns:
            names.types[f"{ns}.{schema['name']}"] = schema
    if t in ("record", "error"):
        for f in schema.get("fields", []):
            register_named_types(f.get("type"), names, ns)
    elif t == "array":
        register_named_types(schema.get("items"), names, ns)
    elif t == "map":
        register_named_types(schema.get("values"), names, ns)


def avro_ftype(field_schema: Any, names: Optional[_Names] = None) -> type:
    """An Avro field schema's FeatureType (the JAX package's mapping).
    Unions drop their null branch."""
    from transmogrifai_tpu_torch import types as T

    names = names or _Names()
    s = _resolve(field_schema, names)
    if isinstance(s, list):
        non_null = [x for x in s if x != "null"]
        return avro_ftype(non_null[0], names) if non_null else T.Text
    if isinstance(s, dict):
        t = s["type"]
        register_named_types(s, names)
        if s.get("logicalType") in ("timestamp-millis", "timestamp-micros",
                                    "local-timestamp-millis", "date"):
            return T.DateTime
        if t in ("record", "map"):
            return T.TextMap
        if t == "enum":
            return T.PickList
        if t == "array":
            item = _resolve(s["items"], names)
            base = item if isinstance(item, str) else (
                [x for x in item if x != "null"][0] if isinstance(item, list)
                else item.get("type"))
            if base in ("float", "double"):
                return T.Geolocation
            if base in ("int", "long"):
                return T.DateList
            return T.TextList
        if t == "fixed":
            return T.Text
        return avro_ftype(t, names)
    return {
        "boolean": T.Binary, "int": T.Integral, "long": T.Integral,
        "float": T.Real, "double": T.Real, "string": T.Text,
        "bytes": T.Base64, "null": T.Text,
    }.get(s, T.Text)


def dataset_avro_schema(ds, name: str = "Record") -> Dict[str, Any]:
    """A record schema of nullable unions for a Dataset's columns."""
    from transmogrifai_tpu_torch import types as T

    fields = []
    for col, ftype in ds.schema.items():
        if issubclass(ftype, T.Binary):
            base: Any = "boolean"
        elif issubclass(ftype, (T.Date, T.DateTime)) or \
                issubclass(ftype, T.Integral):
            base = "long"
        elif issubclass(ftype, T.OPNumeric):
            base = "double"
        elif issubclass(ftype, (T.TextList, T.MultiPickList)):
            base = {"type": "array", "items": "string"}
        elif issubclass(ftype, (T.DateList,)):
            base = {"type": "array", "items": "long"}
        elif issubclass(ftype, T.Geolocation):
            base = {"type": "array", "items": "double"}
        elif issubclass(ftype, T.GeolocationMap):
            base = {"type": "map", "values": [
                "null", {"type": "array", "items": "double"}]}
        elif issubclass(ftype, T.MultiPickListMap):
            base = {"type": "map", "values": [
                "null", {"type": "array", "items": "string"}]}
        elif issubclass(ftype, T.OPMap):
            # long before double: integral map values stay integers
            base = {"type": "map", "values": ["null", "string", "long",
                                              "double", "boolean"]}
        else:
            base = "string"
        fields.append({"name": col, "type": ["null", base], "default": None})
    return {"type": "record", "name": name, "fields": fields}


def _record_to_row(rec: Any) -> Mapping[str, Any]:
    if isinstance(rec, dict):
        return {k: (set(v) if isinstance(v, frozenset) else v)
                for k, v in rec.items()}
    return {"value": rec}


def container_ftypes(avsc: Any) -> Dict[str, type]:
    """{field: FeatureType} of a container's writer schema: a record's
    fields by `avro_ftype`, with its named types resolved; {} for any
    other schema."""
    out: Dict[str, type] = {}
    if isinstance(avsc, dict) and avsc.get("type") == "record":
        names = _Names()
        _decoder(avsc, names)  # registers the named types
        for f in avsc["fields"]:
            out[f["name"]] = avro_ftype(f["type"], names)
    return out


def dataset_from_avro(path: str,
                      schema: Optional[Mapping[str, type]] = None):
    """An Avro container as a Dataset: FeatureTypes from the writer schema
    unless `schema` names them."""
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.data.dataset import Dataset

    avsc, records = read_container(path)
    sch = container_ftypes(avsc)
    sch.update(schema or {})
    ds = Dataset.from_rows([_record_to_row(r) for r in records], schema=sch)
    # arrays decode as lists: a MultiPickList column's (and a
    # MultiPickListMap's values) become sets
    for col, ftype in list(ds.schema.items()):
        arr = ds.columns[col]
        if issubclass(ftype, T.MultiPickList):
            for i, v in enumerate(arr):
                if isinstance(v, list):
                    arr[i] = set(v)
        elif issubclass(ftype, T.MultiPickListMap):
            for i, v in enumerate(arr):
                if isinstance(v, dict):
                    arr[i] = {k: set(x) if isinstance(x, list) else x
                              for k, x in v.items()}
    return ds


def _avro_value(v: Any) -> Any:
    """A map value as the writer takes it: numpy scalars as python
    values, sets as sorted lists."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    return v


def _avro_column(arr: np.ndarray, binary: bool, int_like: bool,
                 typed_map: bool) -> list:
    """One Dataset column as the writer's values, by the JAX package's
    per-row rules: None where missing, booleans and integers where typed
    so, sets sorted, numpy scalars as python values."""
    if arr.dtype != object:  # numeric storage: NaN is missing
        f = arr.astype(np.float64)
        if binary:
            conv = bool
        elif int_like:
            conv = int
        else:
            return [None if v != v else v for v in f.tolist()]
        return [None if v != v else conv(v) for v in f.tolist()]
    out = []
    for v in arr:
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, (set, frozenset)):
            v = sorted(v)
        elif v is not None and binary:
            v = bool(v)
        elif v is not None and int_like and isinstance(v, float):
            v = int(v)
        elif v is not None and typed_map:
            v = {k: _avro_value(x) for k, x in v.items()}
        out.append(v)
    return out


def dataset_to_avro(ds, path: str, codec: str = "deflate",
                    name: str = "Record") -> None:
    from transmogrifai_tpu_torch import types as T

    avsc = dataset_avro_schema(ds, name=name)
    names = ds.names()
    columns = [_avro_column(
        ds.columns[c], issubclass(ds.schema[c], T.Binary),
        issubclass(ds.schema[c], (T.Integral, T.Date, T.DateTime)),
        issubclass(ds.schema[c], (T.GeolocationMap, T.MultiPickListMap)))
        for c in names]
    records = [dict(zip(names, vals)) for vals in zip(*columns)]
    write_container(path, avsc, records, codec=codec)
