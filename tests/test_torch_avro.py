"""Parity of the port's Avro container codec and readers with the JAX
package on the CPU (ROADMAP queue 1, item 2).

The cases of tests/test_avro.py run against the port (its CLI cases stay
with queue 1, item 10). Then containers written by each package are read
by the other: records equal, Datasets equal, and the files' bytes equal
once the 16-byte sync markers (drawn at random per file) are masked. The
port writes two things the JAX package refuses ("no union branch"):
numpy scalars inside map values, and GeolocationMap / MultiPickListMap
columns (a typed map schema); the JAX package reads those containers.
"""

import io
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import transmogrifai_tpu.data.avro as javro  # noqa: E402
import transmogrifai_tpu.types as jt  # noqa: E402
from transmogrifai_tpu.data import Dataset as JDataset  # noqa: E402

import transmogrifai_tpu_torch.data.avro as pavro  # noqa: E402
import transmogrifai_tpu_torch.types as T  # noqa: E402
from transmogrifai_tpu_torch.data.avro import (  # noqa: E402
    _Names, _decoder, _encoder, _read_long, _write_long, avro_ftype,
    read_container, write_container)
from transmogrifai_tpu_torch.data.dataset import Dataset  # noqa: E402
from transmogrifai_tpu_torch.readers import DataReaders  # noqa: E402

import chip_smoke  # noqa: E402


# --------------------------------------------------------------------------- #
# tests/test_avro.py's cases on the port                                      #
# --------------------------------------------------------------------------- #

def test_zigzag_varint_roundtrip():
    for n in (0, 1, -1, 63, -64, 64, 1 << 20, -(1 << 20), (1 << 62),
              -(1 << 62)):
        out = io.BytesIO()
        _write_long(out, n)
        assert _read_long(io.BytesIO(out.getvalue())) == n


def test_known_zigzag_bytes():
    for n, b in ((0, b"\x00"), (-1, b"\x01"), (1, b"\x02"), (-2, b"\x03"),
                 (2, b"\x04"), (-64, b"\x7f"), (64, b"\x80\x01")):
        out = io.BytesIO()
        _write_long(out, n)
        assert out.getvalue() == b


SCHEMA = {
    "type": "record", "name": "Passenger",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"], "default": None},
        {"name": "age", "type": ["null", "double"], "default": None},
        {"name": "survived", "type": "boolean"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "scores", "type": {"type": "map", "values": "double"}},
        {"name": "klass", "type": {"type": "enum", "name": "K",
                                   "symbols": ["a", "b", "c"]}},
    ],
}

RECORDS = [
    {"id": 1, "name": "Ann", "age": 31.5, "survived": True,
     "tags": ["x", "y"], "scores": {"m": 1.0}, "klass": "a"},
    {"id": 2, "name": None, "age": None, "survived": False,
     "tags": [], "scores": {}, "klass": "c"},
    {"id": 3, "name": "Bob", "age": 4.0, "survived": True,
     "tags": ["z"], "scores": {"m": -2.5, "n": 0.0}, "klass": "b"},
]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_container_roundtrip(tmp_path, codec):
    path = str(tmp_path / f"p_{codec}.avro")
    write_container(path, SCHEMA, RECORDS, codec=codec)
    schema, records = read_container(path)
    assert schema == SCHEMA
    assert records == RECORDS


def test_container_multiblock(tmp_path):
    path = str(tmp_path / "blocks.avro")
    many = [{"id": i, "name": f"r{i}", "age": float(i),
             "survived": i % 2 == 0, "tags": [], "scores": {}, "klass": "a"}
            for i in range(1000)]
    write_container(path, SCHEMA, many, block_records=64)
    _, records = read_container(path)
    assert records == many


def test_binary_encode_decode_all_types():
    sch = {"type": "record", "name": "R", "fields": [
        {"name": "i", "type": "int"},
        {"name": "f", "type": "float"},
        {"name": "by", "type": "bytes"},
        {"name": "fx", "type": {"type": "fixed", "name": "F", "size": 3}},
        {"name": "u", "type": ["null", "long", "string"]},
    ]}
    rec = {"i": -7, "f": 2.5, "by": b"\x00\x01", "fx": b"abc", "u": "s"}
    out = io.BytesIO()
    _encoder(sch, _Names())(out, rec)
    assert _decoder(sch, _Names())(io.BytesIO(out.getvalue())) == rec


def test_avro_ftype_mapping():
    names = _Names()
    assert avro_ftype("long", names) is T.Integral
    assert avro_ftype("double", names) is T.Real
    assert avro_ftype("boolean", names) is T.Binary
    assert avro_ftype("string", names) is T.Text
    assert avro_ftype(["null", "string"], names) is T.Text
    assert avro_ftype({"type": "array", "items": "string"},
                      names) is T.TextList
    assert avro_ftype({"type": "array", "items": "double"},
                      names) is T.Geolocation
    assert avro_ftype({"type": "map", "values": "double"},
                      names) is T.TextMap
    assert avro_ftype({"type": "enum", "name": "E", "symbols": ["x"]},
                      names) is T.PickList
    assert avro_ftype({"type": "long", "logicalType": "timestamp-millis"},
                      names) is T.DateTime


def test_dataset_from_avro(tmp_path):
    path = str(tmp_path / "ds.avro")
    write_container(path, SCHEMA, RECORDS)
    ds = Dataset.from_avro(path)
    assert len(ds) == 3
    assert ds.schema["id"] is T.Integral
    assert ds.schema["name"] is T.Text
    assert ds.schema["age"] is T.Real
    assert ds.schema["survived"] is T.Binary
    assert ds.schema["tags"] is T.TextList
    assert ds.schema["klass"] is T.PickList
    age = ds.column("age")
    assert age[0] == 31.5 and np.isnan(age[1])
    assert list(ds.column("name")) == ["Ann", None, "Bob"]


def test_dataset_avro_roundtrip(tmp_path):
    ds = Dataset.from_rows(
        [{"x": 1.5, "n": 3, "s": "a", "b": True, "lst": ["p", "q"],
          "mp": {"k": 1.0}},
         {"x": None, "n": None, "s": None, "b": None, "lst": None,
          "mp": None}],
        schema={"x": T.Real, "n": T.Integral, "s": T.Text, "b": T.Binary,
                "lst": T.TextList, "mp": T.RealMap})
    path = str(tmp_path / "rt.avro")
    ds.to_avro(path)
    back = Dataset.from_avro(path, schema=dict(ds.schema))
    assert len(back) == 2
    assert back.column("x")[0] == 1.5 and np.isnan(back.column("x")[1])
    assert back.column("n")[0] == 3
    assert back.column("s")[0] == "a" and back.column("s")[1] is None
    assert back.column("lst")[0] == ["p", "q"]
    assert back.column("mp")[0] == {"k": 1.0}


def test_avro_reader_and_stream(tmp_path):
    path = str(tmp_path / "r.avro")
    write_container(path, SCHEMA, RECORDS)
    ds = DataReaders.avro(path, key_column="id").read()
    assert len(ds) == 3
    from transmogrifai_tpu_torch.readers.readers import KEY_COLUMN
    assert list(ds.column(KEY_COLUMN)) == ["1", "2", "3"]
    batches = list(DataReaders.stream(avro_path=path, batch_size=2).stream())
    assert [len(b) for b in batches] == [2, 1]
    assert batches[0].schema["age"] is T.Real


def test_workflow_trains_from_avro(tmp_path):
    """An Avro file → reader → transmogrify → LR train → score."""
    from transmogrifai_tpu_torch import (
        FeatureBuilder, OpLogisticRegression, Workflow, transmogrify)
    rng = np.random.default_rng(0)
    n = 120
    x = rng.normal(size=n)
    recs = [{"x": float(x[i]), "c": ["u", "v"][int(rng.integers(2))],
             "y": float(x[i] + rng.normal(0, 0.3) > 0)} for i in range(n)]
    sch = {"type": "record", "name": "Row", "fields": [
        {"name": "x", "type": ["null", "double"], "default": None},
        {"name": "c", "type": ["null", "string"], "default": None},
        {"name": "y", "type": "double"}]}
    path = str(tmp_path / "train.avro")
    write_container(path, sch, recs)
    ds = DataReaders.avro(path, schema={"c": T.PickList,
                                        "y": T.Integral}).read()
    preds, label = FeatureBuilder.from_dataset(ds, response="y")
    pf = OpLogisticRegression(max_iter=15).set_input(
        label, transmogrify(preds)).get_output()
    model = Workflow().set_result_features(pf, label) \
        .set_input_dataset(ds).train(device="cpu")
    pred = np.asarray(model.score(ds)[pf.name].data["prediction"])
    assert pred.shape == (n,)
    assert float((pred == np.array([r["y"] for r in recs])).mean()) > 0.8


def test_nested_named_type_registration():
    names = _Names()
    assert avro_ftype({"type": "array",
                       "items": {"type": "enum", "name": "Tag",
                                 "namespace": "com.x",
                                 "symbols": ["a", "b"]}}, names) is T.TextList
    assert avro_ftype("Tag", names) is T.PickList
    assert avro_ftype("com.x.Tag", names) is T.PickList


def test_namespace_inheritance():
    names = _Names()
    pavro.register_named_types({
        "type": "record", "name": "Outer", "namespace": "com.x",
        "fields": [{"name": "tag",
                    "type": {"type": "enum", "name": "Tag",
                             "symbols": ["a"]}}]}, names)
    assert avro_ftype("com.x.Tag", names) is T.PickList


# --------------------------------------------------------------------------- #
# each package reads the other's containers                                   #
# --------------------------------------------------------------------------- #

FTYPE_CASES = [
    "long", "int", "double", "float", "boolean", "string", "bytes", "null",
    ["null", "string"], ["null", "long", "string"], ["string", "null"],
    ["null"],
    {"type": "array", "items": "string"},
    {"type": "array", "items": "double"},
    {"type": "array", "items": "float"},
    {"type": "array", "items": "long"},
    {"type": "array", "items": ["null", "int"]},
    {"type": "array", "items": {"type": "enum", "name": "E2",
                                "symbols": ["a"]}},
    {"type": "map", "values": "double"},
    {"type": "record", "name": "Inner", "fields": []},
    {"type": "enum", "name": "E", "symbols": ["x"]},
    {"type": "fixed", "name": "Fx", "size": 4},
    {"type": "long", "logicalType": "timestamp-millis"},
    {"type": "long", "logicalType": "timestamp-micros"},
    {"type": "long", "logicalType": "local-timestamp-millis"},
    {"type": "int", "logicalType": "date"},
    {"type": "string"},
    "Unknown.Name",
]


@pytest.mark.parametrize("case", range(len(FTYPE_CASES)))
def test_avro_ftype_equals_jax(case):
    sch = FTYPE_CASES[case]
    got = avro_ftype(sch, _Names())
    want = javro.avro_ftype(sch, javro._Names())
    assert got.__name__ == want.__name__


MIXED_SCHEMA = {"type": "record", "name": "Mixed", "namespace": "com.x",
                "fields": [
                    {"name": "n", "type": ["null", "long"]},
                    {"name": "b", "type": ["null", "boolean"]},
                    {"name": "u", "type": ["null", "long", "double",
                                           "boolean", "string"]},
                    {"name": "e", "type": {"type": "enum", "name": "Kind",
                                           "symbols": ["p", "q"]}},
                    {"name": "e2", "type": ["null", "Kind"]},
                    {"name": "m", "type": {"type": "map", "values": [
                        "null", "string", "long", "double", "boolean"]}},
                    {"name": "a", "type": {"type": "array", "items": [
                        "null", "double"]}}]}


def mixed_records():
    """bool before int (bool is an int subclass), ints that must pick long
    over double, floats, nulls, unicode, and big integers past 2^53."""
    return [
        {"n": 1, "b": True, "u": True, "e": "p", "e2": None,
         "m": {"t": True, "i": 3, "f": 2.5, "s": "ß", "z": None},
         "a": [1.5, None]},
        {"n": None, "b": False, "u": 7, "e": "q", "e2": "p",
         "m": {"big": (1 << 60) + 1}, "a": []},
        {"n": -(1 << 62), "b": None, "u": -0.0, "e": "p", "e2": "q",
         "m": {}, "a": [float("inf")]},
        {"n": 0, "b": True, "u": "東京", "e": "q", "e2": None,
         "m": {"neg": -1}, "a": [None]},
        {"n": 5, "b": True, "u": None, "e": "p", "e2": None,
         "m": {"e": ""}, "a": [0.1]},
    ]


def sync_of(path: str) -> bytes:
    """The 16-byte sync marker that ends a container's header."""
    with open(path, "rb") as fh:
        buf = io.BytesIO(fh.read())
    buf.read(4)
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        for _ in range(abs(n)):
            buf.read(_read_long(buf))
            buf.read(_read_long(buf))
    return buf.read(16)


def masked_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    return data.replace(sync_of(path), b"\x00" * 16)


WRITERS = {"port": pavro.write_container, "jax": javro.write_container}
READERS = {"port": pavro.read_container, "jax": javro.read_container}


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_containers_cross_read_with_equal_bytes(tmp_path, codec, writer):
    recs = mixed_records() * 3
    paths = {}
    for who in ("port", "jax"):
        paths[who] = str(tmp_path / f"{who}_{codec}.avro")
        WRITERS[who](paths[who], MIXED_SCHEMA, recs, codec=codec,
                     block_records=4)
    reader = "jax" if writer == "port" else "port"
    schema, got = READERS[reader](paths[writer])
    assert schema == MIXED_SCHEMA
    assert got == recs
    assert [{k: type(v) for k, v in r["m"].items()} for r in got] == \
        [{k: type(v) for k, v in r["m"].items()} for r in recs]
    assert masked_bytes(paths["port"]) == masked_bytes(paths["jax"])
    assert sync_of(paths["port"]) != sync_of(paths["jax"])


JAX_WRITABLE = chip_smoke.STRUCT_AVRO_COLUMNS


def structural_subset(n, cols, seed=3):
    rows = [{c: r[c] for c in cols}
            for r in chip_smoke.structural_rows(n, seed=seed)]
    return rows


dataset_rows = chip_smoke.plain_rows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_structural_tables_cross_read(tmp_path, writer):
    """Every column type the JAX package can write, through each
    package's `dataset_to_avro` and the other's `dataset_from_avro`:
    the same bytes but the sync markers, and equal rows."""
    rows = structural_subset(300, JAX_WRITABLE)
    psch = {c: f for c, f in chip_smoke.structural_schema(T).items()
            if c in JAX_WRITABLE}
    jsch = {c: getattr(jt, f.__name__) for c, f in psch.items()}
    pds = Dataset.from_rows(rows, schema=psch)
    jds = JDataset.from_rows(rows, schema=jsch)
    paths = {"port": str(tmp_path / "p.avro"),
             "jax": str(tmp_path / "j.avro")}
    pavro.dataset_to_avro(pds, paths["port"])
    javro.dataset_to_avro(jds, paths["jax"])
    assert masked_bytes(paths["port"]) == masked_bytes(paths["jax"])
    if writer == "port":
        back = javro.dataset_from_avro(paths["port"], schema=jsch)
    else:
        back = pavro.dataset_from_avro(paths["jax"], schema=psch)
    assert list(back.schema) == list(psch)
    assert dataset_rows(back) == dataset_rows(pds)


def test_port_writes_what_jax_refuses(tmp_path):
    """GeolocationMap and MultiPickListMap columns, and numpy scalars in
    map values: the JAX package's writer finds no union branch; the
    port's writes them and the JAX package reads them back."""
    cols = ("interests", "geos")
    rows = structural_subset(50, cols)
    psch = {c: getattr(T, chip_smoke.structural_schema(T)[c].__name__)
            for c in cols}
    jsch = {c: getattr(jt, f.__name__) for c, f in psch.items()}
    with pytest.raises(ValueError, match="no union branch"):
        javro.dataset_to_avro(JDataset.from_rows(rows, schema=jsch),
                              str(tmp_path / "j.avro"))
    path = str(tmp_path / "p.avro")
    pavro.dataset_to_avro(Dataset.from_rows(rows, schema=psch), path)
    for back in (pavro.dataset_from_avro(path, schema=psch),
                 javro.dataset_from_avro(path, schema=jsch)):
        got = dataset_rows(back)
        for g, r in zip(got, rows):
            assert {k: set(v) for k, v in (g["interests"] or {}).items()} \
                == (r["interests"] or {})
            assert (g["geos"] or {}) == (r["geos"] or {})
    np_rows = [{"m": {"a": np.int64(3), "b": np.float32(0.5),
                      "c": np.bool_(True)}}]
    with pytest.raises(ValueError, match="no union branch"):
        javro.dataset_to_avro(JDataset.from_rows(
            np_rows, schema={"m": jt.RealMap}), str(tmp_path / "jn.avro"))
    pavro.dataset_to_avro(Dataset.from_rows(
        np_rows, schema={"m": T.RealMap}), str(tmp_path / "pn.avro"))
    _, recs = javro.read_container(str(tmp_path / "pn.avro"))
    assert recs == [{"m": {"a": 3, "b": 0.5, "c": True}}]
    assert type(recs[0]["m"]["a"]) is int


@pytest.mark.parametrize("reader", ["simple", "stream"])
def test_readers_equal_jax_on_the_same_container(tmp_path, reader):
    rows = structural_subset(120, JAX_WRITABLE)
    jsch = {c: getattr(jt, chip_smoke.structural_schema(jt)[c].__name__)
            for c in JAX_WRITABLE}
    path = str(tmp_path / "s.avro")
    javro.dataset_to_avro(JDataset.from_rows(rows, schema=jsch), path)
    psch = {c: getattr(T, f.__name__) for c, f in jsch.items()}
    from transmogrifai_tpu.readers import DataReaders as JDR
    if reader == "simple":
        got = [DataReaders.avro(path, schema=psch).read()]
        want = [JDR.avro(path, schema=jsch).read()]
    else:
        got = list(DataReaders.stream(avro_path=path, batch_size=50)
                   .stream())
        want = list(JDR.stream(avro_path=path, batch_size=50).stream())
    assert [len(d) for d in got] == [len(d) for d in want]
    for g, w in zip(got, want):
        assert [k for k in g.schema] == [k for k in w.schema]
        assert [f.__name__ for f in g.schema.values()] == \
            [f.__name__ for f in w.schema.values()]
        assert dataset_rows(g) == dataset_rows(w)


def test_committed_jax_container_reads_as_expected():
    """`chip_smoke.py` phase 27 (a)'s committed container, written by the
    JAX package: the port reads the rows the generator made."""
    ns = chip_smoke.structural_namespace()
    got, want = chip_smoke.committed_avro_rows(ns)
    assert got == want
