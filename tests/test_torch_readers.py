"""Parity of the port's aggregators and readers with the JAX package on
the CPU: every default monoid, the cutoff and window rules, the
aggregating, conditional, joined, streaming and CSV readers, the
vectorized columnar aggregation, a workflow trained through a reader,
and the two aggregation examples (`examples/op_joins_aggregates.py`,
`examples/op_conditional_aggregation.py`).

The inputs are those of tests/test_readers.py, test_columnar_agg.py and
test_dataprep_examples.py. All of this is host Python over the same
values, so every comparison is exact: the same rows in the same order,
the same column order and types, the same pre-extracted marking.
"""

import os
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def pkg(name: str) -> types.SimpleNamespace:
    """The reader-side API of the JAX package ("jax") or the port."""
    if name == "jax":
        import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
        import transmogrifai_tpu.aggregators as agg
        import transmogrifai_tpu.readers as readers
        import transmogrifai_tpu.readers.columnar_agg as columnar
        import transmogrifai_tpu.types as t
        from transmogrifai_tpu.data import Dataset
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.ops.numeric import RealVectorizer
        from transmogrifai_tpu.workflow import Workflow
        train_kw = {}
    else:
        import transmogrifai_tpu_torch.aggregators as agg
        import transmogrifai_tpu_torch.readers as readers
        import transmogrifai_tpu_torch.readers.columnar_agg as columnar
        import transmogrifai_tpu_torch.types as t
        from transmogrifai_tpu_torch import Dataset, FeatureBuilder
        from transmogrifai_tpu_torch.ops.numeric import RealVectorizer
        from transmogrifai_tpu_torch.workflow import Workflow
        train_kw = {"device": "cpu"}
    return types.SimpleNamespace(
        agg=agg, readers=readers, columnar=columnar, t=t, Dataset=Dataset,
        FeatureBuilder=FeatureBuilder, RealVectorizer=RealVectorizer,
        Workflow=Workflow, train_kw=train_kw)


def plain(v):
    """A cell as a comparable python value: NaN as None, sets sorted."""
    if v is None:
        return None
    if isinstance(v, (float, np.floating)):
        return None if np.isnan(v) else float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted(v)))
    if isinstance(v, dict):
        return ("dict", tuple(sorted((k, plain(x)) for k, x in v.items())))
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return v


def table(ds):
    """(column names, {name: type name}, rows, pre-extracted names)."""
    return (list(ds.names()), {k: v.__name__ for k, v in ds.schema.items()},
            [tuple(plain(r[k]) for k in ds.names()) for r in ds.to_rows()],
            sorted(getattr(ds, "pre_extracted", None) or ()))


# --------------------------------------------------------------------------- #
# aggregators                                                                 #
# --------------------------------------------------------------------------- #

# (feature type, event values): the default monoid of each type over a
# list with a missing value, and over no events at all
AGG_CASES = {
    "Real": [1.5, 2.5, None], "RealNN": [1.0, None, 2.25],
    "Currency": [3.0, 4.5], "Integral": [2, 3, None],
    "Percent": [0.2, 0.6, None], "Binary": [False, True, None],
    "Date": [100, 500, 300], "DateTime": [7, 3], "Text": ["a", None, "b"],
    "PickList": ["b", "a", "b", "a"], "MultiPickList": [{"x", "y"},
                                                         {"y", "z"}],
    "TextList": [["a"], ["b", "c"]], "DateList": [[1], [2, 3]],
    "Geolocation": [[0.0, 0.0, 1.0], [0.0, 90.0, 5.0], None],
    "RealMap": [{"a": 1.0, "b": 2.0}, {"b": 3.0, "c": 4.0}],
    "TextMap": [{"a": "x"}, {"a": "y", "b": "z"}],
    "IntegralMap": [{"a": 1}, {"a": 2}], "BinaryMap": [{"a": False},
                                                       {"a": True}],
    "PercentMap": [{"a": 0.5}, {"a": 0.25}],
    "DateMap": [{"a": 5}, {"a": 9}],
    "MultiPickListMap": [{"a": {"x"}}, {"a": {"y"}}],
    "GeolocationMap": [{"a": [10.0, 20.0, 1.0]}, {"a": [30.0, 40.0, 2.0]}],
    "OPVector": [[1.0, 2.0], [3.0]],
}


@pytest.mark.parametrize("ftype", sorted(AGG_CASES))
def test_default_aggregators_match_jax(ftype):
    got, want = [], []
    for out, name in ((got, "port"), (want, "jax")):
        ns = pkg(name)
        agg = ns.agg.default_aggregator(getattr(ns.t, ftype))
        evs = [ns.agg.Event(i, v) for i, v in enumerate(AGG_CASES[ftype])]
        out += [agg.name, plain(agg(evs)), plain(agg([]))]
    assert got == want


def test_monoid_factories_match_jax():
    cases = []
    for name in ("port", "jax"):
        a = pkg(name).agg
        evs = [a.Event(5, "late"), a.Event(1, "early"), a.Event(3, "mid")]
        nums = [a.Event(t, float(t)) for t in range(6)]
        cases.append([
            a.first_agg()(evs), a.last_agg()(evs),
            a.mean_agg()(nums), a.mean_agg("MeanRealNN", zero=(0.0, 0))([]),
            a.min_agg()(nums), a.max_agg(integral=True)(nums),
            a.min_agg("MinRealNN", zero=np.inf)([]),
            a.logical_and_agg()([a.Event(0, True), a.Event(1, False)]),
            a.logical_xor_agg()([a.Event(0, True), a.Event(1, True)]),
            a.concat_agg("|")(evs), a.mode_agg()(evs),
            plain(a.union_map_agg(a.mean_agg())(
                [a.Event(0, {"k": 1.0}), a.Event(1, {"k": 3.0})])),
            a.sum_vector_agg()([a.Event(0, [1.0, 2.0]),
                                a.Event(1, [3.0, 4.0])]),
            a.custom_agg(lambda x, y: x * y)(
                [a.Event(0, 2.0), a.Event(1, 5.0)]),
            a.sum_agg("SumReal")([]), a.sum_agg("SumRealNN", zero=0.0)([])])
    assert cases[0] == cases[1]


@pytest.mark.parametrize("case", [
    "predictor", "response", "window", "response_window", "no_cutoff",
    "infinite_future", "reader_windows", "realnn_empty"])
def test_aggregate_events_matches_jax(case):
    outs = []
    for name in ("port", "jax"):
        ns = pkg(name)
        a, t = ns.agg, ns.t
        evs = [a.Event(tt, float(tt)) for tt in range(10)]
        cut = a.CutOffTime.unix_epoch(5)
        kw = {"predictor": dict(cutoff=cut),
              "response": dict(cutoff=cut, is_response=True),
              "window": dict(cutoff=a.CutOffTime.unix_epoch(8), window_ms=3),
              "response_window": dict(cutoff=cut, is_response=True,
                                      window_ms=2),
              "no_cutoff": dict(cutoff=a.CutOffTime.no_cutoff()),
              "infinite_future": dict(cutoff=a.CutOffTime.infinite_future(),
                                      window_ms=2),
              "reader_windows": dict(cutoff=cut, predictor_window_ms=1,
                                     response_window_ms=1),
              "realnn_empty": dict(cutoff=a.CutOffTime.unix_epoch(0))}[case]
        ftype = t.RealNN if case == "realnn_empty" else t.Real
        outs.append(a.aggregate_events(evs, ftype, **kw))
    assert outs[0] == outs[1]


def test_cutoff_kinds_match_jax():
    now = 1_000 * 86_400_000
    got = [(c.kind, c.timestamp) for c in (
        f(pkg(name).agg.CutOffTime) for name in ("port", "jax")
        for f in (lambda C: C.days_ago(10, now),
                  lambda C: C.weeks_ago(2, now),
                  lambda C: C.ddmmyyyy("04092017"),
                  lambda C: C.unix_epoch(123)))]
    assert got[:4] == got[4:]


# --------------------------------------------------------------------------- #
# readers                                                                     #
# --------------------------------------------------------------------------- #

EVENTS = [
    {"id": "a", "day": 1, "amount": 10.0, "tag": "x", "converted": 0},
    {"id": "a", "day": 2, "amount": 5.0, "tag": "y", "converted": 0},
    {"id": "a", "day": 8, "amount": 99.0, "tag": "z", "converted": 1},
    {"id": "b", "day": 3, "amount": 2.0, "tag": "x", "converted": 0},
    {"id": "b", "day": 9, "amount": 50.0, "tag": "x", "converted": 0},
]


def raw_features(ns):
    FB = ns.FeatureBuilder
    return (FB.Real("amount").from_column("amount").as_predictor(),
            FB.PickList("tag").from_column("tag").as_predictor(),
            FB.Binary("converted").from_column("converted").as_response())


def key(r):
    return r["id"]


def day(r):
    return r["day"]


def converted(r):
    return r["converted"] == 1


def reader_case(ns, case):
    """One reader scenario of tests/test_readers.py over package `ns`:
    the dataset it reads."""
    DR = ns.readers.DataReaders
    amount, tag, label = raw_features(ns)
    if case == "aggregate_cutoff":
        return DR.aggregate(EVENTS, key_fn=key, time_fn=day,
                            cutoff=ns.agg.CutOffTime.unix_epoch(5)).read(
            [amount, tag, label])
    if case == "aggregate_custom":
        mean_amount = ns.FeatureBuilder.Real("amount").from_column(
            "amount").aggregate(ns.agg.mean_agg(), window=5).as_predictor()
        return DR.aggregate(EVENTS, key_fn=key, time_fn=day,
                            cutoff=ns.agg.CutOffTime.unix_epoch(9)).read(
            [mean_amount])
    if case.startswith("conditional"):
        _, keep, drop = case.split(":")
        events = EVENTS + [{"id": "a", "day": 6, "amount": 7.0, "tag": "x",
                            "converted": 1}]
        return DR.conditional(
            events, key_fn=key, time_fn=day, target_condition=converted,
            time_stamp_to_keep=keep, drop_if_not_met=drop == "drop",
            response_window_ms=None, predictor_window_ms=None).read(
            [amount, tag, label])
    left = DR.simple(records=[{"id": "a", "age": 30}, {"id": "b", "age": 40}],
                     key_fn=key)
    if case in ("left_join", "inner_join"):
        right = DR.simple(records=[{"id": "a", "city": "sf"}], key_fn=key)
        joined = (left.left_outer_join(right) if case == "left_join"
                  else left.inner_join(right))
        return joined.read([])
    if case in ("secondary", "duplicates", "outer_join"):
        right = DR.simple(records=[
            {"id": "a" if case != "outer_join" else "z", "spend": float(s)}
            for s in (1, 2, 3)], key_fn=key,
            schema={"spend": ns.t.Real, "id": ns.t.Text})
        joined = (left.outer_join(right) if case == "outer_join"
                  else left.left_outer_join(right))
        if case == "secondary":
            joined = joined.with_secondary_aggregation()
        return joined.read([])
    if case == "two_aggregating":
        visits = [{"id": "a", "day": 1, "visits": 1.0},
                  {"id": "a", "day": 2, "visits": 1.0}]
        purchases = [{"id": "a", "day": 1, "spend": 5.0},
                     {"id": "a", "day": 3, "spend": 7.0}]
        nv = ns.FeatureBuilder.Real("visits").from_column("visits") \
            .as_predictor()
        sp = ns.FeatureBuilder.Real("spend").from_column("spend") \
            .as_predictor()
        return DR.aggregate(visits, key_fn=key, time_fn=day,
                            features=[nv]).left_outer_join(
            DR.aggregate(purchases, key_fn=key, time_fn=day,
                         features=[sp])).read([nv, sp])
    if case == "derivable":
        events = [{"id": "a", "day": 1, "spend": 5.0},
                  {"id": "a", "day": 2, "spend": 7.0}]
        sp = ns.FeatureBuilder.Real("spend").from_column("spend") \
            .as_predictor()
        age = ns.FeatureBuilder.Real("age").from_column("age").as_predictor()
        return DR.aggregate(events, key_fn=key, time_fn=day) \
            .left_outer_join(DR.simple(records=[{"id": "a", "age": 33.0}],
                                       key_fn=key)).read([sp, age])
    if case == "csv_key":
        return DR.csv(chip_smoke.TITANIC, key_column="id").read()
    raise KeyError(case)


READER_CASES = ("aggregate_cutoff", "aggregate_custom",
                "conditional:min:drop", "conditional:max:drop",
                "conditional:random:keep", "conditional:max:keep",
                "left_join", "inner_join", "secondary", "duplicates",
                "outer_join", "two_aggregating", "derivable", "csv_key")


@pytest.mark.parametrize("case", READER_CASES)
def test_readers_match_jax(case):
    got = table(reader_case(pkg("port"), case))
    want = table(reader_case(pkg("jax"), case))
    assert got == want


def test_two_aggregating_readers_without_allowlists_raise_like_jax():
    msgs = []
    for name in ("port", "jax"):
        ns = pkg(name)
        DR = ns.readers.DataReaders
        sp = ns.FeatureBuilder.Real("spend").from_column("spend") \
            .as_predictor()
        events = [{"id": "a", "day": 1, "spend": 5.0}]
        a = DR.aggregate(events, key_fn=key, time_fn=day)
        b = DR.aggregate(events, key_fn=key, time_fn=day)
        with pytest.raises(ValueError, match="allowlist") as e:
            a.inner_join(b).read([sp])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("source", ["records", "csv"])
def test_streaming_reader_matches_jax(source, tmp_path):
    path = tmp_path / "s.csv"
    path.write_text("x,y,z\n1,2,a\n3,,b\n5,6.5,\n7,8,d\n9,10,e\n")
    got = []
    for name in ("port", "jax"):
        DR = pkg(name).readers.DataReaders
        r = (DR.stream(records=[{"x": float(i), "s": str(i)}
                                for i in range(10)], batch_size=4)
             if source == "records" else
             DR.stream(csv_path=str(path), batch_size=2))
        got.append([table(b) for b in r.stream()] + [table(r.read())])
    assert got[0] == got[1]


def test_avro_and_parquet_are_refused_by_name(tmp_path):
    """Parquet is refused by name (no pyarrow on the GPU machine); Avro,
    refused until the port had its container codec, now reads (its
    parity is tests/test_torch_avro.py's)."""
    DR = pkg("port").readers.DataReaders
    with pytest.raises(NotImplementedError, match="pyarrow"):
        DR.parquet("x.parquet").read()
    with pytest.raises(NotImplementedError, match="pyarrow"):
        list(DR.stream(parquet_path="x.parquet").stream())
    from transmogrifai_tpu_torch.data.avro import write_container
    path = str(tmp_path / "x.avro")
    write_container(path, {"type": "record", "name": "R", "fields": [
        {"name": "s", "type": ["null", "string"]}]}, [{"s": "a"}, {"s": None}])
    assert list(DR.avro(path).read().column("s")) == ["a", None]
    assert [len(b) for b in DR.stream(avro_path=path).stream()] == [2]


# --------------------------------------------------------------------------- #
# the columnar aggregation                                                    #
# --------------------------------------------------------------------------- #

def columnar_features(ns):
    FB = ns.FeatureBuilder
    return [FB.Real("amount").from_column("amount").as_predictor(),
            FB.Integral("clicks").from_column("clicks").as_predictor(),
            FB.Binary("active").from_column("active").as_predictor(),
            FB.Date("last_seen").from_column("last_seen").as_predictor(),
            FB.Percent("rate").from_column("rate").as_predictor(),
            FB.PickList("tag").from_column("tag").as_predictor(),
            FB.RealNN("label").from_column("label").as_response()]


def columnar_events(ns, n=600, n_keys=60, seed=0):
    """tests/test_columnar_agg.py's events (at a tenth of its size), with a
    PickList column that takes the per-group fallback fold."""
    t = ns.t
    rng = np.random.default_rng(seed)
    keys = rng.integers(n_keys, size=n)
    times = rng.integers(0, 1_000_000, size=n)
    rows = [{"key": f"k{keys[i]}", "t": int(times[i]),
             "amount": (float(rng.normal()) if rng.uniform() > 0.1
                        else None),
             "clicks": int(rng.integers(0, 5)),
             "active": bool(rng.uniform() > 0.5),
             "last_seen": int(times[i]), "rate": float(rng.uniform()),
             "tag": str(rng.choice(["u", "v", "w"])),
             "label": float(rng.uniform() > 0.5),
             "hit": bool(rng.uniform() > 0.7)} for i in range(n)]
    schema = {"key": t.ID, "t": t.Integral, "amount": t.Real,
              "clicks": t.Integral, "active": t.Binary,
              "last_seen": t.Date, "rate": t.Percent, "tag": t.PickList,
              "label": t.RealNN, "hit": t.Binary}
    return rows, ns.Dataset.from_rows(rows, schema=schema)


def columnar_case(ns, case, columnar: bool):
    rows, ds = columnar_events(ns)
    feats = columnar_features(ns)
    R = ns.readers
    if case.startswith("aggregate"):
        cutoff = {"aggregate:none": None,
                  "aggregate:epoch": ns.agg.CutOffTime.unix_epoch(500_000),
                  "aggregate:future": ns.agg.CutOffTime.infinite_future()
                  }[case]
        reader = (R.AggregateDataReader(ds, cutoff=cutoff, key_column="key",
                                        time_column="t") if columnar else
                  R.AggregateDataReader(rows, key_fn=lambda r: r["key"],
                                        time_fn=lambda r: r["t"],
                                        cutoff=cutoff))
    else:
        _, keep, drop = case.split(":")
        kw = dict(time_stamp_to_keep=keep, drop_if_not_met=drop == "drop",
                  seed=7)
        reader = (R.ConditionalDataReader(ds, key_column="key",
                                          time_column="t",
                                          condition_column="hit", **kw)
                  if columnar else
                  R.ConditionalDataReader(
                      rows, key_fn=lambda r: r["key"],
                      time_fn=lambda r: r["t"],
                      target_condition=lambda r: r["hit"], **kw))
    return reader.read(feats)


COLUMNAR_CASES = ("aggregate:none", "aggregate:epoch", "aggregate:future",
                  "conditional:min:keep", "conditional:max:drop",
                  "conditional:random:keep", "conditional:random:drop")


@pytest.mark.parametrize("case", COLUMNAR_CASES)
def test_columnar_aggregation_matches_jax(case):
    """The columnar core equals the JAX package's row for row, and the
    port's own per-record fold (by key: the record path emits keys in
    first-seen order, the columnar one sorted), f64 sums within 1e-9
    relative of the fold as in tests/test_columnar_agg.py."""
    port = columnar_case(pkg("port"), case, columnar=True)
    assert table(port) == table(columnar_case(pkg("jax"), case,
                                              columnar=True))
    oracle = columnar_case(pkg("port"), case, columnar=False)
    by_key = {r["key"]: r for r in oracle.to_rows()}
    assert sorted(by_key) == sorted(r["key"] for r in port.to_rows())
    for r in port.to_rows():
        for name, v in r.items():
            w = by_key[r["key"]][name]
            if isinstance(v, float) and w is not None:
                assert v == pytest.approx(w, rel=1e-9), (name, v, w)
            else:
                assert plain(v) == plain(w), (name, v, w)


# --------------------------------------------------------------------------- #
# workflows through readers, and the examples                                 #
# --------------------------------------------------------------------------- #

def reader_workflow(name):
    ns = pkg(name)
    amount, tag, label = raw_features(ns)
    reader = ns.readers.DataReaders.aggregate(
        EVENTS, key_fn=key, time_fn=day,
        cutoff=ns.agg.CutOffTime.unix_epoch(5))
    vec = ns.RealVectorizer().set_input(amount).get_output()
    model = ns.Workflow().set_result_features(vec, label) \
        .set_reader(reader).train(**ns.train_kw)
    ds = reader.read([amount, tag, label])
    cols = model.score(ds)
    return (np.asarray(cols[vec.name].data),
            [plain(v.value) for v in cols[label.name].to_values()])


def test_workflow_trains_through_a_reader_like_jax():
    (vec, lab), (j_vec, j_lab) = reader_workflow("port"), \
        reader_workflow("jax")
    np.testing.assert_array_equal(vec, j_vec)
    assert lab == j_lab


@pytest.mark.parametrize("example", ["op_joins_aggregates",
                                     "op_conditional_aggregation"])
def test_aggregation_examples_match_jax(example):
    """The example through the port's readers (its own code, imports
    pointed at the port) gives the rows tests/test_dataprep_examples.py
    asserts, and the JAX package's own run's rows."""
    got = chip_smoke.aggregation_example_rows(example, device="cpu")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        mod = __import__(example)
    finally:
        sys.path.pop(0)
    want = {r["key"]: r for r in mod.run()}
    assert got == chip_smoke.AGGREGATION_ROWS[example]
    assert {k: {c: plain(v) for c, v in r.items()}
            for k, r in want.items()} == got
