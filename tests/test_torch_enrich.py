"""The port's text enrichment (`ops/enrich.py`, the phone map of
`ops/maps.py`) against the JAX package on the CPU (ROADMAP queue 1, item
6b): every stage on hostile inputs (empty strings, one digit, "+" numbers
of every supported region, extensions, letters, full-width digits, None,
undecodable base64), `PhoneVectorizer` and `PhoneMapVectorizer` (fitted
keys, metadata, eager and compiled vectors), `transmogrify` over the
email, url, phone and base64 groups and phone maps, and the new DSL
methods.

Tolerance: equal, but for the Real group's mean fill (an f32 sum, whose
order XLA and torch take apart: within one f32 ulp, `F32_ULP` relative).
The phone rules are the JAX package's, including where
they part from the Scala reference (inputs shorter than 2 characters,
extensions; see the port's `ops/enrich.py`).
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_structural import (  # noqa: E402
    assert_vectors, check_stage, fit_both, jax_jitted, meta_json, packages,
    port_compiled)
from transmogrifai_tpu.ops import enrich as jen  # noqa: E402
from transmogrifai_tpu_torch.ops import enrich as pen  # noqa: E402

REGIONS = sorted(pen._PHONE_REGIONS)
F32_ULP = 2.0 ** -23


def hostile_phones():
    """Phones of every supported region (national and "+" forms, valid
    lengths and one digit short or long), extensions, letters, full-width
    digits, a lone "+", one digit, empty and None."""
    out = [None, "", " ", "5", "+", "++1", "+1", "12", "0", "00",
           "(415) 555-2671", "415-555-2671 x12", "415.555.2671 ext. 55",
           "(015) 555-2671", "(415) 155-2671", "1-800-FLOWERS",
           "４１５５５５２６７１", "+１ ４１５ ５５５ ２６７１", "+999 1234567",
           "+9991234567890123", "+44 20 7946 0958", "020 7946 0958",
           "+49 30 1234567", "030 1234567", "+39 06 1234 5678",
           "06 1234 5678", "+7 495 123-45-67", "call me", "+1 (415) 555-26",
           "+1-415-555-2671-99", "0044 20 7946 0958"]
    rng = np.random.default_rng(11)
    for region in REGIONS:
        cc, lo, hi = pen._PHONE_REGIONS[region]
        for k in (lo - 1, lo, hi, hi + 1):
            digits = "".join(str(x) for x in rng.integers(2, 10, k))
            out += [f"+{cc} {digits}", digits, "0" + digits]
    for region, _ in chip_smoke.ENRICH_REGIONS:
        out += [chip_smoke._enrich_phone(rng, region) for _ in range(3)]
    return out


REGION_TEXTS = [None, "", "US", "us", "GB", "Germany", "deutschland",
                "United Kingdom", "Brasil", "Spain", "Narnia", "XX", "ZZ",
                " japan ", "Viet Nam", "korea"]


def text_col(pkg, values, tn="Text"):
    t, Col, _, _, _ = packages()[pkg]
    return Col.from_values(getattr(t, tn), list(values))


def values_of(col):
    """A column's values: the scalar kinds as (value, mask) lists."""
    data = col.data
    if isinstance(data, dict):
        return {k: np.asarray(v).tolist() for k, v in data.items()}
    return list(data)


def host_stage_pair(name, in_types, kw=None):
    kw = kw or {}
    out = {}
    for pkg in ("port", "jax"):
        t, Col, Gen, _, _ = packages()[pkg]
        feats = [Gen(name=f"f{i}", ftype=getattr(t, tn)).get_output()
                 for i, tn in enumerate(in_types)]
        mod = pen if pkg == "port" else jen
        out[pkg] = getattr(mod, name)(**kw).set_input(*feats)
    return out["port"], out["jax"]


def check_host(name, inputs, kw=None):
    """A host stage of ops/enrich.py on `inputs` ([(type name, values)]):
    equal outputs and params in both packages."""
    ps, js = host_stage_pair(name, [tn for tn, _ in inputs], kw)
    got = ps.transform([text_col("port", v, tn) for tn, v in inputs], "cpu")
    want = js.transform([text_col("jax", v, tn) for tn, v in inputs])
    assert got.ftype.__name__ == want.ftype.__name__
    assert values_of(got) == values_of(want)
    assert ps.get_params() == js.get_params()
    return got


EMAILS = [None, "", "a@b.co", "user.1@mail2.com", "no-at-sign.com", "a@b",
          "x@y.c", "@corp1.com", "two@@corp2.com", "sp ace@corp3.com",
          "UPPER@EXAMPLE.ORG", "o'neil+tag@sub.domain.io", "ünï@códe.es",
          "a@b.c.d.museum", " lead@space.com", "trail@space.com "]
URLS = [None, "", "http://a.com", "https://www.site1.org/page1",
        "ftp://files.example.net:21/x", "HTTP://UPPER.COM/Path",
        "htp://site1.com", "www.nohttp.com", "http://localhost",
        "http://bad domain.com", "https://", "ftp//site2.net",
        "  https://padded.io  ", "https://a.b.c.d.co.uk/q?x=1#f",
        "mailto:me@x.com", "https://xn--bcher-kva.ch"]


@pytest.mark.parametrize("name", ["ValidEmailTransformer",
                                  "EmailDomainTransformer",
                                  "EmailToPickListMapTransformer"])
def test_email_stages_equal_jax(name):
    rows = [r["email"] for r in chip_smoke.enrichment_rows(200)]
    check_host(name, [("Email", EMAILS + rows)])


@pytest.mark.parametrize("name", ["UrlIsValidTransformer",
                                  "UrlDomainTransformer",
                                  "UrlProtocolTransformer"])
def test_url_stages_equal_jax(name):
    rows = [r["website"] for r in chip_smoke.enrichment_rows(200)]
    check_host(name, [("URL", URLS + rows)])


@pytest.mark.parametrize("region", ["US", "GB", "DE", "IT", "ZZ", "XX"])
@pytest.mark.parametrize("strict", [False, True])
def test_phone_rules_equal_jax(region, strict):
    """is_valid_phone, parse_phone and the two stages of each against
    one default region, every supported region's numbers included."""
    phones = hostile_phones()
    for p in phones:
        assert pen.is_valid_phone(p, region, strict) == \
            jen.is_valid_phone(p, region, strict), p
        assert pen.parse_phone(p, region, strict) == \
            jen.parse_phone(p, region, strict), p
    kw = {"default_region": region, "strict": strict}
    check_host("PhoneIsValidTransformer", [("Phone", phones)], kw)
    check_host("PhoneParseTransformer", [("Phone", phones)], kw)


@pytest.mark.parametrize("codes", [None, {"FR": "France, Gaul",
                                          "DE": "Germany"}])
def test_phone_with_region_stages_equal_jax(codes):
    phones = hostile_phones()
    regions = [REGION_TEXTS[i % len(REGION_TEXTS)]
               for i in range(len(phones))]
    for p, r in zip(phones, regions):
        assert pen.resolve_region(p, r, "US", codes) == \
            jen.resolve_region(p, r, "US", codes)
    kw = {"country_codes": codes}
    for name in ("PhoneIsValidWithRegionTransformer",
                 "PhoneParseWithRegionTransformer"):
        check_host(name, [("Phone", phones), ("Text", regions)], kw)


def phone_maps(n=160, seed=7):
    rng = np.random.default_rng(seed)
    phones = hostile_phones()
    out = []
    for i in range(n):
        if rng.random() < 0.1:
            out.append(None)
            continue
        out.append({k: phones[rng.integers(0, len(phones))]
                    for k in ("home", "work", "mobile", "fax")
                    if rng.random() < 0.6})
    return out


def test_phone_map_validity_equals_jax():
    check_host("PhoneMapIsValidTransformer", [("PhoneMap", phone_maps())])


B64 = [None, "", "not base64!!", "====", "JVBERi0xLjQK", "iVBORw0KGgo=",
       "/9j/4AAQ", "R0lGODlhAQABAA==", "UEsDBA==", "H4sIAAAA", "UmFyIQ==",
       "f0VMRg==", "TVo=", "SUQz", "UklGRg==", "T2dnUw==", "0M8R4A==",
       "PGh0bWw+PC9odG1sPg==", "PCFET0NUWVBFIGh0bWw+", "PD94bWwgdj0xPz4=",
       "eyJhIjogMX0=", "WzEsMl0=", "PHN2Zz48L3N2Zz4=", "aGVsbG8gd29ybGQ=",
       "//79AA==", "Qk0="]


@pytest.mark.parametrize("hint", [None, "application/x-custom"])
def test_mime_detector_equals_jax(hint):
    rows = [r["attachment"] for r in chip_smoke.enrichment_rows(200)]
    check_host("MimeTypeDetector", [("Base64", B64 + rows)],
               {"type_hint": hint})


NAMES = [None, "", "Mary Smith", "dr maria lopez", "JAMES", "Acme Corp",
         "a b c d e", "o'brien-smith", "José García", "Zoë", "x",
         "María López visitó Madrid", "info desk", "Sophia"]


def test_language_name_and_entity_detectors_equal_jax():
    rows = chip_smoke.enrichment_rows(150)
    notes = [r["note"] for r in rows] + NAMES
    contacts = [r["contact"] for r in rows] + NAMES
    check_host("LangDetector", [("Text", notes)])
    check_host("HumanNameDetector", [("Text", contacts)])
    for v in contacts:
        assert pen.name_stats(v) == jen.name_stats(v)
    check_host("NameEntityRecognizer", [("Text", contacts + notes[:40])])
    check_host("NameEntityRecognizer", [("Text", contacts[:60])],
               {"language": "nl"})


def test_entity_heuristic_equals_jax():
    """Without models (an empty model directory) both fall back to the
    capitalization + name-dictionary heuristic."""
    for v in NAMES + ["Mary Ann Smith met John", "Peter Pan"]:
        assert pen.NameEntityRecognizer._entities(v) == \
            jen.NameEntityRecognizer._entities(v)


@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("region", ["US", "DE"])
def test_phone_vectorizer_equals_jax(track_nulls, region):
    """PhoneVectorizer over two phone features: metadata and vectors
    equal, eager and compiled."""
    phones = hostile_phones()
    inputs = [("Phone", phones), ("Phone", phones[::-1])]
    both = {}
    for pkg in ("port", "jax"):
        t, Col, Gen, _, _ = packages()[pkg]
        feats = [Gen(name=f"p{i}", ftype=t.Phone).get_output()
                 for i in range(2)]
        mod = pen if pkg == "port" else jen
        stage = mod.PhoneVectorizer(default_region=region,
                                    track_nulls=track_nulls).set_input(*feats)
        both[pkg] = (stage, [Col.from_values(t.Phone, v) for _, v in inputs])
    (ps, pcols), (js, jcols) = both["port"], both["jax"]
    got, want = ps.transform(pcols, "cpu"), js.transform(jcols)
    assert meta_json(got.meta) == meta_json(want.meta)
    assert_vectors(got.data, want.data)
    assert_vectors(port_compiled(ps, pcols), jax_jitted(js, jcols))
    assert ps.get_params() == js.get_params()


@pytest.mark.parametrize("track_nulls", [True, False])
def test_phone_map_vectorizer_equals_jax(track_nulls):
    """PhoneMapVectorizer: fitted keys, metadata and vectors equal, eager
    and compiled, on maps scored after the fit (a key unseen at fit)."""
    train = [("m", "PhoneMap", phone_maps())]
    score = [("m", "PhoneMap", phone_maps(60, seed=9)
              + [{"pager": "+1 415 555 2671"}])]
    ps, js = check_stage("maps", "PhoneMapVectorizer", train, score,
                         track_nulls=track_nulls)
    assert ps.keys_per_feature == js.keys_per_feature


def test_phone_maps_save_and_load_across_packages():
    from transmogrifai_tpu.stages.base import StageRegistry as JReg
    from transmogrifai_tpu_torch import from_jax_params
    js = fit_both("maps", "PhoneMapVectorizer",
                  [("m", "PhoneMap", phone_maps())])["jax"][0]
    stage = from_jax_params("PhoneMapModel", js.get_params(), uid="u")
    assert stage.get_params() == js.get_params()
    back = JReg.get("PhoneMapModel")(uid="v", **stage.get_params())
    assert back.get_params() == js.get_params()


def dataset(pkg, rows):
    t = packages()[pkg][0]
    from importlib import import_module
    root = packages()[pkg][4]
    Dataset = import_module(f"{root}.data").Dataset
    return Dataset.from_rows(rows, schema=chip_smoke.enrichment_schema(t))


def workflow_of(pkg):
    from importlib import import_module
    return import_module(f"{packages()[pkg][4]}.workflow").Workflow


def raw(pkg, name):
    t = packages()[pkg][0]
    from importlib import import_module
    FB = import_module(f"{packages()[pkg][4]}.features").FeatureBuilder
    ft = chip_smoke.enrichment_schema(t)[name]
    return getattr(FB, ft.__name__)(name).from_column(name).as_predictor()


def train_kw(pkg):
    return {"device": "cpu"} if pkg == "port" else {}


@pytest.mark.parametrize("cols", [["email"], ["website"], ["phone"],
                                  ["attachment"], ["phones"],
                                  ["email", "website", "phone", "attachment",
                                   "phones", "revenue"]])
def test_transmogrify_enrichment_groups_equal_jax(cols):
    """transmogrify over the email, url, phone and base64 groups and a
    phone map: the combined vector's metadata and values equal, eager
    and compiled."""
    import transmogrifai_tpu  # noqa: F401  (attaches the DSL)
    from transmogrifai_tpu.automl import transmogrify as jtr
    from transmogrifai_tpu_torch import transmogrify as ptr
    rows = chip_smoke.enrichment_rows(300)
    res = {}
    for pkg, tr in (("port", ptr), ("jax", jtr)):
        vec = tr([raw(pkg, c) for c in cols])
        model = workflow_of(pkg)().set_result_features(vec) \
            .set_input_dataset(dataset(pkg, rows)).train(**train_kw(pkg))
        scored = model.score(dataset(pkg, rows[:120]))[vec.name]
        res[pkg] = (scored, model, vec)
    got, want = res["port"][0], res["jax"][0]
    assert chip_smoke.meta_entries(got.meta.columns) == \
        chip_smoke.meta_entries(want.meta.columns)
    if "revenue" in cols:
        np.testing.assert_allclose(np.asarray(got.data),
                                   np.asarray(want.data), rtol=F32_ULP,
                                   atol=0)
    else:
        assert_vectors(np.asarray(got.data), np.asarray(want.data))
    pm, pv = res["port"][1], res["port"][2]
    compiled = pm.score_compiled(dataset("port", rows[:120]))[pv.name]
    assert_vectors(compiled.numpy(), np.asarray(got.data))


DSL_CASES = [
    ("email", "is_valid_email", {}), ("email", "to_email_domain", {}),
    ("email", "to_email_parts", {}), ("website", "is_valid_url", {}),
    ("website", "to_domain", {}), ("website", "to_protocol", {}),
    ("phone", "is_valid_phone", {}), ("phone", "is_valid_phone",
                                      {"default_region": "GB"}),
    ("phone", "is_valid_phone", {"region": "phone_region"}),
    ("phone", "parse_phone", {}),
    ("phone", "parse_phone", {"region": "phone_region"}),
    ("phones", "is_valid_phone_map", {}),
    ("attachment", "detect_mime_types", {}),
    ("note", "detect_languages", {}), ("contact", "detect_name", {}),
    ("contact", "recognize_entities", {}), ("note", "text_len", {}),
]


@pytest.mark.parametrize("col,method,kw", DSL_CASES,
                         ids=[f"{m}-{i}" for i, (_, m, _) in
                              enumerate(DSL_CASES)])
def test_dsl_enrichment_methods_equal_jax(col, method, kw):
    """Each new DSL method wires the same stage class with the same params
    in both packages, and its trained output is equal."""
    import transmogrifai_tpu  # noqa: F401
    import transmogrifai_tpu_torch  # noqa: F401
    rows = chip_smoke.enrichment_rows(120)
    res = {}
    for pkg in ("port", "jax"):
        f = raw(pkg, col)
        args = dict(kw)
        if "region" in args:
            args["region"] = raw(pkg, args["region"])
        out = getattr(f, method)(**args)
        model = workflow_of(pkg)().set_result_features(out) \
            .set_input_dataset(dataset(pkg, rows)).train(**train_kw(pkg))
        res[pkg] = (out, model.score(dataset(pkg, rows))[out.name])
    (po, pc), (jo, jc) = res["port"], res["jax"]
    assert type(po.origin_stage).__name__ == type(jo.origin_stage).__name__
    assert po.origin_stage.get_params() == jo.origin_stage.get_params()
    assert values_of(pc) == values_of(jc)
