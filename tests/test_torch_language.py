"""The port's language tools against the JAX package on the CPU (ROADMAP
queue 1, item 6b): `utils/language.py` (language detection, stopwords),
`utils/stemmers.py`, `utils/opennlp.py` (every packaged model: sentence
splits, tokens, POS tags and named-entity spans) and `TextTokenizer`'s
language modes.

Tolerance: equal — detection's confidences too (its softmax is f64 Python
in both packages; the port's rank distances are integer sums over one
table, the JAX package's a loop a profile), and the OpenNLP decoders' outputs (the same parameter
sums in the same order). The port reads its own copies of the profile
file and the model binaries.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from transmogrifai_tpu.utils import language as jlang  # noqa: E402
from transmogrifai_tpu.utils import opennlp as jnlp  # noqa: E402
from transmogrifai_tpu.utils import stemmers as jstem  # noqa: E402
from transmogrifai_tpu_torch.utils import language as plang  # noqa: E402
from transmogrifai_tpu_torch.utils import opennlp as pnlp  # noqa: E402
from transmogrifai_tpu_torch.utils import stemmers as pstem  # noqa: E402

LANGS = sorted(plang._SEED)

MIXED = ["hello мир 你好", "مرحبا بالعالم hello", "שלום עולם", "नमस्ते दुनिया",
         "γειά σου κόσμε", "สวัสดีชาวโลก", "こんにちは世界", "안녕하세요 세계",
         "Привет, как дела? Ы э", "Добрий день і вечір", "12345 67890",
         "!!!", " ", "a", "Dr. Müller & Søn — café", "ꙮ ∑ ☃",
         "x" * 500, "The the THE tHe", "élève garçon naïve"]


def texts():
    out = [None, ""] + MIXED
    rng = np.random.default_rng(3)
    for lang in LANGS:
        words = plang._SEED[lang].split()
        out.append(plang._SEED[lang])
        for k in (1, 3, 8, 25):
            out.append(" ".join(rng.choice(words, k)))
    for lang, _ in chip_smoke.ENRICH_LANGS:
        vocab = chip_smoke.enrichment_vocab(lang)
        for k in (5, 19, 40):
            out.append(" ".join(rng.choice(vocab[:400], k)))
    return out


def test_profiles_and_models_are_the_ports_own_copies():
    """The port reads its own profile file and model directory, byte for
    byte the JAX package's, with no environment variable set."""
    assert "transmogrifai_tpu_torch" in plang._PROFILE_RESOURCE
    assert open(plang._PROFILE_RESOURCE, "rb").read() == \
        open(jlang._PROFILE_RESOURCE, "rb").read()
    env = os.environ.pop("TRANSMOGRIFAI_OPENNLP_DIR", None)
    try:
        pdir, jdir = pnlp.model_dir(), jnlp.model_dir()
    finally:
        if env is not None:
            os.environ["TRANSMOGRIFAI_OPENNLP_DIR"] = env
    assert pdir.startswith(os.path.join(REPO, "transmogrifai_tpu_torch"))
    pm, jm = pnlp.available_models(pdir), jnlp.available_models(jdir)
    assert sorted(pm) == sorted(jm) and len(pm) == 21
    for k in pm:
        assert open(pm[k], "rb").read() == open(jm[k], "rb").read()


@pytest.mark.parametrize("part", range(4))
def test_detect_language_equals_jax(part):
    """Every seeded language (whole seeds and word draws of 1 to 25),
    the phase's note vocabularies, mixed scripts, empty and None."""
    cases = texts()[part::4]
    for t in cases:
        got, want = plang.detect_language(t), jlang.detect_language(t)
        assert list(got.items()) == list(want.items()), t
        assert plang.detect(t) == jlang.detect(t)


def test_rank_distances_equal_the_jax_loop():
    """The port's out-of-place distances to every profile at once (one
    table, integer sums) against the JAX package's per-profile loop
    (`_rank_distance`), text by text and profile by profile: equal."""
    for t in texts():
        if not t:
            continue
        ranks = [g for g, _ in
                 jlang._trigrams(t).most_common(jlang._PROFILE_SIZE)]
        got = plang._rank_distances(ranks)
        col = plang._rank_table()["col"]
        jlang._ensure_profiles()
        for lang, prof in jlang._PROFILES.items():
            want = jlang._rank_distance(ranks, prof)
            assert (1.0 if got is None else float(got[col[lang]])) == \
                want, (t, lang)


def test_stopwords_equal_jax():
    for lang in LANGS + ["xx", None, ""]:
        assert plang.stopwords_for(lang) == jlang.stopwords_for(lang)


def stem_words(lang):
    base = plang._word_re.findall(plang._SEED.get(lang, "").lower())
    base += sorted(plang.stopwords_for(lang))
    if lang in dict(chip_smoke.ENRICH_LANGS):
        base += chip_smoke.enrichment_vocab(lang)[:600]
    suffixes = ["s", "es", "ing", "ed", "ly", "ment", "ación", "ungen",
                "heden", "ει", "ов", "ями", "e", "ar", "ied", "sses", "ies"]
    return base + [w + s for w in base[:120] for s in suffixes] + [
        "", "a", "ab", "running", "hopping", "caresses", "ponies"]


@pytest.mark.parametrize("lang", sorted(pstem.SUPPORTED) + ["pl", "zz",
                                                            None])
def test_stems_equal_jax(lang):
    words = stem_words(lang or "en")
    assert [pstem.stem(w, lang) for w in words] == \
        [jstem.stem(w, lang) for w in words]
    assert pstem.stem_tokens(words, lang) == jstem.stem_tokens(words, lang)
    assert pstem.SUPPORTED == jstem.SUPPORTED


NLP_TEXTS = [
    "El señor Juan Pérez visitó Madrid con María López el martes. Luego "
    "habló con la empresa Telefónica en Barcelona.",
    "Mr. Smith went to Washington on Jan. 5th, 2020. He met Dr. Jones "
    "at 3 p.m. and they discussed U.S. policy!",
    "De heer Jan de Vries woont in Amsterdam. Hij werkt bij Philips.",
    "Der schnelle braune Fuchs springt. Frau Müller wohnt in Berlin.",
    "Eu moro em Lisboa. O Sr. Silva trabalha no Porto.",
    "Jeg bor i København. Hr. Jensen arbejder i Aarhus.",
    "Jag bor i Stockholm. Anna Larsson arbetar i Göteborg.",
    "", "a", "...", "Ana Garcia", "email me at x@y.com, or call (415) 555-2671",
]


def _models(mod, kind):
    mods = mod.available_models(mod.model_dir())
    return {k: p for k, p in sorted(mods.items()) if kind in k}


@pytest.mark.parametrize("kind", ["sent", "token", "pos", "ner"])
def test_opennlp_models_load_and_decode_equal(kind):
    """Every packaged model of a kind loads in both packages and gives
    equal sentence splits, tokens, POS tags and NER spans."""
    pm, jm = _models(pnlp, kind), _models(jnlp, kind)
    assert sorted(pm) == sorted(jm) and pm
    for key in pm:
        pmod, jmod = pnlp.load_model(pm[key]), jnlp.load_model(jm[key])
        assert pmod.outcomes == jmod.outcomes
        for text in NLP_TEXTS:
            toks = text.split()
            if kind == "sent":
                assert pnlp.SentenceDetector(pmod).split(text) == \
                    jnlp.SentenceDetector(jmod).split(text)
            elif kind == "token":
                assert pnlp.TokenizerME(pmod).tokenize(text) == \
                    jnlp.TokenizerME(jmod).tokenize(text)
            elif kind == "pos":
                pt_ = pnlp.POSTagger(pmod, pnlp.load_tag_dictionary(pm[key]))
                jt_ = jnlp.POSTagger(jmod, jnlp.load_tag_dictionary(jm[key]))
                assert pt_.tag(toks) == jt_.tag(toks)
            else:
                assert pnlp.NameFinder(pmod).spans(toks) == \
                    jnlp.NameFinder(jmod).spans(toks)
                assert pnlp.NameFinder(pmod).tag(toks) == \
                    jnlp.NameFinder(jmod).tag(toks)


def tokenizer_pair(**kw):
    import transmogrifai_tpu.types as jt
    import transmogrifai_tpu_torch.types as pt
    from transmogrifai_tpu.ops.text import TextTokenizer as JTok
    from transmogrifai_tpu.stages.base import FeatureGeneratorStage as JGen
    from transmogrifai_tpu_torch.ops.text import TextTokenizer as PTok
    from transmogrifai_tpu_torch.stages.base import (
        FeatureGeneratorStage as PGen)
    return (PTok(**kw).set_input(PGen(name="t", ftype=pt.Text).get_output()),
            JTok(**kw).set_input(JGen(name="t", ftype=jt.Text).get_output()),
            pt, jt)


@pytest.mark.parametrize("kw", [
    {}, {"language": "es"}, {"language": "de", "stem": False},
    {"auto_detect_language": True},
    {"auto_detect_language": True, "auto_detect_threshold": 0.5,
     "default_language": "fr"},
    {"auto_detect_language": True, "to_lowercase": False},
    {"language": "pl", "min_token_length": 3}])
def test_tokenizer_language_modes_equal_jax(kw):
    """The default, explicit-language and auto-detect modes on the notes
    of phase 28's five languages, mixed scripts, empty and None."""
    from transmogrifai_tpu.data.columns import Column as JColumn
    from transmogrifai_tpu_torch.data.columns import Column as PColumn
    from transmogrifai_tpu_torch import from_jax_params
    ps, js, pt, jt = tokenizer_pair(**kw)
    rows = [r["note"] for r in chip_smoke.enrichment_rows(120)] + texts()[:60]
    got = ps.transform([PColumn.from_values(pt.Text, rows)], "cpu")
    want = js.transform([JColumn.from_values(jt.Text, rows)])
    assert list(got.data) == list(want.data)
    assert [ps.language_of(r) for r in rows] == [js.language_of(r)
                                                 for r in rows]
    stage = from_jax_params("TextTokenizer", js.get_params(), uid="t")
    assert stage.get_params() == js.get_params()
