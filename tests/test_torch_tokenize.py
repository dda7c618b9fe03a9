"""Parity of the port's tokenizer and hashing with the JAX package on
the CPU.

The JAX package tokenizes a column through pyarrow's RE2 kernels
(`tokenize_batch`, `_flat_tokens_arrow`); the port, whose GPU machine has
no pyarrow, tokenizes each row with Python's `re`. The tokens are held
equal to the JAX package's arrow path on hostile text: accents and
combining marks, superscript digits, underscores, CJK, Thai, Arabic,
empty strings, whitespace only and None. Hashed counts are bit-equal
(`HashingVectorizer` with `binary` and `shared_hash_space`, per-input
seeds, Text and TextList inputs).
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import transmogrifai_tpu.ops.text as jtext  # noqa: E402
import transmogrifai_tpu.types as jt  # noqa: E402
from transmogrifai_tpu.data.columns import Column as JColumn  # noqa: E402
from transmogrifai_tpu.stages.base import (  # noqa: E402
    FeatureGeneratorStage as JGen)

import transmogrifai_tpu_torch.ops.text as ptext  # noqa: E402
import transmogrifai_tpu_torch.types as pt  # noqa: E402
from transmogrifai_tpu_torch import from_jax_params  # noqa: E402
from transmogrifai_tpu_torch.data.columns import Column as PColumn  # noqa
from transmogrifai_tpu_torch.stages.base import (  # noqa: E402
    FeatureGeneratorStage as PGen)

HOSTILE = [
    "Café crème brûlée", "naïve résumé", "été café",
    "x² + y³ = z⁴", "H₂O and CO₂", "snake_case __dunder__ a_b_c",
    "東京都 Tōkyō は日本の首都", "ภาษาไทยไม่มีช่องว่าง", "مُحَمَّد الأمين",
    "", "   ", "\t\n", None, "MiXeD CaSe WORDS", "İstanbul ǅemal ß",
    "1,234.56 -7 +8e9", "emoji 😀 test", "ＦＵＬＬ　ｗｉｄｔｈ", "a", "a-b'c",
    "ΑΒΓ αβγ ςσ", "ΟΔΟΣ ΣΑΣ Σ", "Ǆ ǅ ǆ", "ẞ STRASSE", "٣ ٤ ٥ digits",
    "mixed 東 and ไทย", "İ 東京", "Ⅻ ⅻ ① ½ ¾"]


def arrow_rows(values, min_len=1, lower=True):
    """The JAX package's arrow path as per-row token lists."""
    rows, flat = jtext._flat_tokens_arrow(values, min_len, lower)
    toks = flat.to_pylist()
    out = [[] for _ in values]
    for r, t in zip(rows.tolist(), toks):
        out[r].append(t)
    return out


@pytest.mark.parametrize("min_len", [1, 2, 3])
@pytest.mark.parametrize("lower", [True, False])
def test_tokens_equal_the_jax_arrow_path(min_len, lower):
    values = np.array(HOSTILE, dtype=object)
    want = arrow_rows(values, min_len, lower)
    got = [ptext.column_tokens(v, min_len, lower) for v in values]
    assert got == want
    batch = ptext.tokenize_batch(values, min_len, lower)
    assert [b or [] for b in batch] == want
    jbatch = jtext.tokenize_batch(values, min_len, lower)
    assert list(batch) == list(jbatch)


@pytest.mark.parametrize("i", range(len(HOSTILE)))
def test_each_hostile_text_tokenizes_as_in_jax(i):
    """`tokenize` equals the JAX package's row-wise `tokenize` (Python's
    full lowercase), and `column_tokens` its arrow path (the simple
    one); they differ only on İ and a final Σ."""
    v = HOSTILE[i]
    assert ptext.tokenize(v) == jtext.tokenize(v)
    assert ptext.column_tokens(v) == \
        arrow_rows(np.array([v], dtype=object))[0]


def text_col(mod_col, t, values):
    return mod_col.from_values(t.Text, list(values))


def test_text_tokenizer_equals_jax():
    values = HOSTILE * 3
    pst = ptext.TextTokenizer().set_input(
        PGen(name="d", ftype=pt.Text).get_output())
    jst = jtext.TextTokenizer().set_input(
        JGen(name="d", ftype=jt.Text).get_output())
    got = pst.transform([text_col(PColumn, pt, values)], "cpu")
    want = jst.transform([text_col(JColumn, jt, values)])
    assert got.ftype is pt.TextList
    assert list(got.data) == list(want.data)
    stage = from_jax_params("TextTokenizer", jst.get_params(), uid="t")
    assert stage.get_params() == jst.get_params()


@pytest.mark.parametrize("kw", [{"language": "en"},
                                {"auto_detect_language": True}])
def test_tokenizer_language_modes_raise_naming_item_6b(kw):
    """Item 6b is ported: the language modes build and tokenize as the
    JAX package does (held in full by tests/test_torch_language.py)."""
    values = HOSTILE * 2
    pst = ptext.TextTokenizer(**kw).set_input(
        PGen(name="d", ftype=pt.Text).get_output())
    jst = jtext.TextTokenizer(**kw).set_input(
        JGen(name="d", ftype=jt.Text).get_output())
    got = pst.transform([text_col(PColumn, pt, values)], "cpu")
    want = jst.transform([text_col(JColumn, jt, values)])
    assert list(got.data) == list(want.data)


def hash_inputs(rng, n=200):
    vocab = HOSTILE[:-1] + ["alpha beta", "beta gamma delta", "zeta"]
    text = [vocab[j] if rng.random() > 0.1 else None
            for j in rng.integers(0, len(vocab), n)]
    lists = [[f"tok{j}" for j in rng.integers(0, 40, rng.integers(1, 9))]
             if rng.random() > 0.15 else None for _ in range(n)]
    return text, lists


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("pre_tokenized", [False, True])
@pytest.mark.parametrize("seed", [0, 42, 1234567])
def test_hash_counts_bit_equal(binary, pre_tokenized, seed):
    text, lists = hash_inputs(np.random.default_rng(seed))
    values = np.array(lists if pre_tokenized else text, dtype=object)
    for nf in (16, 512):
        got = ptext._hash_counts(values, ptext.TokenHasher(nf, seed),
                                 binary, pre_tokenized)
        want = jtext._hash_counts(values, jtext.TokenHasher(nf, seed),
                                  binary, pre_tokenized)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("track_nulls", [False, True])
def test_hashing_vectorizer_equals_jax(binary, shared, track_nulls):
    text, lists = hash_inputs(np.random.default_rng(3))
    kw = dict(num_features=64, binary=binary, shared_hash_space=shared,
              track_nulls=track_nulls, seed=11)
    pst = ptext.HashingVectorizer(**kw).set_input(
        PGen(name="a", ftype=pt.Text).get_output(),
        PGen(name="b", ftype=pt.TextList).get_output())
    jst = jtext.HashingVectorizer(**kw).set_input(
        JGen(name="a", ftype=jt.Text).get_output(),
        JGen(name="b", ftype=jt.TextList).get_output())
    pcols = [PColumn.from_values(pt.Text, text),
             PColumn.from_values(pt.TextList, lists)]
    jcols = [JColumn.from_values(jt.Text, text),
             JColumn.from_values(jt.TextList, lists)]
    got = pst.transform(pcols, "cpu")
    want = jst.transform(jcols)
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))
    assert [c.to_json() for c in got.meta.columns] == \
        [c.to_json() for c in want.meta.columns]
    stage = from_jax_params("HashingVectorizer", jst.get_params(), uid="h")
    assert stage.get_params() == jst.get_params()


def test_hashing_vectorizer_refuses_other_types():
    with pytest.raises(TypeError, match="Text or TextList"):
        ptext.HashingVectorizer().set_input(
            PGen(name="x", ftype=pt.Real).get_output())
