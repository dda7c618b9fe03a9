"""The port's advanced text stages (`ops/text_advanced.py`) against the
JAX package on the CPU (ROADMAP queue 1, item 6b): stopword removal,
n-grams, the count vectorizer's vocabulary and vectors, Word2Vec's
vectors and LDA's topics (host numpy fits with the JAX package's calls in
its order on the same `default_rng(seed)`), and each model's transform,
eager and compiled.

Tolerance: equal (bit for bit, Word2Vec's table and LDA's topics too).
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_structural import (  # noqa: E402
    assert_vectors, fit_both, jax_jitted, meta_json, packages,
    port_compiled)


def token_lists(n=300, seed=0):
    """Token lists of phase 28's notes (tokenized by the English
    analyzer), with None rows, empty lists, single tokens and mixed
    case."""
    from transmogrifai_tpu_torch.ops.text import tokenize
    rows = chip_smoke.enrichment_rows(n, seed=seed)
    out = []
    for i, r in enumerate(rows):
        toks = tokenize(r["note"]) if r["note"] else None
        if i % 17 == 0:
            toks = None
        elif i % 23 == 0:
            toks = []
        elif i % 29 == 0:
            toks = ["The", "AND", "Stop", "words", "The"]
        elif i % 31 == 0:
            toks = ["solo"]
        out.append(toks)
    return out


def check_host(name, values, **kw):
    both = fit_both("text_advanced", name, [("t", "TextList", values)], **kw)
    (ps, pcols), (js, jcols) = both["port"], both["jax"]
    got, want = ps.transform(pcols, "cpu"), js.transform(jcols)
    assert list(got.data) == list(want.data)
    assert ps.get_params() == js.get_params()


@pytest.mark.parametrize("kw", [{}, {"case_sensitive": True},
                                {"stop_words": ["ka", "The", "de"]}])
def test_stop_words_remover_equals_jax(kw):
    check_host("OpStopWordsRemover", token_lists(), **kw)


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_ngram_equals_jax(n):
    check_host("OpNGram", token_lists(), n=n)


def fitted_vector_stage(name, values, score=None, **kw):
    """An estimator of text_advanced fitted in both packages: params,
    metadata and eager and compiled transforms equal."""
    inputs = [("t", "TextList", values)]
    both = fit_both("text_advanced", name, inputs,
                    None if score is None else [("t", "TextList", score)],
                    **kw)
    (ps, pcols), (js, jcols) = both["port"], both["jax"]
    dump = lambda p: json.dumps(p, sort_keys=True, default=str)  # noqa
    assert dump(ps.get_params()) == dump(js.get_params())
    got, want = ps.transform(pcols, "cpu"), js.transform(jcols)
    assert meta_json(got.meta) == meta_json(want.meta)
    assert_vectors(got.data, want.data)
    assert_vectors(port_compiled(ps, pcols), jax_jitted(js, jcols))
    return ps, js


@pytest.mark.parametrize("kw", [{}, {"min_df": 3.0}, {"min_df": 0.02},
                                {"vocab_size": 50, "binary": True}])
def test_count_vectorizer_equals_jax(kw):
    ps, js = fitted_vector_stage("OpCountVectorizer", token_lists(),
                                 token_lists(80, seed=1), **kw)
    assert ps.vocab == js.vocab


@pytest.mark.parametrize("kw", [{"vector_size": 16, "min_count": 2},
                                {"vector_size": 8, "window": 2,
                                 "min_count": 1, "num_iter": 2,
                                 "negatives": 3, "seed": 7},
                                {"min_count": 10_000}])
def test_word2vec_equals_jax(kw):
    """The skip-gram table bit for bit (same draws, same `np.add.at`
    order), and the mean-of-vectors transform."""
    ps, js = fitted_vector_stage("OpWord2Vec", token_lists(400),
                                 token_lists(80, seed=2), **kw)
    assert sorted(ps.vectors) == sorted(js.vectors)
    for w in js.vectors:
        np.testing.assert_array_equal(ps.vectors[w], js.vectors[w])


def count_vectors(pkg, values, min_df=2.0):
    t, Col, Gen, Ctx, root = packages()[pkg]
    from importlib import import_module
    mod = import_module(f"{root}.ops.text_advanced")
    f = Gen(name="t", ftype=t.TextList).get_output()
    cv = mod.OpCountVectorizer(min_df=min_df).set_input(f)
    col = Col.from_values(t.TextList, values)
    model = cv.fit([col], Ctx(n_rows=len(values)))
    return model, (model.transform([col], "cpu") if pkg == "port"
                   else model.transform([col]))


@pytest.mark.parametrize("k,max_iter", [(3, 5), (10, 20)])
def test_lda_equals_jax(k, max_iter):
    """LDA's topics bit for bit and the folded-in topic mixtures of the
    fit rows and of new rows, eager and through the compiled scorer."""
    from importlib import import_module
    values = token_lists(300)
    out = {}
    for pkg in ("port", "jax"):
        t, Col, Gen, Ctx, root = packages()[pkg]
        mod = import_module(f"{root}.ops.text_advanced")
        cvm, counts = count_vectors(pkg, values)
        lda = mod.OpLDA(k=k, max_iter=max_iter).set_input(cvm.get_output())
        model = lda.fit([counts], Ctx(n_rows=len(values)))
        out[pkg] = (model, counts)
    (pm, pc), (jm, jc) = out["port"], out["jax"]
    np.testing.assert_array_equal(pm.topics, jm.topics)
    got, want = pm.transform([pc], "cpu"), jm.transform([jc])
    assert chip_smoke.meta_entries(got.meta.columns) == \
        chip_smoke.meta_entries(want.meta.columns)
    assert_vectors(got.data, want.data)
    assert pm.jittable is False   # F25: a host stage in the port


def test_lda_serves_after_a_count_vectorizer_f25():
    """F25: the JAX package's compiled scorer cannot run LDA after a
    count vectorizer (its `host_prepare` is handed no host column and
    raises); the port's LDA model is a host stage, so `score_compiled`
    gives the eager transform's topic mixtures."""
    from importlib import import_module
    rows = chip_smoke.enrichment_rows(120)
    res = {}
    for pkg in ("port", "jax"):
        root = packages()[pkg][4]
        t = packages()[pkg][0]
        import_module(root)
        FB = import_module(f"{root}.features").FeatureBuilder
        Dataset = import_module(f"{root}.data").Dataset
        Workflow = import_module(f"{root}.workflow").Workflow
        note = FB.Text("note").from_column("note").as_predictor()
        topics = note.tokenize().count_vectorize(min_df=2).lda(k=4)
        ds = Dataset.from_rows(rows, schema={"note": t.Text})
        kw = {"device": "cpu"} if pkg == "port" else {}
        model = Workflow().set_result_features(topics).set_input_dataset(
            ds).train(**kw)
        res[pkg] = (model, topics, ds)
    jm, jf, jds = res["jax"]
    with pytest.raises(AttributeError):
        jm.score_compiled(jds)
    pm, pf, pds = res["port"]
    eager = np.asarray(pm.score(pds)[pf.name].data)
    np.testing.assert_array_equal(
        pm.score_compiled(pds)[pf.name].numpy(), eager)
    np.testing.assert_array_equal(
        eager, np.asarray(jm.score(jds)[jf.name].data))
