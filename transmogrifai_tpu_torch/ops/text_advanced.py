"""Advanced text ops: count vectorizer, n-grams, stopwords, Word2Vec, LDA.

The port's counterpart of the JAX package's `ops/text_advanced.py`.
Reference parity: `core/.../feature/OpCountVectorizer.scala`,
`OpNGram.scala`, `OpStopWordsRemover.scala`, `OpWord2Vec.scala:41`,
`OpLDA.scala:41` — the reference wraps Spark MLlib; these are native
implementations with the same stage contracts (TextList → OPVector /
TextList). The fits are host numpy with the JAX package's calls in its
order on the same `default_rng(seed)` (Word2Vec's `np.add.at` and
`np.einsum` too), so Word2Vec's table and LDA's topics are the JAX
package's bits on one machine; the transforms' host encodings are numpy
as there, and their device side passes the encoding through.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.data.metadata import (
    VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, HostTransformer, Transformer)

# --------------------------------------------------------------------------- #
# OpStopWordsRemover                                                          #
# --------------------------------------------------------------------------- #

ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll he's
her here here's hers herself him himself his how how's i i'd i'll i'm i've
if in into is isn't it it's its itself let's me more most mustn't my myself
no nor not of off on once only or other ought our ours ourselves out over
own same shan't she she'd she'll she's should shouldn't so some such than
that that's the their theirs them themselves then there there's these they
they'd they'll they're they've this those through to too under until up
very was wasn't we we'd we'll we're we've were weren't what what's when
when's where where's which while who who's whom why why's with won't would
wouldn't you you'd you'll you're you've your yours yourself yourselves
""".split())


class OpStopWordsRemover(HostTransformer):
    """TextList → TextList minus stopwords (OpStopWordsRemover.scala)."""

    in_types = (T.TextList,)
    out_type = T.TextList

    def __init__(self, stop_words: Optional[Sequence[str]] = None,
                 case_sensitive: bool = False, uid: Optional[str] = None):
        super().__init__(uid=uid, case_sensitive=case_sensitive)
        self.stop_words = frozenset(stop_words) if stop_words is not None \
            else ENGLISH_STOP_WORDS
        self.case_sensitive = case_sensitive
        self.params["stop_words"] = sorted(self.stop_words)

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, toks in enumerate(cols[0].data):
            if toks is None:
                out[i] = None
                continue
            if self.case_sensitive:
                kept = [t for t in toks if t not in self.stop_words]
            else:
                kept = [t for t in toks if t.lower() not in self.stop_words]
            out[i] = kept or None
        return Column(T.TextList, out)


class OpNGram(HostTransformer):
    """TextList → TextList of space-joined n-grams (OpNGram.scala)."""

    in_types = (T.TextList,)
    out_type = T.TextList

    def __init__(self, n: int = 2, uid: Optional[str] = None):
        if n < 1:
            raise ValueError("n must be >= 1")
        super().__init__(uid=uid, n=int(n))
        self.n = int(n)

    def transform(self, cols: Sequence[Column], device=None) -> Column:
        out = np.empty(len(cols[0].data), dtype=object)
        for i, toks in enumerate(cols[0].data):
            if toks is None or len(toks) < self.n:
                out[i] = None
                continue
            out[i] = [" ".join(toks[j:j + self.n])
                      for j in range(len(toks) - self.n + 1)]
        return Column(T.TextList, out)


# --------------------------------------------------------------------------- #
# OpCountVectorizer                                                           #
# --------------------------------------------------------------------------- #

class CountVectorizerModel(Transformer):
    out_type = T.OPVector

    def __init__(self, vocab: Sequence[str], binary: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocab = list(vocab)
        self.binary = binary
        self._lut = {w: i for i, w in enumerate(self.vocab)}

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        c = cols[0]
        out = np.zeros((len(c.data), len(self.vocab)), dtype=np.float32)
        lut = self._lut
        for i, toks in enumerate(c.data):
            if toks is None:
                continue
            for t in toks:
                j = lut.get(t)
                if j is not None:
                    out[i, j] += 1.0
        if self.binary:
            np.minimum(out, 1.0, out=out)
        return out

    def device_apply(self, enc, dev):
        return enc

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[0]
        cols = tuple(VectorColumnMetadata(
            parent_name=f.name, parent_type=f.ftype.__name__,
            descriptor_value=w) for w in self.vocab)
        return VectorMetadata(self.output_name(), cols).with_indices()

    def get_params(self):
        return {"vocab": self.vocab, "binary": self.binary}


class OpCountVectorizer(Estimator):
    """TextList → term-count OPVector over a fitted vocabulary
    (OpCountVectorizer.scala wrapping Spark CountVectorizer: vocab_size cap,
    min_df document-frequency floor)."""

    in_types = (T.TextList,)
    out_type = T.OPVector

    def __init__(self, vocab_size: int = 1 << 18, min_df: float = 1.0,
                 binary: bool = False, uid: Optional[str] = None):
        super().__init__(uid=uid, vocab_size=vocab_size, min_df=min_df,
                         binary=binary)
        self.vocab_size = int(vocab_size)
        self.min_df = min_df
        self.binary = binary

    def fit_model(self, cols: Sequence[Column], ctx: FitContext) -> Transformer:
        df: Counter = Counter()
        n_docs = 0
        for toks in cols[0].data:
            if toks is None:
                continue
            n_docs += 1
            df.update(set(toks))
        min_count = self.min_df if self.min_df >= 1.0 else \
            self.min_df * max(n_docs, 1)
        eligible = [(c, w) for w, c in df.items() if c >= min_count]
        eligible.sort(key=lambda t: (-t[0], t[1]))
        vocab = [w for _, w in eligible[: self.vocab_size]]
        return CountVectorizerModel(vocab, binary=self.binary)


# --------------------------------------------------------------------------- #
# OpWord2Vec — native skip-gram with negative sampling                        #
# --------------------------------------------------------------------------- #

class Word2VecModel(Transformer):
    """Transform = mean of token vectors (Spark Word2VecModel.transform)."""

    out_type = T.OPVector

    def __init__(self, vectors: Dict[str, np.ndarray], vector_size: int,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vectors = {k: np.asarray(v, dtype=np.float32)
                        for k, v in vectors.items()}
        self.vector_size = int(vector_size)

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        c = cols[0]
        out = np.zeros((len(c.data), self.vector_size), dtype=np.float32)
        for i, toks in enumerate(c.data):
            if not toks:
                continue
            vecs = [self.vectors[t] for t in toks if t in self.vectors]
            if vecs:
                out[i] = np.mean(vecs, axis=0)
        return out

    def device_apply(self, enc, dev):
        return enc

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[0]
        cols = tuple(VectorColumnMetadata(
            parent_name=f.name, parent_type=f.ftype.__name__,
            descriptor_value=f"w2v_{j}") for j in range(self.vector_size))
        return VectorMetadata(self.output_name(), cols).with_indices()

    def get_params(self):
        return {"vectors": {k: v.tolist() for k, v in self.vectors.items()},
                "vector_size": self.vector_size}


class OpWord2Vec(Estimator):
    """TextList → OPVector via skip-gram negative sampling trained on the
    fit corpus (OpWord2Vec.scala:41 wrapping Spark Word2Vec; native numpy
    SGNS here — same params: vector_size, window, min_count, num_iter)."""

    in_types = (T.TextList,)
    out_type = T.OPVector

    def __init__(self, vector_size: int = 100, window: int = 5,
                 min_count: int = 5, num_iter: int = 1,
                 learning_rate: float = 0.025, negatives: int = 5,
                 seed: int = 42, uid: Optional[str] = None):
        super().__init__(uid=uid, vector_size=vector_size, window=window,
                         min_count=min_count, num_iter=num_iter,
                         learning_rate=learning_rate, negatives=negatives,
                         seed=seed)
        self.vector_size = int(vector_size)
        self.window = int(window)
        self.min_count = int(min_count)
        self.num_iter = int(num_iter)
        self.learning_rate = float(learning_rate)
        self.negatives = int(negatives)
        self.seed = int(seed)

    def fit_model(self, cols: Sequence[Column], ctx: FitContext) -> Transformer:
        counts: Counter = Counter()
        docs: List[List[int]] = []
        for toks in cols[0].data:
            if toks:
                counts.update(toks)
        vocab = sorted((w for w, c in counts.items() if c >= self.min_count),
                       key=lambda w: (-counts[w], w))
        lut = {w: i for i, w in enumerate(vocab)}
        for toks in cols[0].data:
            if toks:
                ids = [lut[t] for t in toks if t in lut]
                if len(ids) > 1:
                    docs.append(ids)
        V, D = len(vocab), self.vector_size
        rng = np.random.default_rng(self.seed)
        if V == 0 or not docs:
            return Word2VecModel({}, D)
        W_in = (rng.random((V, D), dtype=np.float32) - 0.5) / D
        W_out = np.zeros((V, D), dtype=np.float32)
        # unigram^(3/4) negative-sampling table
        freq = np.asarray([counts[w] for w in vocab], dtype=np.float64) ** 0.75
        neg_p = freq / freq.sum()
        lr = self.learning_rate
        # Flat skip-gram pair generation, vectorized over ALL
        # positions: docs concatenate into one id stream with document
        # boundaries, per-position dynamic window spans draw like the
        # word2vec reference, and each offset o ∈ [1, window] contributes
        # the (center, center±o) pairs where o ≤ span and both sides stay
        # inside the document.
        flat = np.concatenate([np.asarray(d) for d in docs])
        doc_of = np.concatenate(
            [np.full(len(d), i) for i, d in enumerate(docs)])
        n_pos = len(flat)
        # Batch caps at 8·vocab pairs: `np.add.at` SUMS every in-batch
        # duplicate of a word as one stale-gradient step, so a tiny
        # vocabulary (near-categorical text columns) under a large batch
        # takes effective steps of ~(batch/V)·lr·‖v‖ — divergent even at
        # the default lr. Bounding duplicates-per-word at ~8 keeps the
        # batched update within a small factor of gensim/Spark's
        # sequential SGD (their batch is effectively 1); natural corpora
        # (V ≥ 1024) keep the full throughput batch.
        batch = int(min(8192, max(16, 8 * V)))
        for it in range(self.num_iter):
            spans = rng.integers(1, self.window + 1, size=n_pos)
            centers_l, contexts_l = [], []
            for o in range(1, self.window + 1):
                ok = (spans >= o)
                same_doc = doc_of[o:] == doc_of[:-o]
                # each side gates on the CENTER position's own span draw —
                # word2vec's per-center dynamic window
                left = ok[o:] & same_doc    # center at idx, context idx-o
                idx_l = np.flatnonzero(left) + o
                centers_l.append(flat[idx_l])
                contexts_l.append(flat[idx_l - o])
                right = ok[:-o] & same_doc  # center at idx-o, context idx
                idx_r = np.flatnonzero(right) + o
                centers_l.append(flat[idx_r - o])
                contexts_l.append(flat[idx_r])
            centers = np.concatenate(centers_l)
            contexts = np.concatenate(contexts_l)
            order = rng.permutation(len(centers))
            centers, contexts = centers[order], contexts[order]
            # minibatched SGNS: per batch one gathered matmul-free update
            # (einsum over (B, k+1, D)); np.add.at applies the scatter
            for s in range(0, len(centers), batch):
                c = centers[s:s + batch]
                pos_t = contexts[s:s + batch]
                B = len(c)
                negs = rng.choice(V, size=(B, self.negatives), p=neg_p)
                targets = np.concatenate([pos_t[:, None], negs], axis=1)
                labels = np.zeros((B, 1 + self.negatives), np.float32)
                labels[:, 0] = 1.0
                vin = W_in[c]                          # (B, D)
                vout = W_out[targets]                  # (B, m, D)
                # numerically stable sigmoid: exp only ever sees -|x|, so
                # huge logits (adversarial corpora drive dot products past
                # ±700 where exp overflows to inf) stay finite
                logits = np.einsum("bmd,bd->bm", vout, vin)
                ez = np.exp(-np.abs(logits))
                scores = np.where(logits >= 0, 1.0 / (1.0 + ez),
                                  ez / (1.0 + ez))
                g = (labels - scores) * lr             # (B, m)
                # no-NaN guarantee: a raw update is ≤ lr·‖v‖ — growth
                # MULTIPLICATIVE in the weight scale, so a huge
                # user-supplied lr turns wrong-direction saturation into
                # an exponential run to ±inf (whose 0·inf / inf−inf
                # products are where NaNs are born). An absolute ±1e3
                # per-element update clip (far above any useful gradient;
                # trained embeddings live at ‖v‖ ≲ 10) caps growth at
                # linear, keeping every value finite forever while never
                # binding during sane training.
                gin = np.clip(np.einsum("bm,bmd->bd", g, vout), -1e3, 1e3)
                gout = np.clip((g[:, :, None] * vin[:, None, :]).reshape(
                    -1, D), -1e3, 1e3)
                np.add.at(W_in, c, gin)
                np.add.at(W_out, targets.reshape(-1), gout)
        return Word2VecModel({w: W_in[i] for i, w in enumerate(vocab)}, D)


# --------------------------------------------------------------------------- #
# OpLDA — native batch variational EM                                         #
# --------------------------------------------------------------------------- #

class LDAModel(Transformer):
    """OPVector (term counts) → topic distribution via folded-in E-steps.

    A host stage in the port (F25): its E-step reads the count vector on
    the host, and in a compiled scorer the counts come from a device
    stage, which hands `host_prepare` no host column (the JAX package's
    compiled scorer fails there). As a host stage it is given the
    counts, materialized from the device, and its values are the eager
    transform's."""

    out_type = T.OPVector
    jittable = False

    def __init__(self, topics: np.ndarray, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.topics = np.asarray(topics, dtype=np.float64)  # (k, V) normalized

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        X = to_host(cols[0].data).astype(np.float64)
        k = self.topics.shape[0]
        theta = np.full((X.shape[0], k), 1.0 / k)
        B = self.topics + 1e-12
        for _ in range(20):  # fixed-point E-step per doc batch
            # responsibility-weighted counts: theta ∝ sum_w x_w * p(z|w)
            denom = theta @ B + 1e-12                 # (n, V)
            theta_new = theta * ((X / denom) @ B.T)
            s = theta_new.sum(axis=1, keepdims=True)
            theta = np.where(s > 0, theta_new / np.maximum(s, 1e-12),
                             1.0 / k)
        return theta.astype(np.float32)

    def device_apply(self, enc, dev):
        return enc

    def output_meta(self) -> VectorMetadata:
        f = self.input_features[0]
        cols = tuple(VectorColumnMetadata(
            parent_name=f.name, parent_type=f.ftype.__name__,
            descriptor_value=f"topic_{j}")
            for j in range(self.topics.shape[0]))
        return VectorMetadata(self.output_name(), cols).with_indices()

    def get_params(self):
        return {"topics": self.topics.tolist()}


class OpLDA(Estimator):
    """OPVector (term counts) → k-topic mixture (OpLDA.scala:41 wrapping
    Spark LDA; native EM here: multinomial mixture with Dirichlet
    smoothing, which is LDA's MAP point estimate)."""

    in_types = (T.OPVector,)
    out_type = T.OPVector

    def __init__(self, k: int = 10, max_iter: int = 20, seed: int = 42,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, k=k, max_iter=max_iter, seed=seed)
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.seed = int(seed)

    def fit_model(self, cols: Sequence[Column], ctx: FitContext) -> Transformer:
        X = to_host(cols[0].data).astype(np.float64)  # (n, V)
        n, V = X.shape
        rng = np.random.default_rng(self.seed)
        B = rng.random((self.k, V)) + 0.1
        B /= B.sum(axis=1, keepdims=True)
        theta = np.full((n, self.k), 1.0 / self.k)
        for _ in range(self.max_iter):
            denom = theta @ B + 1e-12                  # (n, V)
            R = X / denom                              # (n, V)
            theta = theta * (R @ B.T)
            theta /= np.maximum(theta.sum(axis=1, keepdims=True), 1e-12)
            B = B * ((theta.T @ R))                    # (k, V)
            B += 1.0 / V                               # Dirichlet smoothing
            B /= B.sum(axis=1, keepdims=True)
        return LDAModel(B)
