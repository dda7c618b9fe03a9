"""Text ops: tokenizer, murmur3 hashing, SmartTextVectorizer and its model.

The port's counterpart of the JAX package's `ops/text.py`. All string work
is host-side numpy prep producing dense (n, d) count arrays; the device
side is a concat. Hashing is pure-python murmur3-32 over the row-wise
tokenizer — the JAX package's `_hash_counts` row-loop branch — so bucket
ids and counts are bit-identical to the JAX package's.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.ops.categorical import (
    one_hot_np, pivot_encode_ids, top_k_levels)
from transmogrifai_tpu_torch.stages.base import (
    Estimator, FitContext, Transformer)

# ---------------------------------------------------------------------------
# murmur3-32 (pure python, memoized) — HashAlgorithm.MurMur3 parity
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M32
    length = len(data)
    rounded = length & ~0x3
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * c2) & _M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M32
        h = (h * 5 + 0xE6546B64) & _M32
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * c2) & _M32
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


class TokenHasher:
    """Memoized token → bucket mapper."""

    def __init__(self, num_features: int, seed: int = 42):
        self.num_features = num_features
        self.seed = seed
        self._memo: Dict[str, int] = {}

    def __call__(self, token: str) -> int:
        b = self._memo.get(token)
        if b is None:
            b = murmur3_32(token.encode("utf-8"), self.seed) % self.num_features
            self._memo[token] = b
        return b


# ---------------------------------------------------------------------------
# Tokenizer (TextTokenizer.scala → LuceneTextAnalyzer.scala:87 parity:
# Unicode-script-aware analysis instead of one regex; VERDICT r3 #4)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"[^\W_]+", re.UNICODE)

# script runs that need non-whitespace segmentation. Lucene's CJKAnalyzer
# emits overlapping character bigrams for Han/kana runs; Thai/Lao/Khmer/
# Myanmar (no inter-word spaces) get the same bigram treatment here as a
# dictionary-segmentation stand-in (Lucene uses ICU break iterators).
_BIGRAM_CLASS = (
    "\u4e00-\u9fff\u3400-\u4dbf"   # Han
    "\u3040-\u309f\u30a0-\u30ff"   # hiragana / katakana
    "\u0e00-\u0e7f\u0e80-\u0eff"   # Thai / Lao
    "\u1780-\u17ff\u1000-\u109f")  # Khmer / Myanmar
_BIGRAM_RUN_RE = re.compile(f"([{_BIGRAM_CLASS}]+)")
_ARABIC_RE = re.compile("[\u0600-\u06ff\u0750-\u077f]")
# cheap probe: does the text contain ANY char needing the analyzer path?
_NONSIMPLE_RE = re.compile(
    f"[{_BIGRAM_CLASS}\u0600-\u06ff\u0750-\u077f]")

# Arabic normalization (Lucene ArabicNormalizer): strip tatweel (0640) +
# harakat diacritics (064B-065F, 0670), fold alef/yaa/ta-marbuta variants
_AR_DIACRITICS = re.compile("[\u0640\u064b-\u065f\u0670]")
_AR_FOLD = str.maketrans({"\u0622": "\u0627", "\u0623": "\u0627",
                          "\u0625": "\u0627", "\u0649": "\u064a",
                          "\u0629": "\u0647"})


def _bigram_tokens(run: str) -> List[str]:
    if len(run) == 1:
        return [run]
    return [run[i:i + 2] for i in range(len(run) - 1)]


def _analyze(text: str, min_token_length: int) -> List[str]:
    """Script-aware token stream: bigram CJK/SEA runs, normalized Arabic,
    regex words elsewhere. CJK/SEA bigrams bypass min_token_length (a
    2-char bigram IS the token unit for those scripts)."""
    out: List[str] = []
    for part in _BIGRAM_RUN_RE.split(text):
        if not part:
            continue
        if _BIGRAM_RUN_RE.fullmatch(part):
            out.extend(_bigram_tokens(part))
            continue
        if _ARABIC_RE.search(part):
            part = _AR_DIACRITICS.sub("", part).translate(_AR_FOLD)
        out.extend(t for t in _TOKEN_RE.findall(part)
                   if len(t) >= min_token_length)
    return out


def tokenize(text: Optional[str], min_token_length: int = 1,
             to_lowercase: bool = True,
             language: Optional[str] = None) -> List[str]:
    """Analyzer tokens. `language` is accepted for the TextTokenizer
    API (reserved for per-language stopword/stemming rules); the script-
    aware segmentation itself is language-independent."""
    if not text:
        return []
    if to_lowercase:
        text = text.lower()
    if _NONSIMPLE_RE.search(text) is None:  # fast path: simple scripts
        return [t for t in _TOKEN_RE.findall(text)
                if len(t) >= min_token_length]
    return _analyze(text, min_token_length)


def _hash_counts(values, hasher: TokenHasher,
                 pre_tokenized: bool) -> np.ndarray:
    """(n, num_features) f32 hashed token counts, one row per value:
    tokens are hashed one by one and scatter-added with `np.add.at`."""
    n = len(values)
    out = np.zeros((n, hasher.num_features), dtype=np.float32)
    rows: List[int] = []
    toks: List[str] = []
    for i, v in enumerate(values):
        if v is None:
            continue
        t = v if pre_tokenized else tokenize(v)
        toks.extend(t)
        rows.extend([i] * len(t))
    if not toks:
        return out
    buckets = np.fromiter((hasher(t) for t in toks), np.int64, len(toks))
    np.add.at(out, (np.asarray(rows, dtype=np.int64), buckets), 1.0)
    return out


# ---------------------------------------------------------------------------
# SmartTextModel (SmartTextVectorizer.scala:62-267, fitted side)
# ---------------------------------------------------------------------------

PIVOT, HASH, IGNORE = "pivot", "hash", "ignore"


class SmartTextModel(Transformer):
    """Fitted per-field strategy: categorical pivot, hashed tokens, or
    null-indicator-only for ID-like fields."""

    out_type = T.OPVector

    def __init__(self, strategies: Sequence[str], vocabs: Sequence[Sequence[str]],
                 num_features: int, track_nulls: bool = True, seed: int = 42,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.strategies = list(strategies)
        self.vocabs = [list(v) for v in vocabs]
        self.num_features = num_features
        self.track_nulls = track_nulls
        self.seed = seed
        self._lookups = [{s: i for i, s in enumerate(v)} for v in self.vocabs]

    def host_prepare(self, cols: Sequence[Optional[Column]]):
        blocks = []
        for i, c in enumerate(cols):
            strat = self.strategies[i]
            n = len(c.data)
            if strat == PIVOT:
                lut, k = self._lookups[i], len(self.vocabs[i])
                block = one_hot_np(pivot_encode_ids(c.data, lut, k), k,
                                   self.track_nulls)
            elif strat == HASH:
                hasher = TokenHasher(self.num_features, self.seed + i)
                block = _hash_counts(c.data, hasher, False)
                if self.track_nulls:
                    nulls = np.fromiter(
                        (1.0 if v is None else 0.0 for v in c.data),
                        dtype=np.float32, count=n)
                    block = np.concatenate([block, nulls[:, None]], axis=1)
            else:  # IGNORE: null indicator only
                nulls = np.fromiter(
                    (1.0 if v is None else 0.0 for v in c.data),
                    dtype=np.float32, count=n)
                block = nulls[:, None]
            blocks.append(block)
        return blocks

    def device_apply(self, enc, dev):
        return torch.cat(list(enc), dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            strat = self.strategies[i]
            if strat == PIVOT:
                for lvl in self.vocabs[i]:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=f.name, indicator_value=lvl))
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=f.name, indicator_value="OTHER"))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=f.name, indicator_value=NULL_INDICATOR))
            elif strat == HASH:
                for j in range(self.num_features):
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        descriptor_value=f"hash_{j}"))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        indicator_value=NULL_INDICATOR))
            else:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"strategies": self.strategies, "vocabs": self.vocabs,
                "num_features": self.num_features,
                "track_nulls": self.track_nulls, "seed": self.seed}


class SmartTextVectorizer(Estimator):
    """Per-field cardinality stats choose the encoding:

    - distinct <= max_cardinality          → top-K categorical pivot
    - ID-like (distinct / count >= ratio)  → ignore (null indicator only)
    - otherwise                            → hashed token counts
    """

    in_types = (T.Text, Ellipsis)
    out_type = T.OPVector

    def __init__(self, max_cardinality: int = 100, top_k: int = 20,
                 min_support: int = 10, num_features: int = 512,
                 id_detect_ratio: float = 0.99, track_nulls: bool = True,
                 seed: int = 42, uid: Optional[str] = None):
        super().__init__(
            uid=uid, max_cardinality=max_cardinality, top_k=top_k,
            min_support=min_support, num_features=num_features,
            id_detect_ratio=id_detect_ratio, track_nulls=track_nulls,
            seed=seed)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_features = num_features
        self.id_detect_ratio = id_detect_ratio
        self.track_nulls = track_nulls
        self.seed = seed

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        strategies, vocabs = [], []
        for c in cols:
            counter = Counter(s for s in c.data if s is not None)
            n_values = sum(counter.values())
            n_distinct = len(counter)
            if n_distinct == 0:
                strategies.append(IGNORE)
                vocabs.append([])
            elif n_distinct <= self.max_cardinality:
                strategies.append(PIVOT)
                vocabs.append(top_k_levels(counter, self.top_k,
                                           self.min_support))
            elif n_values > 0 and n_distinct / n_values >= \
                    self.id_detect_ratio:
                strategies.append(IGNORE)
                vocabs.append([])
            else:
                strategies.append(HASH)
                vocabs.append([])
        return SmartTextModel(strategies, vocabs, self.num_features,
                              self.track_nulls, self.seed)
