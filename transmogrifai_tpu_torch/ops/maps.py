"""Map-type vectorizers: each map key behaves like its scalar counterpart.

The port's counterpart of the JAX package's `ops/maps.py`
(OPMapVectorizer.scala, TextMapPivotVectorizer.scala,
SmartTextMapVectorizer.scala, MultiPickListMapVectorizer.scala,
GeolocationMapVectorizer.scala, DateMapToUnitCircleVectorizer.scala).

A fit discovers the key set on the host, sorted; the transform encodes
each key as its scalar counterpart would, so a map column becomes
`len(keys)` pseudo-columns whose metadata carries the key in `grouping`.
The per-key extraction, pivots and hashing are host work; the device
fills, takes sin and cos, and concatenates. The fills go through
`fill_missing` (stages/base.py), which rounds as the JAX package's XLA
programs do (F11). `PhoneMapVectorizer` validates each key's phones
with `ops/enrich.py`'s parser, as `PhoneVectorizer` does.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column
from transmogrifai_tpu_torch.data.metadata import (
    NULL_INDICATOR, OTHER_INDICATOR, VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.ops.categorical import (
    one_hot_np, pivot_encode_ids, top_k_levels)
from transmogrifai_tpu_torch.ops.dates import (
    DEFAULT_PERIODS, date_phases, unit_circle)
from transmogrifai_tpu_torch.ops.enrich import phone_valid_block
from transmogrifai_tpu_torch.ops.text import TokenHasher, _hash_counts
from transmogrifai_tpu_torch.stages.base import (
    ConstantArrays, Estimator, FitContext, Transformer, fill_missing)


def _discover_keys(col: Column, allow: Sequence[str] = (),
                   block: Sequence[str] = ()) -> List[str]:
    keys = set()
    for m in col.data:
        if m is not None:
            keys.update(m.keys())
    if allow:
        keys &= set(allow)
    keys -= set(block)
    return sorted(keys)


def _key_scalar(col: Column, key: str) -> Tuple[np.ndarray, np.ndarray]:
    """Extract one key of a numeric map → (value f64, mask f32)."""
    n = len(col.data)
    val = np.zeros(n, dtype=np.float64)
    mask = np.zeros(n, dtype=np.float32)
    for i, m in enumerate(col.data):
        if m is not None:
            v = m.get(key)
            if v is not None:
                val[i] = float(v)
                mask[i] = 1.0
    return val, mask


class NumericMapModel(Transformer):
    out_type = T.OPVector

    def __init__(self, keys_per_feature: Sequence[Sequence[str]],
                 fills: Sequence[Sequence[float]], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.fills = [np.asarray(f, dtype=np.float32) for f in fills]
        self.track_nulls = track_nulls

    def host_prepare(self, cols):
        out = []
        for i, c in enumerate(cols):
            vals, masks = [], []
            for key in self.keys_per_feature[i]:
                v, m = _key_scalar(c, key)
                vals.append(v.astype(np.float32))
                masks.append(m)
            out.append({
                "value": (np.stack(vals, 1) if vals
                          else np.zeros((len(c.data), 0), np.float32)),
                "mask": (np.stack(masks, 1) if masks
                         else np.zeros((len(c.data), 0), np.float32))})
        return out

    def device_constants(self, device):
        return ConstantArrays(self.fills).to(device)

    def device_apply_with(self, consts, enc, dev):
        parts = []
        for i, e in enumerate(enc):
            v, m = e["value"], e["mask"]
            filled = fill_missing(v, m, consts[i][None, :])
            if self.track_nulls:
                # explicit width: reshape(n, -1) breaks on 0-row batches
                parts.append(torch.stack([filled, 1.0 - m], dim=2).reshape(
                    v.shape[0], 2 * v.shape[1]))
            else:
                parts.append(filled)
        return torch.cat(parts, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f, keys in zip(self.input_features, self.keys_per_feature):
            for k in keys:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=k))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=k, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "fills": [f.tolist() for f in self.fills],
                "track_nulls": self.track_nulls}


class NumericMapVectorizer(Estimator):
    """RealMap/IntegralMap/BinaryMap… → per-key impute + null indicator
    (OPMapVectorizer)."""

    in_types = (T.OPMap, Ellipsis)
    out_type = T.OPVector

    def __init__(self, fill_value: str = "mean", track_nulls: bool = True,
                 allow_keys: Sequence[str] = (),
                 block_keys: Sequence[str] = (),
                 uid: Optional[str] = None):
        super().__init__(uid=uid, fill_value=fill_value,
                         track_nulls=track_nulls,
                         allow_keys=list(allow_keys),
                         block_keys=list(block_keys))
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.allow_keys = tuple(allow_keys)
        self.block_keys = tuple(block_keys)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        keys_pf, fills_pf = [], []
        for c in cols:
            keys = _discover_keys(c, self.allow_keys, self.block_keys)
            fills = []
            for k in keys:
                v, m = _key_scalar(c, k)
                if self.fill_value == "mean" and m.sum() > 0:
                    fills.append(float((v * m).sum() / m.sum()))
                else:
                    fills.append(0.0)
            keys_pf.append(keys)
            fills_pf.append(fills)
        return NumericMapModel(keys_pf, fills_pf, self.track_nulls)


class TextMapPivotModel(Transformer):
    out_type = T.OPVector

    def __init__(self, keys_per_feature: Sequence[Sequence[str]],
                 vocabs: Sequence[Dict[str, List[str]]],
                 track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.vocabs = list(vocabs)
        self.track_nulls = track_nulls

    def host_prepare(self, cols):
        blocks = []
        for i, c in enumerate(cols):
            n = len(c.data)
            feat_blocks = []
            for key in self.keys_per_feature[i]:
                vocab = self.vocabs[i][key]
                lut = {s: j for j, s in enumerate(vocab)}
                k = len(vocab)
                width = k + 1 + (1 if self.track_nulls else 0)
                block = np.zeros((n, width), dtype=np.float32)
                for r, m in enumerate(c.data):
                    v = None if m is None else m.get(key)
                    if v is None:
                        if self.track_nulls:
                            block[r, k + 1] = 1.0
                    elif isinstance(v, (set, frozenset)):  # MultiPickListMap
                        for s in v:
                            block[r, lut.get(s, k)] = 1.0
                    else:
                        block[r, lut.get(v, k)] = 1.0
                feat_blocks.append(block)
            blocks.append(np.concatenate(feat_blocks, 1) if feat_blocks
                          else np.zeros((n, 0), np.float32))
        return blocks

    def device_apply(self, enc, dev):
        return torch.cat(list(enc), dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            for key in self.keys_per_feature[i]:
                for lvl in self.vocabs[i][key]:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=lvl))
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=key, indicator_value=OTHER_INDICATOR))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "vocabs": self.vocabs,
                "track_nulls": self.track_nulls}


class TextMapPivotVectorizer(Estimator):
    """TextMap/PickListMap… → per-key top-K pivot
    (TextMapPivotVectorizer.scala)."""

    in_types = (T.OPMap, Ellipsis)
    out_type = T.OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        keys_pf, vocabs_pf = [], []
        for c in cols:
            keys = _discover_keys(c)
            vocabs: Dict[str, List[str]] = {}
            for k in keys:
                counter: Counter = Counter()
                for m in c.data:
                    if m is not None:
                        v = m.get(k)
                        if v is None:
                            continue
                        if isinstance(v, (set, frozenset)):  # MultiPickListMap
                            counter.update(v)
                        else:
                            counter[v] += 1
                vocabs[k] = top_k_levels(counter, self.top_k, self.min_support)
            keys_pf.append(keys)
            vocabs_pf.append(vocabs)
        return TextMapPivotModel(keys_pf, vocabs_pf, self.track_nulls)


class GeolocationMapModel(Transformer):
    out_type = T.OPVector

    def __init__(self, keys_per_feature, fills, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.fills = [np.asarray(f, dtype=np.float32) for f in fills]  # (K,3)
        self.track_nulls = track_nulls

    def host_prepare(self, cols):
        out = []
        for i, c in enumerate(cols):
            n = len(c.data)
            keys = self.keys_per_feature[i]
            vals = np.zeros((n, len(keys), 3), dtype=np.float32)
            mask = np.zeros((n, len(keys)), dtype=np.float32)
            for r, m in enumerate(c.data):
                if m is None:
                    continue
                for j, key in enumerate(keys):
                    v = m.get(key)
                    if v is not None:
                        vals[r, j] = v
                        mask[r, j] = 1.0
            out.append({"value": vals, "mask": mask})
        return out

    def device_constants(self, device):
        return ConstantArrays([f.reshape(-1, 3) for f in self.fills]).to(
            device)

    def device_apply_with(self, consts, enc, dev):
        parts = []
        for i, e in enumerate(enc):
            v = e["value"]                 # (n, K, 3)
            m = e["mask"][:, :, None]      # (n, K, 1)
            filled = fill_missing(v, m, consts[i][None, :, :])
            block = (torch.cat([filled, 1.0 - m], dim=2) if self.track_nulls
                     else filled)
            parts.append(block.reshape(v.shape[0],
                                       block.shape[1] * block.shape[2]))
        return torch.cat(parts, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            for key in self.keys_per_feature[i]:
                for d in ("lat", "lon", "accuracy"):
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, descriptor_value=d))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "fills": [f.tolist() for f in self.fills],
                "track_nulls": self.track_nulls}


class GeolocationMapVectorizer(Estimator):
    in_types = (T.GeolocationMap, Ellipsis)
    out_type = T.OPVector

    def __init__(self, track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid, track_nulls=track_nulls)
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        keys_pf, fills_pf = [], []
        for c in cols:
            keys = _discover_keys(c)
            sums = np.zeros((len(keys), 3), dtype=np.float64)
            counts = np.zeros(len(keys), dtype=np.float64)
            for m in c.data:
                if m is None:
                    continue
                for j, key in enumerate(keys):
                    v = m.get(key)
                    if v is not None:
                        sums[j] += v
                        counts[j] += 1
            fills = sums / np.maximum(counts, 1.0)[:, None]
            keys_pf.append(keys)
            fills_pf.append(fills)
        return GeolocationMapModel(keys_pf, fills_pf, self.track_nulls)


class DateMapVectorizer(Estimator):
    """DateMap → per-key unit-circle encodings
    (DateMapToUnitCircleVectorizer.scala)."""

    in_types = (T.DateMap, Ellipsis)
    out_type = T.OPVector

    def __init__(self, periods: Sequence[str] = DEFAULT_PERIODS,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, periods=list(periods))
        self.periods = tuple(periods)

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        keys_pf = [_discover_keys(c) for c in cols]
        return DateMapModel(keys_pf, self.periods)


class DateMapModel(Transformer):
    out_type = T.OPVector

    def __init__(self, keys_per_feature,
                 periods: Sequence[str] = DEFAULT_PERIODS,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.periods = tuple(periods)

    def host_prepare(self, cols):
        per_key = []
        n = len(cols[0].data) if cols else 0
        for i, c in enumerate(cols):
            for key in self.keys_per_feature[i]:
                val, mask = _key_scalar(c, key)
                per_key.append({
                    "phases": date_phases(val.astype(np.int64), self.periods),
                    "mask": mask})
        return {"n": np.zeros((n, 0), np.float32), "keys": per_key}

    def device_apply(self, enc, dev):
        parts = [unit_circle(e["phases"], e["mask"]) for e in enc["keys"]]
        if not parts:  # no key: every training value was null
            return enc["n"]
        return torch.cat(parts, dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            for key in self.keys_per_feature[i]:
                for p in self.periods:
                    for fn in ("sin", "cos"):
                        cols.append(VectorColumnMetadata(
                            parent_name=f.name, parent_type=f.ftype.__name__,
                            grouping=key, descriptor_value=f"{p}_{fn}"))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "periods": list(self.periods)}


class SmartTextMapModel(Transformer):
    """Fitted per-(feature, key) strategy: pivot / hashed tokens / ignore."""

    out_type = T.OPVector

    def __init__(self, keys_per_feature: Sequence[Sequence[str]],
                 strategies: Sequence[Dict[str, str]],
                 vocabs: Sequence[Dict[str, List[str]]],
                 num_features: int = 512, track_nulls: bool = True,
                 seed: int = 42, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.strategies = list(strategies)
        self.vocabs = list(vocabs)
        self.num_features = num_features
        self.track_nulls = track_nulls
        self.seed = seed

    def _key_values(self, c: Column, key: str) -> np.ndarray:
        out = np.empty(len(c.data), dtype=object)
        for i, m in enumerate(c.data):
            out[i] = None if m is None else m.get(key)
        return out

    def host_prepare(self, cols):
        blocks = []
        for i, c in enumerate(cols):
            n = len(c.data)
            feat_blocks = []
            for ki, key in enumerate(self.keys_per_feature[i]):
                values = self._key_values(c, key)
                strat = self.strategies[i][key]
                if strat == "pivot":
                    vocab = self.vocabs[i][key]
                    lut = {s: j for j, s in enumerate(vocab)}
                    block = one_hot_np(
                        pivot_encode_ids(values, lut, len(vocab)),
                        len(vocab), self.track_nulls)
                elif strat == "hash":
                    hasher = TokenHasher(self.num_features,
                                         self.seed + 31 * i + ki)
                    block = _hash_counts(values, hasher, False, False)
                    if self.track_nulls:
                        nulls = np.fromiter(
                            (1.0 if v is None else 0.0 for v in values),
                            dtype=np.float32, count=n)
                        block = np.concatenate([block, nulls[:, None]], 1)
                else:  # ignore: null indicator only
                    nulls = np.fromiter(
                        (1.0 if v is None else 0.0 for v in values),
                        dtype=np.float32, count=n)
                    block = nulls[:, None]
                feat_blocks.append(block)
            blocks.append(np.concatenate(feat_blocks, 1) if feat_blocks
                          else np.zeros((n, 0), np.float32))
        return blocks

    def device_apply(self, enc, dev):
        return torch.cat(list(enc), dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            for key in self.keys_per_feature[i]:
                strat = self.strategies[i][key]
                if strat == "pivot":
                    for lvl in self.vocabs[i][key]:
                        cols.append(VectorColumnMetadata(
                            parent_name=f.name, parent_type=f.ftype.__name__,
                            grouping=key, indicator_value=lvl))
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=OTHER_INDICATOR))
                    if self.track_nulls:
                        cols.append(VectorColumnMetadata(
                            parent_name=f.name, parent_type=f.ftype.__name__,
                            grouping=key, indicator_value=NULL_INDICATOR))
                elif strat == "hash":
                    for j in range(self.num_features):
                        cols.append(VectorColumnMetadata(
                            parent_name=f.name, parent_type=f.ftype.__name__,
                            grouping=key, descriptor_value=f"hash_{j}"))
                    if self.track_nulls:
                        cols.append(VectorColumnMetadata(
                            parent_name=f.name, parent_type=f.ftype.__name__,
                            grouping=key, indicator_value=NULL_INDICATOR))
                else:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "strategies": self.strategies, "vocabs": self.vocabs,
                "num_features": self.num_features,
                "track_nulls": self.track_nulls, "seed": self.seed}


class SmartTextMapVectorizer(Estimator):
    """TextMap/TextAreaMap → per-KEY cardinality stats choose pivot vs
    hashed tokens vs ignore (SmartTextMapVectorizer.scala — the map
    variant of SmartTextVectorizer; the transmogrify default for
    TextMap/TextAreaMap, Transmogrifier.scala:196-209)."""

    in_types = (T.OPMap, Ellipsis)
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
        keys_pf, strats_pf, vocabs_pf = [], [], []
        for c in cols:
            keys = _discover_keys(c)
            strategies: Dict[str, str] = {}
            vocabs: Dict[str, List[str]] = {}
            for k in keys:
                counter: Counter = Counter()
                for m in c.data:
                    v = None if m is None else m.get(k)
                    if v is not None:
                        counter[v] += 1
                n_values = sum(counter.values())
                n_distinct = len(counter)
                if n_distinct == 0:
                    strategies[k] = "ignore"
                    vocabs[k] = []
                elif n_distinct <= self.max_cardinality:
                    strategies[k] = "pivot"
                    vocabs[k] = top_k_levels(counter, self.top_k,
                                             self.min_support)
                elif n_values > 0 and \
                        n_distinct / n_values >= self.id_detect_ratio:
                    strategies[k] = "ignore"
                    vocabs[k] = []
                else:
                    strategies[k] = "hash"
                    vocabs[k] = []
            keys_pf.append(keys)
            strats_pf.append(strategies)
            vocabs_pf.append(vocabs)
        return SmartTextMapModel(keys_pf, strats_pf, vocabs_pf,
                                 self.num_features, self.track_nulls,
                                 self.seed)


class MultiPickListMapVectorizer(TextMapPivotVectorizer):
    """MultiPickListMap → per-key top-K multi-hot
    (MultiPickListMapVectorizer.scala). The pivot model already multi-hots
    set values; this named class carries the reference's stage identity and
    restricts input typing."""

    in_types = (T.MultiPickListMap, Ellipsis)


class PhoneMapModel(Transformer):
    """PhoneMap → per key [isValid(, isNull)], the blocks of
    `PhoneVectorizer` (`ops/enrich.py`'s `phone_valid_block`), so scalar
    and map phone encodings cannot drift; the device concatenates."""

    out_type = T.OPVector

    def __init__(self, keys_per_feature: Sequence[Sequence[str]],
                 default_region: str = "US", track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.default_region = default_region
        self.track_nulls = track_nulls

    def host_prepare(self, cols):
        blocks = []
        for i, c in enumerate(cols):
            n = len(c.data)
            key_blocks = []
            for key in self.keys_per_feature[i]:
                values = [None if m is None else m.get(key) for m in c.data]
                key_blocks.append(phone_valid_block(
                    values, self.default_region, self.track_nulls))
            blocks.append(np.concatenate(key_blocks, 1) if key_blocks
                          else np.zeros((n, 0), np.float32))
        return blocks

    def device_apply(self, enc, dev):
        return torch.cat(list(enc), dim=1)

    def output_meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for i, f in enumerate(self.input_features):
            for key in self.keys_per_feature[i]:
                cols.append(VectorColumnMetadata(
                    parent_name=f.name, parent_type=f.ftype.__name__,
                    grouping=key, indicator_value="IsValid"))
                if self.track_nulls:
                    cols.append(VectorColumnMetadata(
                        parent_name=f.name, parent_type=f.ftype.__name__,
                        grouping=key, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name(), tuple(cols)).with_indices()

    def get_params(self):
        return {"keys_per_feature": self.keys_per_feature,
                "default_region": self.default_region,
                "track_nulls": self.track_nulls}


class PhoneMapVectorizer(Estimator):
    """PhoneMap → per-key validity vector (the transmogrify default for
    PhoneMap, Transmogrifier.scala:185-187)."""

    in_types = (T.PhoneMap, Ellipsis)
    out_type = T.OPVector

    def __init__(self, default_region: str = "US", track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(uid=uid, default_region=default_region,
                         track_nulls=track_nulls)
        self.default_region = default_region
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column],
                  ctx: FitContext) -> Transformer:
        return PhoneMapModel([_discover_keys(c) for c in cols],
                             self.default_region, self.track_nulls)


def map_vectorizers(features: Sequence, defaults) -> List:
    """Dispatch map-typed features to their vectorizers (transmogrify's
    map group, the JAX package's order; Transmogrifier.scala:140-273)."""
    numeric, pivot, smart, multi, phone, geo, date = ([], [], [], [], [],
                                                      [], [])
    for f in features:
        ft = f.ftype
        if issubclass(ft, T.Prediction):
            raise TypeError(
                f"transmogrify: refusing to vectorize Prediction feature "
                f"{f.name!r} — feeding model scores back in is usually "
                f"label leakage; extract explicit columns if intended")
        if issubclass(ft, T.GeolocationMap):
            geo.append(f)
        elif issubclass(ft, (T.DateMap,)):
            date.append(f)
        elif issubclass(ft, (T.RealMap, T.IntegralMap, T.BinaryMap)):
            numeric.append(f)
        elif issubclass(ft, T.PhoneMap):
            phone.append(f)
        elif issubclass(ft, T.MultiPickListMap):
            multi.append(f)
        elif issubclass(ft, (T.TextAreaMap,)) or ft in (T.TextMap,):
            # free-text maps → per-key smart strategies
            smart.append(f)
        elif issubclass(ft, T.TextMap):
            # Email/ID/URL/PickList/ComboBox/Base64/location maps → pivot
            pivot.append(f)
        else:
            raise TypeError(f"No map vectorizer for {ft.__name__} ({f.name})")
    out = []
    if numeric:
        out.append(NumericMapVectorizer(
            track_nulls=defaults.track_nulls).set_input(*numeric).get_output())
    if pivot:
        out.append(TextMapPivotVectorizer(
            top_k=defaults.top_k, min_support=defaults.min_support,
            track_nulls=defaults.track_nulls).set_input(*pivot).get_output())
    if smart:
        out.append(SmartTextMapVectorizer(
            max_cardinality=defaults.max_cardinality, top_k=defaults.top_k,
            min_support=defaults.min_support,
            num_features=defaults.num_hash_features,
            track_nulls=defaults.track_nulls).set_input(*smart).get_output())
    if multi:
        out.append(MultiPickListMapVectorizer(
            top_k=defaults.top_k, min_support=defaults.min_support,
            track_nulls=defaults.track_nulls).set_input(*multi).get_output())
    if phone:
        out.append(PhoneMapVectorizer(
            track_nulls=defaults.track_nulls).set_input(*phone).get_output())
    if geo:
        out.append(GeolocationMapVectorizer(
            track_nulls=defaults.track_nulls).set_input(*geo).get_output())
    if date:
        out.append(DateMapVectorizer(
            periods=defaults.circular_date_periods).set_input(
                *date).get_output())
    return out
