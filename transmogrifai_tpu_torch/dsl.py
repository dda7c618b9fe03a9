"""Feature DSL: methods attached to `Feature` that wire a stage.

The port's counterpart of the JAX package's `dsl.py` (which imports the
JAX ops lazily, so the port keeps its own): the arithmetic operators and
unary math, the scalers, the numeric bucketizers, the generic row ops,
`pivot`, `sanity_check` and `indexed`. Importing the package attaches
the methods; each wires a stage and returns its output feature, nothing
runs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from transmogrifai_tpu_torch.features.feature import Feature


def _stage(cls, *inputs, **kw) -> Feature:
    return cls(**kw).set_input(*inputs).get_output()


# -- arithmetic (RichNumericFeature) ------------------------------------ #

def _binary_or_scalar(op: str):
    def method(self: Feature, other):
        from transmogrifai_tpu_torch.ops.mathops import (
            BinaryMathTransformer, ScalarMathTransformer)
        if isinstance(other, Feature):
            return _stage(BinaryMathTransformer, self, other, op=op)
        return _stage(ScalarMathTransformer, self, op=op,
                      scalar=float(other))
    return method


def _reflected_scalar(op: str):
    """scalar ⊕ feature for the non-commutative ops."""
    def method(self: Feature, other):
        from transmogrifai_tpu_torch.ops.mathops import ScalarMathTransformer
        return _stage(ScalarMathTransformer, self, op=op,
                      scalar=float(other))
    return method


def _unary(op: str, needs_arg: bool = False):
    def method(self: Feature, *arg: float):
        from transmogrifai_tpu_torch.ops.mathops import UnaryMathTransformer
        if len(arg) != int(needs_arg):
            raise TypeError(f"{op}() takes {int(needs_arg)} argument(s)")
        return _stage(UnaryMathTransformer, self, op=op,
                      **({"arg": arg[0]} if needs_arg else {}))
    return method


def log(self: Feature, base: float = 0.0) -> Feature:
    from transmogrifai_tpu_torch.ops.mathops import UnaryMathTransformer
    return _stage(UnaryMathTransformer, self, op="log", arg=base)


# -- scalers ------------------------------------------------------------- #

def z_normalize(self: Feature, with_mean: bool = True,
                with_std: bool = True) -> Feature:
    from transmogrifai_tpu_torch.ops.scalers import OpScalarStandardScaler
    return _stage(OpScalarStandardScaler, self, with_mean=with_mean,
                  with_std=with_std)


def fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
    from transmogrifai_tpu_torch.ops.scalers import FillMissingWithMean
    return _stage(FillMissingWithMean, self, default=default)


def bucketize(self: Feature, splits, track_nulls: bool = True,
              track_invalid: bool = False) -> Feature:
    from transmogrifai_tpu_torch.ops.bucketizers import NumericBucketizer
    return _stage(NumericBucketizer, self, splits=splits,
                  track_nulls=track_nulls, track_invalid=track_invalid)


def auto_bucketize(self: Feature, label: Feature, max_depth: int = 2,
                   track_nulls: bool = True) -> Feature:
    """Label-aware buckets of a numeric feature (a single-feature decision
    tree's thresholds, fitted against `label`)."""
    from transmogrifai_tpu_torch.ops.bucketizers import (
        DecisionTreeNumericBucketizer)
    return _stage(DecisionTreeNumericBucketizer, label, self,
                  max_depth=max_depth, track_nulls=track_nulls)


def to_percentile(self: Feature, buckets: int = 100) -> Feature:
    from transmogrifai_tpu_torch.ops.scalers import PercentileCalibrator
    return _stage(PercentileCalibrator, self, buckets=buckets)


def scale(self: Feature, scaling_type: str = "linear", slope: float = 1.0,
          intercept: float = 0.0) -> Feature:
    from transmogrifai_tpu_torch.ops.scalers import ScalerTransformer
    return _stage(ScalerTransformer, self, scaling_type=scaling_type,
                  slope=slope, intercept=intercept)


def descale(self: Feature, scaled: Feature) -> Feature:
    from transmogrifai_tpu_torch.ops.scalers import DescalerTransformer
    return _stage(DescalerTransformer, self, scaled)


# -- label, sanity and text entry points --------------------------------- #

def sanity_check(self: Feature, feature_vector: Feature, **kw) -> Feature:
    """label.sanity_check(vector): the SanityChecker's cleaned vector
    (RichNumericFeature.sanityCheck)."""
    from transmogrifai_tpu_torch.automl.sanity_checker import SanityChecker
    return _stage(SanityChecker, self, feature_vector, **kw)


def indexed(self: Feature, handle_invalid: str = "error") -> Feature:
    """text.indexed(): the label's index by descending count
    (OpStringIndexer)."""
    from transmogrifai_tpu_torch.ops.indexers import OpStringIndexer
    return _stage(OpStringIndexer, self, handle_invalid=handle_invalid)


def pivot(self: Feature, top_k: int = 20, min_support: int = 10,
          track_nulls: bool = True) -> Feature:
    from transmogrifai_tpu_torch.ops.categorical import OneHotVectorizer
    return _stage(OneHotVectorizer, self, top_k=top_k,
                  min_support=min_support, track_nulls=track_nulls)


# -- generic row ops (RichFeature) -------------------------------------- #

def alias(self: Feature, name: str) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import AliasTransformer
    return _stage(AliasTransformer, self, name=name)


def map_values(self: Feature, fn: Callable[[Any], Any],
               out_type: type) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import LambdaMap
    return _stage(LambdaMap, self, fn=fn, out_type=out_type)


def filter_values(self: Feature, predicate: Callable[[Any], bool]
                  ) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import FilterTransformer
    return _stage(FilterTransformer, self, predicate=predicate)


def exists(self: Feature, predicate: Callable[[Any], bool]) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import ExistsTransformer
    return _stage(ExistsTransformer, self, predicate=predicate)


def replace_with(self: Feature, old: Any, new: Any) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import ReplaceTransformer
    return _stage(ReplaceTransformer, self, old=old, new=new)


def occurs(self: Feature,
           match_fn: Optional[Callable[[Any], bool]] = None) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import ToOccurTransformer
    return _stage(ToOccurTransformer, self, match_fn=match_fn)


def jaccard_similarity(self: Feature, other: Feature) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import JaccardSimilarity
    return _stage(JaccardSimilarity, self, other)


def ngram_similarity(self: Feature, other: Feature, n: int = 3) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import NGramSimilarity
    return _stage(NGramSimilarity, self, other, n=n)


def contained_in(self: Feature, other: Feature,
                 ignore_case: bool = True) -> Feature:
    from transmogrifai_tpu_torch.ops.rowops import SubstringTransformer
    return _stage(SubstringTransformer, self, other, ignore_case=ignore_case)


_METHODS = {
    "__add__": _binary_or_scalar("plus"),
    "__radd__": _binary_or_scalar("plus"),
    "__sub__": _binary_or_scalar("minus"),
    "__rsub__": _reflected_scalar("rminus"),
    "__mul__": _binary_or_scalar("multiply"),
    "__rmul__": _binary_or_scalar("multiply"),
    "__truediv__": _binary_or_scalar("divide"),
    "__rtruediv__": _reflected_scalar("rdivide"),
    "abs": _unary("abs"), "ceil": _unary("ceil"), "floor": _unary("floor"),
    "round": _unary("round"), "exp": _unary("exp"), "sqrt": _unary("sqrt"),
    "negate": _unary("negate"), "power": _unary("power", needs_arg=True),
    "log": log,
    "z_normalize": z_normalize,
    "fill_missing_with_mean": fill_missing_with_mean,
    "bucketize": bucketize, "auto_bucketize": auto_bucketize,
    "to_percentile": to_percentile, "scale": scale, "descale": descale,
    "sanity_check": sanity_check, "indexed": indexed, "pivot": pivot,
    "alias": alias, "map_values": map_values, "filter_values": filter_values,
    "exists": exists, "replace_with": replace_with, "occurs": occurs,
    "jaccard_similarity": jaccard_similarity,
    "ngram_similarity": ngram_similarity, "contained_in": contained_in,
}

for _name, _fn in _METHODS.items():
    setattr(Feature, _name, _fn)
