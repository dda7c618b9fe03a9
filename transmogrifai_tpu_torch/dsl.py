"""Feature DSL: methods attached to `Feature` that wire a stage.

The port's counterpart of the JAX package's `dsl.py` (which imports the
JAX ops lazily, so the port keeps its own). Importing the package
attaches the methods.
"""

from __future__ import annotations

from transmogrifai_tpu_torch.features.feature import Feature


def _stage(cls, *inputs, **kw) -> Feature:
    return cls(**kw).set_input(*inputs).get_output()


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


Feature.sanity_check = sanity_check
Feature.indexed = indexed
