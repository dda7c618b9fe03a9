"""DAG scheduling: topological layering with cycle detection, the
private copy of a DAG that a workflow fits, and the DAG without blocked
raw features.

The port's copy of `topological_layers`, `clone_graph` and
`rewire_without` from the JAX package's `features/dag.py`: `layer(stage)
= 1 + max(layer(parent stages))`, raw FeatureGeneratorStages at layer 0,
stages sorted by uid within a layer.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

from transmogrifai_tpu_torch.stages.base import FeatureGeneratorStage, Stage


class FeatureCycleError(RuntimeError):
    """The feature graph contains a cycle; `path` names the stage chain."""

    def __init__(self, message: str, path: Sequence[str] = ()):
        super().__init__(message)
        self.path = list(path)


def topological_layers(result_features: Sequence) -> List[List[Stage]]:
    """Layered schedule of all stages reachable from `result_features`.

    Returns layers in execution order; layer 0 is all raw feature
    generators. Raises FeatureCycleError on cyclic graphs.
    """
    depth: Dict[str, int] = {}
    stages: Dict[str, Stage] = {}
    visiting: set = set()
    stack: List[Stage] = []  # DFS path, for cycle reporting

    def visit(stage: Stage) -> int:
        if stage.uid in depth:
            return depth[stage.uid]
        if stage.uid in visiting:
            start = next(i for i, s in enumerate(stack)
                         if s.uid == stage.uid)
            loop = stack[start:] + [stage]
            names = [f"{s.operation_name}({s.get_output().name})"
                     if s._output is not None else s.operation_name
                     for s in loop]
            raise FeatureCycleError(
                "Cycle detected in the feature graph: "
                + " -> ".join(names)
                + f" (stage uids: {', '.join(s.uid for s in loop)})",
                path=[s.operation_name for s in loop])
        visiting.add(stage.uid)
        stack.append(stage)
        try:
            if isinstance(stage, FeatureGeneratorStage) or not stage.input_features:
                d = 0
            else:
                d = 1 + max(visit(p.origin_stage) for p in stage.input_features)
        finally:
            stack.pop()
            visiting.discard(stage.uid)
        depth[stage.uid] = d
        stages[stage.uid] = stage
        return d

    for f in result_features:
        if f.origin_stage is not None:
            visit(f.origin_stage)

    if not stages:
        return []
    n_layers = max(depth.values()) + 1
    layers: List[List[Stage]] = [[] for _ in range(n_layers)]
    for uid, d in depth.items():
        layers[d].append(stages[uid])
    # deterministic order within a layer
    for layer in layers:
        layer.sort(key=lambda s: s.uid)
    return layers


def _clone_stage(stage: Stage) -> Stage:
    """Shallow stage copy that does not share mutable param containers."""
    cs = copy.copy(stage)
    cs.params = {k: (v.copy() if isinstance(v, (dict, list, set)) else v)
                 for k, v in getattr(stage, "params", {}).items()}
    return cs


def clone_graph(result_features: Sequence) -> List:
    """Private copy of the feature DAG, preserving uids. A workflow fits
    the copy, so the estimator→model swap never touches the caller's
    graph; fitted models in the source graph unwind to their estimators,
    so a re-train refits."""
    from transmogrifai_tpu_torch.features.feature import Feature

    fmap: Dict[str, object] = {}
    smap: Dict[str, Stage] = {}

    def clone_feature(f) -> object:
        if f.uid in fmap:
            return fmap[f.uid]
        parents = tuple(clone_feature(p) for p in f.parents)
        stage = getattr(f.origin_stage, "_estimator", None) or f.origin_stage
        cs = smap.get(stage.uid)
        if cs is None:
            cs = _clone_stage(stage)
            cs._output = None
            smap[stage.uid] = cs
        if parents:
            cs.input_features = parents
        nf = Feature(name=f.name, ftype=f.ftype, origin_stage=cs,
                     parents=parents, is_response=f.is_response, uid=f.uid)
        cs._output = nf
        fmap[f.uid] = nf
        return nf

    return [clone_feature(f) for f in result_features]


def rewire_without(result_features: Sequence, blocked_raw: Sequence[str]):
    """The DAG rebuilt without the named raw features (the JAX package's
    blocklist rewiring): a variadic stage keeps the inputs that survive;
    a fixed-arity stage that loses an input is dropped, and the drop
    cascades to what depends on it. Returns (surviving result features,
    names of the dropped ones)."""
    from transmogrifai_tpu_torch.features.feature import Feature

    blocked = set(blocked_raw)
    fmap: Dict[str, object] = {}
    smap: Dict[str, Stage] = {}

    def rebuild(f):
        """A copy of `f` without blocked ancestors, or None."""
        if f.uid in fmap:
            return fmap[f.uid]
        stage = getattr(f.origin_stage, "_estimator", None) or f.origin_stage
        if isinstance(stage, FeatureGeneratorStage) or not f.parents:
            nf = None if f.name in blocked else f
            fmap[f.uid] = nf
            return nf
        kept = tuple(p for p in (rebuild(p) for p in f.parents)
                     if p is not None)
        spec = stage.in_types
        variadic = spec is not None and len(spec) == 2 and spec[1] is Ellipsis
        if not kept or (not variadic and len(kept) != len(f.parents)):
            fmap[f.uid] = None  # a required input was blocked
            return None
        cs = smap.get(stage.uid)
        if cs is None:
            cs = _clone_stage(stage)
            cs._output = None
            cs.input_features = kept
            smap[stage.uid] = cs
        nf = Feature(name=f.name, ftype=f.ftype, origin_stage=cs,
                     parents=kept, is_response=f.is_response, uid=f.uid)
        cs._output = nf
        fmap[f.uid] = nf
        return nf

    survived, dropped = [], []
    for f in result_features:
        nf = rebuild(f)
        if nf is None:
            dropped.append(f.name)
        else:
            survived.append(nf)
    return survived, dropped
