"""DAG scheduling: topological layering with cycle detection.

The port's copy of `topological_layers` from the JAX package's
`features/dag.py`: `layer(stage) = 1 + max(layer(parent stages))`, raw
FeatureGeneratorStages at layer 0, stages sorted by uid within a layer.
"""

from __future__ import annotations

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
