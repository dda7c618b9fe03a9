"""RecordInsightsLOCO: per-record leave-one-column-out score deltas.

The port's counterpart of the JAX package's `insights/loco.py`
(`core/.../insights/RecordInsightsLOCO.scala:101-347`): for each scored
row, ablate each logical feature (a group of vector slots) and report the
top-K score changes; hashed-text and date unit-circle slots of one parent
are one group. The output is the reference's TextMap of feature group →
JSON array of [class_index, score_diff] pairs, which `RecordInsightsParser`
reads back.

The ablated scores come from one of two paths:

- tree models (forests, decision trees, GBT binary / regression /
  multiclass, and so a selector whose winner is one of them, since the
  selector's fitted stage is the winner) score every group's ablation by
  `loco_scores`: K4 bins X and X · 0 once, and the hand kernel K5-loco
  walks each group's ablation from the two binned matrices, so no ablated
  copy of X is made or binned;
- every other family (LR, SVC, GLM, naive Bayes, MLP) scores chunks of
  `X · (1 − m)` through `predict_arrays`, the JAX package's formulation.

`group_chunk` bounds the groups a pass: the (chunk, n, C) output on the
tree path, the (chunk·n, d) ablated copies on the other. The top-K
selection stays on the host with the JAX package's `np.argsort`, so ties
(groups of strength exactly 0 are common with trees) come out in its
order.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.data.metadata import VectorMetadata
from transmogrifai_tpu_torch.device import resolve_device
from transmogrifai_tpu_torch.stages.base import HostTransformer


def _score_matrix(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(rows, C): the probability when it has columns, else the
    prediction as one column."""
    prob = out.get("probability")
    if prob is not None and prob.dim() == 2 and prob.shape[1] > 0:
        return prob
    return out["prediction"][:, None]


class RecordInsightsLOCO(HostTransformer):
    """LOCO insights transformer over a fitted prediction model.

    `RecordInsightsLOCO(fitted_model).set_input(feature_vector)`: the
    input is the OPVector the model consumes; the output a TextMap."""

    in_types = (T.OPVector,)
    out_type = T.TextMap

    def __init__(self, model=None, top_k: int = 20, group_chunk: int = 32,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.model = model
        self.params["top_k"] = int(top_k)
        self.params["group_chunk"] = int(group_chunk)

    @staticmethod
    def _groups(meta: Optional[VectorMetadata], d: int
                ) -> Tuple[List[str], np.ndarray]:
        """Group vector slots into logical features via column metadata
        (hash/one-hot/date slots of one parent collapse together); masks
        is (G, d) with 1s on the group's slots. Without metadata every
        slot is a group (G = d)."""
        if meta is None or meta.size != d:
            names = [f"column_{j}" for j in range(d)]
            return names, np.eye(d, dtype=np.float32)
        order: List[str] = []
        idx: Dict[str, List[int]] = {}
        for j, cm in enumerate(meta.columns):
            g = cm.grouping_key()
            if g not in idx:
                idx[g] = []
                order.append(g)
            idx[g].append(j)
        masks = np.zeros((len(order), d), dtype=np.float32)
        for gi, g in enumerate(order):
            masks[gi, idx[g]] = 1.0
        return order, masks

    def _scores(self, X: torch.Tensor) -> torch.Tensor:
        return _score_matrix(self.model.predict_arrays(X))

    def ablated_scores(self, X: torch.Tensor, masks: np.ndarray
                       ) -> torch.Tensor:
        """(g, n, C) scores of X with each group of `masks` (g, d) zeroed:
        the tree path's `loco_scores`, else `predict_arrays` over the
        materialized chunk."""
        g, (n, d) = masks.shape[0], X.shape
        loco = getattr(self.model, "loco_scores", None)
        if loco is not None:
            return _score_matrix(loco(X, masks)).reshape(g, n, -1)
        m = torch.as_tensor(masks, device=X.device)
        Xa = (X[None, :, :] * (1.0 - m[:, None, :])).reshape(g * n, d)
        return self._scores(Xa).reshape(g, n, -1)

    def diffs(self, X: torch.Tensor, masks: np.ndarray) -> np.ndarray:
        """(G, n, C) f32 base − ablated scores, `group_chunk` groups a
        pass."""
        n = X.shape[0]
        base = self._scores(X)                                # (n, C)
        chunk = max(1, self.params.get("group_chunk", 32))
        # empty seed: zero groups (everything pruned) → empty insight maps
        parts: List[np.ndarray] = [
            np.zeros((0, n, base.shape[1]), np.float32)]
        for s in range(0, masks.shape[0], chunk):
            ablated = self.ablated_scores(X, masks[s:s + chunk])
            parts.append(to_host(base[None, :, :] - ablated))
        return np.concatenate(parts, axis=0)

    def transform(self, cols: Sequence[Column], device="cuda") -> Column:
        if self.model is None:
            raise RuntimeError("RecordInsightsLOCO needs a fitted model")
        vec = cols[0]
        X = vec.device_value(resolve_device(device)).to(torch.float32)
        n, d = X.shape
        names, masks = self._groups(vec.meta, d)
        diffs_np = self.diffs(X, masks)                       # (G, n, C)

        top_k = min(self.params["top_k"], len(names))
        strength = np.max(np.abs(diffs_np), axis=2)           # (G, n)
        top_idx = np.argsort(-strength, axis=0)[:top_k, :]    # (K, n)
        sel = np.take_along_axis(diffs_np, top_idx[:, :, None], axis=0)
        sel = np.round(sel.astype(np.float64), 9)             # (K, n, C)
        n_classes = sel.shape[2]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = {
                names[top_idx[k, i]]: json.dumps(
                    [[c, sel[k, i, c]] for c in range(n_classes)])
                for k in range(top_k)}
        return Column(T.TextMap, out)

    def get_params(self) -> Dict[str, Any]:
        return {"top_k": self.params["top_k"],
                "group_chunk": self.params["group_chunk"]}


class RecordInsightsParser:
    """Parse LOCO TextMap values back to structured insights
    (RecordInsightsParser.scala): {feature_group: [(class_index, diff)]}."""

    @staticmethod
    def parse_row(value: Dict[str, str]
                  ) -> Dict[str, List[Tuple[int, float]]]:
        return {k: [(int(c), float(x)) for c, x in json.loads(v)]
                for k, v in (value or {}).items()}

    @staticmethod
    def parse_column(col: Column) -> List[Dict[str, List[Tuple[int, float]]]]:
        return [RecordInsightsParser.parse_row(v) for v in col.data]
