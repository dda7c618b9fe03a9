"""ModelInsights: the merged explanation artifact of a fitted workflow.

The port's counterpart of the JAX package's `insights/model_insights.py`
(the reference's `ModelInsights.scala:74-858`): the sanity checker's
column statistics, the model selector's summary and each derived column's
contribution to the fitted model, grouped under the raw features. The
contributions come off the fitted model's host arrays: the coefficients
of the linear families, the split-frequency importances of the trees.
Host numpy only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.metadata import VectorMetadata


@dataclass
class DerivedFeatureInsights:
    """One engineered vector slot's story (ModelInsights `Insights`)."""

    name: str
    index: int
    contribution: List[float] = field(default_factory=list)
    corr: Optional[float] = None
    cramers_v: Optional[float] = None
    variance: Optional[float] = None
    mean: Optional[float] = None
    dropped_reasons: List[str] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "derivedFeatureName": self.name, "index": self.index,
            "contribution": self.contribution, "corr": self.corr,
            "cramersV": self.cramers_v, "variance": self.variance,
            "mean": self.mean, "droppedReasons": self.dropped_reasons,
        }


@dataclass
class FeatureInsights:
    """Per-raw-feature insights (ModelInsights `FeatureInsights`)."""

    name: str
    ftype: str
    derived: List[DerivedFeatureInsights] = field(default_factory=list)
    distributions: List[Dict[str, Any]] = field(default_factory=list)
    rff_reasons: List[str] = field(default_factory=list)

    @property
    def importance(self) -> float:
        """max |contribution| across derived columns (summary ranking)."""
        vals = [abs(c) for d in self.derived for c in d.contribution]
        return max(vals) if vals else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "featureName": self.name, "featureType": self.ftype,
            "derivedFeatures": [d.to_json() for d in self.derived],
            "distributions": self.distributions,
            "exclusionReasons": self.rff_reasons,
        }


def _tree_importances(trees, d: int,
                      n_bins: Optional[int] = None) -> Optional[np.ndarray]:
    """Split-frequency importances from dense histogram trees
    ({"feat","bin","leaf"} pytrees, models/trees.py): count valid splits per
    feature (bin == n_bins marks "no split"). `n_bins` must come from the
    model — inferring the sentinel as bins.max() would wrongly exclude real
    splits at the top bin when no node is unsplit."""
    try:
        counts = np.zeros(d, dtype=np.float64)
        tlist = trees if isinstance(trees, (list, tuple)) else [trees]
        for t in tlist:
            feat = np.asarray(t["feat"]).reshape(-1)
            bins = np.asarray(t["bin"]).reshape(-1)
            sentinel = n_bins if n_bins is not None else bins.max()
            valid = bins < sentinel
            for f in feat[valid]:
                if 0 <= int(f) < d:
                    counts[int(f)] += 1.0
        s = counts.sum()
        return counts / s if s > 0 else counts
    except Exception:
        return None


def feature_contributions(model, d: int) -> List[List[float]]:
    """Per-column contribution vectors from a fitted prediction model:
    linear family → raw coefficients (per class for multinomial); trees →
    normalized split-frequency importances; unknown → empty."""
    W = getattr(model, "W", None)
    if W is not None:
        # (d, k) features × classes (fit_logreg, models/logistic.py:40)
        W = np.asarray(W, dtype=np.float64)
        if W.ndim == 1:
            W = W[:, None]
        return [W[j, :].tolist() for j in range(min(d, W.shape[0]))]
    beta = getattr(model, "beta", None)
    if beta is not None:
        b = np.asarray(beta, dtype=np.float64).reshape(-1)
        return [[float(b[j])] for j in range(min(d, b.size))]
    trees = getattr(model, "trees", None)
    if trees is not None:
        # edges is (d, max_bins-1) → the "unsplit" bin sentinel is max_bins
        edges = getattr(model, "edges", None)
        n_bins = None if edges is None else int(np.asarray(edges).shape[1]) + 1
        imp = _tree_importances(trees, d, n_bins=n_bins)
        if imp is not None:
            return [[float(imp[j])] for j in range(d)]
    inner = getattr(model, "model", None) or getattr(model, "best_model", None)
    if inner is not None and inner is not model:
        return feature_contributions(inner, d)
    return [[] for _ in range(d)]


@dataclass
class ModelInsights:
    """The merged artifact (ModelInsights.scala:74-166)."""

    label_name: Optional[str]
    features: List[FeatureInsights]
    selected_model: Optional[Dict[str, Any]]
    stage_info: List[Dict[str, Any]] = field(default_factory=list)
    sanity_checker: Optional[Dict[str, Any]] = None
    rff: Optional[Dict[str, Any]] = None
    # drift-detection basis captured at fit time (continual/drift.py):
    # per-feature training histograms + moments + label rate, persisted
    # so a continual DriftMonitor in ANY later process can compare
    # appended records against what this model actually trained on
    training_fingerprint: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "label": self.label_name,
            "features": [f.to_json() for f in self.features],
            "selectedModelInfo": self.selected_model,
            "stageInfo": self.stage_info,
            "sanityChecker": self.sanity_checker,
            "rawFeatureFilterResults": self.rff,
            "trainingFingerprint": self.training_fingerprint,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, default=str)

    def pretty(self, top: int = 20) -> str:
        lines = [f"Model insights (label: {self.label_name})"]
        if self.selected_model:
            lines.append(f"  Best model: {self.selected_model.get('best_model')} "
                         f"{self.selected_model.get('best_grid')}")
        ranked = sorted(self.features, key=lambda f: -f.importance)
        lines.append("  Top features by |contribution|:")
        for f in ranked[:top]:
            lines.append(f"    {f.name} ({f.ftype}): {f.importance:.4f}")
        return "\n".join(lines)

    # ------------------------------------------------------------------ #

    @staticmethod
    def extract(model) -> "ModelInsights":
        """Walk a fitted WorkflowModel's stages and merge every artifact
        (ModelInsights.extractFromStages, ModelInsights.scala:446-520)."""
                # locate the prediction result + its input vector metadata
        pred_feature = next(
            (f for f in model.result_features
             if issubclass(f.ftype, T.Prediction)), None)
        label_feature = next(
            (f for f in model.result_features if f.is_response), None)
        pred_model = None
        vec_meta: Optional[VectorMetadata] = None
        if pred_feature is not None:
            stage = pred_feature.origin_stage
            pred_model = model.fitted.get(stage.uid, stage)
            vec_parent = next(
                (p for p in pred_feature.parents
                 if issubclass(p.ftype, T.OPVector)), None)
            if vec_parent is not None:
                col = model.train_columns.get(vec_parent.uid)
                vec_meta = col.meta if col is not None else None

        # sanity checker + selector summaries off the fitted stages
        sc_summary = None
        selector_summary = None
        stage_info: List[Dict[str, Any]] = []
        for uid, s in sorted(model.fitted.items()):
            stage_info.append({"uid": uid, "class": type(s).__name__})
            summ = getattr(s, "summary", None)
            if summ is None:
                continue
            cls = type(s).__name__
            if "SanityChecker" in cls:
                sc_summary = summ
            elif hasattr(summ, "validation_results"):
                selector_summary = summ

        # per-column stats/contributions keyed by vector slot
        d = vec_meta.size if vec_meta is not None else 0
        contribs = (feature_contributions(pred_model, d)
                    if pred_model is not None else [])
        stats_by_idx: Dict[int, Dict[str, Any]] = {}
        if sc_summary is not None:
            # SanityCheckerModel.summary is the persisted JSON dict; its
            # stats are per pre-drop column — map onto kept slots by name
            by_name = {st["name"]: st for st in sc_summary.get("stats", [])}
            if vec_meta is not None:
                for j, cname in enumerate(vec_meta.column_names()):
                    if cname in by_name:
                        stats_by_idx[j] = by_name[cname]

        rff_results = getattr(model, "rff_results", None)
        rff_by_name: Dict[str, List[str]] = {}
        dist_by_name: Dict[str, List[Dict[str, Any]]] = {}
        if rff_results is not None:
            for m in rff_results.metrics:
                if m.reasons:
                    rff_by_name.setdefault(m.name, []).extend(m.reasons)
                dist_by_name.setdefault(m.name, []).append({
                    "key": m.key, "trainingFillRate": m.training_fill_rate,
                    "scoringFillRate": m.scoring_fill_rate,
                    "jsDivergence": m.js_divergence,
                    "nullLabelCorrelation": m.null_label_correlation,
                })

        # group derived columns under their raw parent features
        features: Dict[str, FeatureInsights] = {}
        raw_types: Dict[str, str] = {}
        for f in model.result_features:
            for r in f.raw_features():
                raw_types[r.name] = r.ftype.__name__
        if vec_meta is not None:
            for j, cm in enumerate(vec_meta.columns):
                fi = features.get(cm.parent_name)
                if fi is None:
                    fi = FeatureInsights(
                        name=cm.parent_name,
                        ftype=cm.parent_type or raw_types.get(cm.parent_name, ""),
                        rff_reasons=rff_by_name.get(cm.parent_name, []),
                        distributions=dist_by_name.get(cm.parent_name, []))
                    features[cm.parent_name] = fi
                st = stats_by_idx.get(j, {})
                fi.derived.append(DerivedFeatureInsights(
                    name=cm.column_name(), index=j,
                    contribution=contribs[j] if j < len(contribs) else [],
                    corr=st.get("corrLabel"),
                    cramers_v=st.get("cramersV"),
                    variance=st.get("variance"),
                    mean=st.get("mean"),
                    dropped_reasons=list(st.get("dropped", []))))
        # raw features with no vector slots (e.g. RFF-dropped features are
        # rewired OUT of the result DAG) still appear, with their reasons
        for name, reasons in rff_by_name.items():
            if name not in features:
                features[name] = FeatureInsights(
                    name=name, ftype=raw_types.get(name, ""),
                    rff_reasons=reasons,
                    distributions=dist_by_name.get(name, []))

        fp = getattr(model, "training_fingerprint", None)
        return ModelInsights(
            label_name=None if label_feature is None else label_feature.name,
            features=list(features.values()),
            selected_model=(None if selector_summary is None
                            else selector_summary.to_json()),
            stage_info=stage_info,
            sanity_checker=sc_summary,
            rff=None if rff_results is None else rff_results.to_json(),
            training_fingerprint=(fp.to_json() if fp is not None
                                  and hasattr(fp, "to_json") else fp))
