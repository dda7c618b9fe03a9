"""CompiledScorer: the fitted DAG planned as host and device segments.

The port's counterpart of the JAX package's `workflow/compiled.py`,
without the quantized wire and without sharding. Per batch:

- host phase: materialize the raw columns, run host stages, and call
  each device stage's `host_prepare` (strings → ids, hash counts);
- device phase: the encodings and raw numeric columns move to the model's
  device once, and consecutive device stages run back to back on tensors
  there. A device segment returns only what a later segment or a result
  feature reads.

A plan whose device stages form one trailing segment (the usual shape:
string work happens in `host_prepare`) is `fusable` and scores with one
host→device transfer per call (`score_fused`). Plans where a host stage
reads a device output alternate segments through `__call__`.

The fitted tables of each device stage (`device_constants(device)`) are
built on the device once, when the scorer is built.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.columns import Column, to_host
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.features.dag import topological_layers
from transmogrifai_tpu_torch.stages.base import (
    HOST_KINDS, FeatureGeneratorStage, Transformer, is_host_stage,
    to_device)


def pad_dataset(dataset: Dataset, target_rows: int) -> Dataset:
    """Pad a Dataset to `target_rows` by repeating its last row, so pad
    rows take the same host-encode path as the valid rows."""
    n = len(dataset)
    if target_rows < n:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    if target_rows == n:
        return dataset
    if n == 0:
        raise ValueError("cannot pad an empty dataset (no row to repeat)")
    pad_idx = np.full(target_rows - n, n - 1, dtype=np.int64)
    return Dataset.concat([dataset, dataset.take(pad_idx)])


def slice_result_tree(value: Any, start: int, stop: int) -> Any:
    """Slice every batch-leading array leaf of a scoring result pytree to
    rows [start, stop)."""
    if isinstance(value, dict):
        return {k: slice_result_tree(v, start, stop)
                for k, v in value.items()}
    if getattr(value, "ndim", 0) >= 1:
        return value[start:stop]
    return value


def _column_from_device(ftype: type, dev) -> Column:
    """Wrap a device pytree back into a host Column (segment boundary)."""
    if isinstance(dev, dict) and "prediction" in dev:
        return Column(T.Prediction, {k: to_host(v) for k, v in dev.items()})
    if isinstance(dev, dict) and "value" in dev:
        return Column(ftype, {
            "value": to_host(dev["value"]).astype(np.float64),
            "mask": to_host(dev["mask"]) > 0.5})
    return Column(T.OPVector, to_host(dev))


class CompiledScorer:
    def __init__(self, model):
        self.model = model
        self.device = model.device
        layers = topological_layers(model.result_features)
        self.generators: List[FeatureGeneratorStage] = (
            list(layers[0]) if layers else [])
        ordered: List[Transformer] = []
        for layer in layers[1:]:
            for stage in layer:
                fitted = model.fitted.get(stage.uid)
                if fitted is None:
                    raise RuntimeError(f"Unfitted stage {stage.uid}")
                ordered.append(fitted)
        self._stage_out_uid = {s.uid: s.get_output().uid for s in ordered}
        # alternating host/device segments in topological order
        self.segments: List[Tuple[str, List[Transformer]]] = []
        for s in ordered:
            kind = "host" if is_host_stage(s) else "device"
            if not self.segments or self.segments[-1][0] != kind:
                self.segments.append((kind, []))
            self.segments[-1][1].append(s)
        # per segment, the outputs a later segment or a result reads
        result_uids = {f.uid for f in model.result_features}
        self._seg_out_uids: List[List[str]] = []
        for i, (kind, stages) in enumerate(self.segments):
            produced = {self._stage_out_uid[s.uid] for s in stages}
            needed = set(result_uids)
            for _, later in self.segments[i + 1:]:
                for s2 in later:
                    needed.update(f.uid for f in s2.input_features)
            self._seg_out_uids.append(sorted(produced & needed))
        self.device_stages: List[Transformer] = [
            s for kind, stages in self.segments if kind == "device"
            for s in stages]
        self._consts: Dict[str, Any] = {}
        for s in self.device_stages:
            c = s.device_constants(self.device)
            if c is not None:
                self._consts[s.uid] = c

    # ------------------------------------------------------------------ #

    def _run_segment(self, seg_idx: int, encs: Dict[str, Any],
                     dev_vals: Dict[str, Any]) -> Dict[str, Any]:
        """Run one device segment's stages on the device; returns the
        segment's needed outputs by feature uid."""
        vals = dict(dev_vals)
        for stage in self.segments[seg_idx][1]:
            dev_inputs = [vals.get(f.uid) for f in stage.input_features]
            consts = self._consts.get(stage.uid)
            if consts is not None:
                out = stage.device_apply_with(
                    consts, encs.get(stage.uid), dev_inputs)
            else:
                out = stage.device_apply(encs.get(stage.uid), dev_inputs)
            vals[self._stage_out_uid[stage.uid]] = out
        return {u: vals[u] for u in self._seg_out_uids[seg_idx]}

    def _fused_index(self) -> int:
        """Index of the single trailing device segment, or raise."""
        dev_segs = [i for i, (k, _) in enumerate(self.segments)
                    if k == "device"]
        if len(dev_segs) != 1 or dev_segs[0] != len(self.segments) - 1:
            raise RuntimeError(
                "pipeline does not plan to a single trailing device "
                "segment; use __call__")
        return dev_segs[0]

    @property
    def fusable(self) -> bool:
        """True when the plan is a host prefix plus ONE trailing device
        segment (`score_fused` then moves data to the device once)."""
        try:
            self._fused_index()
        except RuntimeError:
            return False
        return True

    def host_phase(self, dataset: Dataset):
        """Raw materialization + host-prefix stages + `host_prepare`,
        with the encodings and raw numeric columns placed on the device.
        Returns (encs, raw_dev, columns)."""
        columns: Dict[str, Column] = {}
        for gen in self.generators:
            columns[gen.get_output().uid] = gen.materialize(
                dataset, allow_missing_response=True)
        for kind, stages in self.segments[:-1]:  # host prefix
            if kind != "host":
                raise RuntimeError("host_phase requires a host-prefix plan")
            for stage in stages:
                inputs = [columns[f.uid] for f in stage.input_features]
                columns[self._stage_out_uid[stage.uid]] = stage.transform(
                    inputs, self.device)
        encs: Dict[str, Any] = {}
        for stage in self.device_stages:
            enc = stage.host_prepare(
                [columns.get(f.uid) for f in stage.input_features])
            if enc is not None:
                encs[stage.uid] = to_device(enc, self.device)
        raw_dev: Dict[str, Any] = {}
        for uid, c in columns.items():
            if c.kind not in HOST_KINDS:
                dv = c.device_value(self.device)
                if dv is not None:
                    raw_dev[uid] = dv
        return encs, raw_dev, columns

    # ------------------------------------------------------------------ #

    def run(self, dataset: Dataset):
        """Execute all segments; returns (dev_vals, columns)."""
        columns: Dict[str, Column] = {}
        dev_vals: Dict[str, Any] = {}
        for gen in self.generators:
            f = gen.get_output()
            c = gen.materialize(dataset, allow_missing_response=True)
            columns[f.uid] = c
            if c.kind not in HOST_KINDS:
                dev_vals[f.uid] = c.device_value(self.device)
        for seg_idx, (kind, stages) in enumerate(self.segments):
            if kind == "host":
                for stage in stages:
                    inputs = []
                    for f in stage.input_features:
                        c = columns.get(f.uid)
                        if c is None:  # device-produced → materialize once
                            c = _column_from_device(f.ftype, dev_vals[f.uid])
                            columns[f.uid] = c
                        inputs.append(c)
                    out_col = stage.transform(inputs, self.device)
                    uid = self._stage_out_uid[stage.uid]
                    columns[uid] = out_col
                    dv = out_col.device_value(self.device)
                    if dv is not None:
                        dev_vals[uid] = dv
            else:
                encs: Dict[str, Any] = {}
                for stage in stages:
                    enc = stage.host_prepare(
                        [columns.get(f.uid) for f in stage.input_features])
                    if enc is not None:
                        encs[stage.uid] = to_device(enc, self.device)
                dev_vals.update(self._run_segment(seg_idx, encs, dev_vals))
        return dev_vals, columns

    def __call__(self, dataset: Dataset) -> Dict[str, Any]:
        dev_vals, columns = self.run(dataset)
        result: Dict[str, Any] = {}
        for f in self.model.result_features:
            if f.uid in dev_vals:
                result[f.name] = dev_vals[f.uid]
            else:  # host-kind result feature
                result[f.name] = columns[f.uid].data
        return result

    def score_fused(self, dataset: Dataset) -> Dict[str, Any]:
        """Host phase, then the single trailing device segment; returns
        the result features. Raises RuntimeError on plans with more than
        one device segment (`__call__` is the general path)."""
        fi = self._fused_index()
        encs, raw_dev, columns = self.host_phase(dataset)
        out = self._run_segment(fi, encs, raw_dev)
        result: Dict[str, Any] = {}
        for f in self.model.result_features:
            if f.uid in out:
                result[f.name] = out[f.uid]
            else:
                dv = raw_dev.get(f.uid)
                result[f.name] = dv if dv is not None else \
                    columns[f.uid].data
        return result

    def score_padded(self, dataset: Dataset,
                     pad_to: int) -> Dict[str, Any]:
        """Score `dataset` padded up to `pad_to` rows (a bucket of the
        serving ladder) and return the valid rows only."""
        n_valid = len(dataset)
        padded = pad_dataset(dataset, pad_to)
        out = self.score_fused(padded) if self.fusable else self(padded)
        if pad_to == n_valid:
            return out
        return {name: slice_result_tree(v, 0, n_valid)
                for name, v in out.items()}
