"""Model saving and loading, in the JAX package's on-disk format.

A model directory holds `op-model.json` (the manifest: features, stages,
per-stage params), `arrays.npz` (params of >= 64 elements, referenced from
the manifest as ``{"__npz__": key}``) and `integrity.json` (sha256 and
size of each file, written last at save time). `load_model` verifies the
integrity manifest before it reads anything else, then rebuilds each stage
through `from_jax_params`, which maps a JAX package class name and its
params onto the port's class. A class the port has not ported raises and
names itself. `save_model` writes the same three files from the port's
fitted stages (each stage's `get_params()`), so the JAX package's
`load_model` reads what the port trained.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.features.feature import Feature
from transmogrifai_tpu_torch.stages.base import (
    FeatureGeneratorStage, Stage, StageRegistry, Transformer)

MANIFEST = "op-model.json"
ARRAYS = "arrays.npz"
INTEGRITY = "integrity.json"
VERSION = 1
INTEGRITY_VERSION = 1
NPZ_MIN_SIZE = 64  # numeric payloads at/above this many elements offload


class ModelIntegrityError(RuntimeError):
    """A model directory failed integrity verification (missing,
    truncated or altered file, or a save that never finished)."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(
            f"model artifact {path!r} failed integrity check: {reason}")


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def verify_model_dir(path: str) -> Dict[str, Any]:
    """Check every file `integrity.json` lists against its recorded size
    and sha256; returns the parsed integrity manifest. Raises
    `ModelIntegrityError` on any mismatch or missing file."""
    if not os.path.isdir(path):
        raise ModelIntegrityError(path, "not a directory")
    if not os.path.exists(os.path.join(path, MANIFEST)):
        raise ModelIntegrityError(path, f"missing {MANIFEST}")
    ipath = os.path.join(path, INTEGRITY)
    if not os.path.exists(ipath):
        raise ModelIntegrityError(
            path, f"missing {INTEGRITY} — the save died before the "
                  "integrity manifest landed, or this is a pre-integrity "
                  "save (load with verify=False)")
    try:
        with open(ipath) as fh:
            integrity = json.load(fh)
    except ValueError as e:
        raise ModelIntegrityError(path, f"unreadable {INTEGRITY}: {e}")
    files = integrity.get("files")
    if not isinstance(files, dict) or MANIFEST not in files:
        raise ModelIntegrityError(path, f"malformed {INTEGRITY}")
    for name, rec in files.items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise ModelIntegrityError(path, f"{name} is missing")
        size = os.path.getsize(fpath)
        if size != rec.get("bytes"):
            raise ModelIntegrityError(
                path, f"{name} truncated or resized: {size} bytes on "
                      f"disk, {rec.get('bytes')} recorded")
        if _sha256_file(fpath) != rec.get("sha256"):
            raise ModelIntegrityError(
                path, f"{name} checksum mismatch (torn write or bit "
                      "corruption)")
    return integrity


def _offload_arrays(value: Any, store: Dict[str, np.ndarray],
                    prefix: str) -> Any:
    """Large numeric arrays/lists inside stage params become
    `{"__npz__": key}` references into arrays.npz (the JAX package's
    rule and key names)."""
    if isinstance(value, dict):
        return {k: _offload_arrays(v, store, f"{prefix}.{k}")
                for k, v in value.items()}
    if isinstance(value, (np.ndarray, list)):
        try:
            arr = np.asarray(value)
        except Exception:
            arr = None
        if arr is not None and arr.dtype != object \
                and arr.dtype.kind in "biuf" and arr.size >= NPZ_MIN_SIZE:
            key = f"{prefix}#{len(store)}"
            store[key] = arr
            return {"__npz__": key}
        if isinstance(value, np.ndarray):
            return value.tolist()
        return [_offload_arrays(v, store, f"{prefix}[{i}]")
                for i, v in enumerate(value)]
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    return value


def _feature_entry(f: Feature) -> Dict[str, Any]:
    return {"uid": f.uid, "name": f.name, "ftype": f.ftype.__name__,
            "is_response": f.is_response,
            "origin_stage": f.origin_stage.uid if f.origin_stage else None,
            "parents": [p.uid for p in f.parents]}


def _fsync_file(path: str) -> None:
    with open(path, "rb") as fh:
        os.fsync(fh.fileno())


def save_model(model, path: str, overwrite: bool = True) -> None:
    """Write `model` (a `WorkflowModel`) to `path`: every file goes into a
    temporary sibling directory and is fsynced, the integrity manifest
    last, and the directory is then renamed into place (an existing model
    is renamed aside first and removed once the new one is live)."""
    path = os.path.normpath(path)
    if os.path.exists(os.path.join(path, MANIFEST)) and not overwrite:
        raise FileExistsError(os.path.join(path, MANIFEST))
    features: Dict[str, Feature] = {}
    order: List[str] = []
    for rf in model.result_features:
        for f in rf.traverse():
            if f.uid not in features:
                features[f.uid] = f
                order.append(f.uid)
    stage_entries = []
    seen = set()
    arrays: Dict[str, np.ndarray] = {}
    for f in features.values():
        stage = f.origin_stage
        if stage is None or stage.uid in seen:
            continue
        seen.add(stage.uid)
        fitted = model.fitted.get(stage.uid, stage)
        stage_entries.append({
            "uid": stage.uid,
            "class": type(fitted).__name__,
            "estimator_class": type(
                getattr(stage, "_estimator", stage)).__name__,
            "params": _offload_arrays(fitted.get_params(), arrays,
                                      stage.uid),
            "inputs": [p.uid for p in stage.input_features]})
    manifest = {
        "version": VERSION,
        "result_features": [f.uid for f in model.result_features],
        "features": [_feature_entry(features[uid]) for uid in order],
        "stages": stage_entries}
    # the fit-time quantization ranges, under the JAX package's key
    cal = getattr(model, "quant_calibration", None)
    if cal:
        manifest["quant_calibration"] = cal

    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        names = []
        if arrays:
            np.savez_compressed(os.path.join(tmp, ARRAYS), **arrays)
            _fsync_file(os.path.join(tmp, ARRAYS))
            names.append(ARRAYS)
        with open(os.path.join(tmp, MANIFEST), "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        names.append(MANIFEST)
        integrity = {
            "integrity_version": INTEGRITY_VERSION,
            "files": {name: {
                "sha256": _sha256_file(os.path.join(tmp, name)),
                "bytes": os.path.getsize(os.path.join(tmp, name)),
            } for name in names}}
        with open(os.path.join(tmp, INTEGRITY), "w") as fh:
            json.dump(integrity, fh)
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    aside = None
    if os.path.exists(path):
        aside = f"{path}.old-{os.getpid()}"
        os.rename(path, aside)
    os.rename(tmp, path)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)


def _restore_arrays(value: Any, npz) -> Any:
    if isinstance(value, dict):
        if set(value.keys()) == {"__npz__"}:
            if npz is None:
                raise ValueError(
                    "manifest references arrays.npz but the file is missing")
            return npz[value["__npz__"]]
        return {k: _restore_arrays(v, npz) for k, v in value.items()}
    if isinstance(value, list):
        return [_restore_arrays(v, npz) for v in value]
    return value


def _ensure_stage_library() -> None:
    """Import every ported stage module so the registry knows them."""
    import transmogrifai_tpu_torch.automl.sanity_checker  # noqa: F401
    import transmogrifai_tpu_torch.models.glm  # noqa: F401
    import transmogrifai_tpu_torch.models.linear  # noqa: F401
    import transmogrifai_tpu_torch.models.linear_svc  # noqa: F401
    import transmogrifai_tpu_torch.models.logistic  # noqa: F401
    import transmogrifai_tpu_torch.models.mlp  # noqa: F401
    import transmogrifai_tpu_torch.models.naive_bayes  # noqa: F401
    import transmogrifai_tpu_torch.models.trees  # noqa: F401
    import transmogrifai_tpu_torch.ops.bucketizers  # noqa: F401
    import transmogrifai_tpu_torch.ops.categorical  # noqa: F401
    import transmogrifai_tpu_torch.ops.combiner  # noqa: F401
    import transmogrifai_tpu_torch.ops.indexers  # noqa: F401
    import transmogrifai_tpu_torch.ops.mathops  # noqa: F401
    import transmogrifai_tpu_torch.ops.numeric  # noqa: F401
    import transmogrifai_tpu_torch.ops.rowops  # noqa: F401
    import transmogrifai_tpu_torch.ops.scalers  # noqa: F401
    import transmogrifai_tpu_torch.ops.text  # noqa: F401
    import transmogrifai_tpu_torch.selector.model_selector  # noqa: F401


def from_jax_params(class_name: str, params: Dict[str, Any],
                    uid: Optional[str] = None) -> Stage:
    """The port's stage for a JAX package stage class name and its params
    (numpy arrays and JSON values, as `get_params()` returns them there).
    Raises KeyError naming the class when the port has not ported it."""
    _ensure_stage_library()
    cls = StageRegistry.get(class_name)
    params = dict(params)
    if cls is FeatureGeneratorStage:
        params["ftype"] = T.feature_type_by_name(params.pop("ftype"))
    return cls(uid=uid, **params)


def load_model(path: str, device: DeviceLike = "cuda", verify: bool = True):
    """Load a model directory saved by the JAX package's `model.save` for
    scoring on `device` (default CUDA; raises without it unless
    ``device="cpu"``). `verify=True` checks the integrity manifest first."""
    from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

    dev = resolve_device(device)
    if verify:
        verify_model_dir(path)
    with open(os.path.join(path, MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest["version"] != VERSION:
        raise ValueError(f"Unsupported model version {manifest['version']}")

    npz_path = os.path.join(path, ARRAYS)
    npz = np.load(npz_path) if os.path.exists(npz_path) else None
    try:
        stages: Dict[str, Stage] = {
            spec["uid"]: from_jax_params(
                spec["class"], _restore_arrays(spec["params"], npz),
                uid=spec["uid"])
            for spec in manifest["stages"]}
    finally:
        if npz is not None:
            npz.close()

    features: Dict[str, Feature] = {}
    for fe in manifest["features"]:
        stage = stages.get(fe["origin_stage"])
        parents = tuple(features[p] for p in fe["parents"])
        if stage is not None and parents:
            stage.input_features = parents
        f = Feature(
            name=fe["name"], ftype=T.feature_type_by_name(fe["ftype"]),
            origin_stage=stage, parents=parents,
            is_response=fe["is_response"], uid=fe["uid"])
        if stage is not None:
            stage._output = f
        features[fe["uid"]] = f

    fitted = {uid: s for uid, s in stages.items()
              if isinstance(s, Transformer)}
    result = [features[uid] for uid in manifest["result_features"]]
    model = WorkflowModel(result_features=result, fitted=fitted, device=dev)
    model.loaded_from = path
    model.quant_calibration = manifest.get("quant_calibration")
    return model
