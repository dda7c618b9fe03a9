"""OpParams: the JSON-loadable run configuration.

The port's own copy of the JAX package's `workflow/params.py`
(OpParams.scala:81-97): stage overrides, reader params, model / write /
metrics / trace locations, custom tags and params, and the serving,
sweep-checkpoint, mesh, feature-cache, continual and cost-model blocks.
`OpParams.from_json` and `to_json` read and write the same JSON as the
JAX package. `Workflow.set_parameters` takes an OpParams or a dict;
`stage_params` overrides apply to the DAG's stages at train time
(`apply_stage_params`, matched by class name, operation name or uid) and
`feature_cache` installs the run's cache policy (`cache_scope`).

`mesh` builds the run's device mesh (`MeshParams.build`, the runner
passes it to `Workflow.train(mesh=)`, a data axis included) and
`sweep_checkpoint` makes every selector's sweep resumable. Parsed but
not run by the port yet, each refused where it would act: `serving` and
its `fleet` block (the `serve` run type, item 10), `continual` and
`perf_model` (item 10).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# the parameters the port parses but refuses at run time, and where
# ROADMAP.md queues them
CONTINUAL_REFUSAL = ("the continuous-training loop is not ported yet "
                     "(ROADMAP.md queue 1, item 10)")
PERF_MODEL_REFUSAL = ("the learned cost model is not ported yet "
                      "(ROADMAP.md queue 1, item 10)")

from transmogrifai_tpu_torch.continual.params import ContinualParams
from transmogrifai_tpu_torch.data.feature_cache import FeatureCacheParams
from transmogrifai_tpu_torch.perf.params import PerfModelParams


@dataclass
class ReaderParams:
    """Per-reader runtime params (ReaderParams analogue): data path +
    format + anything reader-specific."""

    path: Optional[str] = None
    format: str = "csv"          # csv | parquet | stream
    key_column: Optional[str] = None
    batch_size: int = 1024
    custom: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ReaderParams":
        known = {k: d[k] for k in ("path", "format", "key_column",
                                   "batch_size") if k in d}
        custom = {k: v for k, v in d.items()
                  if k not in ("path", "format", "key_column", "batch_size")}
        return ReaderParams(custom=custom, **known)

    def to_json(self) -> Dict[str, Any]:
        return {"path": self.path, "format": self.format,
                "key_column": self.key_column, "batch_size": self.batch_size,
                **self.custom}


@dataclass
class ServingParams:
    """Online-serving runtime params (the `serving/` subsystem's
    JSON-loadable config: the `serve` run type / CLI subcommand builds a
    `serving.ServingConfig` + HTTP frontend from this)."""

    host: str = "127.0.0.1"
    port: int = 8080               # 0 = OS-assigned free port
    max_batch: int = 64
    min_bucket: int = 1
    buckets: Optional[list] = None  # explicit ladder; overrides max_batch
    max_queue: int = 256
    batch_wait_ms: float = 2.0
    default_deadline_ms: float = 2000.0
    warm_on_load: bool = True
    keep_versions: int = 2
    # derive the bucket ladder from observed request sizes + the cost
    # model's predicted per-bucket latency (serving/batcher.derive_ladder)
    auto_ladder: bool = False
    # FeatureCacheParams JSON dict: installed as the serving process's
    # device-matrix cache policy (resident matrices survive hot-swaps)
    feature_cache: Optional[Dict[str, Any]] = None
    # the JAX package's persistent compilation cache at serving startup
    # (utils/compile_cache.py, 0s persistence threshold): a replica or
    # same-shaped swap warms on cache hits instead of recompiling the
    # bucket ladder; None = TRANSMOGRIFAI_SERVING_COMPILE_CACHE env
    # (cli `serve` defaults it on)
    compile_cache: Optional[bool] = None
    compile_cache_dir: Optional[str] = None
    # write/read the AOT warmup manifest beside each model artifact so
    # warm starts report `serving_compile_cache_saved_s`
    warmup_manifest: bool = True
    # FleetConfig JSON block (serving/fleet.py): when set, `cli serve`
    # boots a multi-model FleetService (named models, per-tenant
    # quotas/priorities, shared bucket programs) instead of the
    # single-model service
    fleet: Optional[Dict[str, Any]] = None
    # serving/resilience.ResilienceParams JSON: health state machine,
    # circuit breaker + degraded fallback, hang watchdog (None =
    # defaults, enabled; {"enabled": false} turns the layer off)
    resilience: Optional[Dict[str, Any]] = None
    # quantized inference mode ("int8"/"int4", or "int8-calibrated"/
    # "int4-calibrated" for fit-time fleet-wide ranges with bit-stable
    # repeat scores): request matrix on an affine narrow wire +
    # narrowed fitted-table dtypes inside the fused bucket programs
    # (workflow/compiled.ScoringQuant; None = exact f32 scoring)
    quantize: Optional[str] = None
    # request-scoped tracing + tail sampling (obs/trace.TracingParams
    # JSON; None = defaults, ON; {"enabled": false} disables)
    tracing: Optional[Dict[str, Any]] = None
    # SLO burn-rate engine (obs/slo.SLOParams JSON; None = off)
    slo: Optional[Dict[str, Any]] = None
    # crash flight recorder config ({"enabled", "dir", "capacity",
    # "min_interval_s"}; None = enabled with defaults)
    flight: Optional[Dict[str, Any]] = None
    # SLO-burn serving autopilot (serving/autopilot.AutopilotParams
    # JSON; fleet runs only — needs the fleet block + an slo block to
    # close the loop on; None = no controller)
    autopilot: Optional[Dict[str, Any]] = None

    _FIELDS = ("host", "port", "max_batch", "min_bucket", "buckets",
               "max_queue", "batch_wait_ms", "default_deadline_ms",
               "warm_on_load", "keep_versions", "auto_ladder",
               "feature_cache", "compile_cache", "compile_cache_dir",
               "warmup_manifest", "fleet", "resilience", "quantize",
               "tracing", "slo", "flight", "autopilot")

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ServingParams":
        return ServingParams(**{k: d[k] for k in ServingParams._FIELDS
                                if k in d})

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}

    def to_config(self):
        """The port's `serving.ServingConfig` view: the knobs its minimal
        service has (the rest belong to the HTTP front end and the
        serving layers of ROADMAP.md queue 1, item 10)."""
        from transmogrifai_tpu_torch.serving.service import ServingConfig
        return ServingConfig(max_batch=self.max_batch,
                             max_queue=self.max_queue,
                             batch_wait_ms=self.batch_wait_ms,
                             quantize=self.quantize)

    def to_fleet_config(self):
        raise NotImplementedError(
            "serving fleets are not ported yet (ROADMAP.md queue 1, "
            "item 10)")


@dataclass
class MeshParams:
    """Device-mesh configuration for distributed runs: the JSON-loadable
    form the runner builds a `parallel.mesh.Mesh` from. A >1-wide sweep
    axis makes every `ModelSelector` in the run schedule its grid blocks
    across the mesh through the work-stealing scheduler
    (`parallel/scheduler.py`). `n_slices` lays the mesh out in
    contiguous slices (`make_multislice_mesh`, slice boundaries on the
    sweep axis). Devices left on the data axis (n_devices / sweep, or
    `data_per_slice`) split each worker's rows: its fits run on row
    shards (`parallel/rowshards.py`)."""

    n_devices: Optional[int] = None   # default: every visible device
    sweep: Optional[int] = None       # sweep-axis width (default: all)
    n_slices: Optional[int] = None    # multislice layout when set
    data_per_slice: Optional[int] = None

    _FIELDS = ("n_devices", "sweep", "n_slices", "data_per_slice")

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "MeshParams":
        return MeshParams(**{k: d[k] for k in MeshParams._FIELDS if k in d})

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}

    def build(self, device="cuda"):
        """The configured mesh over `device`'s kind (validates
        divisibility — a config asking for devices it cannot use must
        fail loudly, not silently train on a subset)."""
        from transmogrifai_tpu_torch.parallel.mesh import (
            make_mesh, make_multislice_mesh)
        if self.n_slices:
            if self.sweep is not None:
                raise ValueError(
                    "mesh params: `sweep` cannot be combined with "
                    "`n_slices`; control the lane count via "
                    "`data_per_slice` (sweep = n_slices × "
                    "devices_per_slice / data_per_slice)")
            per = None
            if self.n_devices is not None:
                if self.n_devices % self.n_slices != 0:
                    raise ValueError(
                        f"mesh params: n_devices={self.n_devices} does "
                        f"not divide into n_slices={self.n_slices}")
                per = self.n_devices // self.n_slices
            return make_multislice_mesh(
                self.n_slices, devices_per_slice=per,
                data_per_slice=self.data_per_slice, device=device)
        if self.data_per_slice is not None:
            raise ValueError(
                "mesh params: `data_per_slice` requires `n_slices`; on a "
                "flat mesh set `sweep` (data width = n_devices / sweep)")
        return make_mesh(self.n_devices, sweep=self.sweep, device=device)


@dataclass
class SweepCheckpointParams:
    """Resumable-sweep configuration: where `ModelSelector` persists its
    per-family checkpoints and per-block `SweepJournal` files
    (runtime/journal.py). With `checkpoint_dir` set, `Workflow.train()`
    threads it onto every selector in the DAG that has none of its own,
    so a preempted training run re-invoked with the same params resumes
    at the first un-journaled grid block."""

    checkpoint_dir: Optional[str] = None
    fsync: bool = True        # journal durability (relax for throwaway runs)

    _FIELDS = ("checkpoint_dir", "fsync")

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "SweepCheckpointParams":
        return SweepCheckpointParams(
            **{k: d[k] for k in SweepCheckpointParams._FIELDS if k in d})

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}


@dataclass
class OpParams:
    """Runtime workflow configuration (OpParams.scala:81-97)."""

    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    reader_params: Dict[str, ReaderParams] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    metrics_location: Optional[str] = None
    # Perfetto/Chrome-trace output path for the run's span timeline
    # (the CLI's --trace-out); a sibling .events.jsonl gets the
    # structured event log with the run correlation id
    trace_location: Optional[str] = None
    batch_duration_secs: Optional[int] = None
    custom_tag_name: Optional[str] = None
    custom_tag_value: Optional[str] = None
    log_stage_metrics: bool = False
    collect_stage_metrics: bool = True
    custom_params: Dict[str, Any] = field(default_factory=dict)
    serving: Optional[ServingParams] = None
    sweep_checkpoint: Optional[SweepCheckpointParams] = None
    # device-mesh config: train runs build the mesh and pass it to
    # Workflow.train(mesh=...), turning the selector sweep into a
    # distributed schedule (parallel/scheduler.py)
    mesh: Optional[MeshParams] = None
    # persistent device-matrix cache (data/feature_cache.py):
    # `Workflow.train()` installs this as the process default for the
    # run's extent, so every big-data matrix build under the train
    # resolves the run's cache policy
    feature_cache: Optional[FeatureCacheParams] = None
    # continuous-training loop thresholds (continual/params.py): drift
    # triggers, warm-refit budget, promotion gate, rollback policy
    continual: Optional[ContinualParams] = None
    # learned cost model (perf/): corpus/model locations and the knobs
    # it drives (scheduler block sizing, HBM gate); installed for the
    # train's extent by `Workflow.train()` like the feature cache
    perf_model: Optional[PerfModelParams] = None

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpParams":
        readers = {k: ReaderParams.from_json(v)
                   for k, v in (d.get("reader_params") or {}).items()}
        serving = (ServingParams.from_json(d["serving"])
                   if d.get("serving") else None)
        sweep_ckpt = (SweepCheckpointParams.from_json(d["sweep_checkpoint"])
                      if d.get("sweep_checkpoint") else None)
        feature_cache = (FeatureCacheParams.from_json(d["feature_cache"])
                         if d.get("feature_cache") else None)
        mesh = MeshParams.from_json(d["mesh"]) if d.get("mesh") else None
        continual = (ContinualParams.from_json(d["continual"])
                     if d.get("continual") else None)
        perf_model = (PerfModelParams.from_json(d["perf_model"])
                      if d.get("perf_model") else None)
        return OpParams(
            stage_params=dict(d.get("stage_params") or {}),
            reader_params=readers,
            model_location=d.get("model_location"),
            write_location=d.get("write_location"),
            metrics_location=d.get("metrics_location"),
            trace_location=d.get("trace_location"),
            batch_duration_secs=d.get("batch_duration_secs"),
            custom_tag_name=d.get("custom_tag_name"),
            custom_tag_value=d.get("custom_tag_value"),
            log_stage_metrics=bool(d.get("log_stage_metrics", False)),
            collect_stage_metrics=bool(d.get("collect_stage_metrics", True)),
            custom_params=dict(d.get("custom_params") or {}),
            serving=serving,
            sweep_checkpoint=sweep_ckpt,
            mesh=mesh,
            feature_cache=feature_cache,
            continual=continual,
            perf_model=perf_model)

    @staticmethod
    def load(path: str) -> "OpParams":
        with open(path) as f:
            return OpParams.from_json(json.load(f))

    def to_json(self) -> Dict[str, Any]:
        return {
            "stage_params": self.stage_params,
            "reader_params": {k: v.to_json()
                              for k, v in self.reader_params.items()},
            "model_location": self.model_location,
            "write_location": self.write_location,
            "metrics_location": self.metrics_location,
            "trace_location": self.trace_location,
            "batch_duration_secs": self.batch_duration_secs,
            "custom_tag_name": self.custom_tag_name,
            "custom_tag_value": self.custom_tag_value,
            "log_stage_metrics": self.log_stage_metrics,
            "collect_stage_metrics": self.collect_stage_metrics,
            "custom_params": self.custom_params,
            "serving": self.serving.to_json() if self.serving else None,
            "sweep_checkpoint": (self.sweep_checkpoint.to_json()
                                 if self.sweep_checkpoint else None),
            "mesh": self.mesh.to_json() if self.mesh else None,
            "feature_cache": (self.feature_cache.to_json()
                              if self.feature_cache else None),
            "continual": (self.continual.to_json()
                          if self.continual else None),
            "perf_model": (self.perf_model.to_json()
                           if self.perf_model else None),
        }


def apply_stage_params(stages, stage_params: Dict[str, Dict[str, Any]],
                       log=None) -> int:
    """Set per-stage param overrides, matched by stage class name, operation
    name, or uid (OpWorkflow.setParameters → ReflectionUtils setter path).
    Returns the number of stages touched."""
    touched = 0
    for stage in stages:
        for key in (type(stage).__name__, stage.operation_name, stage.uid):
            overrides = stage_params.get(key)
            if overrides:
                # REBIND params (defense in depth): clones now own their
                # params dict (dag._clone_stage), but rebinding instead of
                # mutating also keeps overrides out of any dict a caller
                # obtained via get_params()/aliasing before this ran
                stage.params = {**stage.params, **overrides}
                for name, value in overrides.items():
                    if hasattr(stage, name):
                        setattr(stage, name, value)
                touched += 1
                if log is not None:
                    log.info("Applied %s overrides to %s", key, stage.uid)
                break
    return touched
