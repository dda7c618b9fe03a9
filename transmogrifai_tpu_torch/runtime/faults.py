"""Deterministic, seedable fault injection for chaos testing.

The port's own copy of the JAX package's `runtime/faults.py`. The
reference inherits fault tolerance from Spark (lineage re-execution,
task retry); this package builds its own, and a fault-tolerance layer
that is never exercised is one that silently rots. This module is the
exercise machinery: production code paths declare *named injection
sites* (`fault_point("ingest.read_chunk")`) that are free when no plan
is installed, and a chaos test installs a `FaultPlan` that fires a
specific fault on the Nth pass through a site.

Everything is deterministic: faults fire on exact pass counts (no
wall-clock, no unseeded randomness — the same plan against the same
code produces the same failure, which is what makes kill/resume parity
assertable bit-for-bit). `prob < 1` sampling draws from a PRNG seeded
by the plan's `seed`, so even probabilistic plans replay exactly.

Sites threaded through the port (the serving and continual sites are
names only until those subsystems are ported, ROADMAP.md queue 1, item
10):

- ``ingest.read_chunk``    — data/pipeline.py, before each chunk prepare
- ``sweep.run_block``      — parallel/sweep.py, before each grid block
- ``serialize.write_file`` — workflow/serialization.py, before each
  artifact file write
- ``scheduler.worker_block`` — parallel/scheduler.py, as a mesh worker
  claims a grid block (worker-level preemption/failure injection)
- ``continual.holdout_eval`` — continual/loop.py, before the post-swap
  live holdout evaluation: an injected fault here is treated as a
  holdout regression (metric unknowable → the gate must assume the
  worst), so chaos tests can force the automatic serving rollback path
  deterministically
- ``serving.batch_assemble`` — serving/service.py, before the scoring
  thread concatenates a micro-batch (an `error` degrades the batch to
  per-request quarantine scoring)
- ``serving.device_dispatch`` — serving/service.py, before each
  PRIMARY-path compiled-scorer dispatch (`error` storms trip the
  member's circuit breaker, `kill` kills the scoring thread the way a
  fatal runtime error would — the watchdog's restart path — and
  `delay` wedges the loop past the watchdog's stall budget). Degraded
  FALLBACK dispatches skip the site: the fault models a broken active
  version, not a broken device, so the resident previous version keeps
  working
- ``serving.reload_load`` — serving/service.py, between a reload's
  integrity verification and the candidate model load (a fault here
  must leave the resident version serving)

In a fleet each member scopes its serving sites by name —
``serving.device_dispatch#<member>`` — so a chaos plan targets ONE
member's dispatches deterministically while its peers run clean; a
single-model service uses the bare site names.

Fault kinds:

- ``error``: raise `InjectedFault` (an Exception; `transient=True`
  marks it retryable for `runtime.retry.RetryPolicy` classification)
- ``oom``:   raise `InjectedFault` shaped like a device OOM
  (`is_oom_error` recognizes it alongside real RESOURCE_EXHAUSTED
  errors) — exercises graceful-degradation paths
- ``kill``:  raise `InjectedKill`, a **BaseException**: it sails
  through every ``except Exception`` fault-tolerance layer exactly
  like a preemption/SIGKILL would, killing the run at the site
- ``delay``: sleep `delay_s` then continue (latency injection)

Plans install process-globally (`install_plan` / the `plan.active()`
context manager): injection must reach worker threads and thread pools,
which a thread-local could not.
"""

from __future__ import annotations

import contextlib
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "FaultSpec", "FaultPlan", "InjectedFault", "InjectedKill",
    "fault_point", "install_plan", "clear_plan", "active_plan",
    "is_oom_error",
    "SITE_READ_CHUNK", "SITE_RUN_BLOCK", "SITE_WRITE_FILE",
    "SITE_WORKER_BLOCK", "SITE_HOLDOUT_EVAL",
    "SITE_BATCH_ASSEMBLE", "SITE_DEVICE_DISPATCH", "SITE_RELOAD_LOAD",
]

SITE_READ_CHUNK = "ingest.read_chunk"
SITE_RUN_BLOCK = "sweep.run_block"
SITE_WRITE_FILE = "serialize.write_file"
# parallel/scheduler.py: fires as a worker CLAIMS a block, before any
# execution — `error` retires the worker (its block is stolen), `kill`
# preempts the whole schedule (drain + re-raise; resume re-runs only the
# claiming worker's in-flight block)
SITE_WORKER_BLOCK = "scheduler.worker_block"
# continual/loop.py: fires before the post-swap live holdout eval — an
# injected `error` makes the gate treat the eval as a regression and
# auto-roll the serving swap back (deterministic rollback chaos testing)
SITE_HOLDOUT_EVAL = "continual.holdout_eval"
# serving/service.py (fleet members suffix `#<member>`): batch
# concatenation on the scoring thread, the primary-path device
# dispatch, and the post-integrity model load of a /reload — the
# serving resilience layer's three injectable failure modes
SITE_BATCH_ASSEMBLE = "serving.batch_assemble"
SITE_DEVICE_DISPATCH = "serving.device_dispatch"
SITE_RELOAD_LOAD = "serving.reload_load"


class InjectedFault(RuntimeError):
    """An injected error/oom fault. `transient` feeds RetryPolicy
    classification; `oom` makes `is_oom_error` recognize it."""

    def __init__(self, site: str, n: int, transient: bool = False,
                 oom: bool = False, message: str = ""):
        self.site = site
        self.n = n
        self.transient = transient
        self.oom = oom
        detail = message or ("RESOURCE_EXHAUSTED: injected device OOM"
                             if oom else "injected fault")
        super().__init__(f"{detail} at site {site!r} (pass {n})")


class InjectedKill(BaseException):
    """Simulated preemption: a BaseException, so every `except Exception`
    fault-tolerance layer lets it through — the run dies at the site the
    way a real SIGKILL/preemption would (modulo finally blocks)."""

    def __init__(self, site: str, n: int):
        self.site = site
        self.n = n
        super().__init__(f"injected kill at site {site!r} (pass {n})")


@dataclass
class FaultSpec:
    """Fire a fault at the `at`-th pass through `site` (1-based), for
    `times` consecutive passes (0 = every pass from `at` on)."""

    site: str
    at: int = 1
    kind: str = "error"     # error | oom | kill | delay
    times: int = 1
    transient: bool = False
    delay_s: float = 0.0
    prob: float = 1.0       # sampled from the plan's seeded PRNG
    message: str = ""

    def __post_init__(self):
        if self.kind not in ("error", "oom", "kill", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 1:
            raise ValueError("`at` is a 1-based pass count")

    def matches(self, n: int) -> bool:
        if n < self.at:
            return False
        return self.times == 0 or n < self.at + self.times


class FaultPlan:
    """A set of FaultSpecs plus per-site pass counters. Thread-safe: the
    sites live in worker threads and thread pools. `fired` records every
    fault actually raised/applied, for test assertions."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None,
                 seed: int = 0):
        self.specs = list(specs or [])
        self.seed = seed
        self._rng = random.Random(seed)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []  # (site, pass, kind)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        self.specs.append(spec)
        return self

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def check(self, site: str) -> None:
        """One pass through `site`: bump the counter, apply the first
        matching spec (delay sleeps, the rest raise)."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            hit = None
            for spec in self.specs:
                if spec.site == site and spec.matches(n) and \
                        (spec.prob >= 1.0
                         or self._rng.random() < spec.prob):
                    hit = spec
                    self.fired.append((site, n, spec.kind))
                    break
        if hit is None:
            return
        # the structured event log + current trace span both record the
        # injection the moment it fires — a kill never gets another chance
        from transmogrifai_tpu_torch.obs.export import record_event
        record_event("fault", site=site, n=n, fault_kind=hit.kind)
        if hit.kind == "delay":
            time.sleep(hit.delay_s)
            return
        if hit.kind == "kill":
            raise InjectedKill(site, n)
        raise InjectedFault(site, n, transient=hit.transient,
                            oom=hit.kind == "oom", message=hit.message)

    @contextlib.contextmanager
    def active(self):
        """Install this plan globally for the scope of the with-block."""
        install_plan(self)
        try:
            yield self
        finally:
            clear_plan(self)


# -- process-global registration -------------------------------------------- #

_PLAN_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None


def install_plan(plan: FaultPlan) -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan


def clear_plan(plan: Optional[FaultPlan] = None) -> None:
    """Remove the active plan (if `plan` is given, only when it is the
    one installed — a nested scope must not clear an outer plan)."""
    global _PLAN
    with _PLAN_LOCK:
        if plan is None or _PLAN is plan:
            _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def fault_point(site: str) -> None:
    """Named injection site. Near-free when no plan is installed (one
    global read); under an active plan, counts the pass and applies any
    matching fault."""
    plan = _PLAN
    if plan is not None:
        plan.check(site)


# -- classification helpers -------------------------------------------------- #

_OOM_RE = re.compile(r"RESOURCE_EXHAUSTED|out of memory|allocat\w+ .*memory"
                     r"|hbm.*exceed", re.IGNORECASE)


def is_oom_error(e: BaseException) -> bool:
    """Device OOM detection: injected faults carry an `oom` attr; a real
    one is `torch.cuda.OutOfMemoryError`, or recognized by its message
    (the CUDA caching allocator's "CUDA out of memory", a kernel's
    "out of memory" error code, RESOURCE_EXHAUSTED)."""
    if getattr(e, "oom", False):
        return True
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return bool(_OOM_RE.search(str(e)))
