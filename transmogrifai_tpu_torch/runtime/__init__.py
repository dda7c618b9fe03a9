"""Runtime fault-tolerance layer: fault injection, bounded retry, and
sweep journaling (the port's copy of the JAX package's `runtime/`).

- `faults`  — deterministic fault-injection registry (`FaultPlan`) with
  named sites threaded through ingest, sweep, scheduler and
  serialization paths.
- `retry`   — shared `RetryPolicy` (bounded attempts, exponential
  backoff + seeded jitter, transient-vs-fatal classification,
  per-attempt metrics/profile hooks).
- `journal` — `SweepJournal`, the append-only block log that makes
  `ModelSelector` sweeps resumable at grid-block granularity.
- `integrity` — fsync and staged-directory commit helpers.
"""

from transmogrifai_tpu_torch.runtime.faults import (  # noqa: F401
    FaultPlan, FaultSpec, InjectedFault, InjectedKill, active_plan,
    clear_plan, fault_point, install_plan, is_oom_error)
from transmogrifai_tpu_torch.runtime.journal import SweepJournal  # noqa: F401
from transmogrifai_tpu_torch.runtime.retry import (  # noqa: F401
    RetryEvent, RetryPolicy, metrics_hook, profile_hook)
