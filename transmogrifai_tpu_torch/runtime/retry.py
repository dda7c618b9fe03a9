"""Shared bounded-retry policy: attempts, backoff + deterministic
jitter, transient-vs-fatal classification, per-attempt hooks.

The port's own copy of the JAX package's `runtime/retry.py`: the same
`random.Random` jitter sequence for the same seed and label, so the two
packages sleep the same delays.

The anti-patterns this replaces are ``except Exception: pass`` and
``while True`` retry loops (the JAX package's lint L008): both hide the
failure, neither bounds the work. A `RetryPolicy` is explicit about all
three decisions a retry makes —

- **how many** attempts (`max_attempts` total tries, not re-tries),
- **how long** between them (exponential backoff capped at
  `max_delay_s`, with jitter drawn from a PRNG seeded per call label —
  deterministic replay),
- **what** is worth retrying: an exception is transient iff the
  caller's `classify` says so, else the exception's own ``transient``
  attribute (set by `runtime.faults.InjectedFault` and by transport
  layers that know), else membership in `transient_types`. Fatal
  errors propagate on the FIRST attempt — a retry that re-runs a
  deterministic crash just triples the time to the same stack trace.

Exhaustion re-raises the LAST underlying exception (callers' existing
handling keeps working; the attempt history is visible through the
hooks and whatever stats object the caller records into).

Per-attempt hooks receive a `RetryEvent`; `metrics_hook(registry)`
adapts one onto an `obs.metrics.MetricsRegistry` counter and
`profile_hook(profile)` onto a `utils.profiling.RunProfile`, so retry
pressure is observable wherever the caller already reports.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

from transmogrifai_tpu_torch.obs import export as obs_export
from transmogrifai_tpu_torch.obs.trace import TRACER

__all__ = ["RetryEvent", "RetryPolicy", "metrics_hook", "profile_hook"]

log = logging.getLogger(__name__)


@dataclass
class RetryEvent:
    """One failed attempt that will be retried."""

    label: str
    attempt: int          # 1-based attempt number that failed
    delay_s: float        # backoff before the next attempt
    error: BaseException


@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter.

    `max_attempts` counts total tries; `max_attempts=1` disables
    retrying while keeping the classification/hook plumbing.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff: float = 2.0
    jitter: float = 0.25       # ± fraction of the backoff delay
    seed: int = 0
    transient_types: Tuple[type, ...] = (OSError, TimeoutError)
    classify: Optional[Callable[[BaseException], Optional[bool]]] = None
    hooks: Tuple[Callable[[RetryEvent], Any], ...] = ()
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    # -- classification -------------------------------------------------- #

    def is_transient(self, e: BaseException) -> bool:
        if self.classify is not None:
            verdict = self.classify(e)
            if verdict is not None:
                return bool(verdict)
        flagged = getattr(e, "transient", None)
        if flagged is not None:
            return bool(flagged)
        return isinstance(e, self.transient_types)

    # -- schedule --------------------------------------------------------- #

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Backoff before the attempt following failed attempt N."""
        d = min(self.base_delay_s * self.backoff ** (attempt - 1),
                self.max_delay_s)
        if self.jitter > 0.0:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)

    # -- execution --------------------------------------------------------- #

    def call(self, fn: Callable[..., Any], *args: Any,
             label: str = "retry",
             on_attempt: Optional[Callable[[RetryEvent], Any]] = None,
             **kwargs: Any) -> Any:
        """Run `fn(*args, **kwargs)` under the policy. Fatal errors and
        the final exhausted attempt re-raise the underlying exception."""
        # jitter PRNG seeded by (policy seed, label): deterministic per
        # call site, independent across sites
        rng = random.Random(f"{self.seed}:{label}")
        attempt = 0
        while True:
            attempt += 1
            t_attempt = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                wasted = time.perf_counter() - t_attempt
                if attempt >= self.max_attempts or not self.is_transient(e):
                    raise
                delay = self.delay_for(attempt, rng)
                event = RetryEvent(label, attempt, delay, e)
                for hook in self.hooks:
                    hook(event)
                if on_attempt is not None:
                    on_attempt(event)
                log.warning(
                    "%s: transient failure on attempt %d/%d (%s: %s) — "
                    "retrying in %.3fs", label, attempt, self.max_attempts,
                    type(e).__name__, e, delay)
                obs_export.record_event(
                    "retry", site=label, attempt=attempt,
                    delay_s=round(delay, 6),
                    error=f"{type(e).__name__}: {e}")
                # the failed attempt's wall time is REDONE work (the
                # next attempt repeats it): goodput's fault_redo bucket,
                # distinct from the backoff sleep measured by the span
                obs_export.record_event(
                    "fault_redo", site=label,
                    wasted_s=round(wasted, 6))
                # the backoff sleep is pure badput: give it a span so the
                # goodput rollup and the Perfetto timeline both see it,
                # nested under whatever opened this attempt (ingest
                # worker chunk, sweep family, serving handler)
                with TRACER.span(f"retry:{label}", category="retry",
                                 attempt=attempt,
                                 error=type(e).__name__):
                    self.sleep(delay)

    def wrap(self, fn: Callable[..., Any], label: str = "retry",
             on_attempt: Optional[Callable[[RetryEvent], Any]] = None
             ) -> Callable[..., Any]:
        """Partial-application form of `call` for pipeline stages."""
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(fn, *args, label=label,
                             on_attempt=on_attempt, **kwargs)
        return wrapped


# -- observability adapters -------------------------------------------------- #

def metrics_hook(registry) -> Callable[[RetryEvent], None]:
    """Per-attempt hook onto an `obs.metrics.MetricsRegistry`:
    increments `runtime_retry_attempts_total{site=label}` so retry
    pressure shows up beside the serving/ingest series."""
    def hook(event: RetryEvent) -> None:
        registry.counter(
            "runtime_retry_attempts_total",
            "transient failures retried by RetryPolicy",
            site=event.label).inc()
    return hook


def profile_hook(profile) -> Callable[[RetryEvent], None]:
    """Per-attempt hook onto a `utils.profiling.RunProfile`: each retry
    lands as a phase entry naming the site, attempt, and error, so
    resumed/degraded runs show their scars in the profile dump."""
    from transmogrifai_tpu_torch.utils.profiling import PhaseMetric

    def hook(event: RetryEvent) -> None:
        profile.phases.append(PhaseMetric(
            f"retry:{event.label}", event.delay_s,
            {"attempt": event.attempt,
             "error": f"{type(event.error).__name__}: {event.error}"}))
    return hook
