"""Distributed sweep execution: a work-stealing grid scheduler over a mesh.

The port's counterpart of the JAX package's `parallel/scheduler.py`.
The reference distributes exactly this workload — model×grid×fold fits
fanned out as Futures over a Spark executor pool
(`OpValidator.scala:299-358`). This module is that story on a
`parallel.mesh.Mesh` of torch devices: the grid-config blocks the family
handlers in `parallel/sweep.py` run as single batched fits become the
scheduler's work units, partitioned across the mesh's SWEEP axis, one
worker lane (a thread) per sweep row.

Design:

- **block = compiled group.** `sweep.static_signature(est, grid)` cuts
  each family's grids along the exact boundaries the handlers group
  them, so a scheduled block regroups into ONE batched fit on its
  worker — distribution never splits a static group.
- **work stealing.** Blocks are dealt round-robin into per-worker
  deques (longest-first, LPT-style packing); a worker that drains its
  own deque steals from the back of the longest other deque (recorded
  as a ``steal`` event on its lane). A worker that dies of a
  worker-level fault retires and its in-flight block is requeued for
  the survivors — a preempted worker costs only its in-flight block.
- **the journal is the shared completion log.** Each worker appends
  completed blocks to its own `ShardedSweepJournal` shard
  (``journal-w<k>.jsonl`` — no shared fd, so concurrent appends cannot
  interleave), and lookups merge every shard: resume skips the union
  of all workers' completed blocks and reproduces the bit-identical
  winner, the single-device invariant now under concurrency.
- **preemption (InjectedKill / BaseException) drains.** A kill observed
  by one worker cancels undispatched work, lets the other lanes finish
  (and journal) their in-flight blocks, then re-raises — a resumed
  schedule re-runs only the killed worker's in-flight block plus any
  blocks never dispatched before the kill (with blocks ≤ lanes, exactly
  the one in-flight block); completed blocks never re-run.
- **per-worker lanes in the trace.** Every worker opens a
  ``sweep:worker:<k>`` span under the scheduling root; steal/idle
  events land on the lane, and the end-of-run ``mesh_utilization``
  event (Σbusy / workers·wall, straggler flag) feeds the
  `GoodputReport` mesh rollup (obs/goodput.py).

Device placement: worker k owns sweep-row k of the (sweep, data) mesh.
Its thread pins X and y to the row's first device once and runs each
block as the single-device sweep inside the device's context, on a stream
of its own (bit-identical metrics: every family's batched fit gives a
config the same bits whatever configs share its launch). A row of more
than one device is the worker's (1, data) sub-mesh, its fit context's
mesh (`sweep.Lanes`, as the JAX package's `_build_submesh`): the worker
leaves the placement to the sweep, which splits X over the row's devices
once and runs every block's fits on those row shards. The learned cost
model's plan (predicted block seconds, block splitting, true LPT) comes
with `perf/` (ROADMAP.md queue 1, item 10); the plan is the count
heuristic.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from transmogrifai_tpu_torch.device import DeviceLike, resolve_device
from transmogrifai_tpu_torch.obs import export as obs_export
from transmogrifai_tpu_torch.obs.trace import TRACER
from transmogrifai_tpu_torch.parallel.sweep import (
    Lanes, journal_prefill, run_sweep, static_signature)
from transmogrifai_tpu_torch.runtime.faults import (
    SITE_WORKER_BLOCK, fault_point)

__all__ = ["SweepJob", "GridScheduler", "HostScheduler", "SchedulerReport",
           "WorkerStats"]

log = logging.getLogger(__name__)


@dataclass
class SweepJob:
    """One model family's sweep, as submitted to the scheduler."""

    index: int                 # caller's job id (the selector's model index)
    est: Any                   # the family estimator prototype
    grids: List[Dict]
    journal: Any = None        # ShardedSweepJournal (or None)
    name: str = ""
    # optional run_sweep-signature callable wrapping the block execution
    # (the selector passes run_sweep behind its transient-RPC
    # RetryPolicy, so distribution keeps the single-device path's
    # fault tolerance); None = plain run_sweep
    run: Any = None


@dataclass
class _Block:
    job: int                   # index into the jobs sequence
    key: Tuple                 # static_signature group key
    idxs: List[int]            # grid indices within the job
    home: int = 0              # worker the block was dealt to


@dataclass
class WorkerStats:
    worker: int
    blocks: int = 0
    steals: int = 0
    busy_s: float = 0.0
    idle_s: float = 0.0
    retired: Optional[str] = None   # worker-level failure, if any


@dataclass
class SchedulerReport:
    """What the schedule did with the mesh: the measured counterpart of
    the pod-extrapolation's perfect-packing assumption."""

    n_workers: int = 0
    wall_s: float = 0.0
    blocks: int = 0
    steals: int = 0
    requeues: int = 0
    utilization_frac: float = 0.0
    straggler: Optional[int] = None
    workers: List[WorkerStats] = field(default_factory=list)
    # pod tier (HostScheduler runs only): host id + lease-table traffic
    pod: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        out = {
            "n_workers": self.n_workers,
            "wall_s": round(self.wall_s, 6),
            "blocks": self.blocks,
            "steals": self.steals,
            "requeues": self.requeues,
            "utilization_frac": round(self.utilization_frac, 4),
            "straggler": self.straggler,
            "workers": [{
                "worker": w.worker, "blocks": w.blocks, "steals": w.steals,
                "busy_s": round(w.busy_s, 6), "idle_s": round(w.idle_s, 6),
                "retired": w.retired} for w in self.workers],
        }
        if self.pod is not None:
            out["pod"] = dict(self.pod)
        return out


class GridScheduler:
    """Schedule grid blocks across the sweep axis of a device mesh.

    A worker-level **Exception** at the claim site
    (`scheduler.worker_block`) retires the worker and requeues its block
    for the survivors to steal. A **BaseException** (InjectedKill,
    KeyboardInterrupt — preemption semantics) takes the whole schedule
    down via the drain path.
    """

    def __init__(self, mesh=None, n_workers: Optional[int] = None,
                 pod=None, device: DeviceLike = "cuda"):
        self.mesh = mesh
        # pod tier: a parallel.pod.PodCoordinator makes this one HOST's
        # scheduler in a multi-host sweep — workers CAS-acquire each
        # block fleet-wide before running it (see HostScheduler)
        self.pod = pod
        # one lane per sweep row (its devices: a (1, data) sub-mesh when
        # there are several); without a mesh, one lane on `device`
        self._rows: List[List[torch.device]] = (
            mesh.rows() if mesh is not None
            else [[resolve_device(device)]])
        if n_workers is not None:
            if n_workers < 1:
                raise ValueError("n_workers must be >= 1")
            # fewer lanes than sweep rows: use the first n rows
            self._rows = self._rows[:n_workers]
        self._lanes: List[torch.device] = [r[0] for r in self._rows]
        self.n_workers = len(self._rows)
        self.report = SchedulerReport(n_workers=self.n_workers)
        # shared queue state
        self._cond = threading.Condition()
        self._queues: List[deque] = []
        self._inflight = 0
        self._abort_exc: Optional[BaseException] = None
        self._job_errors: Dict[int, Exception] = {}
        # pod-mode plan identity: _Block id -> fleet block key, and back
        self._block_keys: Dict[int, str] = {}
        self._blocks_by_key: Dict[str, "_Block"] = {}
        self._pod_finished = False  # guarded-by: self._cond

    # -- scheduling -------------------------------------------------------- #

    def run(self, jobs: Sequence[SweepJob], X, y, folds, evaluator,
            ctx) -> List[Any]:
        """Execute every job's sweep across the mesh. Returns one outcome
        per job: the [grid][fold] metric matrix, or the Exception that
        failed the family (the caller applies its family-drop policy).
        A BaseException (preemption) drains in-flight blocks on the
        surviving lanes, then re-raises."""
        results: List[List[Optional[List[float]]]] = [
            [None] * len(j.grids) for j in jobs]
        self._job_errors = {}

        # resume: the merged journal shards are the shared completion
        # log — blocks any worker completed in a previous (or killed)
        # schedule never re-run (shared resume-skip implementation with
        # the in-family path)
        for ji, job in enumerate(jobs):
            journal_prefill(job.journal, job.grids, results[ji])

        blocks: List[_Block] = []
        for ji, job in enumerate(jobs):
            groups: Dict[Tuple, List[int]] = {}
            for i, g in enumerate(job.grids):
                if results[ji][i] is None:
                    groups.setdefault(
                        static_signature(job.est, g), []).append(i)
            blocks += [_Block(ji, key, idxs) for key, idxs in groups.items()]
        blocks = self._plan(blocks)

        # count-LPT (longest first) + round-robin deal
        self._queues = [deque() for _ in range(self.n_workers)]
        for bi, blk in enumerate(blocks):
            blk.home = bi % self.n_workers
            self._queues[blk.home].append(blk)
        self._inflight = 0
        self._abort_exc = None
        self._pod_finished = False  # guarded-by: self._cond (pre-start reset)
        self.report = SchedulerReport(
            n_workers=self.n_workers, blocks=len(blocks),
            workers=[WorkerStats(worker=k) for k in range(self.n_workers)])

        self._block_keys, self._blocks_by_key = {}, {}
        if self.pod is not None:
            from transmogrifai_tpu_torch.parallel.pod import block_key
            for ji, job in enumerate(jobs):
                if job.journal is None:
                    raise ValueError(
                        "pod scheduling requires a journal per job: the "
                        "shards are the cross-host completion log")
            for blk in blocks:
                bkey = block_key(blk.job, blk.key, blk.idxs)
                self._block_keys[id(blk)] = bkey
                self._blocks_by_key[bkey] = blk
            # every host registers the same deterministic plan; first
            # writer wins per key, so the table converges to the union
            self.pod.register(sorted(self._blocks_by_key))
            self.pod.start()

        t0 = time.perf_counter()
        try:
            with TRACER.span("sweep:scheduler", category="scheduler",
                             workers=self.n_workers, blocks=len(blocks),
                             jobs=len(jobs)) as root:
                # one lane context, placement and stream per worker: X
                # and y are pinned to a lane's device once per run
                lanes = Lanes(ctx, self._rows)
                threads = [
                    threading.Thread(
                        target=self._worker_loop,
                        args=(k, root, jobs, results, lanes,
                              X, y, folds, evaluator),
                        name=f"sweep-worker-{k}", daemon=True)
                    for k in range(self.n_workers)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                self.report.wall_s = time.perf_counter() - t0
                self._rollup(root)
        finally:
            if self.pod is not None:
                self.pod.stop()
        if self._abort_exc is not None:
            raise self._abort_exc
        leftover = sum(len(q) for q in self._queues)
        if leftover:
            raise RuntimeError(
                f"all {self.n_workers} sweep workers retired with "
                f"{leftover} grid blocks unfinished")
        if self.pod is not None:
            self._pod_fill(jobs, results)
        return [self._job_errors.get(ji, results[ji])
                for ji in range(len(jobs))]

    def _pod_fill(self, jobs: Sequence[SweepJob], results) -> None:
        """Fill the rows OTHER hosts computed: re-merge their journal
        shards from the shared store (the cross-host completion log —
        `complete()` is ordered after the records are durable, so a
        done block's rows are readable by now) and prefill exactly like
        a resume; the JSON float round trip keeps the winner
        bit-identical to a single-host run. A family that failed
        fleet-wide surfaces as that job's error, mirroring the local
        family-drop policy."""
        for ji, job in enumerate(jobs):
            if hasattr(job.journal, "refresh"):
                job.journal.refresh()
            # "pod_merge", not "journal_resume": these blocks were run
            # by OTHER hosts this run — fleet work, not resume savings
            journal_prefill(job.journal, job.grids, results[ji],
                            event="pod_merge")
        snap = self.pod.snapshot()
        for ji in range(len(jobs)):
            if ji in self._job_errors:
                continue
            missing = [i for i, row in enumerate(results[ji])
                       if row is None]
            if not missing:
                continue
            failed = [b for key, b in snap.items()
                      if b.get("state") == "failed"
                      and key in self._blocks_by_key
                      and self._blocks_by_key[key].job == ji]
            if failed:
                self._job_errors[ji] = RuntimeError(
                    f"sweep family failed fleet-wide on host "
                    f"{failed[0].get('owner')}: {failed[0].get('error')}")
            else:
                raise RuntimeError(
                    f"pod sweep: job {ji} still missing {len(missing)} "
                    "grid rows after the fleet drained (done block "
                    "without journal records?)")

    @staticmethod
    def _plan(blocks: List[_Block]) -> List[_Block]:
        """Order the grid blocks: by config count, longest first, with a
        deterministic tie-break (the JAX package's cold-model plan; its
        warm plan of predicted seconds needs `perf/`, ROADMAP.md queue 1,
        item 10)."""
        blocks.sort(key=lambda b: (-len(b.idxs), b.job, repr(b.key)))
        return blocks

    # -- queue protocol ----------------------------------------------------- #

    def _claim(self, k: int) -> Optional[Tuple[_Block, bool]]:
        """Own deque first; otherwise steal from the BACK of the longest
        other deque. Returns None when every deque is empty and nothing
        is in flight (or the schedule is aborting); blocks while other
        lanes still run — a dying lane may requeue its block for us."""
        with self._cond:
            while True:
                if self._abort_exc is not None:
                    return None
                if self._queues[k]:
                    self._inflight += 1
                    return self._queues[k].popleft(), False
                donors = [(len(q), j) for j, q in enumerate(self._queues)
                          if j != k and q]
                if donors:
                    donors.sort(key=lambda p: (-p[0], p[1]))
                    self._inflight += 1
                    return self._queues[donors[0][1]].pop(), True
                if self._inflight == 0:
                    return None
                self._cond.wait(timeout=0.1)

    def _complete(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def _requeue(self, blk: _Block) -> None:
        with self._cond:
            self._queues[blk.home].append(blk)
            self._inflight -= 1
            self.report.requeues += 1
            self._cond.notify_all()

    def _abort(self, exc: BaseException) -> None:
        """Preemption: cancel undispatched work so the surviving lanes
        drain only their IN-FLIGHT blocks (journaling them), then the
        schedule re-raises. What was cancelled or in flight on the dead
        lane re-runs on resume via the journal."""
        with self._cond:
            if self._abort_exc is None:
                self._abort_exc = exc
            for q in self._queues:
                q.clear()
            self._inflight -= 1
            self._cond.notify_all()

    def _fail_job(self, ji: int, exc: Exception) -> None:
        with self._cond:
            self._job_errors.setdefault(ji, exc)
            for q in self._queues:  # cancel the family's remaining blocks
                for blk in [b for b in q if b.job == ji]:
                    q.remove(blk)
            self._cond.notify_all()

    # -- worker ------------------------------------------------------------- #

    def _claims(self, k: int, stats: WorkerStats, lane):
        """Yield (block, stolen) claims for lane k until the schedule
        drains, charging wait time to the lane's idle account. In pod
        mode a locally drained lane keeps polling the fleet lease table
        (cross-host stealing) until every block is done fleet-wide."""
        while True:
            t_wait = time.perf_counter()
            claim = self._claim(k)
            if claim is None and self.pod is not None \
                    and not self._pod_over():
                claim = self._pod_takeover(k)
            waited = time.perf_counter() - t_wait
            if waited > 0.002:
                stats.idle_s += waited
                lane.event("idle", waited_s=round(waited, 6))
            if claim is None:
                if self.pod is not None and not self._pod_over():
                    continue  # fleet still has live blocks: poll again
                return
            yield claim

    def _pod_over(self) -> bool:
        with self._cond:
            return self._pod_finished or self._abort_exc is not None

    def _pod_takeover(self, k: int):
        """One fleet poll round for a locally drained lane: claim a
        pool or TTL-expired block (cross-host steal), flag the schedule
        finished when every block is done fleet-wide, or sleep until
        the earliest foreign lease can expire. Returns a (block,
        stolen) claim or None (caller re-polls)."""
        remaining, next_expiry = self.pod.pending()
        if remaining == 0:
            with self._cond:
                self._pod_finished = True
                self._cond.notify_all()
            return None
        key = self.pod.claim_any()
        if key is not None:
            blk = self._blocks_by_key.get(key)
            if blk is None:
                # a key from a DIVERGENT foreign plan (other jobs): not
                # ours to run — hand it back to its planner's host
                self.pod.foreign += 1
                self.pod.release(key)
            else:
                with self._cond:
                    if self._abort_exc is None:
                        self._inflight += 1
                        return blk, True
                self.pod.release(key)
                return None
        # everything left is live-leased elsewhere (or foreign): sleep
        # until the earliest lease could expire, woken early by a local
        # requeue/abort notify — TTL-derived, never a blind poll
        delay = 0.05 if next_expiry == float("inf") \
            else min(max(next_expiry, 0.05), self.pod.ttl_s)
        with self._cond:
            if self._abort_exc is None and not self._queues[k]:
                self._cond.wait(timeout=delay)
        return None

    def _worker_loop(self, k: int, root, jobs, results, lanes,
                     X, y, folds, evaluator) -> None:
        stats = self.report.workers[k]
        with TRACER.span(f"sweep:worker:{k}", category="sweep_worker",
                         parent=root, worker=k,
                         device=str(self._lanes[k])) as lane:
            for blk, stolen in self._claims(k, stats, lane):
                job = jobs[blk.job]
                bkey = self._block_keys.get(id(blk)) \
                    if self.pod is not None else None
                if bkey is not None:
                    with self._cond:
                        job_failed = blk.job in self._job_errors
                    if job_failed:
                        # our host already failed this family: propagate
                        # instead of letting the block ping-pong
                        self.pod.fail(bkey, "family failed on this host")
                        self._complete()
                        continue
                    if not self.pod.try_acquire(bkey):
                        # another host owns or finished it: drop the
                        # block locally — its rows arrive at _pod_fill
                        # via the merged journal shards
                        self._complete()
                        continue
                if stolen:
                    stats.steals += 1
                    with self._cond:  # += from N lanes loses increments
                        self.report.steals += 1
                    obs_export.record_event(
                        "steal", worker=k, from_worker=blk.home,
                        job=job.name or type(job.est).__name__,
                        configs=len(blk.idxs))
                try:
                    fault_point(SITE_WORKER_BLOCK)
                except Exception as e:
                    # worker-level failure (the executor died, not the
                    # family): retire this lane, hand the block to the
                    # survivors — the preemption costs one in-flight block
                    stats.retired = f"{type(e).__name__}: {e}"
                    obs_export.record_event(
                        "worker_retired", worker=k, configs=len(blk.idxs))
                    log.warning("sweep worker %d retired (%s); block "
                                "requeued for stealing", k, e)
                    self._requeue(blk)
                    return
                except BaseException as e:
                    stats.retired = f"{type(e).__name__}: {e}"
                    obs_export.record_event("worker_killed", worker=k,
                                            configs=len(blk.idxs))
                    self._abort(e)
                    return
                t0 = time.perf_counter()
                try:
                    rows = self._run_claimed_block(k, job, blk, lanes, X, y,
                                                   folds, evaluator)
                except Exception as e:
                    log.error("sweep worker %d: family %s block failed",
                              k, job.name or type(job.est).__name__,
                              exc_info=True)
                    self._fail_job(blk.job, e)
                    if bkey is not None:
                        self.pod.fail(bkey, f"{type(e).__name__}: {e}")
                    self._complete()
                    continue
                except BaseException as e:
                    stats.retired = f"{type(e).__name__}: {e}"
                    obs_export.record_event("worker_killed", worker=k,
                                            configs=len(blk.idxs))
                    self._abort(e)
                    return
                with self._cond:
                    for i, row in zip(blk.idxs, rows):
                        results[blk.job][i] = row
                block_s = time.perf_counter() - t0
                if bkey is not None:
                    # ordered AFTER the block ran: the journal records are
                    # durable, so done-in-the-lease-table implies
                    # readable-by-any-host
                    self.pod.complete(bkey)
                stats.busy_s += block_s
                stats.blocks += 1
                self._complete()

    def _run_claimed_block(self, k: int, job: SweepJob, blk: _Block,
                           lanes: Lanes, X, y, folds, evaluator):
        """Run a claimed block as the single-device sweep on lane k,
        appending to the lane's journal shard."""
        grids = [job.grids[i] for i in blk.idxs]
        journal = None
        if job.journal is not None:
            # pod mode: host-qualified shard ids so two hosts' lane-k
            # workers never share a shard file on the shared store
            tag = k if self.pod is None else f"{self.pod.host}_{k}"
            journal = job.journal.shard(tag)
        fn = job.run or run_sweep
        return lanes.run(
            k, lambda lctx, Xk, yk: fn(job.est, grids, Xk, yk, folds,
                                       evaluator, lctx, sharding=None,
                                       journal=journal), X, y)

    # -- rollup ------------------------------------------------------------- #

    def _rollup(self, root) -> None:
        rep = self.report
        busy = [w.busy_s for w in rep.workers]
        denom = rep.n_workers * max(rep.wall_s, 1e-9)
        rep.utilization_frac = min(1.0, sum(busy) / denom)
        alive = [(b, w.worker) for b, w in zip(busy, rep.workers)
                 if w.retired is None]
        if len(alive) > 1:
            med = float(np.median([b for b, _ in alive]))
            worst_busy, worst = max(alive)  # retired lanes can't straggle
            if med > 0 and worst_busy > 1.5 * med:
                rep.straggler = worst
                obs_export.record_event(
                    "straggler", worker=worst,
                    busy_s=round(worst_busy, 6), median_s=round(med, 6))
        extra: Dict[str, Any] = {}
        if self.pod is not None:
            rep.pod = {"host": self.pod.host, "ttl_s": self.pod.ttl_s,
                       **self.pod.stats()}
            extra = {"host": self.pod.host,
                     "pod_takeovers": self.pod.takeovers,
                     "pod_skips": self.pod.skips}
        obs_export.record_event(
            "mesh_utilization", workers=rep.n_workers,
            utilization_frac=round(rep.utilization_frac, 4),
            steals=rep.steals, requeues=rep.requeues,
            idle_s=round(sum(w.idle_s for w in rep.workers), 6),
            blocks=rep.blocks, wall_s=round(rep.wall_s, 6), **extra)
        root.set(utilization_frac=round(rep.utilization_frac, 4),
                 steals=rep.steals)


class HostScheduler(GridScheduler):
    """One pod host's scheduler tier: the work-stealing `GridScheduler`
    for the host's local lanes plus a `parallel.pod.PodCoordinator`
    claiming every block from the shared lease table before running it.

    K processes (one per host), each constructed over the SAME shared
    `store_root` and `sweep_id` with a unique `host` id, cooperatively
    drain one sweep: blocks distribute by claim-order racing, a drained
    host steals pool/TTL-expired blocks, a killed host's in-flight
    block is TTL-reclaimed by a survivor, and every host returns the
    complete, bit-identical result matrix (its own rows plus the other
    hosts' rows merged from the host-qualified journal shards).

    Determinism note: hosts must compute the same plan — same jobs in
    the same order. A divergent plan only costs the dedupe (both hosts
    run overlapping blocks; the journal merge still converges).
    """

    def __init__(self, store_root: str, host: str, sweep_id: str = "pod",
                 mesh=None, n_workers: Optional[int] = None,
                 lease_ttl_s: float = 30.0, device: DeviceLike = "cuda"):
        from transmogrifai_tpu_torch.parallel.pod import PodCoordinator
        super().__init__(mesh=mesh, n_workers=n_workers,
                         pod=PodCoordinator(store_root, sweep_id, host,
                                            ttl_s=lease_ttl_s),
                         device=device)
