"""Pod tier of the sweep scheduler: cross-host block coordination.

The port's own copy of the JAX package's `parallel/pod.py`. One
`HostScheduler` process runs per host (parallel/scheduler.py — the
work-stealing engine for the host's local lanes); this module is
the thin tier above it, in the shape of the TF distributed runtime
(arxiv 1605.08695): no master process, just a shared lease table on the
`store/` state plane (`store.state.LeaseTable` — `StateCell` CAS with
TTL expiry) that every host's workers claim grid blocks from.

Every host computes the SAME deterministic block plan (same jobs → same
`static_signature` groups → same `block_key`s), registers it
idempotently, and deals all blocks into its local lanes; a worker
CAS-acquires a block fleet-wide right before running it and skips
blocks another host owns or finished. Work distribution is therefore
claim-order racing — the faster host simply acquires more blocks — and
cross-host stealing is the drained host claiming pool or TTL-expired
blocks. A host that dies mid-block stops renewing its lease; when the
TTL passes, a survivor's claim takes the block over, so the preemption
costs the fleet exactly the in-flight block (the lane-retirement unit,
now across hosts).

The per-worker journal shards are the cross-host completion log: pod
workers journal under host-qualified shard ids (``<base>-wh0_3.jsonl``)
on the shared store, `complete()` is only called after the block's
journal records are durable, and a drained host re-merges foreign
shards (`ShardedSweepJournal.refresh`) before filling the rows other
hosts computed — winner selection stays bit-identical to single-host
because every row round-trips through the same JSON journal bytes.
Leases carry no W3C ``traceparent`` (the JAX package stamps one for its
fleet trace merge; request tracing is ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
from typing import Dict, List, Optional, Tuple

from transmogrifai_tpu_torch.store.state import LeaseTable

__all__ = ["PodCoordinator", "block_key"]

_HOST_RE = re.compile(r"^[A-Za-z0-9_]{1,32}$")


def block_key(job: int, sig_key: Tuple, idxs: List[int]) -> str:
    """Deterministic fleet-wide identity of one planned grid block: the
    job index, the static-signature group, and the exact grid indices
    (post-split). Hosts running the same plan derive the same keys; a
    host with a divergent plan (e.g. a different warm cost model) only
    loses the dedupe — the journal merge still dedupes the results."""
    blob = json.dumps([job, repr(sig_key), sorted(int(i) for i in idxs)])
    return f"j{job}." + hashlib.sha256(blob.encode()).hexdigest()[:12]


class PodCoordinator:
    """One host's handle on the shared block lease table.

    Wraps `LeaseTable` with the scheduler's idioms: host-idempotent
    acquire (two lanes of one host may pass the same requeued block),
    a background lease renewer so blocks longer than the TTL are not
    torn from a live host, and failure propagation (a family that
    fails on one host marks its blocks ``failed`` so the fleet applies
    the same family-drop policy instead of ping-ponging the block).
    """

    def __init__(self, root: str, sweep_id: str, host: str,
                 ttl_s: float = 30.0) -> None:
        if not _HOST_RE.match(host):
            raise ValueError(f"illegal pod host id: {host!r} "
                             "(need [A-Za-z0-9_]+, it names journal shards)")
        self.host = host
        self.ttl_s = float(ttl_s)
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", sweep_id)[:80] or "sweep"
        self.table = LeaseTable(root, safe, owner=host, ttl_s=ttl_s)
        self._lock = threading.Lock()
        self._held: set = set()          # guarded-by: self._lock
        self._stop = threading.Event()
        self._renewer: Optional[threading.Thread] = None
        self.skips = 0                   # blocks another host owned/finished
        self.foreign = 0                 # claimed keys outside our plan
        self.renew_errors = 0            # CAS bursts the renewer rode out

    # -- lifecycle --------------------------------------------------------- #

    def register(self, keys: List[str]) -> None:
        self.table.register(keys)

    def start(self) -> None:
        """Start the lease renewer (idempotent)."""
        with self._lock:
            if self._renewer is not None:
                return
            self._stop.clear()
            self._renewer = threading.Thread(
                target=self._renew_loop, name=f"pod-renew-{self.host}",
                daemon=True)
            self._renewer.start()

    def stop(self) -> None:
        with self._lock:
            t, self._renewer = self._renewer, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5.0)

    def _renew_loop(self) -> None:
        # interval-paced on the TTL (never a blind poll): renew held
        # leases at a third of their expiry so one missed beat — a GC
        # pause, a slow CAS round — still leaves two chances before a
        # survivor is allowed to tear the block away
        while not self._stop.wait(self.ttl_s / 3.0):
            with self._lock:
                held = list(self._held)
            for key in held:
                try:
                    if not self.table.renew(key):
                        # TTL takeover revoked us: the block re-runs
                        # elsewhere; our journal append (if any) merges
                        # harmlessly — records are keyed by config
                        with self._lock:
                            self._held.discard(key)
                except Exception:
                    # CAS contention burst: the lease still has ~2/3 of
                    # its TTL, so count it and let the next beat retry
                    self.renew_errors += 1
                    continue

    # -- claims ------------------------------------------------------------ #

    def try_acquire(self, key: str) -> bool:
        """Acquire `key` for this host right before running it. True for
        a pool block, a TTL-expired foreign lease, or a lease this host
        already holds (requeue-within-host); False when another host
        owns it live or it is already done/failed — the caller drops
        the block locally."""
        status = self.table.acquire(key)
        if status in ("acquired", "takeover", "held"):
            with self._lock:
                self._held.add(key)
            return True
        self.skips += 1
        return False

    def claim_any(self, prefer: Optional[List[str]] = None) -> Optional[str]:
        """Cross-host steal: claim any pool or expired block."""
        key = self.table.claim(prefer=prefer)
        if key is not None:
            with self._lock:
                self._held.add(key)
        return key

    def complete(self, key: str) -> None:
        """Mark `key` done fleet-wide. Callers MUST have made the
        block's journal records durable first — done is the signal a
        drained host trusts before merging shards."""
        with self._lock:
            self._held.discard(key)
        self.table.complete(key)

    def release(self, key: str) -> None:
        with self._lock:
            self._held.discard(key)
        self.table.release(key)

    def fail(self, key: str, error: str) -> None:
        """Mark `key` failed fleet-wide (family-level error): every host
        applies its family-drop policy instead of re-running the block."""
        with self._lock:
            self._held.discard(key)
        self.table.fail(key, error)

    # -- reads ------------------------------------------------------------- #

    def pending(self) -> Tuple[int, float]:
        return self.table.pending()

    def snapshot(self) -> Dict[str, Dict]:
        return self.table.snapshot()

    @property
    def takeovers(self) -> int:
        return self.table.takeovers

    def stats(self) -> Dict[str, int]:
        return {"takeovers": self.table.takeovers, "skips": self.skips,
                "cas_rounds": self.table.cas_rounds,
                "foreign": self.foreign,
                "renew_errors": self.renew_errors}
