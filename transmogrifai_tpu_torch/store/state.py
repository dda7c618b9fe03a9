"""CAS-guarded shared mutable state on the artifact store's directory.

The port's own copy of the JAX package's `store/state.py`, with one
repair (ROADMAP.md F7). Artifacts are immutable; lease tables and quota
balances are not. `StateCell` gives them a compare-and-swap on any POSIX
filesystem with `flock`: each write publishes a fully written, fsynced
temp file under the NEXT version number via `os.link` — link creation is
atomic and fails with EEXIST when another writer claimed that version
first, which IS the CAS failure. Readers take the highest parseable
version without a lock (a reader can never observe a torn value, because
the link only ever exposes complete files). Old versions are pruned
behind a keep window so the cell stays O(1) on disk.

F7: in the JAX package a writer whose base version has fallen out of the
keep window links into a slot `_prune` already deleted, gets True, and
its value is never read (the newest version is higher). Here the claim
also requires that the base version is still the newest: the check and
the link run under an exclusive `flock` on the cell's lock file
(``.<name>.lock`` beside the versions), so no other claim or prune can
land between them. The version files are the JAX package's.

`SharedQuota` builds the K-replica tenant invariant on top: one shared
token balance per tenant, refilled by wall clock at CAS time, from
which each replica WITHDRAWS a lease (a fraction of the burst budget)
and spends it locally per-request. The shared balance is only touched
when a lease runs dry, so admission stays a local counter decrement in
the hot path — no per-request round trip — while the sum of what K
replicas can admit between syncs stays bounded by the one shared
refill rate.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from transmogrifai_tpu_torch.runtime.integrity import fsync_dir

__all__ = ["StateCell", "SharedQuota", "LeaseTable"]

log = logging.getLogger(__name__)

_CELL_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,120}$")
_KEEP_VERSIONS = 4


class StateCell:
    """A named JSON value with filesystem compare-and-swap."""

    def __init__(self, root: str, name: str) -> None:
        if not _CELL_RE.match(name):
            raise ValueError(f"illegal state cell name: {name!r}")
        self.dir = os.path.join(os.path.abspath(os.path.expanduser(root)),
                                "state")
        self.name = name

    def _version_path(self, version: int) -> str:
        return os.path.join(self.dir, f"{self.name}.v{version}.json")

    def _versions(self) -> List[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        prefix = f"{self.name}.v"
        for n in names:
            if n.startswith(prefix) and n.endswith(".json"):
                try:
                    out.append(int(n[len(prefix):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def read(self) -> Tuple[int, Optional[Any]]:
        """(version, value) of the newest parseable version; (0, None)
        for a never-written cell. Values are complete by construction
        (link-published), but a version written by a crashed process
        before its fsync landed could in principle read short after a
        power cut — fall back one version instead of failing."""
        for version in reversed(self._versions()):
            try:
                with open(self._version_path(version), "r",
                          encoding="utf-8") as fh:
                    return version, json.load(fh)
            except (OSError, ValueError):
                continue
        return 0, None

    @contextlib.contextmanager
    def _claim_lock(self):
        """Exclusive `flock` on the cell's lock file: one claim (newest
        check, link, prune) at a time across threads and processes (each
        call opens its own file description, so threads of one process
        exclude each other too)."""
        fd = os.open(os.path.join(self.dir, f".{self.name}.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing the description releases the lock

    def try_write(self, version: int, value: Any) -> bool:
        """Publish `value` as version `version + 1`. False = CAS lost:
        `version` is not the newest version (another writer published
        since it was read, whether or not its slot was pruned since), or
        another writer claimed `version + 1` first — re-read and retry."""
        os.makedirs(self.dir, exist_ok=True)
        target = self._version_path(version + 1)
        tmp = os.path.join(
            self.dir,
            f".{self.name}-{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(value, fh)
                fh.flush()
                os.fsync(fh.fileno())
            with self._claim_lock():
                versions = self._versions()
                if (versions[-1] if versions else 0) != version:
                    return False  # F7: a stale base never claims
                try:
                    os.link(tmp, target)  # atomic claim-or-fail
                except FileExistsError:
                    return False
                except OSError as e:
                    # no hardlink support on this filesystem: O_EXCL
                    # create + byte copy is the degraded path (claim is
                    # still atomic; the value was already durable in tmp)
                    log.debug("state cell link failed (%s); O_EXCL "
                              "fallback", e)
                    try:
                        fd = os.open(target,
                                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    except FileExistsError:
                        return False
                    with os.fdopen(fd, "w", encoding="utf-8") as fh:
                        json.dump(value, fh)
                        fh.flush()
                        os.fsync(fh.fileno())
                fsync_dir(self.dir)
                self._prune(version + 1)
            return True
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _prune(self, latest: int) -> None:
        for version in self._versions():
            if version <= latest - _KEEP_VERSIONS:
                try:
                    os.unlink(self._version_path(version))
                except OSError:
                    pass

    def update(self, fn: Callable[[Optional[Any]], Any],
               retries: int = 32) -> Any:
        """CAS loop: read, transform, try_write; backs off a few ms on
        contention. Raises RuntimeError if `retries` straight CAS
        losses (K replicas hammering one cell — raise the lease size,
        not the retry count)."""
        for attempt in range(retries):
            version, value = self.read()
            new = fn(value)
            if self.try_write(version, new):
                return new
            time.sleep(min(0.001 * (2 ** min(attempt, 5)), 0.05))
        raise RuntimeError(
            f"state cell {self.name}: CAS contention exceeded "
            f"{retries} retries")


class LeaseTable:
    """TTL-leased work claims on one `StateCell` — the pod scheduler's
    shared block pool.

    The cell value is ``{"blocks": {key: {"state": pool|leased|done,
    "owner": host, "deadline": wall_clock, "attempts": n}}}``. Every
    transition is a CAS transform, so two hosts racing for the same
    block resolve to exactly one owner, and a host that dies mid-block
    simply stops renewing: when its deadline passes, any survivor's
    `claim` takes the block over (attempts increments — the preemption
    costs the fleet that one in-flight block, the same unit a lane
    retirement costs a single host).

    Wall-clock TTLs assume the hosts' clocks agree to within a fraction
    of `ttl_s` — the same assumption `SharedQuota`'s refill already
    makes on this store.
    """

    def __init__(self, root: str, name: str, owner: str,
                 ttl_s: float = 30.0) -> None:
        self.owner = str(owner)
        self.ttl_s = float(ttl_s)
        self._cell = StateCell(root, f"lease-{name}")
        self.takeovers = 0       # expired-lease claims we performed
        self.cas_rounds = 0      # update() calls (round trips)

    # -- transforms -------------------------------------------------------- #

    @staticmethod
    def _blocks(value: Optional[Any]) -> Dict[str, Dict[str, Any]]:
        if isinstance(value, dict) and isinstance(value.get("blocks"), dict):
            return value["blocks"]
        return {}

    def register(self, keys: List[str]) -> None:
        """Idempotently add `keys` to the pool. Every host registers the
        same deterministic block plan; first writer wins per key, so the
        table converges to the union without coordination."""
        keys = [str(k) for k in keys]

        def transform(value):
            blocks = dict(self._blocks(value))
            for k in keys:
                blocks.setdefault(k, {"state": "pool", "attempts": 0})
            return {"blocks": blocks}

        self._cell.update(transform)
        self.cas_rounds += 1

    def claim(self, prefer: Optional[List[str]] = None) -> Optional[str]:
        """CAS-claim one block: a pool block, else an EXPIRED lease
        (takeover). `prefer` orders the scan (a host tries its own plan
        slice first, then steals), making claim order deterministic
        under no contention. Returns the claimed key, or None when
        nothing is claimable right now (all leased-and-live or done)."""
        got: Dict[str, Any] = {"key": None, "takeover": False}

        def transform(value):
            blocks = dict(self._blocks(value))
            got["key"] = None
            got["takeover"] = False
            now = time.time()
            order = [k for k in (prefer or []) if k in blocks]
            order += [k for k in sorted(blocks) if k not in set(order)]
            for k in order:
                b = blocks[k]
                state = b.get("state")
                expired = (state == "leased"
                           and float(b.get("deadline", 0.0)) < now)
                if state == "pool" or expired:
                    blocks[k] = {"state": "leased", "owner": self.owner,
                                 "deadline": now + self.ttl_s,
                                 "attempts": int(b.get("attempts", 0)) + 1}
                    got["key"] = k
                    got["takeover"] = expired
                    break
            return {"blocks": blocks}

        self._cell.update(transform)
        self.cas_rounds += 1
        if got["takeover"]:
            self.takeovers += 1
        return got["key"]

    def acquire(self, key: str) -> str:
        """Targeted claim of one block: ``acquired`` (was pool),
        ``takeover`` (expired foreign lease), ``held`` (our own live
        lease, deadline renewed — two lanes of one host may pass the
        same requeued block), ``busy`` (live foreign lease), ``done``,
        ``failed``, or ``missing``."""
        out = {"status": "missing"}

        def transform(value):
            blocks = dict(self._blocks(value))
            b = blocks.get(key)
            if not isinstance(b, dict):
                out["status"] = "missing"
                return {"blocks": blocks}
            now = time.time()
            state = b.get("state")
            if state in ("done", "failed"):
                out["status"] = state
                return {"blocks": blocks}
            if state == "leased":
                live = float(b.get("deadline", 0.0)) >= now
                if live and b.get("owner") != self.owner:
                    out["status"] = "busy"
                    return {"blocks": blocks}
                out["status"] = "held" if b.get("owner") == self.owner \
                    else "takeover"
            else:
                out["status"] = "acquired"
            attempts = int(b.get("attempts", 0))
            if out["status"] != "held":
                attempts += 1
            blocks[key] = {"state": "leased", "owner": self.owner,
                           "deadline": now + self.ttl_s,
                           "attempts": attempts}
            return {"blocks": blocks}

        self._cell.update(transform)
        self.cas_rounds += 1
        if out["status"] == "takeover":
            self.takeovers += 1
        return out["status"]

    def fail(self, key: str, error: str) -> bool:
        """Mark our leased block permanently failed (family-level error:
        every host must apply the same family-drop policy rather than
        re-running a block that fails deterministically)."""
        ok = {"v": False}

        def transform(value):
            blocks = dict(self._blocks(value))
            b = blocks.get(key)
            ok["v"] = (isinstance(b, dict) and b.get("state") == "leased"
                       and b.get("owner") == self.owner)
            if ok["v"]:
                blocks[key] = {"state": "failed", "owner": self.owner,
                               "error": str(error)[:500],
                               "attempts": int(b.get("attempts", 0))}
            return {"blocks": blocks}

        self._cell.update(transform)
        self.cas_rounds += 1
        return ok["v"]

    def _transition(self, key: str, state: str) -> bool:
        """Move `key` to `state` iff we still hold its lease (a TTL
        takeover revokes the old owner: its late complete/release must
        not clobber the new owner's claim)."""
        ok = {"v": False}

        def transform(value):
            blocks = dict(self._blocks(value))
            b = blocks.get(key)
            ok["v"] = (isinstance(b, dict) and b.get("state") == "leased"
                       and b.get("owner") == self.owner)
            if ok["v"]:
                nb = {"state": state, "owner": self.owner,
                      "attempts": int(b.get("attempts", 0))}
                if state == "leased":
                    nb["deadline"] = time.time() + self.ttl_s
                elif state == "pool":
                    nb.pop("owner")
                blocks[key] = nb
            return {"blocks": blocks}

        self._cell.update(transform)
        self.cas_rounds += 1
        return ok["v"]

    def renew(self, key: str) -> bool:
        """Extend our lease by `ttl_s`; False = lost to a takeover."""
        return self._transition(key, "leased")

    def complete(self, key: str) -> bool:
        """Mark our leased block done (its journal record is durable)."""
        return self._transition(key, "done")

    def release(self, key: str) -> bool:
        """Return our leased block to the pool (lane-retirement path:
        the block failed locally; let another host run it)."""
        return self._transition(key, "pool")

    # -- reads ------------------------------------------------------------- #

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        _, value = self._cell.read()
        return dict(self._blocks(value))

    def pending(self) -> Tuple[int, float]:
        """(blocks not done, seconds until the earliest live lease
        expires). The second value is what a drained host's wait loop
        sleeps against — TTL-aware, never a blind poll; `inf` when
        nothing is leased (only pool blocks remain: claim immediately)."""
        now = time.time()
        remaining = 0
        next_expiry = float("inf")
        for b in self.snapshot().values():
            state = b.get("state")
            if state in ("done", "failed"):
                continue
            remaining += 1
            if state == "leased":
                next_expiry = min(next_expiry,
                                  float(b.get("deadline", 0.0)) - now)
        return remaining, next_expiry


class SharedQuota:
    """Lease-based cross-replica token budget per tenant.

    The shared cell holds ``{"tokens": float, "ts": wall_clock}`` —
    refill happens inside the CAS transform from the wall-clock delta,
    capped at the burst budget, so K replicas reading concurrently can
    never mint more than `rate * elapsed` between them. A replica
    withdraws ``lease_frac * burst`` tokens at a time and spends the
    lease locally; `try_spend` is the hot-path call and only goes to the
    shared cell when the local lease runs dry.
    """

    def __init__(self, root: str, replica: str = "r0",
                 lease_frac: float = 0.25, registry=None) -> None:
        self.root = root
        self.replica = replica
        self.lease_frac = float(lease_frac)
        self._lock = threading.Lock()
        self._leases: Dict[str, float] = {}  # guarded-by: self._lock
        self._cells: Dict[str, StateCell] = {}  # guarded-by: self._lock
        if registry is None:
            from transmogrifai_tpu_torch.obs.metrics import get_registry
            registry = get_registry()
        self._m_sync = registry.counter(
            "router_quota_syncs_total",
            "shared-quota cell round trips", replica=replica)
        self._m_denied = registry.counter(
            "router_quota_denied_total",
            "admissions denied by the shared balance", replica=replica)

    def _cell(self, tenant: str) -> StateCell:
        with self._lock:
            cell = self._cells.get(tenant)
            if cell is None:
                safe = re.sub(r"[^A-Za-z0-9._-]", "_", tenant)[:80] or "t"
                cell = StateCell(self.root, f"quota-{safe}")
                self._cells[tenant] = cell
        return cell

    def _withdraw(self, tenant: str, rate: float, burst: float,
                  want: float) -> float:
        """CAS-withdraw up to `want` tokens from the shared balance.
        Runs OUTSIDE self._lock — the cell update can touch shared
        storage and must never serialize the other tenants."""
        granted = {"v": 0.0}

        def transform(value: Optional[Dict[str, Any]]) -> Dict[str, Any]:
            now = time.time()
            if not isinstance(value, dict):
                tokens, ts = burst, now
            else:
                tokens = float(value.get("tokens", 0.0))
                ts = float(value.get("ts", now))
                tokens = min(burst, tokens + max(0.0, now - ts) * rate)
            granted["v"] = max(0.0, min(tokens, want))
            return {"tokens": tokens - granted["v"], "ts": now,
                    "rate": rate, "burst": burst}

        self._cell(tenant).update(transform)
        self._m_sync.inc()
        return granted["v"]

    def try_spend(self, tenant: str, n: float, rate: float,
                  burst: float) -> bool:
        """Spend `n` tokens for `tenant`; False = over the K-replica
        budget (caller maps to quota_exceeded/429)."""
        if rate == float("inf"):
            return True
        with self._lock:
            lease = self._leases.get(tenant, 0.0)
            if lease >= n:
                self._leases[tenant] = lease - n
                return True
        want = max(n, burst * self.lease_frac)
        granted = self._withdraw(tenant, rate, burst, want)
        with self._lock:
            lease = self._leases.get(tenant, 0.0) + granted
            if lease >= n:
                self._leases[tenant] = lease - n
                return True
            # not enough fleet-wide: keep the partial lease for later
            self._leases[tenant] = lease
        self._m_denied.inc()
        return False

    def refill_eta_s(self, tenant: str, n: float, rate: float) -> float:
        """Honest Retry-After for a denied admission: how long the
        SHARED refill needs to cover `n` tokens beyond what this
        replica already holds."""
        if rate <= 0.0:
            return 3600.0
        with self._lock:
            lease = self._leases.get(tenant, 0.0)
        return min(3600.0, max(0.0, (n - lease)) / rate)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            leases = dict(self._leases)
        out: Dict[str, Any] = {"replica": self.replica, "tenants": {}}
        for tenant, lease in sorted(leases.items()):
            _, value = self._cell(tenant).read()
            out["tenants"][tenant] = {
                "lease": round(lease, 3),
                "shared": value if isinstance(value, dict) else None,
            }
        return out
