"""SweepJournal: append-only log of completed sweep grid-config blocks.

The port's own copy of the JAX package's `runtime/journal.py`: the same
file names, header, `key_of` hash, record keys and float round trip, so
either package reads the other's journals. The port writes no
`facts` (the cost model's block features come with `perf/`, ROADMAP.md
queue 1, item 10); it ignores them in records that carry them.

The selector's per-family checkpoint (model_selector.py) persists a
family's whole metric matrix only AFTER the family finishes — a
preemption 90% of the way through a 2-hour tree sweep still loses
everything. The journal closes that gap: `parallel/sweep.py` appends
one record per grid config as soon as its block's fold metrics are
complete, and a resumed sweep skips journaled configs before grouping,
so a kill at any block boundary costs at most the in-flight block.

File format — one JSON object per line:

    {"journal": 1, "meta": {...}}                               # header
    {"key": "<config hash>", "grid": {...},
     "fold_metrics": [...], "best": {...}}                      # blocks

Properties the resume guarantees lean on:

- **append-only + flush/fsync per record**: a kill never corrupts
  earlier records; at worst the FINAL line is torn, and the loader
  stops at the first unparseable line (the torn block simply re-runs).
- **bit-identical metrics**: fold metrics round-trip through JSON's
  shortest-repr floats, which is exact for float64 — a resumed sweep
  selects the same winner with the same bytes as an uninterrupted run.
- **keyed by config content**: `key_of(grid)` hashes the sorted JSON
  of the grid dict; the enclosing file path carries the family/data/
  fold/seed signature (model_selector `_signature`), and a header-meta
  mismatch discards the file rather than resuming against stale state.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional

__all__ = ["SweepJournal", "ShardedSweepJournal"]

log = logging.getLogger(__name__)

_FORMAT_VERSION = 1

# Parsed-shard cache keyed by absolute path -> ((size, mtime_ns), state).
# Cross-host resume over shared storage re-opens every shard on each
# refresh/restart; an unchanged shard (same size + mtime) must not be
# re-read and re-json-parsed — on NFS-ish pod stores that is the
# difference between an O(changed) and an O(all shards) resume. Entries
# hold the immutable parse result; instances copy the dict skins so one
# journal's post-load appends never leak into another's view.
_PARSE_CACHE: Dict[str, tuple] = {}  # guarded-by: _PARSE_CACHE_LOCK
_PARSE_CACHE_LOCK = threading.Lock()
_PARSE_CACHE_MAX = 256


def _parse_cache_get(path: str, stat_key: tuple):
    with _PARSE_CACHE_LOCK:
        hit = _PARSE_CACHE.get(path)
        if hit is not None and hit[0] == stat_key:
            return hit[1]
    return None


def _parse_cache_put(path: str, stat_key: tuple, state: tuple) -> None:
    with _PARSE_CACHE_LOCK:
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX and path not in _PARSE_CACHE:
            _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
        _PARSE_CACHE[path] = (stat_key, state)


class SweepJournal:
    """Append-only per-family journal. Thread-safe (block completions
    can land from a family's host-dispatch loop while another thread
    reads counts)."""

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 fsync: bool = True):
        self.path = path
        self.meta = dict(meta or {})
        self.fsync = fsync
        self._lock = threading.Lock()
        self._rows: Dict[str, List[float]] = {}
        self._durations: Dict[str, float] = {}  # key -> block wall seconds
        self._grids: Dict[str, Dict[str, Any]] = {}  # key -> grid config
        self._header_written = False
        self._load()

    # -- keys ------------------------------------------------------------- #

    @staticmethod
    def key_of(grid: Dict[str, Any]) -> str:
        blob = json.dumps(grid, sort_keys=True, default=repr)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- reading ---------------------------------------------------------- #

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        apath = os.path.abspath(self.path)
        try:
            with open(self.path, "rb") as fh:
                st = os.fstat(fh.fileno())
                stat_key = (st.st_ino, st.st_size, st.st_mtime_ns)
                cached = _parse_cache_get(apath, stat_key)
                raw = b"" if cached is not None else fh.read()
        except OSError:
            log.warning("sweep journal %s unreadable; starting fresh",
                        self.path, exc_info=True)
            return
        if cached is not None:
            header_meta, c_rows, c_durations, c_grids = cached
            if header_meta != self.meta:
                stale = self.path + ".stale"
                try:
                    os.replace(self.path, stale)
                except OSError:
                    pass
                log.warning("sweep journal %s: header mismatch; rotated "
                            "to %s and starting fresh", self.path, stale)
                return
            # dict skins are per-instance (appends add keys); the row
            # lists and grid dicts inside are never mutated in place
            self._rows = dict(c_rows)
            self._durations = dict(c_durations)
            self._grids = dict(c_grids)
            self._header_written = True
            return
        rows: Dict[str, List[float]] = {}
        durations: Dict[str, float] = {}
        grids: Dict[str, Dict[str, Any]] = {}
        header_ok = False
        valid_bytes = 0   # length of the intact, newline-terminated prefix
        saw_record_line = False
        for bline in raw.splitlines(keepends=True):
            text = bline.decode("utf-8", "replace").strip()
            complete = bline.endswith(b"\n")
            if not text:
                if complete:
                    valid_bytes += len(bline)
                continue
            rec = None
            if complete:
                try:
                    rec = json.loads(text)
                except ValueError:
                    rec = None
            if rec is None:
                # torn record from a kill mid-append (no newline), or a
                # garbage line: everything BEFORE it is intact — stop
                # here and TRUNCATE the file back to the intact prefix,
                # or post-resume appends would concatenate onto the
                # garbage and be lost to the next load
                break
            if not saw_record_line:
                saw_record_line = True
                if rec.get("journal") != _FORMAT_VERSION or \
                        rec.get("meta") != self.meta:
                    # stale/foreign journal at this path: do NOT resume
                    # against it (rotate aside so nothing is lost)
                    stale = self.path + ".stale"
                    try:
                        os.replace(self.path, stale)
                    except OSError:
                        pass
                    log.warning("sweep journal %s: header mismatch; "
                                "rotated to %s and starting fresh",
                                self.path, stale)
                    return
                header_ok = True
                valid_bytes += len(bline)
                continue
            key = rec.get("key")
            metrics = rec.get("fold_metrics")
            if isinstance(key, str) and isinstance(metrics, list):
                rows[key] = [float(m) for m in metrics]
                dur = rec.get("duration_s")
                if isinstance(dur, (int, float)):
                    durations[key] = float(dur)
                if isinstance(rec.get("grid"), dict):
                    grids[key] = rec["grid"]
            valid_bytes += len(bline)
        if valid_bytes < len(raw):
            log.warning("sweep journal %s: torn record after %d intact "
                        "block(s); truncating the damaged tail",
                        self.path, len(rows))
            try:
                with open(self.path, "r+b") as fh:
                    fh.truncate(valid_bytes)
                    fh.flush()
                    os.fsync(fh.fileno())
            except OSError:
                # cannot repair in place: rotate aside and start fresh
                # (resume degrades, correctness does not)
                stale = self.path + ".stale"
                try:
                    os.replace(self.path, stale)
                except OSError:
                    pass
                log.warning("sweep journal %s: could not truncate torn "
                            "tail; rotated to %s", self.path, stale,
                            exc_info=True)
                return
        self._rows = rows
        self._durations = durations
        self._grids = grids
        # only a validated header makes appends skip re-writing it — an
        # empty or header-torn file must get a fresh header first
        self._header_written = header_ok
        if header_ok and valid_bytes == len(raw):
            # clean, fully parsed file: the next reader of these exact
            # bytes (cross-host refresh, resume restart) skips the parse
            _parse_cache_put(apath, stat_key,
                             (dict(self.meta), dict(rows), dict(durations),
                              dict(grids)))

    def lookup(self, grid: Dict[str, Any]) -> Optional[List[float]]:
        with self._lock:
            row = self._rows.get(self.key_of(grid))
            return list(row) if row is not None else None

    def duration_of(self, grid: Dict[str, Any]) -> float:
        """Recorded wall seconds of a journaled block (0.0 when the
        record predates duration stamping) — the resume-skip savings
        feeding the goodput report."""
        with self._lock:
            return self._durations.get(self.key_of(grid), 0.0)

    def rows(self) -> List[tuple]:
        """Every journaled ``(grid, fold_metrics)`` pair (records whose
        grid predates grid retention are omitted) — `run_sweep` seeds its
        best-so-far tracker from this, so post-resume journal ``best``
        annotations account for blocks completed before the kill even
        when the resumed call only sees a SUBSET of the grids (the
        distributed scheduler hands each worker one block)."""
        with self._lock:
            return [(self._grids[k], list(self._rows[k]))
                    for k in self._rows if k in self._grids]

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # -- writing ---------------------------------------------------------- #

    def _write_line(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, default=repr)
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())

    def append(self, grid: Dict[str, Any], fold_metrics: List[float],
               best: Optional[Dict[str, Any]] = None,
               duration_s: Optional[float] = None) -> None:
        """Record one completed grid-config block. Idempotent per config;
        never raises (journaling is an optimization — a full disk must
        degrade resume granularity, not kill the sweep). `duration_s`
        stamps the block's wall cost so a resume can report how much
        work the journal saved (goodput resume-skip accounting)."""
        key = self.key_of(grid)
        with self._lock:
            if key in self._rows:
                return
            rec: Dict[str, Any] = {
                "key": key, "grid": grid,
                "fold_metrics": [float(m) for m in fold_metrics],
                "best": best}
            if duration_s is not None:
                rec["duration_s"] = round(float(duration_s), 6)
            try:
                # this is a write-ahead log: the lock deliberately
                # serializes the disk appends themselves
                if not self._header_written:
                    dirname = os.path.dirname(self.path)
                    if dirname:
                        os.makedirs(dirname, exist_ok=True)
                    self._write_line({"journal": _FORMAT_VERSION,
                                      "meta": self.meta})
                    self._header_written = True
                self._write_line(rec)
            except OSError:
                log.warning("sweep journal %s: append failed; block will "
                            "re-run on resume", self.path, exc_info=True)
                return
            self._rows[key] = [float(m) for m in fold_metrics]
            self._grids[key] = grid
            if duration_s is not None:
                self._durations[key] = float(duration_s)


# --------------------------------------------------------------------------- #
# multi-writer sharding                                                       #
# --------------------------------------------------------------------------- #

# shard tokens: plain ints for single-host workers (`-w3.jsonl`), and
# host-qualified names for pod runs (`-wh0_3.jsonl` = host h0, lane 3)
# so two hosts' lane-3 workers never share a shard file on the shared
# store. Digit-only tokens stay int keys for legacy shard discovery.
_SHARD_RE = re.compile(r"-w([A-Za-z0-9_]+)\.jsonl$")


def _shard_key(token: str):
    return int(token) if token.isdigit() else token


class _ShardWriter:
    """One worker's view of a `ShardedSweepJournal`: lookups see the
    MERGED rows of every shard (so a worker never re-runs a block another
    worker completed), while appends land only in the worker's own shard
    file — two workers never share an fd, so concurrent appends cannot
    interleave bytes inside one file."""

    def __init__(self, parent: "ShardedSweepJournal", shard: SweepJournal):
        self._parent = parent
        self._shard = shard

    def lookup(self, grid: Dict[str, Any]) -> Optional[List[float]]:
        return self._parent.lookup(grid)

    def duration_of(self, grid: Dict[str, Any]) -> float:
        return self._parent.duration_of(grid)

    def rows(self) -> List[tuple]:
        return self._parent.rows()

    def append(self, grid: Dict[str, Any], fold_metrics: List[float],
               best: Optional[Dict[str, Any]] = None,
               duration_s: Optional[float] = None) -> None:
        self._shard.append(grid, fold_metrics, best=best,
                           duration_s=duration_s)

    def __len__(self) -> int:
        return len(self._parent)


class ShardedSweepJournal:
    """Concurrent-worker journal: per-worker shard files merged on read.

    A single `SweepJournal` is append-only through one fd; with N
    scheduler workers completing blocks concurrently, sharing that fd
    would interleave partial lines (even line-buffered writes interleave
    across processes/threads on some filesystems). Instead each worker k
    appends to its own ``<base>-w<k>.jsonl`` shard — the same
    header/flush/fsync/torn-tail-repair contract per shard — and reads
    merge every shard, so resume and steal decisions see the union of
    all workers' completed blocks. Shard discovery is by filename
    pattern, so a resumed run with a different worker count still reads
    every prior shard (and only ever appends to its own).
    """

    def __init__(self, base_path: str, meta: Optional[Dict[str, Any]] = None,
                 fsync: bool = True):
        self.base_path = base_path
        self.meta = dict(meta or {})
        self.fsync = fsync
        self._lock = threading.Lock()
        self._shards: Dict[Any, SweepJournal] = {}  # guarded-by: self._lock
        self._owned: set = set()  # keys we hand writers for  # guarded-by: self._lock
        # glob.escape: a checkpoint dir containing [, ?, or * must not
        # turn shard discovery into a character-class match that finds
        # nothing (which would silently re-run every journaled block)
        for path in sorted(_glob.glob(
                _glob.escape(self.base_path) + "-w*.jsonl")):
            m = _SHARD_RE.search(path)
            if m is None:
                continue
            k = _shard_key(m.group(1))
            # load (and torn-tail-repair) every existing shard up front:
            # resume must see the union before any block is scheduled
            self._shards[k] = SweepJournal(path, meta=self.meta,
                                           fsync=self.fsync)
        if os.path.exists(base_path):
            # a pre-sharding single-file journal at the base path merges
            # read-only (shard -1): a single-device run killed and then
            # resumed on a mesh still skips its completed blocks
            self._shards[-1] = SweepJournal(base_path, meta=self.meta,
                                            fsync=self.fsync)

    def _shard_path(self, k) -> str:
        return f"{self.base_path}-w{k}.jsonl"

    def shard(self, k) -> _ShardWriter:
        """Worker k's writer view (merged reads, own-file appends). `k`
        is an int lane index on a single host, or a host-qualified
        string like ``h0_3`` in a pod run."""
        if not isinstance(k, int) and not re.fullmatch(r"[A-Za-z0-9_]+",
                                                       str(k)):
            raise ValueError(f"illegal journal shard id: {k!r}")
        with self._lock:
            sj = self._shards.get(k)
            if sj is None:
                sj = SweepJournal(self._shard_path(k), meta=self.meta,
                                  fsync=self.fsync)
                self._shards[k] = sj
            self._owned.add(k)
        return _ShardWriter(self, sj)

    def refresh(self) -> int:
        """Re-merge foreign shards from disk: discover shards that
        appeared since construction and reload existing non-owned ones
        whose bytes changed (the per-path parse cache makes unchanged
        shards a stat call). Shards this process writes (`shard()` was
        called) are authoritative in memory and never reloaded. Returns
        the number of shards (re)loaded — the cross-host completion-log
        merge a pod host runs before filling other hosts' results."""
        loaded = 0
        with self._lock:
            known = dict(self._shards)
            owned = set(self._owned)
        fresh: Dict[Any, SweepJournal] = {}
        for path in sorted(_glob.glob(
                _glob.escape(self.base_path) + "-w*.jsonl")):
            m = _SHARD_RE.search(path)
            if m is None:
                continue
            k = _shard_key(m.group(1))
            if k in owned:
                continue
            prior = known.get(k)
            if prior is not None:
                try:
                    st = os.stat(path)
                    a_hit = _parse_cache_get(
                        os.path.abspath(path),
                        (st.st_ino, st.st_size, st.st_mtime_ns))
                except OSError:
                    a_hit = None
                if a_hit is not None and len(a_hit[1]) == len(prior):
                    continue  # unchanged since our load: keep it
            fresh[k] = SweepJournal(path, meta=self.meta, fsync=self.fsync)
            loaded += 1
        if fresh:
            with self._lock:
                for k, sj in fresh.items():
                    if k not in self._owned:
                        self._shards[k] = sj
        return loaded

    def shard_paths(self) -> List[str]:
        with self._lock:
            return [s.path for s in self._shards.values()]

    @staticmethod
    def has_shards(base_path: str) -> bool:
        """Shard files exist beside `base_path` — a single-device resume
        of a mesh-journaled sweep must open the sharded reader or every
        mesh-completed block silently re-runs."""
        return bool(_glob.glob(_glob.escape(base_path) + "-w*.jsonl"))

    # -- merged reads ------------------------------------------------------ #

    def _all(self) -> List[SweepJournal]:
        with self._lock:
            return list(self._shards.values())

    def lookup(self, grid: Dict[str, Any]) -> Optional[List[float]]:
        for sj in self._all():
            row = sj.lookup(grid)
            if row is not None:
                return row
        return None

    def duration_of(self, grid: Dict[str, Any]) -> float:
        for sj in self._all():
            d = sj.duration_of(grid)
            if d:
                return d
        return 0.0

    def rows(self) -> List[tuple]:
        seen: Dict[str, tuple] = {}
        for sj in self._all():
            for g, row in sj.rows():
                seen.setdefault(SweepJournal.key_of(g), (g, row))
        return list(seen.values())

    def append(self, grid: Dict[str, Any], fold_metrics: List[float],
               best: Optional[Dict[str, Any]] = None,
               duration_s: Optional[float] = None) -> None:
        """Single-writer convenience (callers outside a scheduler worker
        context append to shard 0)."""
        self.shard(0).append(grid, fold_metrics, best=best,
                             duration_s=duration_s)

    def __len__(self) -> int:
        seen: set = set()
        for sj in self._all():
            with sj._lock:
                seen.update(sj._rows.keys())
        return len(seen)
