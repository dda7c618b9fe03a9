"""Content-addressed artifact store over a pluggable backend.

The port's own copy of the JAX package's `store/artifact.py`: the same
directory layout and the same manifest (`artifact.json`, written with
`json.dump(..., indent=1, sort_keys=True)`), so an artifact committed by
either package verifies in the other. The feature cache's wire tapes
(`data/feature_cache.py`) commit through it.

The durability story is the staged-directory protocol of the store's
integrity helpers: payload files are staged and fsynced, the sha256
manifest is written LAST, and `runtime/integrity.commit_staged_dir` swaps
the directory into place — a crash at any instruction leaves the previous
artifact or the new one, never a torn mix. Readers verify against the
manifest and raise a structured `StoreCorruptError`; consumers treat it as
a miss and rebuild (never serve from a torn tape).

The backend is a directory (`LocalDirBackend`); the `Backend` surface is
small (path/commit/remove/keys). `gc()` applies TTL then LRU eviction
(last-access touch files kept OUTSIDE the sealed artifact, so access
tracking never invalidates a manifest), and `prefetch()` streams an
artifact's wire tape through the page cache — and through sha256 — on a
named background thread ahead of its first consumer read.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from transmogrifai_tpu_torch.runtime.integrity import (
    commit_staged_dir, fsync_dir, fsync_file, sha256_file)

__all__ = [
    "MANIFEST",
    "STORE_VERSION",
    "StoreCorruptError",
    "ArtifactInfo",
    "Backend",
    "LocalDirBackend",
    "ArtifactStore",
]

log = logging.getLogger(__name__)

MANIFEST = "artifact.json"
STORE_VERSION = 1

# keys are content digests or slugs — path-safe by construction, but the
# backend enforces it so a hostile key can never escape the root
_KEY_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,200}$")

# access-time sidecar dir at the store root; one empty touch file per
# key whose mtime is the LRU clock (kept off the sealed artifact dirs)
_ACCESS_DIR = ".access"
_GC_DIR = ".gc"


class StoreCorruptError(RuntimeError):
    """An artifact failed integrity verification. Structured so callers
    can log WHAT failed and fall back to a rebuild instead of serving
    from a torn tape."""

    def __init__(self, path: str, reason: str,
                 key: Optional[str] = None) -> None:
        super().__init__(f"corrupt artifact at {path}: {reason}")
        self.path = path
        self.reason = reason
        self.key = key


@dataclass
class ArtifactInfo:
    key: str
    path: str
    bytes: int
    created: float
    files: int
    meta: Dict[str, Any]


class Backend:
    """Placement + atomic publish/remove for one artifact namespace.

    Implementations must make `commit` atomic (all-or-nothing publish of
    a fully staged dir) and `remove` crash-safe (a half-removed artifact
    must never look present). Everything content-related — manifests,
    hashing, verification, eviction policy — stays in `ArtifactStore`.
    """

    name = "base"

    def path_of(self, key: str) -> str:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def commit(self, staged_dir: str, key: str) -> str:
        raise NotImplementedError

    def remove(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError


class LocalDirBackend(Backend):
    """Tier-0: a directory on local or shared (NFS-style) storage."""

    name = "localdir"

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(os.path.expanduser(root))

    def path_of(self, key: str) -> str:
        if not _KEY_RE.match(key):
            raise ValueError(f"illegal artifact key: {key!r}")
        return os.path.join(self.root, key)

    def exists(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.path_of(key), MANIFEST))

    def commit(self, staged_dir: str, key: str) -> str:
        final = self.path_of(key)
        commit_staged_dir(staged_dir, final)
        return final

    def remove(self, key: str) -> None:
        # rename aside first: a crash mid-rmtree leaves the victim in
        # .gc/ (invisible to exists/keys) instead of half-deleted in
        # place; the next gc() sweep finishes the job
        path = self.path_of(key)
        if not os.path.isdir(path):
            return
        aside = os.path.join(self.root, _GC_DIR,
                             f"{key}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(os.path.dirname(aside), exist_ok=True)
        try:
            os.rename(path, aside)
        except OSError:
            return  # lost a remove race — the other remover owns it
        shutil.rmtree(aside, ignore_errors=True)
        fsync_dir(self.root)

    def keys(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(n for n in names
                      if _KEY_RE.match(n) and self.exists(n))


class ArtifactStore:
    """get/put/stat over a backend, with verification, GC and prefetch."""

    def __init__(self, backend: Backend, registry=None,
                 ttl_s: Optional[float] = None,
                 max_bytes: Optional[int] = None) -> None:
        self.backend = backend
        self.ttl_s = ttl_s
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Thread] = {}  # guarded-by: self._lock
        self._prefetched: Dict[str, Optional[str]] = {}  # guarded-by: self._lock
        if registry is None:
            from transmogrifai_tpu_torch.obs.metrics import get_registry
            registry = get_registry()
        self.registry = registry
        b = backend.name
        self._m_hit = registry.counter(
            "store_hits_total", "artifact store verified hits", backend=b)
        self._m_miss = registry.counter(
            "store_misses_total", "artifact store misses", backend=b)
        self._m_corrupt = registry.counter(
            "store_corrupt_total", "artifacts rejected by verification",
            backend=b)
        self._m_put = registry.counter(
            "store_puts_total", "artifacts committed", backend=b)
        self._m_put_bytes = registry.counter(
            "store_put_bytes_total", "payload bytes committed", backend=b)
        self._m_evict = registry.counter(
            "store_evicted_total", "artifacts evicted by gc", backend=b)
        self._m_prefetch = registry.counter(
            "store_prefetch_total", "artifacts streamed by prefetch",
            backend=b)

    # -- write path ------------------------------------------------------ #

    def put(self, key: str, stage: Callable[[str], None],
            meta: Optional[Dict[str, Any]] = None) -> str:
        """Stage payload files via `stage(tmp_dir)`, seal and publish.

        The store is the only writer into the namespace: it fsyncs every
        staged file, writes the sha256 manifest LAST, and commits through
        the staged-dir rename protocol.
        """
        final = self.backend.path_of(key)
        parent = os.path.dirname(final) or "."
        os.makedirs(parent, exist_ok=True)
        # dot-prefixed staging name: invisible to keys()/gc() until the
        # atomic rename publishes it under the real key
        tmp = os.path.join(
            parent, f".stage-{key}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            stage(tmp)
            self.seal_and_commit(key, tmp, meta)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    def seal_and_commit(self, key: str, staged_dir: str,
                        meta: Optional[Dict[str, Any]] = None) -> str:
        """Tail of `put` for writers that staged files themselves (the
        feature-cache ArtifactWriter streams chunks into the staging dir
        before handing it over). Manifest goes in LAST, then the atomic
        swap."""
        files: Dict[str, Dict[str, Any]] = {}
        total = 0
        for name in sorted(os.listdir(staged_dir)):
            p = os.path.join(staged_dir, name)
            if not os.path.isfile(p) or name == MANIFEST:
                continue
            fsync_file(p)
            size = os.path.getsize(p)
            files[name] = {"sha256": sha256_file(p), "bytes": size}
            total += size
        manifest = dict(meta or {})
        manifest.update({
            "store_version": STORE_VERSION,
            "key": key,
            "created": time.time(),
            "files": files,
        })
        mpath = os.path.join(staged_dir, MANIFEST)
        with open(mpath, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        final = self.backend.commit(staged_dir, key)
        with self._lock:
            self._prefetched.pop(key, None)
        self._m_put.inc()
        self._m_put_bytes.inc(total)
        self._touch(key)
        return final

    # -- read path ------------------------------------------------------- #

    def manifest(self, key: str) -> Dict[str, Any]:
        """Parsed manifest, with the structural checks every reader
        needs (valid JSON, key match, files table)."""
        path = self.backend.path_of(key)
        mpath = os.path.join(path, MANIFEST)
        try:
            with open(mpath, "r", encoding="utf-8") as fh:
                manifest = json.load(fh)
        except FileNotFoundError:
            raise StoreCorruptError(path, "manifest missing", key)
        except (OSError, ValueError) as e:
            raise StoreCorruptError(path, f"manifest unreadable: {e}", key)
        if not isinstance(manifest, dict):
            raise StoreCorruptError(path, "manifest is not an object", key)
        if manifest.get("key", key) != key:
            raise StoreCorruptError(
                path, f"key mismatch: manifest says "
                f"{manifest.get('key')!r}", key)
        if not isinstance(manifest.get("files"), dict):
            raise StoreCorruptError(path, "manifest has no files table", key)
        return manifest

    def stat(self, key: str) -> Optional[ArtifactInfo]:
        """Cheap existence + shape probe (no hashing); None when absent,
        StoreCorruptError when present but structurally broken."""
        if not self.backend.exists(key):
            return None
        manifest = self.manifest(key)
        files = manifest["files"]
        meta = {k: v for k, v in manifest.items()
                if k not in ("files", "key", "store_version", "created")}
        return ArtifactInfo(
            key=key, path=self.backend.path_of(key),
            bytes=sum(int(f.get("bytes", 0)) for f in files.values()),
            created=float(manifest.get("created", 0.0)),
            files=len(files), meta=meta)

    def get(self, key: str, verify: bool = True) -> Optional[str]:
        """Local path of a verified artifact, or None on miss.

        verify=True re-hashes every payload file against the manifest;
        verify=False checks existence + sizes only (the feature cache's
        `verify="auto"` warm path). A prefetch in flight for the key is
        joined first — its streaming read already paid for the hashes,
        so a verified prefetch upgrades this get to the cheap path.
        """
        if not self.backend.exists(key):
            self._m_miss.inc()
            return None
        with self._lock:
            thread = self._inflight.get(key)
        if thread is not None:
            thread.join()
        with self._lock:
            # consume the marker: a prefetch vouches for exactly ONE
            # read — later gets re-verify (the tape may have rotted
            # since)
            pre = self._prefetched.pop(key, False)
        if pre not in (False, None):  # prefetch found corruption
            self._m_corrupt.inc()
            raise StoreCorruptError(self.backend.path_of(key), pre, key)
        path = self.backend.path_of(key)
        manifest = self.manifest(key)
        for name, entry in manifest["files"].items():
            p = os.path.join(path, name)
            if not os.path.isfile(p):
                self._m_corrupt.inc()
                raise StoreCorruptError(path, f"missing file {name}", key)
            size = os.path.getsize(p)
            if size != int(entry.get("bytes", -1)):
                self._m_corrupt.inc()
                raise StoreCorruptError(
                    path, f"{name} truncated or resized: {size} bytes on "
                    f"disk, {entry.get('bytes')} recorded", key)
            if verify and pre is not None:  # None == prefetch verified it
                if sha256_file(p) != entry.get("sha256"):
                    self._m_corrupt.inc()
                    raise StoreCorruptError(
                        path, f"checksum mismatch for {name}", key)
        self._m_hit.inc()
        self._touch(key)
        return path

    def delete(self, key: str) -> None:
        self.backend.remove(key)
        with self._lock:
            self._prefetched.pop(key, None)
        self._drop_touch(key)

    def keys(self) -> List[str]:
        return self.backend.keys()

    # -- prefetch -------------------------------------------------------- #

    def prefetch(self, key: str) -> Optional[threading.Thread]:
        """Stream an artifact's payload through the page cache (and
        through sha256) on a named daemon thread, ahead of its first
        consumer read. `get` joins the stream and skips re-hashing.
        Returns the thread, or None when the artifact is absent."""
        if not self.backend.exists(key):
            return None
        with self._lock:
            thread = self._inflight.get(key)
            if thread is not None:
                return thread
            thread = threading.Thread(
                target=self._prefetch_run, args=(key,),
                name=f"store-prefetch-{key[:16]}", daemon=True)
            self._inflight[key] = thread
        thread.start()
        return thread

    def _prefetch_run(self, key: str) -> None:
        verdict: Optional[str] = None  # None == verified clean
        try:
            path = self.backend.path_of(key)
            manifest = self.manifest(key)
            for name, entry in manifest["files"].items():
                p = os.path.join(path, name)
                if (not os.path.isfile(p)
                        or os.path.getsize(p) != int(entry.get("bytes", -1))):
                    verdict = f"missing or short file {name}"
                    break
                if sha256_file(p) != entry.get("sha256"):
                    verdict = f"checksum mismatch for {name}"
                    break
            else:
                self._m_prefetch.inc()
        except StoreCorruptError as e:
            verdict = e.reason
        except OSError as e:
            verdict = f"unreadable during prefetch: {e}"
        finally:
            with self._lock:
                self._prefetched[key] = verdict
                self._inflight.pop(key, None)

    # -- eviction / GC --------------------------------------------------- #

    def _touch_path(self, key: str) -> str:
        root = getattr(self.backend, "root", None)
        if root is None:
            return ""
        return os.path.join(root, _ACCESS_DIR, key)

    def _touch(self, key: str) -> None:
        p = self._touch_path(key)
        if not p:
            return
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "a"):
                os.utime(p, None)
        except OSError:
            log.debug("store access touch failed for %s", key)

    def _drop_touch(self, key: str) -> None:
        p = self._touch_path(key)
        if p:
            try:
                os.unlink(p)
            except OSError:
                pass

    def _last_access(self, key: str, info: ArtifactInfo) -> float:
        p = self._touch_path(key)
        if p:
            try:
                return os.path.getmtime(p)
            except OSError:
                pass
        return info.created

    def gc(self, ttl_s: Optional[float] = None,
           max_bytes: Optional[int] = None) -> Dict[str, Any]:
        """TTL sweep, then LRU eviction down to the byte budget.

        Last access comes from the touch sidecars (falling back to the
        manifest's created stamp), so a replica that keeps replaying a
        tape keeps it resident while one-shot artifacts age out. Also
        finishes any half-removed victims left in `.gc/` by a crashed
        remover.
        """
        ttl_s = self.ttl_s if ttl_s is None else ttl_s
        max_bytes = self.max_bytes if max_bytes is None else max_bytes
        t0 = time.monotonic()
        root = getattr(self.backend, "root", None)
        if root:
            shutil.rmtree(os.path.join(root, _GC_DIR), ignore_errors=True)
        entries = []
        evicted: List[str] = []
        for key in self.backend.keys():
            try:
                info = self.stat(key)
            except StoreCorruptError:
                # structurally broken artifacts are dead weight: reclaim
                self.delete(key)
                evicted.append(key)
                continue
            if info is None:
                continue
            entries.append((self._last_access(key, info), info))
        now = time.time()
        live: List = []
        for atime, info in sorted(entries):  # oldest-access first
            if ttl_s is not None and now - atime > ttl_s:
                self.delete(info.key)
                evicted.append(info.key)
            else:
                live.append((atime, info))
        if max_bytes is not None:
            total = sum(info.bytes for _, info in live)
            for atime, info in list(live):
                if total <= max_bytes:
                    break
                self.delete(info.key)
                evicted.append(info.key)
                live.remove((atime, info))
                total -= info.bytes
        self._m_evict.inc(len(evicted))
        return {
            "evicted": evicted,
            "kept": len(live),
            "bytes": sum(info.bytes for _, info in live),
            "gc_s": round(time.monotonic() - t0, 6),
        }
