"""Artifact-integrity primitives of the columnar store: chunked sha256
checksums for its manifest, fsync of files and directories, and the
staged-directory commit its append segments go through.

The port's own copy of the four helpers of the JAX package's
`runtime/integrity.py` that `data/columnar_store.py` needs, line for line:
the port imports nothing of the JAX package."""

from __future__ import annotations

import hashlib
import logging
import os
import shutil

__all__ = ["sha256_file", "fsync_file", "fsync_dir", "commit_staged_dir"]

log = logging.getLogger(__name__)


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Chunked sha256 of a file's bytes (bounded memory for multi-GB
    artifacts)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durable directory entry (rename/create visibility). Best-effort:
    not every platform lets you fsync a directory fd."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        log.debug("directory fsync unsupported for %s", path)
    finally:
        os.close(fd)


def commit_staged_dir(tmp: str, final: str) -> None:
    """Atomically swap a fully staged (fsynced, integrity-manifest-last)
    directory into place. A displaced existing `final` is renamed ASIDE
    first and deleted only after the replacement is live — a crash at
    any instruction leaves either the old artifact, the new one, or
    both recoverable, never a torn mix. Finishes with a parent-dir
    fsync so the rename itself is durable."""
    if os.path.exists(final):
        old = f"{final}.old-{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        try:
            os.rename(tmp, final)
        except BaseException:
            try:
                os.rename(old, final)  # restore the displaced artifact
            except OSError:
                # `final` was repopulated by a concurrent committer
                # while we held the displaced copy (the rename race this
                # commit just lost): the new artifact wins — drop the
                # displaced copy instead of stranding a multi-GB
                # `.old-<pid>` dir forever, and let the ORIGINAL commit
                # error propagate, not the restore's ENOTEMPTY
                shutil.rmtree(old, ignore_errors=True)
            raise
        shutil.rmtree(old, ignore_errors=True)
    else:
        parent = os.path.dirname(final)
        if parent:
            os.makedirs(parent, exist_ok=True)
        os.rename(tmp, final)
    fsync_dir(os.path.dirname(os.path.abspath(final)))
