"""One resolution point for every shared on-disk location.

The port's own copy of the JAX package's `store/config.py`, with the same
environment variables and the same precedence, so one cache directory
serves both packages (a feature-cache artifact written by either is a hit
for the other): `TRANSMOGRIFAI_STORE_DIR` moves the whole root, and each
subsystem's own variable (`TRANSMOGRIFAI_FEATURE_CACHE_DIR`, ...) still
wins for its own subtree.
"""

from __future__ import annotations

import os

__all__ = [
    "ENV_STORE",
    "cache_root",
    "resolve_dir",
    "store_configured",
]

ENV_STORE = "TRANSMOGRIFAI_STORE_DIR"

# subsystem env overrides, kept here so callers and docs agree on the
# precedence order: explicit arg > subsystem env > store root env > HOME
ENV_FEATURE_CACHE = "TRANSMOGRIFAI_FEATURE_CACHE_DIR"
ENV_PERF_CORPUS = "TRANSMOGRIFAI_PERF_CORPUS_DIR"
ENV_COMPILE_CACHE = "TRANSMOGRIFAI_TPU_CACHE"


def store_configured() -> bool:
    """True when a shared store root was explicitly pointed somewhere —
    the signal consumers use to ALSO publish replica-portable artifacts
    (warmup manifests, corpus shards) instead of only local sidecars."""
    return bool(os.environ.get(ENV_STORE))


def cache_root() -> str:
    env = os.environ.get(ENV_STORE)
    if env:
        return env
    return os.path.expanduser("~/.cache/transmogrifai_tpu")


def resolve_dir(kind: str, env: str | None = None,
                explicit: str | None = None) -> str:
    """Resolve the directory for one artifact kind.

    Precedence: explicit caller arg, then the subsystem's own env var,
    then `<store root>/<kind>` (where the store root itself honors
    `TRANSMOGRIFAI_STORE_DIR` before falling back to the home cache).
    """
    if explicit:
        return explicit
    if env:
        val = os.environ.get(env)
        if val:
            return val
    return os.path.join(cache_root(), kind)
