"""The port's shared on-disk plane: the content-addressed artifact store
(`artifact.py`) and the resolution point for shared directories
(`config.py`), each the port's own copy of the JAX package's module.

The JAX package's `store/state.py` (`StateCell`, `SharedQuota`,
`LeaseTable`) is not ported: it waits for the multi-GPU work (ROADMAP
queue 1, item 9), which must not copy its stale-claim fault (ROADMAP F7).
"""

from transmogrifai_tpu_torch.store.artifact import (
    MANIFEST, STORE_VERSION, ArtifactInfo, ArtifactStore, Backend,
    LocalDirBackend, StoreCorruptError)
from transmogrifai_tpu_torch.store.config import (
    ENV_STORE, cache_root, resolve_dir, store_configured)

__all__ = [
    "MANIFEST",
    "STORE_VERSION",
    "ArtifactInfo",
    "ArtifactStore",
    "Backend",
    "LocalDirBackend",
    "StoreCorruptError",
    "ENV_STORE",
    "cache_root",
    "resolve_dir",
    "store_configured",
]
