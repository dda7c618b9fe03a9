"""The port's shared on-disk plane: the content-addressed artifact store
(`artifact.py`), the resolution point for shared directories
(`config.py`) and CAS-guarded mutable state (`state.py`: `StateCell`,
`LeaseTable`, `SharedQuota`), each the port's own copy of the JAX
package's module (`state.py` without its stale-claim fault, ROADMAP F7).
"""

from transmogrifai_tpu_torch.store.artifact import (
    MANIFEST, STORE_VERSION, ArtifactInfo, ArtifactStore, Backend,
    LocalDirBackend, StoreCorruptError)
from transmogrifai_tpu_torch.store.config import (
    ENV_STORE, cache_root, resolve_dir, store_configured)
from transmogrifai_tpu_torch.store.state import (
    LeaseTable, SharedQuota, StateCell)

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
    "LeaseTable",
    "SharedQuota",
    "StateCell",
]
