"""Load-side decoding of serialized extract functions.

The port's copy of the JAX package's `utils/fnser.py` decode half. Three
persisted forms exist, most-stable first:

1. ``{"__pyregistry__": name}`` — resolved through `extract_fn`'s
   registry (the defining module must be imported before loading);
2. ``{"__pyref__": "module:qualname"}`` — an importable module-level
   function;
3. ``{"__pyfn__": base64}`` — a cloudpickle payload (lambdas and
   closures). Decoding it needs `cloudpickle`; where that package is
   absent, loading such a model raises.
"""

from __future__ import annotations

import base64
import importlib
from typing import Any, Callable, Dict, Optional

_REF_KEY = "__pyref__"
_PICKLE_KEY = "__pyfn__"
_REG_KEY = "__pyregistry__"

_EXTRACT_REGISTRY: Dict[str, Callable] = {}


def extract_fn(name: str) -> Callable[[Callable], Callable]:
    """Decorator registering a stable name for an extract function."""
    def deco(fn: Callable) -> Callable:
        existing = _EXTRACT_REGISTRY.get(name)
        if existing is not None and existing is not fn:
            raise ValueError(f"extract_fn name {name!r} already registered")
        _EXTRACT_REGISTRY[name] = fn
        fn.__extract_name__ = name
        return fn
    return deco


def registered_fn(name: str) -> Callable:
    if name not in _EXTRACT_REGISTRY:
        raise KeyError(
            f"extract fn {name!r} is not registered; import the module "
            f"that defines it (with its @extract_fn decorator) before "
            f"loading this model")
    return _EXTRACT_REGISTRY[name]


def decode_fn(obj: Any) -> Optional[Callable]:
    if obj is None or callable(obj):
        return obj
    if isinstance(obj, dict):
        if _REG_KEY in obj:
            return registered_fn(obj[_REG_KEY])
        if _REF_KEY in obj:
            mod, qual = obj[_REF_KEY].split(":", 1)
            target: Any = importlib.import_module(mod)
            for part in qual.split("."):
                target = getattr(target, part)
            return target
        if _PICKLE_KEY in obj:
            try:
                import cloudpickle
            except ImportError as e:
                raise ImportError(
                    "this model carries a pickled extract function "
                    "(a lambda or closure); loading it needs cloudpickle, "
                    "which is not installed") from e
            return cloudpickle.loads(base64.b64decode(obj[_PICKLE_KEY]))
    if isinstance(obj, str) and ":" in obj:  # legacy module:qualname string
        return decode_fn({_REF_KEY: obj})
    raise TypeError(f"Cannot decode function from {type(obj).__name__}")
