"""Arithmetic transformers over numeric features.

The port's counterpart of the JAX package's `ops/mathops.py` (the
reference's `MathTransformers.scala` through `RichNumericFeature`), with
the same missing-value rules:

- plus/minus: present if EITHER side is present (a one-sided sum gives
  that side, a one-sided difference its negation);
- multiply/divide: both sides required; a non-finite result (divide by
  zero, overflow) is missing;
- unary ops keep the input mask and drop non-finite outputs (the log of a
  non-positive value, the square root of a negative one).

Each op is elementwise torch on the value/mask pair (masks are f32 0/1,
the port's device contract) with Python scalars rounded to f32, as the
JAX package's weakly typed scalars are; a division by a constant rounds
as `div_const` says.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.stages.base import Transformer, div_const

_BINARY_OPS = ("plus", "minus", "multiply", "divide")
_UNARY_OPS = ("abs", "ceil", "floor", "round", "exp", "sqrt", "log", "power",
              "negate")


def _finite_mask(value: torch.Tensor, mask: torch.Tensor):
    """(value with non-finite cells 0, mask without them) as f32."""
    ok = torch.isfinite(value)
    return (torch.where(ok, value, 0.0),
            (mask & ok).to(torch.float32))


def _nan_where_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0.0, float("nan"), x)


class BinaryMathTransformer(Transformer):
    """feature ⊕ feature → Real (op in plus/minus/multiply/divide)."""

    in_types = (T.OPNumeric, T.OPNumeric)
    out_type = T.Real

    def __init__(self, op: str, uid: Optional[str] = None):
        if op not in _BINARY_OPS:
            raise ValueError(f"unknown binary math op {op!r}")
        super().__init__(uid=uid, op=op)
        self.op = op

    @property
    def operation_name(self) -> str:
        return self.op

    def device_apply(self, enc, dev):
        (x, mx), (y, my) = ((d["value"], d["mask"]) for d in dev)
        mx, my = mx.bool(), my.bool()
        if self.op in ("plus", "minus"):
            a, b = torch.where(mx, x, 0.0), torch.where(my, y, 0.0)
            return {"value": a + b if self.op == "plus" else a - b,
                    "mask": (mx | my).to(torch.float32)}
        if self.op == "multiply":
            v, m = _finite_mask(x * y, mx & my)
        else:
            v, m = _finite_mask(x / _nan_where_zero(y), mx & my)
        return {"value": v, "mask": m}


class ScalarMathTransformer(Transformer):
    """feature ⊕ scalar → Real (ScalarAdd/Subtract/Multiply/Divide; the
    r-variants put the scalar on the left of a non-commutative op)."""

    _OPS = _BINARY_OPS + ("rminus", "rdivide")

    in_types = (T.OPNumeric,)
    out_type = T.Real

    def __init__(self, op: str, scalar: float, uid: Optional[str] = None):
        if op not in self._OPS:
            raise ValueError(f"unknown scalar math op {op!r}")
        super().__init__(uid=uid, op=op, scalar=float(scalar))
        self.op = op
        self.scalar = float(scalar)

    @property
    def operation_name(self) -> str:
        return f"{self.op}S"

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        s = float(np.float32(self.scalar))
        if self.op == "plus":
            v = x + s
        elif self.op == "minus":
            v = x - s
        elif self.op == "rminus":
            v = s - x
        elif self.op == "multiply":
            v = x * s
        elif self.op == "rdivide":  # a true division (`s / t` is a reciprocal)
            v = torch.full_like(x, s) / _nan_where_zero(x)
        else:
            v = div_const(x, self.scalar) if self.scalar != 0.0 \
                else torch.full_like(x, float("nan"))
        v, m = _finite_mask(v, m)
        return {"value": v, "mask": m}


class UnaryMathTransformer(Transformer):
    """Elementwise unary op → Real: abs/ceil/floor/round/exp/sqrt/log/
    power/negate. `arg` is the log base (e when not positive) or the
    power's exponent."""

    in_types = (T.OPNumeric,)
    out_type = T.Real

    def __init__(self, op: str, arg: float = 0.0, uid: Optional[str] = None):
        if op not in _UNARY_OPS:
            raise ValueError(f"unknown unary math op {op!r}")
        super().__init__(uid=uid, op=op, arg=float(arg))
        self.op = op
        self.arg = float(arg)

    @property
    def operation_name(self) -> str:
        return self.op

    def device_apply(self, enc, dev):
        x, m = dev[0]["value"], dev[0]["mask"].bool()
        op = self.op
        if op == "abs":
            v = torch.abs(x)
        elif op == "ceil":
            v = torch.ceil(x)
        elif op == "floor":
            v = torch.floor(x)
        elif op == "round":
            v = torch.round(x)
        elif op == "exp":
            v = torch.exp(x)
        elif op == "sqrt":
            v = torch.sqrt(x)
        elif op == "negate":
            v = -x
        elif op == "log":
            # log(base) in f32, as the JAX package divides by jnp.log(base)
            base = self.arg if self.arg > 0 else math.e
            v = div_const(torch.log(torch.where(x > 0, x, float("nan"))),
                          np.log(np.float32(base)))
        else:
            v = torch.pow(x, float(np.float32(self.arg)))
        v, m = _finite_mask(v, m)
        return {"value": v, "mask": m}
