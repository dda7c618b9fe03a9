"""L-BFGS with a zoom line search, batched over a leading pair axis.

The port's counterpart of `optax.lbfgs()` as the JAX package calls it
(`models/logistic.py`, `models/linear_svc.py`, `models/glm.py`): optax's
algorithm (`scale_by_lbfgs` chained with `scale_by_zoom_linesearch`, optax
0.2.6), not `torch.optim.LBFGS`, whose line search differs. Settings:

- memory 10, the identity scaled by ⟨Δu, Δw⟩/‖Δu‖² (at the first step by
  min(1, 1/‖g‖));
- the zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6) with
  at most 20 steps from the initial step 1, increase factor 2, slope
  tolerance 1e-4, curvature tolerance 0.9, approximate-decrease tolerance
  1e-6, interval threshold 1e-5, and optax's safe step when it fails;
- exactly `max_iter` outer steps with no early exit, as the JAX package's
  `lax.scan` runs; the value and gradient at the new point come from the
  line search.

One deviation from optax's arithmetic: the zoom phase's cubic and
quadratic interpolation runs in f64 and its trial step is rounded to f32.
In f32 the cubic's −B + √(B² − 3AC) cancels when the cubic term is small
(a badly scaled objective), and its value is then a few ulps of B over 3A:
one ulp more or less in a trial's loss decides whether that noise lands
inside the interval. In f64 the interpolation is what it approximates, so
the two packages agree wherever optax's f32 noise falls outside the
interval, as it mostly does.

P problems are solved at once: parameters are (P, D) rows, one per pair,
and `value_and_grad(x)` returns the P losses (P,) and their gradients
(P, D). Each pair's line search stops on its own; a stopped pair is
masked, as a vmapped `while_loop` masks it. Every product runs in exact
f32 (the port never enables TF32).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _decrease_error(step, value, slope, value0, slope0):
    """optax's sufficient-decrease error (Armijo, or the approximate
    Wolfe test of Hager and Zhang), clamped at 0, NaN → inf."""
    err = value - value0 - _SLOPE_RTOL * step * slope0
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope0
    delta = value - value0 - _APPROX_DEC_RTOL * torch.abs(value0)
    err = torch.minimum(torch.maximum(approx, delta), err)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _curvature_error(slope, slope0):
    err = torch.clamp(torch.abs(slope) - _CURV_RTOL * torch.abs(slope0),
                      min=0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                       err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom_middle(low, v_low, s_low, high, v_high, cref, v_cref):
    """The zoom phase's next trial inside [low, high]: the cubic's
    minimizer if it lies 20% inside the interval, else the quadratic's if
    10% inside, else the midpoint (optax's `_zoom_into_interval`)."""
    delta = torch.abs(high - low)
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    cubic = _cubicmin(low, v_low, s_low, high, v_high, cref, v_cref)
    use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
    quad = _quadmin(low, v_low, s_low, high, v_high)
    use_quad = ~use_cubic & (quad > left + 0.1 * delta) \
        & (quad < right - 0.1 * delta)
    middle = torch.where(use_cubic, cubic, cref)
    middle = torch.where(use_quad, quad, middle)
    return torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)


def _pick(cond, new, old):
    """Per pair: `new` where cond holds, else `old` (rows of (P, D) too)."""
    if new.dim() > cond.dim():
        cond = cond[:, None]
    return torch.where(cond, new, old)


def zoom_linesearch(value_and_grad: ValueAndGrad, x: torch.Tensor,
                    d: torch.Tensor, value0: torch.Tensor,
                    grad0: torch.Tensor,
                    max_steps: int = MAX_LINESEARCH_STEPS):
    """Per pair, a step size along d from x (optax's
    `scale_by_zoom_linesearch` with `initial_guess_strategy="one"`).
    Returns (step (P,), value (P,) and gradient (P, D) at x + step·d)."""
    P = x.shape[0]
    f32 = dict(dtype=x.dtype, device=x.device)
    zero = torch.zeros(P, **f32)
    inf = torch.full((P,), float("inf"), **f32)
    false = torch.zeros(P, dtype=torch.bool, device=x.device)
    slope0 = _dot(d, grad0)
    s = {"step": zero, "value": value0, "grad": grad0, "slope": slope0,
         "dec": inf, "curv": inf, "found": false, "done": false,
         "failed": false, "low": zero, "v_low": value0, "s_low": slope0,
         "high": zero, "v_high": value0, "s_high": slope0, "cref": zero,
         "v_cref": value0, "safe": zero, "v_safe": value0, "g_safe": grad0}
    for it in range(max_steps):
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            break
        # the trial step: the search phase doubles the previous step (the
        # first trial is 1); the zoom phase interpolates inside the interval
        search_step = torch.full_like(zero, 1.0) if it == 0 \
            else _INCREASE_FACTOR * s["step"]
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        middle = _zoom_middle(*(s[k].double() for k in (
            "low", "v_low", "s_low", "high", "v_high", "cref", "v_cref"))
        ).to(x.dtype)
        found = s["found"]
        step = torch.where(found, middle, search_step)

        value, grad = value_and_grad(x + step[:, None] * d)
        slope = _dot(grad, d)
        dec = _decrease_error(step, value, slope, value0, slope0)
        curv = _curvature_error(slope, slope0)
        err = torch.maximum(dec, curv)
        ok = err <= 0.0
        last = it + 1 >= max_steps

        # search phase (algorithm 3.5)
        safe_dec = dec <= 0.0
        hi_new = dec > 0.0
        if it > 0:
            hi_new = hi_new | (value >= s["value"])
        lo_new = (slope >= 0.0) & ~hi_new
        sr = {"low": _pick(lo_new, step, s["step"]),
              "v_low": _pick(lo_new, value, s["value"]),
              "s_low": _pick(lo_new, slope, s["slope"]),
              "high": _pick(lo_new, s["step"], step),
              "v_high": _pick(lo_new, s["value"], value),
              "s_high": _pick(lo_new, s["slope"], slope)}
        sr.update(cref=sr["low"], v_cref=sr["v_low"],
                  found=hi_new | lo_new | ok, done=ok,
                  failed=torch.full_like(ok, last) & ~ok,
                  safe=_pick(safe_dec, step, s["safe"]),
                  v_safe=_pick(safe_dec, value, s["v_safe"]),
                  g_safe=_pick(safe_dec, grad, s["g_safe"]))

        # zoom phase (algorithm 3.6)
        upd_safe = safe_dec & (value < s["v_safe"])
        new_safe = _pick(upd_safe, step, s["safe"])
        hi_mid = (dec > 0.0) | (value >= s["v_low"])
        hi_low = (slope * (high - low) >= 0.0) & ~hi_mid
        h1 = _pick(hi_mid, step, high)
        vh1 = _pick(hi_mid, value, s["v_high"])
        sh1 = _pick(hi_mid, slope, s["s_high"])
        moved = hi_mid | hi_low
        zr = {"high": _pick(hi_low, low, h1),
              "v_high": _pick(hi_low, s["v_low"], vh1),
              "s_high": _pick(hi_low, s["s_low"], sh1),
              "low": _pick(~hi_mid, step, low),
              "v_low": _pick(~hi_mid, value, s["v_low"]),
              "s_low": _pick(~hi_mid, slope, s["s_low"]),
              "cref": _pick(moved, high, low),
              "v_cref": _pick(moved, s["v_high"], s["v_low"]),
              "found": found, "done": ok,
              "failed": (torch.full_like(ok, last)
                         | ((delta <= _INTERVAL_THRESHOLD)
                            & (new_safe > 0.0))) & ~ok,
              "safe": new_safe,
              "v_safe": _pick(upd_safe, value, s["v_safe"]),
              "g_safe": _pick(upd_safe, grad, s["g_safe"])}

        new = {k: _pick(found, zr[k], sr[k]) for k in sr}
        new.update(step=step, value=value, grad=grad, slope=slope, dec=dec,
                   curv=curv)
        # a failed search falls back on the best step with sufficient
        # decrease, or stays where it is when there is none
        use_safe = new["failed"] & ((new["safe"] > 0.0)
                                    | torch.isinf(new["dec"]))
        new["step"] = _pick(use_safe, new["safe"], new["step"])
        new["value"] = _pick(use_safe, new["v_safe"], new["value"])
        new["grad"] = _pick(use_safe, new["g_safe"], new["grad"])
        s = {k: _pick(active, new[k], s[k]) for k in s}
    return s["step"], s["value"], s["grad"]


def minimize(value_and_grad: ValueAndGrad, x0: torch.Tensor, max_iter: int,
             memory_size: int = MEMORY_SIZE) -> torch.Tensor:
    """`max_iter` L-BFGS steps from x0 (P, D) for P problems at once;
    returns the parameters (P, D) after the last step."""
    P, D = x0.shape
    x = x0.clone()
    f32 = dict(dtype=x0.dtype, device=x0.device)
    dw_mem = torch.zeros((memory_size, P, D), **f32)
    du_mem = torch.zeros((memory_size, P, D), **f32)
    rho = torch.zeros((memory_size, P), **f32)
    prev_x = torch.zeros_like(x)
    prev_g = torch.zeros_like(x)
    value = torch.full((P,), float("inf"), **f32)
    grad = torch.zeros_like(x)
    for k in range(max_iter):
        # the line search's value and gradient, recomputed where not finite
        bad = ~torch.isfinite(value)
        if bool(bad.any()):
            v, g = value_and_grad(x)
            value = torch.where(bad, v, value)
            grad = _pick(bad, g, grad)
        if k > 0:
            dw, du = x - prev_x, grad - prev_g
            vd = _dot(du, dw)
            slot = (k - 1) % memory_size
            dw_mem[slot], du_mem[slot] = dw, du
            rho[slot] = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            den = _dot(du, du)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=1),
                                max=1.0)
        # two-loop recursion over the slots written so far, newest first
        cur = k % memory_size
        order = [(cur + i) % memory_size for i in range(memory_size)]
        used = [i for i in order if (i < k if k < memory_size else True)]
        q = grad
        alphas = {}
        for i in reversed(used):
            alphas[i] = rho[i] * _dot(dw_mem[i], q)
            q = q - alphas[i][:, None] * du_mem[i]
        q = scale[:, None] * q
        for i in used:
            beta = rho[i] * _dot(du_mem[i], q)
            q = q + (alphas[i] - beta)[:, None] * dw_mem[i]
        prev_x, prev_g = x, grad
        d = -q
        step, value, grad = zoom_linesearch(value_and_grad, x, d, value,
                                            grad)
        x = x + step[:, None] * d
    return x
