"""The port's L-BFGS (`models/lbfgs.py`, optax's `lbfgs()` with its zoom
line search, batched over pairs) and the fits built on it — pure-L2
logistic regression, linear SVC and every GLM family/link pair — against
the JAX package's optax fits on the same seeded inputs.

Tolerances: on well-conditioned problems (n = 300, d = 8, standardized
features, reg_param 0.01, 100 steps) the converged coefficients (weights
and intercepts) agree within 1e-4 relative (max |Δ| over max
|coefficient|) and the losses within 1e-6 relative. The two run the same
algorithm in f32 with sums in other orders, so per-step states agree
only to rounding; on a badly conditioned problem the paths part after
some steps (F5), which is why only converged fits are held tightly. A
line search from the same point picks the same step within 1e-6
relative, and on the selectors' real matrices (Titanic, Boston) optax's
update from the port's own state lands, at every step, within 5e-2 of a
step length of the port's next iterate (median 1e-5).

`JAX_PLATFORMS=cpu python tests/test_torch_lbfgs.py readings` prints
those step gaps for every fit of the Titanic and Boston runs, where the
two packages' paths part, and how far the fold metrics of each lie from
the JAX package's sweep over 24 seeds of input noise; `... readings KIND
...` prints only the fold-metric moves of the named runs (`jax_one_ulp`,
`jax_columns_permuted`, `port_one_ulp` and `port_variant`'s kinds)."""

import contextlib
import os
import sys
import zlib

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

N, D, STEPS, REG = 300, 8, 100, 0.01


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _coef(*parts):
    """Every coefficient of a fit (weights and intercepts) as one vector."""
    return np.concatenate([np.ravel(np.asarray(p, np.float64))
                           for p in parts])


def _data(seed, kind="binary"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    beta = rng.normal(size=D) * 0.5
    eta = X @ beta
    if kind == "binary":
        y = (eta + rng.logistic(size=N) > 0).astype(np.float32)
    elif kind == "multinomial":
        y = np.argmax(X[:, :3] + rng.gumbel(size=(N, 3)), 1).astype(
            np.float32)
    else:
        y = eta.astype(np.float32)
    return X, y


@pytest.mark.parametrize("kind,k", [("binary", 2), ("multinomial", 3)])
def test_fit_logreg_converges_like_optax(kind, k):
    import jax.numpy as jnp
    from transmogrifai_tpu.models import logistic as jl
    from transmogrifai_tpu_torch.models import logistic as pl

    X, y = _data(1 if kind == "binary" else 2, kind)
    w = np.ones(N, np.float32)
    want = jl.fit_logreg(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                         jnp.float32(REG), k, STEPS)
    got = pl.fit_logreg(torch.from_numpy(X), torch.from_numpy(y),
                        torch.from_numpy(w), REG, k, STEPS)
    assert got["W"].shape == (1, D, k) and got["b"].shape == (1, k)
    assert _rel(_coef(got["W"][0], got["b"][0]),
                _coef(want["W"], want["b"])) <= 1e-4
    Y = np.eye(k, dtype=np.float32)[y.astype(int)]
    loss = pl.logreg_loss(got, torch.from_numpy(X), torch.from_numpy(Y),
                          torch.from_numpy(w)[None], torch.tensor(REG))
    jloss = jl.logreg_loss(want, jnp.asarray(X), jnp.asarray(Y),
                           jnp.asarray(w), jnp.float32(REG))
    assert abs(float(loss[0]) - float(jloss)) <= 1e-6 * abs(float(jloss))


def test_fit_logreg_pairs_each_equal_their_own_fit():
    """P pairs at once (other weights, other l2) equal one fit each: the
    line searches of the pairs stop on their own and are masked."""
    from transmogrifai_tpu_torch.models import logistic as pl

    X, y = _data(3, "multinomial")
    rng = np.random.default_rng(4)
    w = (rng.random((3, N)) < 0.7).astype(np.float32)
    l2 = [0.001, 0.05, 0.3]
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    both = pl.fit_logreg(Xt, yt, torch.from_numpy(w), l2, 3, 30)
    for q in range(3):
        one = pl.fit_logreg(Xt, yt, torch.from_numpy(w[q]), l2[q], 3, 30)
        assert _rel(both["W"][q], one["W"][0]) <= 1e-5


def test_fit_linear_svc_converges_like_optax():
    import jax.numpy as jnp
    from transmogrifai_tpu.models import linear_svc as js
    from transmogrifai_tpu_torch.models import linear_svc as ps

    X, y = _data(5, "binary")
    w = np.ones(N, np.float32)
    want = js.fit_linear_svc(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                             jnp.float32(REG), STEPS)
    got = ps.fit_linear_svc(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(w), REG, STEPS)
    assert _rel(_coef(got["beta"][0], got["b"][0]),
                _coef(want["beta"], want["b"])) <= 1e-4


def _glm_labels(family, link, X, rng):
    """Labels in the family's support whose mean the link reaches."""
    eta = 0.3 * X[:, :3].sum(1)
    if family == "binomial":
        return (rng.random(N) < 1 / (1 + np.exp(-eta))).astype(np.float32)
    if family in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.5 + eta * 0.5)).astype(np.float32)
    if family == "gamma":
        return rng.gamma(2.0, np.exp(0.5 + 0.3 * eta) / 2.0).astype(
            np.float32)
    base = 3.0 if link in ("log", "inverse") else 0.0
    return (base + eta + 0.3 * rng.normal(size=N)).astype(np.float32)


def _glm_cases():
    from transmogrifai_tpu_torch.models.glm import VALID_LINKS
    return [(f, ln) for f, links in VALID_LINKS.items() for ln in links]


@pytest.mark.parametrize("family,link", _glm_cases())
def test_fit_glm_converges_like_optax(family, link):
    import jax.numpy as jnp
    from transmogrifai_tpu.models import glm as jg
    from transmogrifai_tpu_torch.models import glm as pg

    rng = np.random.default_rng(zlib.crc32(f"{family}/{link}".encode()))
    X = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
    y = _glm_labels(family, link, X, rng)
    w = np.ones(N, np.float32)
    want = jg.fit_glm(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                      jnp.float32(REG), family, STEPS, 1.5, link)
    got = pg.fit_glm(torch.from_numpy(X), torch.from_numpy(y),
                     torch.from_numpy(w), REG, family, STEPS, 1.5, link)
    assert _rel(_coef(got["beta"][0], got["b"][0]),
                _coef(want["beta"], want["b"])) <= 1e-4, (family, link)
    # the same loss at the optimum
    Xt = torch.from_numpy(X)
    eta = Xt @ got["beta"][0] + got["b"][0]
    mu = pg._inverse_link(family, eta, link, 1.5)
    mine = float((pg._neg_log_likelihood(family, mu, torch.from_numpy(y))
                  .mean() + 0.5 * REG * (got["beta"][0] ** 2).sum()))
    jeta = jnp.asarray(X) @ want["beta"] + want["b"]
    jmu = jg._inverse_link(family, jeta, link, 1.5)
    theirs = float(jg._neg_log_likelihood(family, jmu, jnp.asarray(y))
                   .mean() + 0.5 * REG * (want["beta"] ** 2).sum())
    assert abs(mine - theirs) <= 1e-6 * abs(theirs)


def test_glm_rejects_invalid_links_and_loads_legacy_manifests():
    from transmogrifai_tpu_torch.models.glm import (
        GLMModel, OpGeneralizedLinearRegression)

    with pytest.raises(ValueError, match="invalid for family"):
        OpGeneralizedLinearRegression(family="poisson", link="logit")
    with pytest.raises(ValueError, match="family must be one of"):
        OpGeneralizedLinearRegression(family="cauchy")
    assert GLMModel([0.0], 0.0, family="gamma").link == "log"
    assert GLMModel([0.0], 0.0, family="tweedie").link == "log"


def test_converged_pair_stays_finite_beside_a_live_pair():
    """A pair whose gradient is zero from the start (all weights zero and
    no penalty pull) stays finite and at zero, as optax's does, while
    the pair beside it fits as it would alone."""
    from transmogrifai_tpu_torch.models import logistic as pl

    X, y = _data(6, "binary")
    w = np.stack([np.zeros(N), np.ones(N)]).astype(np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    both = pl.fit_logreg(Xt, yt, torch.from_numpy(w), REG, 2, 20)
    assert torch.isfinite(both["W"]).all() and torch.isfinite(both["b"]).all()
    assert float(both["W"][0].abs().max()) == 0.0
    one = pl.fit_logreg(Xt, yt, torch.from_numpy(w[1]), REG, 2, 20)
    assert _rel(both["W"][1], one["W"][0]) <= 1e-6


@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_zoom_linesearch_picks_optax_step(scale):
    """One line search from the same point and direction (a least-squares
    loss; `scale` badly scales one column, where the cubic interpolation
    cancels in f32): the step optax takes."""
    import jax
    import jax.numpy as jnp
    from optax._src import linesearch as ols
    from transmogrifai_tpu_torch.models import lbfgs

    rng = np.random.default_rng(7)
    X = rng.normal(size=(60, 4)).astype(np.float32)
    X[:, 0] *= scale
    y = (X @ np.array([1.0, -2.0, 0.5, 0.0], np.float32) / scale
         + 0.1 * rng.normal(size=60)).astype(np.float32)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def loss(p):
        return 0.5 * jnp.mean((Xj @ p - yj) ** 2)

    p0 = jnp.zeros(4, jnp.float32)
    v0, g0 = jax.value_and_grad(loss)(p0)
    d = -g0 / jnp.maximum(jnp.linalg.norm(g0), 1.0)
    init, step, cond = ols.zoom_linesearch(20)
    st = init(d, p0, value=v0, grad=g0, prev_stepsize=1.0,
              initial_guess_strategy="one")
    while bool(cond(st)):
        st = step(st, value_and_grad_fn=jax.value_and_grad(loss),
                  fn_kwargs={})

    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)

    def vg(x):
        r = x @ Xt.T - yt
        return 0.5 * (r ** 2).mean(1), r @ Xt / 60.0

    x0 = torch.zeros((1, 4))
    pv, pg = vg(x0)
    got, _, _ = lbfgs.zoom_linesearch(vg, x0, torch.from_numpy(
        np.array(d))[None], pv, pg)
    assert abs(float(got[0]) - float(st.stepsize)) <= 1e-6 * float(
        st.stepsize)


# --------------------------------------------------------------------------- #
# the port's steps against optax's on the selectors' real matrices            #
# --------------------------------------------------------------------------- #

def record_port_path(fit, *args):
    """Run the port's `fit(*args)` with its line search wrapped: per outer
    step k, (x_k, g_k, v_k, x_{k+1}), each over the fit's P pairs."""
    from transmogrifai_tpu_torch.models import lbfgs

    steps, inner = [], lbfgs.zoom_linesearch

    def recording(vg, x, d, v0, g0, max_steps=lbfgs.MAX_LINESEARCH_STEPS):
        step, v, g = inner(vg, x, d, v0, g0, max_steps)
        steps.append((x.clone(), g0.clone(), v0.clone(),
                      x + step[:, None] * d))
        return step, v, g

    lbfgs.zoom_linesearch = recording
    try:
        fit(*args)
    finally:
        lbfgs.zoom_linesearch = inner
    return steps


def optax_step_errors(steps, pair, loss, **loss_kw):
    """Per step k of the port's path of `pair`: optax's L-BFGS update
    (`optax.lbfgs()`: memory 10, zoom line search) from the port's own
    state — x_k, v_k, g_k and the (Δx, Δg) memory of the port's last ten
    steps — and its distance to the port's x_{k+1} over the port's step
    length. `loss(x, **loss_kw)` is the JAX package's objective over the
    flat parameter vector."""
    import jax
    import jax.numpy as jnp
    import optax

    opt = optax.lbfgs()
    xs, gs, vs, nxt = ([np.asarray(s[i][pair].numpy()) for s in steps]
                       for i in range(4))
    kw = {k: jnp.asarray(v) for k, v in loss_kw.items()}

    @jax.jit
    def update(state, x, v, g, kw):
        u, _ = opt.update(g, state, x, value=v, grad=g, value_fn=loss, **kw)
        return optax.apply_updates(x, u)

    st = opt.init(jnp.asarray(xs[0]))
    memory = st[0].weights_memory.shape[0]
    errs = []
    for k in range(len(xs)):
        dp = np.zeros((memory, xs[0].size), np.float32)
        du = np.zeros_like(dp)
        rho = np.zeros(memory, np.float32)
        for j in range(max(1, k - memory), k):
            dp[(j - 1) % memory] = xs[j] - xs[j - 1]
            du[(j - 1) % memory] = gs[j] - gs[j - 1]
            vd = float(jnp.vdot(jnp.asarray(du[(j - 1) % memory]),
                                jnp.asarray(dp[(j - 1) % memory])))
            rho[(j - 1) % memory] = 0.0 if vd == 0.0 else np.float32(1.0) \
                / np.float32(vd)
        prev = k - 1 if k else None
        lb = st[0]._replace(
            count=jnp.asarray(k, jnp.int32),
            params=jnp.asarray(xs[prev] if k else np.zeros_like(xs[0])),
            updates=jnp.asarray(gs[prev] if k else np.zeros_like(gs[0])),
            diff_params_memory=jnp.asarray(dp),
            diff_updates_memory=jnp.asarray(du),
            weights_memory=jnp.asarray(rho))
        ls = st[2]._replace(value=jnp.float32(vs[k]),
                            grad=jnp.asarray(gs[k]))
        theirs = np.asarray(update((lb, st[1], ls), jnp.asarray(xs[k]),
                                   jnp.float32(vs[k]), jnp.asarray(gs[k]),
                                   kw))
        errs.append(float(np.linalg.norm(theirs - nxt[k])
                          / max(np.linalg.norm(nxt[k] - xs[k]), 1e-30)))
    return np.asarray(errs)


def capture_sweep(ns, run, family, grids=None, device=None):
    """Run `run`'s pipeline in package `ns` over one family (`grids`, or
    the family's own) and return what the selector hands `run_sweep`:
    the selector matrix X, labels y, folds, evaluator and context."""
    from test_torch_families import family_models, run_dataset, run_pipeline

    est, own = next((e, g) for e, g in family_models(ns, run)
                    if type(e).__name__ == family)
    seen, inner = {}, ns.ms.run_sweep

    def capturing(est, grids, X, y, folds, evaluator, ctx, *a, **kw):
        seen.update(est=est, grids=grids, X=X, y=y, folds=folds,
                    evaluator=evaluator, ctx=ctx)
        return inner(est, grids, X, y, folds, evaluator, ctx, *a, **kw)

    ns.ms.run_sweep = capturing
    try:
        label, pred = run_pipeline(ns, run, [(est, grids or own)])
        ns.Workflow().set_result_features(pred, label).set_input_dataset(
            run_dataset(ns, run)).train(
                **({"device": device} if device else {}))
    finally:
        ns.ms.run_sweep = inner
    seen["sweep"] = inner
    return seen


def _fold_weights(folds):
    """The folds' training row weights (P, n), as `run_sweep` stacks
    them."""
    return np.stack([np.asarray(tr, np.float32) for tr, _ in folds])


@pytest.fixture(scope="module")
def titanic_matrix():
    from test_torch_multiclass import package

    cap = capture_sweep(package("port"), "binary", "OpLogisticRegression",
                        [{"reg_param": 0.1, "elastic_net_param": 0.0}],
                        device="cpu")
    X, y = cap["X"].numpy(), cap["y"].numpy()
    return X, y, _fold_weights(cap["folds"])


def _jax_logreg_loss(d, k):
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu.models.logistic import logreg_loss

    def loss(x, X, Y, w, l2):
        return logreg_loss({"W": x[:d * k].reshape(d, k), "b": x[d * k:]},
                           X, Y, w, l2)
    return jax.jit(loss)


def test_lbfgs_steps_are_optax_steps_on_titanic(titanic_matrix):
    """The README quickstart's selector matrix (802 × 496, badly
    conditioned), logistic regression at reg_param 0.1 on its three folds,
    the run's 50 steps: at every step optax's update from the port's own
    state lands within 5e-2 of the port's step length from the port's next
    iterate (median within 1e-5). The two differ only in rounding, which
    the zoom line search's interpolation amplifies to at most a few 1e-3
    of a step; a different branch of the line search would part them by
    a whole step. Over the 50 steps the paths part all the same (F5):
    this holds the step, not the path."""
    from transmogrifai_tpu_torch.models import logistic as pl

    X, y, W = titanic_matrix
    d, k = X.shape[1], 2
    steps = record_port_path(pl.fit_logreg, torch.from_numpy(X),
                             torch.from_numpy(y), torch.from_numpy(W),
                             0.1, k, 50)
    loss = _jax_logreg_loss(d, k)
    Y = np.eye(k, dtype=np.float32)[y.astype(int)]
    for pair in range(W.shape[0]):
        errs = optax_step_errors(steps, pair, loss, X=X, Y=Y, w=W[pair],
                                 l2=np.float32(0.1))
        assert len(errs) == 50
        assert errs.max() <= 5e-2 and np.median(errs) <= 1e-5, (
            pair, errs.max(), np.median(errs))


def _jax_glm_loss(family, link, var_power):
    import jax
    from transmogrifai_tpu.models import glm as jg

    def loss(x, X, y, w, l2):
        eta = X @ x[:-1] + x[-1]
        mu = jg._inverse_link(family, eta, link, var_power)
        nll = jg._neg_log_likelihood(family, mu, y, var_power)
        return (nll * w).sum() / jax.numpy.maximum(w.sum(), 1.0) \
            + 0.5 * l2 * (x[:-1] ** 2).sum()
    return jax.jit(loss)


def boston_glm_path(family, link, reg):
    """The Boston example's selector matrix and its one training split;
    the port's GLM fit there (the run's 100 steps) with its path."""
    from test_torch_multiclass import package
    from transmogrifai_tpu_torch.models import glm as pg

    cap = capture_sweep(package("port"), "boston",
                        "OpGeneralizedLinearRegression",
                        [{"family": family, "link": link, "reg_param": reg}],
                        device="cpu")
    X, y = cap["X"].numpy(), cap["y"].numpy()
    W = _fold_weights(cap["folds"])
    steps = record_port_path(pg.fit_glm, torch.from_numpy(X),
                             torch.from_numpy(y), torch.from_numpy(W), reg,
                             family, 100, 1.5, link)
    return X, y, W, steps


def test_lbfgs_steps_are_optax_steps_on_boston_tweedie():
    """The Boston example's selector matrix (unscaled columns), the GLM of
    the fixture's winner (tweedie, power link, var_power 1.5, reg_param
    0.001) over the run's 100 steps: as on Titanic, at every step optax's
    update from the port's own state lands within 5e-2 of the port's step
    length from the port's next iterate, median within 1e-5."""
    X, y, W, steps = boston_glm_path("tweedie", "power", 0.001)
    errs = optax_step_errors(steps, 0, _jax_glm_loss("tweedie", "power", 1.5),
                             X=X, y=y, w=W[0], l2=np.float32(0.001))
    assert len(errs) == 100
    assert errs.max() <= 5e-2 and np.median(errs) <= 1e-5, (
        errs.max(), np.median(errs))


# --------------------------------------------------------------------------- #
# readings: where the two packages' paths part, and what that does to the    #
# fold metrics                                                                #
# --------------------------------------------------------------------------- #

def _jax_logreg_path(X, y, w, l2, k, steps):
    """The JAX package's `fit_logreg` path (its optax L-BFGS), the iterate
    after each step as one flat vector."""
    import jax
    import jax.numpy as jnp
    import optax

    d = X.shape[1]
    loss = _jax_logreg_loss(d, k)
    Y = jnp.asarray(np.eye(k, dtype=np.float32)[y.astype(int)])
    kw = dict(X=jnp.asarray(X), Y=Y, w=jnp.asarray(w), l2=jnp.float32(l2))
    fn = lambda x: loss(x, **kw)  # noqa: E731
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(fn)

    def step(carry, _):
        x, s = carry
        v, g = vg(x, state=s)
        u, s = opt.update(g, s, x, value=v, grad=g, value_fn=fn)
        x = optax.apply_updates(x, u)
        return (x, s), x

    x0 = jnp.zeros(d * k + k, jnp.float32)
    _, xs = jax.jit(lambda x: jax.lax.scan(step, (x, opt.init(x)), None,
                                           length=steps))(x0)
    return np.asarray(xs)


def _parting_step(a, b, rtol=1e-4):
    rel = np.linalg.norm(a - b, axis=1) / np.maximum(
        np.linalg.norm(b, axis=1), 1e-30)
    over = np.flatnonzero(rel > rtol)
    return int(over[0]) + 1 if over.size else None


@contextlib.contextmanager
def port_variant(kind):
    """The port with one F5 candidate changed, for the readings:
    "port_one_ulp_zoom_f32" interpolates the zoom phase in f32, as optax
    does (the port runs it in f64); "port_one_ulp_loss_sum_then_divide"
    rounds the logistic loss as Σ(ll·w)/Σw, the JAX package's order (the
    port rounds Σ(ll·(w/Σw))); "port_one_ulp_grad_vjp" rounds the
    gradient as autodiff's VJP of the JAX package's loss does (the port
    writes out (softmax − Y)·w/Σw); "port_one_ulp_products_xla" computes
    the fit's two products (X·W and Xᵀ·R) with XLA's own dot on the CPU,
    so their sums run in the JAX package's order."""
    from transmogrifai_tpu_torch.models import lbfgs
    from transmogrifai_tpu_torch.parallel import sweep

    def whole(fn):  # the sweep passes X as a one-shard `RowSplit`
        return lambda X, *a, **kw: fn(X.gather(), *a, **kw)
    zoom, fit = lbfgs._zoom_middle, sweep.fit_logreg
    if kind == "port_one_ulp_zoom_f32":
        lbfgs._zoom_middle = lambda *a: zoom(*(t.float() for t in a))
    elif kind == "port_one_ulp_loss_sum_then_divide":
        sweep.fit_logreg = whole(_fit_logreg_sum_then_divide)
    elif kind == "port_one_ulp_grad_vjp":
        sweep.fit_logreg = whole(_fit_logreg_vjp_grad)
    elif kind == "port_one_ulp_products_xla":
        sweep.fit_logreg = whole(_fit_logreg_xla_products)
    try:
        yield
    finally:
        lbfgs._zoom_middle, sweep.fit_logreg = zoom, fit


def _fit_logreg_sum_then_divide(X, y, w, l2, n_classes, max_iter=100):
    """`models.logistic.fit_logreg` with its loss rounded as
    Σ(ll·w)/Σw."""
    from transmogrifai_tpu_torch.models import lbfgs
    from transmogrifai_tpu_torch.models.base import per_pair
    w = w[None, :] if w.dim() == 1 else w
    P, (n, d) = w.shape[0], X.shape
    k = n_classes
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    l2 = per_pair(l2, P, X.device)
    wsum = torch.clamp(w.sum(1), min=1.0)
    wn = (w / wsum[:, None])[:, :, None]

    def value_and_grad(x):
        W = x[:, :d * k].reshape(P, d, k)
        b = x[:, d * k:]
        logits = torch.matmul(X, W) + b[:, None, :]
        ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        value = (ll * w).sum(1) / wsum + 0.5 * l2 * (W ** 2).sum((1, 2))
        R = (torch.softmax(logits, dim=-1) - Y) * wn
        gW = torch.matmul(X.T, R) + l2[:, None, None] * W
        return value, torch.cat([gW.reshape(P, d * k), R.sum(1)], 1)

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (P, d * k + k), dtype=torch.float32, device=X.device), max_iter)
    return {"W": x[:, :d * k].reshape(P, d, k), "b": x[:, d * k:]}


def _fit_logreg_vjp_grad(X, y, w, l2, n_classes, max_iter=100):
    """`models.logistic.fit_logreg` with the logits' gradient rounded as
    JAX's reverse mode rounds the VJP of `optax.softmax_cross_entropy`
    weighted by w/Σw: c = w·(1/Σw), then −Y·c + exp(z − max)·(c / Σ exp(z
    − max)) (log_softmax's VJP through its exp and log), where the port
    writes (softmax − Y)·(w/Σw)."""
    from transmogrifai_tpu_torch.models import lbfgs
    from transmogrifai_tpu_torch.models.base import per_pair
    w = w[None, :] if w.dim() == 1 else w
    P, (n, d) = w.shape[0], X.shape
    k = n_classes
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    l2 = per_pair(l2, P, X.device)
    wsum = torch.clamp(w.sum(1), min=1.0)
    wn = (w / wsum[:, None])[:, :, None]
    c = (w * (1.0 / wsum)[:, None])[:, :, None]

    def value_and_grad(x):
        W = x[:, :d * k].reshape(P, d, k)
        b = x[:, d * k:]
        logits = torch.matmul(X, W) + b[:, None, :]
        ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        value = (ll * wn[:, :, 0]).sum(1) + 0.5 * l2 * (W ** 2).sum((1, 2))
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        R = -(Y * c) + e * (c / e.sum(-1, keepdim=True))
        gW = torch.matmul(X.T, R) + l2[:, None, None] * W
        return value, torch.cat([gW.reshape(P, d * k), R.sum(1)], 1)

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (P, d * k + k), dtype=torch.float32, device=X.device), max_iter)
    return {"W": x[:, :d * k].reshape(P, d, k), "b": x[:, d * k:]}


def _fit_logreg_xla_products(X, y, w, l2, n_classes, max_iter=100):
    """`models.logistic.fit_logreg` with its two products, X·W (batched
    over the pairs) and Xᵀ·R, computed by XLA's jitted `jnp.matmul` on the
    CPU (the JAX package's dot and its sum order); the rest of the fit is
    the port's."""
    import jax
    import jax.numpy as jnp
    from transmogrifai_tpu_torch.models import lbfgs
    from transmogrifai_tpu_torch.models.base import per_pair
    mm = jax.jit(jnp.matmul)

    def xla(a, b):
        return torch.from_numpy(np.array(mm(a.numpy(), b.numpy())))

    w = w[None, :] if w.dim() == 1 else w
    P, (n, d) = w.shape[0], X.shape
    k = n_classes
    Y = torch.nn.functional.one_hot(y.long(), k).to(torch.float32)
    l2 = per_pair(l2, P, X.device)
    wn = (w / torch.clamp(w.sum(1), min=1.0)[:, None])[:, :, None]
    Xt = X.T.contiguous()

    def value_and_grad(x):
        W = x[:, :d * k].reshape(P, d, k)
        b = x[:, d * k:]
        logits = xla(X, W.contiguous()) + b[:, None, :]
        ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        value = (ll * wn[:, :, 0]).sum(1) + 0.5 * l2 * (W ** 2).sum((1, 2))
        R = (torch.softmax(logits, dim=-1) - Y) * wn
        gW = xla(Xt, R.contiguous()) + l2[:, None, None] * W
        return value, torch.cat([gW.reshape(P, d * k), R.sum(1)], 1)

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (P, d * k + k), dtype=torch.float32, device=X.device), max_iter)
    return {"W": x[:, :d * k].reshape(P, d, k), "b": x[:, d * k:]}


def loss_bits(steps, pairs, X, Y, WP, loss):
    """At every iterate x_k of the port's Titanic path (each pair): the
    port's loss as `fit_logreg` rounds it, Σ(ll·(w/Σw)), and in the JAX
    package's order, Σ(ll·w)/Σw, each against the JAX package's
    `logreg_loss` at the same x: the share of bit-equal losses and the
    ulps between them."""
    import jax
    import jax.numpy as jnp

    d, k = X.shape[1], Y.shape[1]
    jl = jax.jit(loss)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    ulps = {"sum_then_divide": [], "weights_divided_first": []}
    for st in steps:
        for p, (r, _) in enumerate(pairs):
            x = st[0][p]
            W, b = x[:d * k].reshape(d, k), x[d * k:]
            ll = -(Yt * torch.log_softmax(Xt @ W + b, -1)).sum(-1)
            w = torch.from_numpy(WP[p])
            wsum = torch.clamp(w.sum(), min=1.0)
            reg = 0.5 * torch.tensor(r, dtype=torch.float32) * (W ** 2).sum()
            want = np.float32(jl(jnp.asarray(x.numpy()), X=X, Y=Y, w=WP[p],
                                 l2=np.float32(r)))
            for kind, got in (("sum_then_divide", (ll * w).sum() / wsum),
                              ("weights_divided_first",
                               (ll * (w / wsum)).sum())):
                g = np.float32((got + reg).item())
                ulps[kind].append(abs(int(g.view(np.int32))
                                      - int(want.view(np.int32))))
    out = {"losses": len(ulps["sum_then_divide"])}
    for kind, u in ulps.items():
        u = np.asarray(u)
        out[kind] = {"bit_equal_share": float((u == 0).mean()),
                     "mean_ulps": float(u.mean()), "max_ulps": int(u.max())}
    return out


def readings(seeds: int = 24, only=None) -> None:
    """Print, as JSON lines: (1) optax's step from the port's state at
    every step of the Titanic logistic-regression fits (4 reg_params × 3
    folds, 50 steps) and of the Boston GLM fits (4 family/link pairs ×
    reg_param 0.001 and 0.2, 100 steps); (2) the first step at which the
    port's Titanic path lies 1e-4 (relative) from the JAX package's, and
    the JAX package's from itself with the matrix moved by one ulp; (3)
    the Titanic logistic regression's largest fold-AuPR move from the JAX
    package's sweep over `seeds` runs each of: the JAX package with the
    matrix moved by one ulp, the JAX package with the matrix's columns
    permuted (the same problem, sums in other orders), and the port with
    the matrix moved by one ulp: as it runs, with its zoom interpolation in
    f32 (as optax runs it), with its loss summed in the JAX package's
    order, with its gradient rounded as the JAX package's autodiff
    rounds it and with its products computed by XLA's dot; and (4) how
    often the port's Titanic loss rounds to the JAX package's
    (`loss_bits`). `only`: print (3) for those runs alone."""
    import json

    import jax.numpy as jnp
    from test_torch_families import one_ulp_noise
    from test_torch_multiclass import package
    from transmogrifai_tpu_torch.models import logistic as pl

    regs = [0.001, 0.01, 0.1, 0.2]
    port_cap = capture_sweep(package("port"), "binary",
                             "OpLogisticRegression", device="cpu")
    jax_cap = capture_sweep(package("jax"), "binary", "OpLogisticRegression")
    X, y = port_cap["X"].numpy(), port_cap["y"].numpy()
    if only is None:
        W = _fold_weights(port_cap["folds"])
        pairs = [(r, f) for r in regs for f in range(W.shape[0])]
        WP = np.stack([W[f] for _, f in pairs])
        steps = record_port_path(pl.fit_logreg, torch.from_numpy(X),
                                 torch.from_numpy(y), torch.from_numpy(WP),
                                 [r for r, _ in pairs], 2, 50)
        loss = _jax_logreg_loss(X.shape[1], 2)
        Y = np.eye(2, dtype=np.float32)[y.astype(int)]
        Xn = one_ulp_noise(X, 1)
        print(json.dumps({"reading": "titanic_logreg_loss_bits",
                          **loss_bits(steps, pairs, X, Y, WP, loss)}),
              flush=True)
        for p, (r, f) in enumerate(pairs):
            errs = optax_step_errors(steps, p, loss, X=X, Y=Y, w=WP[p],
                                     l2=np.float32(r))
            port_path = np.stack([s[3][p].numpy() for s in steps])
            jax_path = _jax_logreg_path(X, y, W[f], r, 2, 50)
            jax_noisy = _jax_logreg_path(Xn, y, W[f], r, 2, 50)
            print(json.dumps({
                "reading": "titanic_logreg_steps", "reg_param": r, "fold": f,
                "optax_step_gap_max": float(errs.max()),
                "optax_step_gap_median": float(np.median(errs)),
                "steps_gap_over_1e-3": int((errs > 1e-3).sum()),
                "port_parts_from_jax_at": _parting_step(port_path, jax_path),
                "jax_parts_from_itself_one_ulp_at": _parting_step(jax_noisy,
                                                                  jax_path)}),
                flush=True)
        for family, link in (("gaussian", "identity"), ("poisson", "log"),
                             ("gamma", "log"), ("tweedie", "power")):
            for r in (0.001, 0.2):
                Xb, yb, Wb, st = boston_glm_path(family, link, r)
                errs = optax_step_errors(
                    st, 0, _jax_glm_loss(family, link, 1.5), X=Xb, y=yb,
                    w=Wb[0], l2=np.float32(r))
                print(json.dumps({
                    "reading": "boston_glm_steps", "family": family,
                    "link": link, "reg_param": r,
                    "optax_step_gap_max": float(errs.max()),
                    "optax_step_gap_at": int(errs.argmax()) + 1,
                    "optax_step_gap_median": float(np.median(errs)),
                    "steps_gap_over_1e-3": int((errs > 1e-3).sum())}),
                    flush=True)

    def sweep(cap, X_):
        return np.asarray(cap["sweep"](cap["est"], cap["grids"], X_, cap["y"],
                                       cap["folds"], cap["evaluator"],
                                       cap["ctx"]), np.float64)

    base = sweep(jax_cap, jax_cap["X"])
    Xj = np.asarray(jax_cap["X"])
    kinds = {
        "jax_one_ulp": lambda s: sweep(jax_cap, jnp.asarray(
            one_ulp_noise(Xj, s))),
        "jax_columns_permuted": lambda s: sweep(jax_cap, jnp.asarray(
            np.ascontiguousarray(Xj[:, np.random.default_rng(s).permutation(
                Xj.shape[1])]))),
        "port_one_ulp": lambda s: sweep(port_cap, torch.from_numpy(
            one_ulp_noise(X, s))),
        "port_one_ulp_zoom_f32": lambda s: sweep(port_cap, torch.from_numpy(
            one_ulp_noise(X, s))),
        "port_one_ulp_loss_sum_then_divide": lambda s: sweep(
            port_cap, torch.from_numpy(one_ulp_noise(X, s))),
        "port_one_ulp_grad_vjp": lambda s: sweep(
            port_cap, torch.from_numpy(one_ulp_noise(X, s))),
        "port_one_ulp_products_xla": lambda s: sweep(
            port_cap, torch.from_numpy(one_ulp_noise(X, s)))}
    for kind, run in kinds.items():
        if only is not None and kind not in only:
            continue
        with port_variant(kind):
            moves = sorted(float(np.abs(run(s) - base).max())
                           for s in range(1, seeds + 1))
        print(json.dumps({
            "reading": "titanic_logreg_fold_aupr_move_from_jax", "runs": kind,
            "seeds": seeds, "median": float(np.median(moves)),
            "max": moves[-1], "min": moves[0]}), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_lbfgs.py readings
    if sys.argv[1:2] != ["readings"]:
        raise SystemExit(
            "usage: python tests/test_torch_lbfgs.py readings [KIND ...]")
    readings(only=sys.argv[2:] or None)
