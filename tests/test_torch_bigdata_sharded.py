"""The big path on a data axis: the port's builders, feature cache and
out-of-core learners over row shards (`parallel/bigdata.py` given
``sharding=data_sharding(mesh)``, `parallel/rowshards.py`), held to the
port's unsharded path and to the JAX package's sharded one, on the CPU.

The stores are tests/test_torch_bigdata.py's (5000 × 12, seed 3, chunk
1024, padded to 5120 rows: 5 chunks). A CPU mesh repeats the ``cpu``
device; 2 shards take 3 + 2 chunks, 3 shards 2 + 2 + 1. The JAX package's
side runs on the conftest's 8 virtual CPU devices, rows over a ("data",)
mesh of 8 (GSPMD needs equal shards; 1024-row chunks split evenly).

Equal, bit for bit:
- each builder's shards, gathered, against the port's unsharded build and
  the JAX package's sharded build;
- a quantized (int8) sharded build through the cache, its miss and its
  hit; the forest grown on the shards with the JAX package's draws
  against the JAX package's unsharded forest (integer sums) and its K5
  predictions; the GBT trees' split features and bins.

Within a stated tolerance:
- the LR grid on 2 shards against the JAX package's on a mesh of 2 (the
  same shard count): within twice the JAX package's own sharded-vs-
  unsharded move there (its bf16 re-rounding of W and R under another sum
  order: 2.29e-3 in W, 2.48e-4 in b on this store), and never above the
  atol 5e-3 of tests/test_bigdata.py:304-307;
- the GBT lockstep and single fits: leaves within
  `chip_smoke.BIG_GBT_LEAF_ATOL`, margins within `BIG_GBT_MARGIN_ATOL`,
  or twice the JAX package's own sharded-vs-unsharded move where that is
  larger (the test computes it: 0.0 on this store).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding as JaxSharding
from jax.sharding import PartitionSpec

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_bigdata import (  # noqa: E402,F401  (fixtures)
    CHUNK, D, built, cs, jax_forest_draws, jbd, pbd, stores)
from transmogrifai_tpu.data import feature_cache as jfc  # noqa: E402
from transmogrifai_tpu_torch.data import feature_cache as pfc  # noqa: E402
from transmogrifai_tpu_torch.parallel.mesh import (  # noqa: E402
    data_sharding, make_mesh, sweep_sharding)
from transmogrifai_tpu_torch.parallel.rowshards import (  # noqa: E402
    RowSplit, chunk_shards)

JAX_SHARDS = 8


def port_sharding(S):
    return data_sharding(make_mesh(S, sweep=1, device="cpu"))


def jax_rows(k=JAX_SHARDS, spec=("data", None)):
    mesh = JaxMesh(np.array(jax.devices()[:k]), ("data",))
    return JaxSharding(mesh, PartitionSpec(*spec))


def bits(x):
    """A port tensor or RowSplit, or a JAX array, as raw bytes."""
    if isinstance(x, RowSplit):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def builders(pkg, store, edges):
    return {"matrix": lambda **kw: pkg.device_matrix(
                store, chunk_rows=CHUNK, **kw),
            "binned": lambda **kw: pkg.device_binned(
                store, edges, chunk_rows=CHUNK, **kw),
            "dual": lambda **kw: pkg.dual_device_matrices(
                store, edges, chunk_rows=CHUNK, **kw)}


@pytest.fixture(scope="module")
def sharded(stores, built):
    """The port's dual build on 2 and 3 shards."""
    _, ps = stores
    return {S: pbd.dual_device_matrices(ps, built["edges"], chunk_rows=CHUNK,
                                        sharding=port_sharding(S))
            for S in (2, 3)}


# --------------------------------------------------------------------------- #
# the builders                                                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("kind", ["matrix", "binned", "dual"])
def test_sharded_builders_equal_unsharded_and_the_jax_sharded_build(
        stores, built, kind, S):
    js, ps = stores
    port = builders(pbd, ps, built["edges"])[kind]
    jaxb = builders(jbd, js, built["edges"])[kind]
    plain = port(device="cpu", cache="off")
    got = port(sharding=port_sharding(S), cache="off")
    want = jaxb(sharding=jax_rows(), cache="off")
    plain, got, want = ((x,) if not isinstance(x, tuple) else x
                        for x in (plain, got, want))
    sizes = {2: [3 * CHUNK, 2 * CHUNK], 3: [2 * CHUNK, 2 * CHUNK, CHUNK]}[S]
    for p, g, j in zip(plain, got, want):
        assert isinstance(g, RowSplit) and g.shards.sizes == sizes
        assert [str(part.device) for part in g.parts] == ["cpu"] * S
        assert g.shape == p.shape and g.dtype == p.dtype
        assert bits(g) == bits(p) == bits(j)


def test_chunk_shards_take_whole_chunks_as_even_as_they_go():
    for n_chunks, S, want in ((17, 2, [9, 8]), (5, 3, [2, 2, 1]),
                              (4, 4, [1, 1, 1, 1]), (1, 1, [1])):
        rs = chunk_shards(n_chunks * 8, 8, ["cpu"] * S)
        assert rs.sizes == [c * 8 for c in want]
        assert rs.bounds[-1] == n_chunks * 8


def test_a_chunk_splitting_or_non_data_sharding_is_refused(stores, built):
    """More shards than chunks would put a shard boundary inside a chunk:
    refused by name; so is a sharding that is not over the data axis."""
    _, ps = stores
    with pytest.raises(ValueError, match="whole chunk"):
        pbd.device_binned(ps, built["edges"], chunk_rows=CHUNK,
                          sharding=port_sharding(6))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        chunk_shards(4 * CHUNK + 3, CHUNK, ["cpu"] * 2)
    with pytest.raises(ValueError, match="data_sharding"):
        pbd.device_matrix(ps, chunk_rows=CHUNK,
                          sharding=sweep_sharding(make_mesh(2,
                                                            device="cpu")))


def test_int8_sharded_build_through_the_cache(stores, built, tmp_path):
    """A quantized build on 2 shards misses, writes its artifact and the
    same sharding hits (parts equal, the wire tape the unsharded build's
    bytes); 3 shards miss (the JAX suite's `test_sharding_change_misses`);
    the unsharded key is the JAX package's, as before."""
    js, ps = stores
    params = pfc.FeatureCacheParams(dir=str(tmp_path / "cache"),
                                    policy="readwrite", wire="int8")
    run = builders(pbd, ps, built["edges"])["binned"]
    got = [run(sharding=port_sharding(S), cache=params, return_stats=True)
           for S in (2, 2, 3)]
    assert [g[-1].cache for g in got] == ["miss", "hit", "miss"]
    assert bits(got[0][0]) == bits(got[1][0]) == bits(got[2][0])
    keys = [g[-1].cache_key for g in got]
    assert keys[0] == keys[1] != keys[2]
    plain, st = run(device="cpu", cache=params, return_stats=True)
    assert st.cache == "miss" and st.cache_key not in keys
    assert bits(plain) == bits(got[0][0])
    kw = dict(target_dtype="int8", wire="int8", chunk_rows=CHUNK,
              edges=built["edges"], quant_sample=params.quant_sample,
              quant_seed=params.quant_seed)
    assert st.cache_key == jfc.cache_key("binned", js, **kw) \
        == pfc.cache_key("binned", ps, **kw)
    tapes = [pfc.FeatureCache(params).load(k).wire for k in
             (keys[0], keys[2], st.cache_key)]
    assert tapes[0].tobytes() == tapes[1].tobytes() == tapes[2].tobytes()


# --------------------------------------------------------------------------- #
# the learners                                                                #
# --------------------------------------------------------------------------- #

def _jax_lr(X, y, w, sharded):
    l1v, l2v = cs.big_grid()
    if sharded:  # on a mesh of the port's 2 shards
        rows = jax_rows(2, spec=("data",))
        X = jax.device_put(X, jax_rows(2))
        y, w = (jax.device_put(jnp.asarray(a), rows) for a in (y, w))
    p = jbd.fit_logreg_enet_grids_big(X, jnp.asarray(y), jnp.asarray(w),
                                      jnp.asarray(l1v), jnp.asarray(l2v), 2,
                                      cs.BIG_LR_STEPS)
    return np.asarray(p["W"]), np.asarray(p["b"])


def test_lr_grid_on_shards_against_the_jax_sharded_grid(built, sharded):
    y, w = built["y"], built["W"][0]
    jW, jb = _jax_lr(built["jX"], y, w, False)
    sW, sb = _jax_lr(built["jX"], y, w, True)
    move = {"W": np.abs(sW - jW).max(), "b": np.abs(sb - jb).max()}
    assert move["W"] > 1e-5  # the bf16 re-rounding's scale
    l1v, l2v = cs.big_grid()
    Xs = sharded[2][0]
    p = pbd.fit_logreg_enet_grids_big(Xs, torch.from_numpy(y),
                                      torch.from_numpy(w), l1v, l2v, 2,
                                      cs.BIG_LR_STEPS)
    for k, want in (("W", sW), ("b", sb)):
        err = np.abs(p[k].numpy() - want).max()
        assert err <= min(2 * move[k], 5e-3), (k, err, move[k])
    probs = pbd.predict_logreg_grids_big(p["W"], p["b"], Xs)
    whole = pbd.predict_logreg_grids_big(p["W"], p["b"], Xs.gather())
    assert torch.equal(probs, whole)  # the same rows, a shard at a time
    one = pbd.predict_logreg_big(p["W"][3], p["b"][3], Xs)
    assert torch.equal(one["probability"], whole[3])
    pl = pbd.fit_logreg_big(Xs, torch.from_numpy(y), torch.from_numpy(w),
                            0.01, 2, 20)
    ref = pbd.fit_logreg_big(Xs.gather(), torch.from_numpy(y),
                             torch.from_numpy(w), 0.01, 2, 20)
    np.testing.assert_allclose(pl["W"].numpy(), ref["W"].numpy(), rtol=0,
                               atol=5e-3)


def test_forest_on_shards_with_the_jax_draws_is_the_jax_forest(built,
                                                               sharded):
    n_pad, y, w = built["n_pad"], built["y"], built["W"][0]
    n_trees, depth = 8, 4
    K = min(jbd.lockstep_width(depth, D, 32, 2, 16, n=n_pad), n_trees)
    boot, mask = jax_forest_draws(n_trees, n_pad, D, 3, K)
    Y1 = np.eye(2, dtype=np.float32)[y.astype(int)]
    jf = jbd.fit_forest_big(built["jB"], jnp.asarray(Y1), jnp.asarray(w),
                            n_trees, depth, 32, 2, seed=3, chunk=CHUNK)
    for S in (2, 3):
        Bs = sharded[S][1]
        pf = pbd.fit_forest_big(Bs, torch.from_numpy(Y1),
                                torch.from_numpy(w), n_trees, depth, 32, 2,
                                seed=3, chunk=CHUNK, draws=(boot, mask),
                                trees_per_dispatch=3)
        for k in ("feat", "bin", "leaf"):
            np.testing.assert_allclose(pf[k].numpy(), np.asarray(jf[k]),
                                       rtol=0, atol=0.0)
        np.testing.assert_array_equal(
            pbd.predict_forest_big(pf, Bs).numpy(),
            np.asarray(jbd.predict_forest_big(jf, built["jB"])))
        np.testing.assert_array_equal(
            pbd.predict_tree_big({k: v[0] for k, v in pf.items()},
                                 Bs).numpy(),
            pbd.predict_tree_big({k: v[0] for k, v in pf.items()},
                                 built["pB"]).numpy())


@pytest.fixture(scope="module")
def jax_gbt(built):
    """The JAX package's lockstep GBT unsharded and on a mesh of 2 (X, y
    and the pair weights row-sharded), and its own move between them."""
    wK = cs.big_gbt_weights(built["W"], built["V"])
    y = jnp.asarray(built["y"])
    fits = [jbd.fit_gbt_big_lockstep(B, yy, ww, 2, 4, 32, 0.1, 1.0,
                                     "logistic", chunk=CHUNK)
            for B, yy, ww in (
                (built["jB"], y, jnp.asarray(wK)),
                (jax.device_put(built["jB"], jax_rows(2)),
                 jax.device_put(y, jax_rows(2, spec=("data",))),
                 jax.device_put(jnp.asarray(wK),
                                jax_rows(2, spec=(None, "data")))))]
    (jt, jm), (st, sm) = fits
    move = {"leaf": float(np.abs(np.asarray(st["leaf"])
                                 - np.asarray(jt["leaf"])).max()),
            "margin": float(np.abs(np.asarray(sm) - np.asarray(jm)).max())}
    return wK, jt, jm, move


@pytest.mark.parametrize("S", [2, 3])
def test_gbt_on_shards_lockstep_and_single(built, sharded, jax_gbt, S):
    """Within BIG_GBT_LEAF_ATOL / BIG_GBT_MARGIN_ATOL, or twice the JAX
    package's own sharded-vs-unsharded move where that is larger (it is
    0.0 on this store)."""
    Bs = sharded[S][1]
    wK, jt, jm, move = jax_gbt
    leaf_tol = max(cs.BIG_GBT_LEAF_ATOL, 2 * move["leaf"])
    margin_tol = max(cs.BIG_GBT_MARGIN_ATOL, 2 * move["margin"])
    pt, pm = pbd.fit_gbt_big_lockstep(
        Bs, torch.from_numpy(built["y"]), torch.from_numpy(wK), 2, 4, 32,
        0.1, 1.0, "logistic", chunk=CHUNK)
    assert pm.shape == (6, built["n_pad"])
    for k in ("feat", "bin"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(jt[k]))
    np.testing.assert_allclose(pt["leaf"].numpy(), np.asarray(jt["leaf"]),
                               rtol=0, atol=leaf_tol)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=margin_tol)
    y, w = built["y"] * 2.5 - 0.5, built["W"][2]
    jt, jm = jbd.fit_gbt_big(built["jB"], jnp.asarray(y), jnp.asarray(w), 2,
                             3, 32, 0.3, 1.0, "squared", chunk=CHUNK)
    pt, pm = pbd.fit_gbt_big(Bs, torch.from_numpy(y), torch.from_numpy(w),
                             2, 3, 32, 0.3, 1.0, "squared", chunk=CHUNK)
    for k in ("feat", "bin"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(jt[k]))
    np.testing.assert_allclose(pt["leaf"].numpy(), np.asarray(jt["leaf"]),
                               rtol=0, atol=cs.BIG_GBT_LEAF_ATOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=cs.BIG_GBT_MARGIN_ATOL)


def test_lockstep_width_counts_the_leads_partials():
    """Over S shards the lead also holds S partial histograms of the
    deepest level, and each shard a K1 scratch: the width only shrinks,
    and one shard is the unsharded width."""
    for depth, m in ((6, 2), (12, 2), (10, 1)):
        one = pbd.lockstep_width(depth, 500, 32, m, 16, n=1 << 20)
        assert pbd.lockstep_width(depth, 500, 32, m, 16, n=1 << 20,
                                  n_shards=1) == one
        two = pbd.lockstep_width(depth, 500, 32, m, 16, n=1 << 19,
                                 n_shards=2)
        assert 1 <= two <= one
    assert pbd.lockstep_width(12, 500, 32, 2, 16, n_shards=2) == 1
    assert pbd.lockstep_width(12, 500, 32, 2, 16) == 2
