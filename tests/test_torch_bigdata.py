"""Parity of the port's out-of-core path with the JAX package's
(`data/columnar_store.py`, `data/pipeline.py`, `parallel/bigdata.py`).

The same store (the JAX tests' 5000 × 12 synthetic store, seed 3, padded by
the builders to 5120 rows with `chunk_rows=1024`) and the same inputs go
through both packages, the port on the CPU.

Equal, bit for bit:
- stores written by either package, read by the other (`X.bin`, `y.bin`
  and the manifest; `synth_binary_store` with the same arguments writes
  the same bytes); appends by either package;
- `device_matrix`, `device_binned` and `dual_device_matrices`: bf16
  compared as int16 bits, int8 bins equal;
- F2: every chunked function of the port raises when n % chunk != 0 (the
  JAX package drops the tail rows there); on padded rows the results
  equal the JAX package's.

Within a stated tolerance:
- the LR grid (`fit_logreg_enet_grids_big`) and its predictions: within
  twice the JAX package's own move when its rows are permuted. FISTA
  rounds W and the residuals to bf16 before every product, so a sum-order
  difference that moves an f32 value across a bf16 rounding boundary moves
  the path by ~1e-3; the JAX package moves as far against itself;
- `grow_tree_big`, `grow_trees_big_lockstep` (V injected),
  `fit_gbt_big_lockstep` and `fit_forest_big` (the JAX package's threefry
  draws injected, reproduced here from `_forest_lockstep_batch`'s
  `inputs(key)`): split features and bins equal, leaves and margins within
  `chip_smoke.BIG_GBT_LEAF_ATOL` / `BIG_GBT_MARGIN_ATOL` (the same
  bf16-rounded values summed in f32 in another order); forest leaves
  equal (integer sums). No near-tie split flips from the sum order on
  these inputs; were one to, F4's precedent applies (show the two gains,
  choose no input to hide it);
- `fit_logreg_big` at the metric level (F5): holdout AuPR within 1e-2.

The committed card fixture `transmogrifai_tpu_torch/testdata/
big_synth_16384x500/` holds the JAX package's results at full width (d =
500, 16384 rows, chunk 4096): the store's and the binned matrix's sha256,
the LR grid, the lockstep GBT and the forest with its draws;
`chip_smoke.py` holds the card to it. Here the port rebuilds the store
and the binned matrix (digests equal) and the LR grid (within the rule
above) on the CPU. Regenerate it (CPU, a few minutes) with:

    JAX_PLATFORMS=cpu python tests/test_torch_bigdata.py regenerate
"""

import hashlib
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.data import columnar_store as jcs
from transmogrifai_tpu.parallel import bigdata as jbd
from transmogrifai_tpu.runtime import integrity as jint
from transmogrifai_tpu_torch.data import columnar_store as pcs
from transmogrifai_tpu_torch.data import pipeline as ppl
from transmogrifai_tpu_torch.evaluators import device_metrics as pdm
from transmogrifai_tpu_torch.parallel import bigdata as pbd
from transmogrifai_tpu_torch.runtime import integrity as pint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402  (the fixture's runs and tolerances)

N, D, CHUNK = 5000, 12, 1024


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("big")
    return (jcs.synth_binary_store(str(root / "jax"), N, D, seed=3,
                                   chunk_rows=CHUNK),
            pcs.synth_binary_store(str(root / "port"), N, D, seed=3,
                                   chunk_rows=CHUNK))


@pytest.fixture(scope="module")
def built(stores):
    """Both packages' resident matrices, labels and folds."""
    js, ps = stores
    edges = js.quantile_edges(32)
    jX, jB = jbd.dual_device_matrices(js, edges, chunk_rows=CHUNK)
    pX, pB = pbd.dual_device_matrices(ps, edges, chunk_rows=CHUNK,
                                      device="cpu")
    n_pad = pX.shape[0]
    W, V = cs.big_folds(N, n_pad)
    return dict(edges=edges, jX=jX, jB=jB, pX=pX, pB=pB, n_pad=n_pad,
                y=cs.big_labels(js, n_pad), W=W, V=V)


# --------------------------------------------------------------------------- #
# the store and its integrity helpers                                         #
# --------------------------------------------------------------------------- #

def test_synth_store_bytes_equal(stores):
    js, ps = stores
    for name in ("X.bin", "y.bin", "manifest.json"):
        assert _sha(os.path.join(js.path, name)) == \
            _sha(os.path.join(ps.path, name)), name
    assert pint.sha256_file(os.path.join(ps.path, "X.bin")) == \
        jint.sha256_file(os.path.join(js.path, "X.bin"))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_written_by_one_package_reads_in_the_other(stores, writer,
                                                         reader):
    js, ps = stores
    src = js if writer == "jax" else ps
    Store = (pcs if reader == "port" else jcs).ColumnarStore
    other = Store(src.path)  # verify=True: sizes and checksums
    assert (other.n_rows, other.n_features) == (N, D)
    np.testing.assert_array_equal(np.asarray(other.chunk(100, 2100)),
                                  np.asarray(src.chunk(100, 2100)))
    np.testing.assert_array_equal(np.asarray(other.y), np.asarray(src.y))
    idx = np.array([0, 4999, -1, 17, 2048])
    np.testing.assert_array_equal(other.take_rows(idx), src.take_rows(idx))
    np.testing.assert_array_equal(other.sample_rows(700, seed=4),
                                  src.sample_rows(700, seed=4))
    np.testing.assert_array_equal(other.quantile_edges(16, sample=3000),
                                  src.quantile_edges(16, sample=3000))
    assert [r for r, _ in other.iter_chunks(700)] == list(range(0, N, 700))


@pytest.mark.parametrize("appender", ["jax", "port"])
def test_appends_read_back_in_both_packages(tmp_path, appender):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(300, 5)).astype(np.float16)
    y = (rng.uniform(size=300) < 0.5).astype(np.float32)
    creator = pcs if appender == "jax" else jcs
    w = creator.ColumnarStore.create(str(tmp_path / "s"), 200, 5)
    w.write_chunk(0, X[:200], y[:200])
    w.close()
    mod = jcs if appender == "jax" else pcs
    a = mod.ColumnarStore.append(str(tmp_path / "s"), 100)
    a.write_chunk(0, X[200:], y[200:])
    a.close()
    for m in (jcs, pcs):
        st = m.ColumnarStore(str(tmp_path / "s"))
        assert st.n_rows == 300 and len(st.meta["segments"]) == 1
        np.testing.assert_array_equal(np.asarray(st.chunk(150, 260)),
                                      X[150:260])
        np.testing.assert_array_equal(np.asarray(st.y), y)


@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_store_raises_in_both_packages(tmp_path, damage):
    st = pcs.synth_binary_store(str(tmp_path / "d"), 600, 4, seed=1,
                                chunk_rows=256)
    path = os.path.join(st.path, "X.bin")
    with open(path, "r+b") as fh:
        if damage == "truncate":
            fh.truncate(100)
        else:
            fh.seek(10)
            b = fh.read(1)
            fh.seek(10)
            fh.write(bytes([b[0] ^ 0xFF]))
    for m in (jcs, pcs):
        with pytest.raises(m.StoreIntegrityError, match="X.bin"):
            m.ColumnarStore(st.path)


def test_commit_staged_dir_swaps_like_the_jax_package(tmp_path):
    for m, tag in ((jint, "j"), (pint, "p")):
        final, tmp = tmp_path / f"{tag}_final", tmp_path / f"{tag}_tmp"
        for d, text in ((final, "old"), (tmp, "new")):
            d.mkdir()
            (d / "f").write_text(text)
        m.commit_staged_dir(str(tmp), str(final))
        assert (final / "f").read_text() == "new" and not tmp.exists()
        assert not [p for p in os.listdir(tmp_path) if ".old-" in p]


# --------------------------------------------------------------------------- #
# the pipeline and the builders                                               #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["matrix", "binned", "dual"])
def test_builders_equal_the_jax_package_bit_for_bit(stores, built, kind):
    js, ps = stores
    edges = built["edges"]
    if kind == "matrix":
        j = [jbd.device_matrix(js, chunk_rows=CHUNK)]
        p, st = pbd.device_matrix(ps, chunk_rows=CHUNK, return_stats=True,
                                  device="cpu")
        p = [p]
    elif kind == "binned":
        j = [jbd.device_binned(js, edges, chunk_rows=CHUNK)]
        p, st = pbd.device_binned(ps, edges, chunk_rows=CHUNK,
                                  return_stats=True, device="cpu")
        p = [p]
    else:
        j = list(jbd.dual_device_matrices(js, edges, chunk_rows=CHUNK))
        *p, st = pbd.dual_device_matrices(ps, edges, chunk_rows=CHUNK,
                                          return_stats=True, device="cpu")
    for a, b in zip(j, p):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) == (5120, D)
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(np.int16),
                                          b.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(a, b.numpy())
    assert st.chunks == 5 and st.bytes_wire == 5120 * D * 2
    assert st.wall_s > 0 and 0.0 <= st.overlap_frac <= 1.0


def test_write_kernels_plain_versions_round_and_bin_as_the_jax_package():
    """K12's plain versions (the kernel's oracle) on an f16 chunk with
    values on the edges, NaN and values that round to even in bf16."""
    rng = np.random.default_rng(5)
    edges = np.sort(rng.normal(size=(D, 31)), axis=1).astype(np.float32)
    c = rng.normal(size=(64, D)).astype(np.float16)
    c[0] = edges[:, 3].astype(np.float16)
    c[1, :3] = [np.nan, np.inf, -np.inf]
    c[2, :2] = [np.float16(1.00390625), np.float16(1.01171875)]  # ties
    jbuf, jb = jbd._dual_write_rows(
        jnp.zeros((128, D), jnp.bfloat16), jnp.zeros((128, D), jnp.int8),
        jnp.asarray(c), jnp.asarray(edges), 64)
    buf16 = torch.zeros((128, D), dtype=torch.bfloat16)
    bufb = torch.zeros((128, D), dtype=torch.int8)
    before = pbd.cuda_build.LAUNCHES["write_rows"]
    pbd.dual_write_rows(buf16, bufb, torch.from_numpy(c),
                        torch.from_numpy(edges), 64)
    assert pbd.cuda_build.LAUNCHES["write_rows"] == before  # plain: no count
    np.testing.assert_array_equal(np.asarray(jb), bufb.numpy())
    ok = ~np.isnan(np.asarray(jbuf, np.float32))
    np.testing.assert_array_equal(np.asarray(jbuf).view(np.int16)[ok],
                                  buf16.view(torch.int16).numpy()[ok])
    assert np.isnan(buf16.float().numpy()[~ok]).all()


def test_pipeline_propagates_worker_errors_and_deadlines():
    def bad(i):
        if i == 3:
            raise OSError("disk gone")
        return i

    with pytest.raises(OSError, match="disk gone"):
        ppl.run_chunk_pipeline(range(8), bad, lambda p: None, workers=2,
                               depth=2)
    with pytest.raises(TimeoutError):
        ppl.run_chunk_pipeline(range(8), lambda i: i, lambda p: None,
                               deadline_s=-1.0)
    st = ppl.run_chunk_pipeline(range(5), lambda i: i, lambda p: None)
    assert st.workers == 2 and st.depth == 2 and st.wall_s > 0


def test_chunk_ring_never_hands_out_a_buffer_still_in_use():
    """Sixteen workers (more than this machine's cores) through a ring of
    two buffers, with a short switch interval: each upload finds its
    buffer still holding its own chunk's value (a buffer reused before its
    chunk was issued would hold a later one)."""
    ring = ppl.ChunkRing(2, (64,), torch.float32, pin=False)
    seen = []

    def prepare(j):
        buf = ring.acquire(j)
        buf.fill_(j)
        return j, buf

    def upload(prepared):
        j, buf = prepared
        seen.append(bool((buf == j).all()))
        ring.issued(j, None)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ppl.run_chunk_pipeline(range(300), prepare, upload, workers=16,
                               depth=2, deadline_s=60.0,
                               on_error=ring.abort)
    finally:
        sys.setswitchinterval(old)
    assert len(seen) == 300 and all(seen)


def test_a_failed_upload_wakes_the_workers_waiting_on_the_ring():
    """A raise in upload aborts the ring: workers blocked in `acquire`
    wake with an error and the pipeline returns the upload's error within
    its time, instead of waiting on chunks that will never be issued."""
    ring = ppl.ChunkRing(1, (4,), torch.float32, pin=False)

    def upload(prepared):
        raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        ppl.run_chunk_pipeline(range(10), ring.acquire, upload, workers=4,
                               depth=1, on_error=ring.abort)
    with pytest.raises(RuntimeError, match="ring aborted"):
        ring.acquire(5)


@pytest.mark.parametrize("arg", [dict(cache="readwrite"), dict(sharding=2),
                                 dict(retry="transient")])
@pytest.mark.parametrize("builder", ["matrix", "binned", "dual"])
def test_builders_take_cache_sharding_and_retry(stores, built, arg,
                                                builder, tmp_path,
                                                monkeypatch):
    """Every option of the builders works: `sharding=` over a
    data mesh of 2 shards builds each matrix as a `RowSplit` equal, row for
    row, to the unsharded build (tests/test_torch_bigdata_sharded.py has
    the rest); `cache=` (tests/test_torch_feature_cache.py): a readwrite
    build misses, writes its artifact and the next build hits it; and
    `retry=`: chunk reads failing transiently at the ``ingest.read_chunk``
    fault point retry to the fault-free build's bits, the retries counted
    in the stats."""
    _, ps = stores
    fn = {"matrix": lambda **kw: pbd.device_matrix(ps, **kw),
          "binned": lambda **kw: pbd.device_binned(ps, built["edges"], **kw),
          "dual": lambda **kw: pbd.dual_device_matrices(
              ps, built["edges"], **kw)}[builder]
    if "cache" in arg:
        monkeypatch.setenv("TRANSMOGRIFAI_FEATURE_CACHE_DIR",
                           str(tmp_path / "cache"))
        got = [fn(device="cpu", chunk_rows=CHUNK, return_stats=True, **arg)
               for _ in range(2)]
        assert [g[-1].cache for g in got] == ["miss", "hit"]
        for a, b in zip(got[0][:-1], got[1][:-1]):
            assert torch.equal(a, b)
    elif "retry" in arg:
        from transmogrifai_tpu_torch.runtime.faults import (
            SITE_READ_CHUNK, FaultPlan, FaultSpec)
        from transmogrifai_tpu_torch.runtime.retry import RetryPolicy
        want = fn(device="cpu", chunk_rows=CHUNK, return_stats=True,
                  cache="off")
        plan = FaultPlan([FaultSpec(SITE_READ_CHUNK, at=2, times=2,
                                    transient=True)])
        with plan.active():
            got = fn(device="cpu", chunk_rows=CHUNK, return_stats=True,
                     cache="off", retry=RetryPolicy(max_attempts=3,
                                                    base_delay_s=0.0))
        assert got[-1].retries == 2 and want[-1].retries == 0
        for a, b in zip(want[:-1], got[:-1]):
            assert torch.equal(a, b)
    else:
        from transmogrifai_tpu_torch.parallel.mesh import (
            data_sharding, make_mesh)
        mesh = make_mesh(arg["sharding"], sweep=1, device="cpu")
        want = fn(device="cpu", chunk_rows=CHUNK, return_stats=True,
                  cache="off")
        got = fn(chunk_rows=CHUNK, return_stats=True, cache="off",
                 sharding=data_sharding(mesh))
        for a, b in zip(want[:-1], got[:-1]):
            assert b.shards.sizes == [3 * CHUNK, 2 * CHUNK]
            assert torch.equal(b.gather().view(torch.uint8),
                               a.view(torch.uint8))
    fn(device="cpu", chunk_rows=CHUNK, cache="off")  # "off" is no cache


def test_zero_row_store_builds_empty(tmp_path):
    st = pcs.ColumnarStore.create(str(tmp_path / "e"), 0, 7).close()
    x, b = pbd.dual_device_matrices(st, np.zeros((7, 3), np.float32),
                                    chunk_rows=128, device="cpu")
    assert x.shape == b.shape == (0, 7)


# --------------------------------------------------------------------------- #
# F2: chunked functions on row counts that are not a chunk multiple           #
# --------------------------------------------------------------------------- #

def _f2_calls(Xb, y, w):
    Y = torch.nn.functional.one_hot(y.long(), 2).float()
    V = torch.stack([y * w, w, w], -1)[None]
    return {
        "grow_tree_big": lambda: pbd.grow_tree_big(
            Xb, (y * w)[:, None], w, 3, 32, chunk=CHUNK),
        "grow_trees_big_lockstep": lambda: pbd.grow_trees_big_lockstep(
            Xb, V, 3, 32, chunk=CHUNK),
        "fit_forest_big": lambda: pbd.fit_forest_big(
            Xb, Y, w, 2, 3, 32, 2, chunk=CHUNK),
        "fit_gbt_big": lambda: pbd.fit_gbt_big(
            Xb, y, w, 1, 3, 32, 0.1, 1.0, chunk=CHUNK),
        "fit_gbt_big_lockstep": lambda: pbd.fit_gbt_big_lockstep(
            Xb, y, w[None], 1, 3, 32, 0.1, 1.0, chunk=CHUNK)}


@pytest.mark.parametrize("fn", ["grow_tree_big", "grow_trees_big_lockstep",
                                "fit_forest_big", "fit_gbt_big",
                                "fit_gbt_big_lockstep"])
def test_f2_chunked_functions_raise_on_a_ragged_tail(built, fn):
    Xb = built["pB"][:N]  # 5000 rows: not a multiple of 1024
    y = torch.from_numpy(built["y"][:N])
    calls = _f2_calls(Xb, y, torch.from_numpy(built["W"][0][:N]))
    with pytest.raises(ValueError, match="not a multiple of chunk=1024"):
        calls[fn]()


def test_f2_the_jax_package_drops_the_tail_and_padding_restores_it(built):
    """On 5000 rows with chunk 1024 the JAX package's chunked histograms
    leave out the 904 tail rows; on the builders' 5120 padded rows
    (zero-weight pad) the port's histograms equal the JAX package's, and
    they hold every real row."""
    jB, pB, y, w = built["jB"], built["pB"], built["y"], built["W"][0]
    V = np.stack([y * w, w], -1)
    node = jnp.zeros(N, jnp.int32)
    ragged = np.asarray(jbd._chunked_histograms(
        jB[:N], node, jnp.asarray(V[:N]), 1, 32, CHUNK))
    assert ragged[1].sum() / D == pytest.approx(w[:4096].sum())
    padded = np.asarray(jbd._chunked_histograms(
        jB, jnp.zeros(5120, jnp.int32), jnp.asarray(V), 1, 32, CHUNK))
    G, H = pbd._value_channels(torch.from_numpy(V)[None])
    hg, hh = pbd._histograms_chunked(
        pB, torch.zeros((1, 5120), dtype=torch.int32), G, H, 1, 32, CHUNK)
    np.testing.assert_array_equal(padded[0], hg[0, 0].numpy())
    np.testing.assert_array_equal(padded[1], hh[0].numpy())
    assert hh.sum().item() / D == pytest.approx(w[:N].sum())


# --------------------------------------------------------------------------- #
# the linear family                                                           #
# --------------------------------------------------------------------------- #

def _lr_grid(X, y, w, jax_side):
    l1v, l2v = cs.big_grid()
    if jax_side:
        p = jbd.fit_logreg_enet_grids_big(
            X, jnp.asarray(y), jnp.asarray(w), jnp.asarray(l1v),
            jnp.asarray(l2v), 2, cs.BIG_LR_STEPS)
        return np.asarray(p["W"]), np.asarray(p["b"]), p
    p = pbd.fit_logreg_enet_grids_big(X, torch.from_numpy(y),
                                      torch.from_numpy(w), l1v, l2v, 2,
                                      cs.BIG_LR_STEPS)
    return p["W"].numpy(), p["b"].numpy(), p


def test_lr_grid_within_the_jax_packages_own_sum_order_move(built):
    y, w = built["y"], built["W"][0]
    jW, jb, jp = _lr_grid(built["jX"], y, w, True)
    pW, pb, pp = _lr_grid(built["pX"], y, w, False)
    perm = np.random.default_rng(1).permutation(built["n_pad"])
    sW, sb, sp = _lr_grid(built["jX"][perm], y[perm], w[perm], True)
    want = {"lr_self_move_W": np.abs(sW - jW).max(),
            "lr_self_move_b": np.abs(sb - jb).max()}
    tol = cs.big_lr_tolerance(want)
    assert 1e-5 < tol["W"] < 1e-2  # the bf16 re-rounding's scale
    assert np.abs(pW - jW).max() <= tol["W"]
    assert np.abs(pb - jb).max() <= tol["b"]
    jpr = np.asarray(jbd.predict_logreg_grids_big(jp["W"], jp["b"],
                                                  built["jX"]))
    spr = np.asarray(jbd.predict_logreg_grids_big(sp["W"], sp["b"],
                                                  built["jX"]))
    ppr = pbd.predict_logreg_grids_big(pp["W"], pp["b"], built["pX"])
    assert ppr.shape == (8, built["n_pad"], 2)
    assert np.abs(ppr.numpy() - jpr).max() <= \
        cs.BIG_LR_SELF_FACTOR * np.abs(spr - jpr).max()
    one = pbd.predict_logreg_big(pp["W"][3], pp["b"][3], built["pX"])
    j1 = jbd.predict_logreg_big(jp["W"][3], jp["b"][3], built["jX"])
    np.testing.assert_array_equal(one["probability"].numpy(),
                                  ppr[3].numpy())
    dec = np.abs(np.diff(np.asarray(j1["rawPrediction"]), axis=1))[:, 0] \
        > 0.05
    np.testing.assert_array_equal(one["prediction"].numpy()[dec],
                                  np.asarray(j1["prediction"])[dec])


def test_lr_enet_single_fit_is_the_grid_fit(built):
    y, w = torch.from_numpy(built["y"]), torch.from_numpy(built["W"][1])
    l1v, l2v = cs.big_grid()
    g = pbd.fit_logreg_enet_grids_big(built["pX"], y, w, l1v[2:3],
                                      l2v[2:3], 2, 30)
    one = pbd.fit_logreg_enet_big(built["pX"], y, w, float(l1v[2]),
                                  float(l2v[2]), 2, 30)
    np.testing.assert_array_equal(one["W"].numpy(), g["W"][0].numpy())
    np.testing.assert_array_equal(one["b"].numpy(), g["b"][0].numpy())


def test_fit_logreg_big_at_the_metric_level(built):
    """F5: the L-BFGS paths part; the holdout AuPR stays within 1e-2."""
    y, w, v = built["y"], built["W"][0], built["V"][0]
    jl = jbd.fit_logreg_big(built["jX"], jnp.asarray(y), jnp.asarray(w),
                            0.01, 2, 50)
    pl = pbd.fit_logreg_big(built["pX"], torch.from_numpy(y),
                            torch.from_numpy(w), 0.01, 2, 50)
    yt, vt = torch.from_numpy(y), torch.from_numpy(v)[None]

    def aupr(p):
        return float(pdm.binned_aupr(p[:, 1][None], yt, vt, 4096,
                                     from_margin=False)[0])

    ja = aupr(torch.from_numpy(np.array(jbd.predict_logreg_big(
        jl["W"], jl["b"], built["jX"])["probability"])))
    pa = aupr(pbd.predict_logreg_big(pl["W"], pl["b"],
                                     built["pX"])["probability"])
    assert 0.6 < ja and abs(pa - ja) <= 1e-2


# --------------------------------------------------------------------------- #
# the tree families                                                           #
# --------------------------------------------------------------------------- #

def _trees_np(t):
    return {k: np.asarray(v) for k, v in t.items()}


def _assert_trees(jt, pt, leaf_atol):
    jt, pt = _trees_np(jt), {k: v.numpy() for k, v in pt.items()}
    np.testing.assert_array_equal(jt["feat"], pt["feat"])
    np.testing.assert_array_equal(jt["bin"], pt["bin"])
    np.testing.assert_allclose(pt["leaf"], jt["leaf"], rtol=0,
                               atol=leaf_atol)


def test_grow_tree_big_with_float_gradients(built):
    rng = np.random.default_rng(2)
    w = built["W"][0]
    G = (rng.normal(size=(built["n_pad"], 1)) * w[:, None]).astype(
        np.float32)
    H = (np.abs(rng.normal(size=built["n_pad"])) * w).astype(np.float32)
    jt = jbd.grow_tree_big(built["jB"], jnp.asarray(G), jnp.asarray(H), 4,
                           32, chunk=CHUNK)
    pt = pbd.grow_tree_big(built["pB"], torch.from_numpy(G),
                           torch.from_numpy(H), 4, 32, chunk=CHUNK)
    _assert_trees(jt, pt, cs.BIG_GBT_LEAF_ATOL)
    np.testing.assert_allclose(
        pbd.predict_tree_big(pt, built["pB"]).numpy(),
        np.asarray(jbd.predict_tree_big(jt, built["jB"])), rtol=0,
        atol=cs.BIG_GBT_LEAF_ATOL)


def test_grow_trees_big_lockstep_with_injected_values(built):
    rng = np.random.default_rng(4)
    K = 5
    fm = rng.uniform(size=(K, D)) < 0.7
    V = np.concatenate([rng.normal(size=(K, built["n_pad"], 2)),
                        rng.uniform(0.5, 2.0, (K, built["n_pad"], 1))],
                       -1).astype(np.float32) * built["W"][0][None, :, None]
    jt = jbd.grow_trees_big_lockstep(
        built["jB"], jnp.asarray(V), 4, 32, reg_lambda=0.5,
        min_child_weight=2.0, feature_mask_K=jnp.asarray(fm), chunk=CHUNK)
    pt = pbd.grow_trees_big_lockstep(
        built["pB"], torch.from_numpy(V), 4, 32, reg_lambda=0.5,
        min_child_weight=2.0, feature_mask_K=torch.from_numpy(fm),
        chunk=CHUNK)
    _assert_trees(jt, pt, cs.BIG_GBT_LEAF_ATOL)


def test_gbt_lockstep_trees_and_margins(built):
    wK = cs.big_gbt_weights(built["W"], built["V"])
    jt, jm = jbd.fit_gbt_big_lockstep(
        built["jB"], jnp.asarray(built["y"]), jnp.asarray(wK), 2, 4, 32,
        0.1, 1.0, "logistic", chunk=CHUNK)
    pt, pm = pbd.fit_gbt_big_lockstep(
        built["pB"], torch.from_numpy(built["y"]), torch.from_numpy(wK), 2,
        4, 32, 0.1, 1.0, "logistic", chunk=CHUNK)
    assert pt["feat"].shape == (2, 6, 4, 16) and pm.shape == (6, 5120)
    _assert_trees(jt, pt, cs.BIG_GBT_LEAF_ATOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=cs.BIG_GBT_MARGIN_ATOL)


def test_gbt_single_fit_squared_objective(built):
    y, w = built["y"] * 2.5 - 0.5, built["W"][2]
    jt, jm = jbd.fit_gbt_big(built["jB"], jnp.asarray(y), jnp.asarray(w), 2,
                             3, 32, 0.3, 1.0, "squared", chunk=CHUNK)
    pt, pm = pbd.fit_gbt_big(built["pB"], torch.from_numpy(y),
                             torch.from_numpy(w), 2, 3, 32, 0.3, 1.0,
                             "squared", chunk=CHUNK)
    _assert_trees(jt, pt, cs.BIG_GBT_LEAF_ATOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=cs.BIG_GBT_MARGIN_ATOL)


def jax_forest_draws(n_trees, n, d, seed, K):
    """The bootstrap counts and feature masks `fit_forest_big` of the JAX
    package draws for its first n_trees trees: `_forest_lockstep_batch`'s
    `inputs(key)` over the keys it splits from the seed."""
    n_sub = max(int(np.sqrt(d)), 1)
    keys = jax.random.split(jax.random.PRNGKey(seed),
                            -(-n_trees // K) * K)[:n_trees]

    def inputs(key):
        k1, k2 = jax.random.split(key)
        boot = jax.random.poisson(k1, 1.0, (n,))
        scores = jax.random.uniform(k2, (d,))
        return boot, scores <= jnp.sort(scores)[n_sub - 1]

    boot, mask = jax.vmap(inputs)(keys)
    return np.asarray(boot), np.asarray(mask)


def test_forest_with_the_jax_packages_draws(built):
    n_pad, y, w = built["n_pad"], built["y"], built["W"][0]
    n_trees, depth = 8, 4
    K = min(jbd.lockstep_width(depth, D, 32, 2, 16, n=n_pad), n_trees)
    boot, mask = jax_forest_draws(n_trees, n_pad, D, 3, K)
    Y1 = np.eye(2, dtype=np.float32)[y.astype(int)]
    jf = jbd.fit_forest_big(built["jB"], jnp.asarray(Y1), jnp.asarray(w),
                            n_trees, depth, 32, 2, seed=3, chunk=CHUNK)
    pf = pbd.fit_forest_big(built["pB"], torch.from_numpy(Y1),
                            torch.from_numpy(w), n_trees, depth, 32, 2,
                            seed=3, chunk=CHUNK, draws=(boot, mask),
                            trees_per_dispatch=3)  # batches need not match
    _assert_trees(jf, pf, 0.0)
    np.testing.assert_array_equal(
        pbd.predict_forest_big(pf, built["pB"]).numpy(),
        np.asarray(jbd.predict_forest_big(jf, built["jB"])))


def test_forest_draws_do_not_depend_on_the_lockstep_width(built):
    Y1 = torch.nn.functional.one_hot(torch.from_numpy(built["y"]).long(),
                                     2).float()
    w = torch.from_numpy(built["W"][0])
    a = pbd.fit_forest_big(built["pB"], Y1, w, 5, 3, 32, 2, seed=7,
                           chunk=CHUNK)
    b = pbd.fit_forest_big(built["pB"], Y1, w, 5, 3, 32, 2, seed=7,
                           chunk=CHUNK, trees_per_dispatch=2)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    boot, mask = pbd.forest_big_draws(7, range(5), 100, D, 3, True, "cpu")
    assert boot.shape == (5, 100) and (mask.sum(1) == 3).all()


def test_lockstep_width_keeps_the_memory_bound():
    for depth, m, want in ((6, 2, 16), (12, 2, 2), (10, 1, 12)):
        assert pbd.lockstep_width(depth, 500, 32, m, 16) == want
        assert pbd.lockstep_width(depth, 500, 32, m, 16) <= \
            jbd.lockstep_width(depth, 500, 32, m, 16)


# --------------------------------------------------------------------------- #
# the card fixture, rebuilt on the CPU                                        #
# --------------------------------------------------------------------------- #

def fixture_store(root):
    return pcs.synth_binary_store(os.path.join(root, "store"),
                                  cs.BIG_FIXTURE_ROWS, cs.BIG_D,
                                  seed=cs.BIG_SEED)


def test_fixture_store_binned_matrix_and_lr_grid_on_the_cpu(tmp_path):
    want = cs.load_big_fixture()
    st = fixture_store(str(tmp_path))
    assert cs.store_digest(st) == str(want["store_sha256"])
    edges = st.quantile_edges(cs.BIG_BINS)
    np.testing.assert_array_equal(edges, want["edges"])
    X16, Xb = pbd.dual_device_matrices(st, edges,
                                       chunk_rows=cs.BIG_FIXTURE_CHUNK,
                                       device="cpu")
    assert cs.tensor_digest(Xb) == str(want["binned_sha256"])
    W, _ = cs.big_folds(st.n_rows, X16.shape[0])
    l1v, l2v = cs.big_grid()
    p = pbd.fit_logreg_enet_grids_big(
        X16, torch.from_numpy(cs.big_labels(st, X16.shape[0])),
        torch.from_numpy(W[0]), l1v, l2v, 2, cs.BIG_LR_STEPS)
    tol = cs.big_lr_tolerance(want)
    assert np.abs(p["W"].numpy() - want["lr_W"]).max() <= tol["W"]
    assert np.abs(p["b"].numpy() - want["lr_b"]).max() <= tol["b"]


# --------------------------------------------------------------------------- #
# regenerate the card fixture with the JAX package                            #
# --------------------------------------------------------------------------- #

def regenerate(out_dir: str = cs.BIG_FIXTURE) -> None:
    """The JAX package's results at the fixture's shape: the store (seed
    11, 16384 × 500), its 32-bin edges, the dual build at chunk 4096, the
    LR grid on fold 0 (and its own move with the rows permuted), the
    lockstep GBT (6 pairs × 2 rounds at depth 6) and the 16-tree depth-6
    forest of seed 3 with its threefry draws."""
    n, d, chunk = cs.BIG_FIXTURE_ROWS, cs.BIG_D, cs.BIG_FIXTURE_CHUNK
    with tempfile.TemporaryDirectory() as tmp:
        st = jcs.synth_binary_store(os.path.join(tmp, "store"), n, d,
                                    seed=cs.BIG_SEED)
        edges = st.quantile_edges(cs.BIG_BINS)
        X16, Xb = jbd.dual_device_matrices(st, edges, chunk_rows=chunk)
        out = {"store_sha256": np.str_(cs.store_digest(st)),
               "edges": edges,
               "binned_sha256": np.str_(cs.tensor_digest(
                   torch.from_numpy(np.array(Xb))))}
        n_pad = X16.shape[0]
        y = cs.big_labels(st, n_pad)
    W, V = cs.big_folds(n, n_pad)
    lW, lb, _ = _lr_grid(X16, y, W[0], True)
    perm = np.random.default_rng(1).permutation(n_pad)
    sW, sb, _ = _lr_grid(X16[perm], y[perm], W[0][perm], True)
    out.update(lr_W=lW, lr_b=lb, lr_self_move_W=np.abs(sW - lW).max(),
               lr_self_move_b=np.abs(sb - lb).max())
    print(json.dumps({"lr_self_move_W": float(out["lr_self_move_W"]),
                      "lr_self_move_b": float(out["lr_self_move_b"])}),
          flush=True)
    g = cs.BIG_GBT
    trees, margin = jbd.fit_gbt_big_lockstep(
        Xb, jnp.asarray(y), jnp.asarray(cs.big_gbt_weights(W, V)),
        g["n_estimators"], g["max_depth"], cs.BIG_BINS, g["learning_rate"],
        g["reg_lambda"], "logistic", chunk=chunk)
    out.update({f"gbt_{k}": np.asarray(v) for k, v in trees.items()})
    out["gbt_margin"] = np.asarray(margin)
    r = cs.BIG_RF
    K = min(jbd.lockstep_width(r["max_depth"], d, cs.BIG_BINS, 2, 16,
                               n=n_pad), r["n_trees"])
    boot, mask = jax_forest_draws(r["n_trees"], n_pad, d, r["seed"], K)
    Y1 = jax.nn.one_hot(jnp.asarray(y).astype(jnp.int32), 2)
    forest = jbd.fit_forest_big(Xb, Y1, jnp.asarray(W[0]), r["n_trees"],
                                r["max_depth"], cs.BIG_BINS, 2,
                                seed=r["seed"], chunk=chunk,
                                trees_per_dispatch=16)
    out.update({f"rf_{k}": np.asarray(v) for k, v in forest.items()})
    assert boot.max() < 256
    out.update(rf_boot=boot.astype(np.uint8), rf_mask=mask)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "fixture.npz"), **out)
    print(json.dumps({"wrote": out_dir, "keys": sorted(out)}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] != ["regenerate"]:
        raise SystemExit(
            "usage: JAX_PLATFORMS=cpu python tests/test_torch_bigdata.py "
            "regenerate")
    regenerate()
