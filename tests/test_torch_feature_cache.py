"""Parity of the port's feature cache and quantized wire with the JAX
package's (`data/feature_cache.py`, `store/artifact.py`, the `cache=`
policy of `parallel/bigdata.py`'s builders, K12-dequant's plain version).

Both packages run on the CPU, each on its own seeded store from its own
`synth_binary_store` (the two write the same bytes; tests/
test_torch_bigdata.py holds that), 5000 × 12 at chunk 1024: the builders
pad to 5120 rows, so the tail chunk carries pad rows.

Equal, bit for bit or byte for byte:
- `cache_key` for every kind, target dtype, wire mode, chunk layout, bin
  plan and quant config; the JAX package's dtype names, never torch's;
- `compute_quant_plan` (scale, lo, pad row) and the wire tape
  (`QuantPlan.quantize`, `_pack4`, `_unpack4_host`), odd d included;
- K12-dequant's plain version (`unpack_dequant_plain` and the three
  writes, f32 and bf16 targets and int8 bins) against the JAX package's
  jitted `_dequant_write_rows`, `_dequant_bin_write_rows` and
  `_dequant_dual_write_rows`: the rounding is one fused multiply-add (a
  case where two roundings differ is in the inputs), values sit on and
  one ulp either side of edges, and subnormal results, scales, los and
  edges act as XLA's CPU program has them act (flushed to signed zero);
- artifacts cross between the packages both ways (a `readwrite` miss in
  one is a hit in the other) on `auto`, `f16`, `int8` and `int4`, with
  bit-equal matrices and byte-equal wire tapes;
- the committed digests of the 16384 × 500 fixture's quantized builds
  (`testdata/big_synth_16384x500/quant_digests.json`, made by the JAX
  package on the CPU) rebuilt by the port on the CPU.

Then the JAX suite's cases (tests/test_feature_cache.py) run against the
port: the warm path, key invalidation, corrupt and torn artifacts, the
quantized wire, resident reuse and policy threading. Left out:
`test_opparams_roundtrip` and `test_serving_config_installs_default` (the
policy is not threaded through `OpParams` and `ServingConfig` yet,
ROADMAP queue 1 items 4 and 10) and the goodput report (`obs/`, item
10). `test_sharding_change_misses` runs against the port in
tests/test_torch_bigdata_sharded.py (a change of data sharding misses,
the same one hits).

Regenerate the fixture digests (CPU, a few seconds) with:

    JAX_PLATFORMS=cpu python tests/test_torch_feature_cache.py regenerate
"""

import dataclasses
import json
import os
import shutil
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the package imports follow the repo root on the path (a script run)
from transmogrifai_tpu.data import columnar_store as jcs  # noqa: E402
from transmogrifai_tpu.data import feature_cache as jfc  # noqa: E402
from transmogrifai_tpu.parallel import bigdata as jbd  # noqa: E402
from transmogrifai_tpu_torch.data import columnar_store as pcs  # noqa: E402
from transmogrifai_tpu_torch.data import feature_cache as fc  # noqa: E402
from transmogrifai_tpu_torch.obs.metrics import get_registry  # noqa: E402
from transmogrifai_tpu_torch.parallel import bigdata as bd  # noqa: E402
from transmogrifai_tpu_torch.runtime import integrity as pint  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the fixture's digests and judge)

N_ROWS, N_FEATS, CHUNK = 5000, 12, 1024
ColumnarStore = pcs.ColumnarStore


def _bits(x: torch.Tensor) -> np.ndarray:
    """A port matrix as numpy bytes (bf16 as its 16-bit patterns)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jbits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture()
def store(tmp_path):
    return pcs.synth_binary_store(str(tmp_path / "store"), N_ROWS, N_FEATS,
                                  seed=3, chunk_rows=CHUNK)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(JAX store, port store): the same bytes, each package's own."""
    root = tmp_path_factory.mktemp("fc")
    return (jcs.synth_binary_store(str(root / "jax"), N_ROWS, N_FEATS,
                                   seed=3, chunk_rows=CHUNK),
            pcs.synth_binary_store(str(root / "port"), N_ROWS, N_FEATS,
                                   seed=3, chunk_rows=CHUNK))


@pytest.fixture()
def params(tmp_path):
    return fc.FeatureCacheParams(dir=str(tmp_path / "cache"),
                                 policy="readwrite")


def _edges(store):
    return store.quantile_edges(16, sample=N_ROWS)


def _matrix(store, **kw):
    return bd.device_matrix(store, chunk_rows=kw.pop("chunk_rows", CHUNK),
                            device="cpu", **kw)


# --------------------------------------------------------------------------- #
# keys, quant plans and wire tapes: the JAX package's bytes                   #
# --------------------------------------------------------------------------- #

TARGETS = {"matrix": [("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)],
           "binned": [("int8", torch.int8)],
           "dual": [("bfloat16", torch.bfloat16)]}


@pytest.mark.parametrize("chunk", [CHUNK, 512])
@pytest.mark.parametrize("wire", ["float16", "int8", "int4", "float32"])
@pytest.mark.parametrize("kind,target", [
    (k, t) for k, ts in TARGETS.items() for t in ts])
def test_cache_key_equals_the_jax_packages(stores, kind, target, wire,
                                           chunk):
    js, ps = stores
    name, tdt = target
    assert np.dtype(getattr(jnp, name)).name == name == fc.dtype_name(tdt)
    edges = None if kind == "matrix" else js.quantile_edges(16)
    for sample, seed in ((200_000, 0), (2000, 7)):
        kw = dict(target_dtype=name, wire=wire, chunk_rows=chunk,
                  edges=edges, quant_sample=sample, quant_seed=seed)
        want = jfc.cache_key(kind, js, **kw)
        assert fc.cache_key(kind, ps, **kw) == want
        assert fc.cache_key(kind, ps, **{**kw, "target_dtype": tdt}) == want
    assert fc.store_fingerprint(ps) == jfc.store_fingerprint(js)
    assert fc._edges_digest(edges) == jfc._edges_digest(edges)


def test_dtype_names_are_the_jax_packages():
    for t in (torch.float16, torch.bfloat16, torch.float32, torch.int8,
              torch.uint8):
        name = fc.dtype_name(t)
        assert not name.startswith("torch")
        assert np.dtype(getattr(jnp, name)).name == name
    with pytest.raises(ValueError):
        fc.dtype_name(torch.complex64)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64", "uint8"])
def test_wire_dtype_mapping_without_ml_dtypes(name):
    """Every wire dtype name an artifact can carry maps to a numpy storage
    dtype of the JAX package's width (bfloat16 as raw uint16 bits) and to
    the torch dtype the ring buffers use."""
    np_dt, t_dt = fc.WIRE_DTYPES[name]
    assert fc._np_dtype(name) == np_dt
    assert np_dt.itemsize == jfc._np_dtype(name).itemsize \
        == t_dt.itemsize
    assert fc.dtype_name(t_dt) == name
    if name != "bfloat16":
        assert np_dt == np.dtype(name)
    else:
        assert np_dt == np.dtype(np.uint16) and t_dt == torch.bfloat16


def test_unknown_wire_dtype_is_a_rejected_artifact(store, params):
    _, st = _matrix(store, cache=params, return_stats=True)
    adir = os.path.join(params.resolved_dir(), st.cache_key)
    with pytest.raises(ValueError):
        fc._np_dtype("float8_e4m3fn")
    with open(os.path.join(adir, fc.ARTIFACT)) as fh:
        meta = json.load(fh)
    meta["wire_dtype"] = "float8_e4m3fn"
    with open(os.path.join(adir, fc.ARTIFACT), "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(fc.FeatureCacheError, match="malformed meta"):
        fc.FeatureCache(params).load(st.cache_key)


@pytest.mark.parametrize("sample,seed", [(N_ROWS, 0), (2000, 0), (2000, 5)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_plan_equals_the_jax_packages(stores, bits, sample, seed):
    js, ps = stores
    want = jfc.compute_quant_plan(js, bits, sample=sample, seed=seed)
    got = fc.compute_quant_plan(ps, bits, sample=sample, seed=seed)
    for k in ("scale", "lo", "pad_row"):
        assert getattr(got, k).dtype == getattr(want, k).dtype
        assert getattr(got, k).tobytes() == getattr(want, k).tobytes(), k
    assert got.wire_cols == want.wire_cols and got.qmax == want.qmax


def test_quant_plan_with_nans_equals_the_jax_packages(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2048, 5)).astype(np.float16)
    X[5, 2] = np.nan
    X[:, 3] = np.nan
    X[:, 4] = 2.5
    plans = []
    for mod in (jcs, pcs):
        w = mod.ColumnarStore.create(str(tmp_path / mod.__name__), 2048, 5)
        w.write_chunk(0, X, np.zeros(2048, np.float32))
        plans.append(mod is jcs and jfc.compute_quant_plan(
            w.close(), 8, sample=2048) or fc.compute_quant_plan(
            w.close(), 8, sample=2048))
    for k in ("scale", "lo", "pad_row"):
        assert getattr(plans[0], k).tobytes() == getattr(plans[1], k).tobytes()


def _wire_inputs(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32) * 3.0
    x[0, :3] = [np.nan, np.inf, -np.inf]
    x[1] = 1e6          # clips to qmax
    x[2] = -1e6         # clips to 0
    return x


@pytest.mark.parametrize("d", [12, 13])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_pack_are_byte_equal(bits, d):
    rng = np.random.default_rng(bits * 100 + d)
    scale = (rng.uniform(0.01, 1.0, d)).astype(np.float32)
    lo = rng.normal(size=d).astype(np.float32) - 3.0
    jp = jfc.QuantPlan(bits=bits, scale=scale, lo=lo)
    pp = fc.QuantPlan(bits=bits, scale=scale, lo=lo)
    assert pp.pad_row.tobytes() == jp.pad_row.tobytes()
    for dtype in (np.float32, np.float16, np.float64):
        with np.errstate(over="ignore"):  # ±1e6 is ±inf in f16
            x = _wire_inputs(rng, 257, d).astype(dtype)
        x_before = x.copy()
        q = pp.quantize(x)
        np.testing.assert_array_equal(x, x_before)  # the input is untouched
        assert q.dtype == np.uint8 and q.shape == (257, pp.wire_cols)
        assert q.tobytes() == jp.quantize(x).tobytes()
    codes = rng.integers(0, 1 << bits, size=(9, d), dtype=np.uint8)
    if bits == 4:
        packed = fc._pack4(codes)
        assert packed.tobytes() == jfc._pack4(codes).tobytes()
        np.testing.assert_array_equal(fc._unpack4_host(packed, d), codes)
        if d % 2:
            assert not (packed[:, -1] >> 4).any()  # the pad nibble is 0


# --------------------------------------------------------------------------- #
# K12-dequant's plain version against the JAX package's jitted writes         #
# --------------------------------------------------------------------------- #

def _dequant_case(bits, d, seed=0):
    """(codes (c, d) uint8, scale, lo, edges (d, 15)) with: an element
    whose FMA and two roundings differ, values on an edge and one ulp
    either side, subnormal results, a subnormal scale, lo and edge, and
    the int4 pad nibble set on odd d (never read)."""
    rng = np.random.default_rng(seed + bits + d)
    c, qmax = 64, (1 << bits) - 1
    scale = rng.uniform(0.01, 2.0, d).astype(np.float32)
    lo = rng.normal(size=d).astype(np.float32) * 4.0
    q = rng.integers(0, qmax + 1, size=(c, d)).astype(np.uint8)
    # column 0: q·scale + lo lands subnormal (exact −2^-130 at q = 1)
    scale[0], lo[0] = 2.0 ** -110, -(2.0 ** -110) - 2.0 ** -130
    q[:3, 0] = [1, 0, 2]
    # column 1: a subnormal scale and lo (treated as signed zeros)
    scale[1], lo[1] = np.float32(3e-39), np.float32(-1e-39)
    x64 = q.astype(np.float64) * scale.astype(np.float64) \
        + lo.astype(np.float64)
    fma = x64.astype(np.float32)
    two = (q.astype(np.float32) * scale) + lo
    assert (fma[:, 2:] != two[:, 2:]).any(), "no element tells FMA apart"
    edges = np.sort(rng.normal(size=(d, 15)) * 4.0, axis=1).astype(
        np.float32)
    # an edge on a value, one ulp above and one below another value
    for f in range(2, d):
        v = fma[3, f]
        edges[f, 5] = v
        edges[f, 6] = np.nextafter(fma[4, f], np.float32(np.inf))
        edges[f, 7] = np.nextafter(fma[5, f], np.float32(-np.inf))
    edges[0, 0] = np.float32(1e-40)   # a subnormal edge
    edges = np.sort(edges, axis=1)
    wire = q if bits == 8 else fc._pack4(q)
    if bits == 4 and d % 2:
        wire = wire.copy()
        wire[:, -1] |= np.uint8(0xA0)  # padding: never read
    return wire, scale, lo, edges


@pytest.mark.parametrize("d", [12, 13])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("entry", ["f32", "bf16", "bin", "dual"])
def test_dequant_plain_equals_the_jax_packages_writes(entry, bits, d):
    wire, scale, lo, edges = _dequant_case(bits, d)
    c, n, r0 = wire.shape[0], 200, 37
    t = [torch.from_numpy(a) for a in (wire, scale, lo, edges)]
    jargs = [jnp.asarray(a) for a in (wire, scale, lo)]
    if entry in ("f32", "bf16"):
        dt, jdt = ((torch.float32, jnp.float32) if entry == "f32"
                   else (torch.bfloat16, jnp.bfloat16))
        buf = torch.full((n, d), 7.0, dtype=dt)
        bd.dequant_write_rows(buf, t[0], t[1], t[2], r0, bits)
        want = jbd._dequant_write_rows(jnp.full((n, d), 7.0, jdt), *jargs,
                                       r0, bits=bits)
        np.testing.assert_array_equal(_bits(buf), _jbits(want))
    elif entry == "bin":
        buf = torch.full((n, d), 9, dtype=torch.int8)
        bd.dequant_bin_write_rows(buf, t[0], t[1], t[2], t[3], r0, bits)
        want = jbd._dequant_bin_write_rows(
            jnp.full((n, d), 9, jnp.int8), *jargs, jnp.asarray(edges), r0,
            bits=bits)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    else:
        b16 = torch.zeros((n, d), dtype=torch.bfloat16)
        bb = torch.zeros((n, d), dtype=torch.int8)
        bd.dequant_dual_write_rows(b16, bb, t[0], t[1], t[2], t[3], r0, bits)
        w16, wb = jbd._dequant_dual_write_rows(
            jnp.zeros((n, d), jnp.bfloat16), jnp.zeros((n, d), jnp.int8),
            *jargs, jnp.asarray(edges), r0, bits=bits)
        np.testing.assert_array_equal(_bits(b16), _jbits(w16))
        np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))
    # the f32 values themselves: the FMA rounded once, flushed to ±0
    x = bd.unpack_dequant_plain(t[0], t[1], t[2], bits, d).numpy()
    assert x.view(np.uint32)[0, 0] == 0x80000000  # −2^-130 → −0
    assert (x[:, 1] == 0).all()                    # subnormal scale, lo
    assert x.shape == (c, d)


def test_dequant_wrappers_check_their_inputs():
    wire, scale, lo, edges = _dequant_case(4, 13)
    t = [torch.from_numpy(a) for a in (wire, scale, lo, edges)]
    buf = torch.zeros((64, 13), dtype=torch.float32)
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        bd.dequant_write_rows(buf, t[0], t[1], t[2], 0, 2)
    with pytest.raises(ValueError, match="wide uint8"):
        bd.dequant_write_rows(buf, t[0], t[1], t[2], 0, 8)
    with pytest.raises(ValueError, match="do not fit"):
        bd.dequant_write_rows(buf, t[0], t[1], t[2], 1, 4)
    with pytest.raises(ValueError, match="scale and lo"):
        bd.dequant_write_rows(buf, t[0], t[1].double(), t[2], 0, 4)
    with pytest.raises(ValueError, match="edges must be"):
        bd.dequant_bin_write_rows(buf.to(torch.int8), t[0], t[1], t[2],
                                  t[3][:, :3].T.contiguous(), 0, 4)


# --------------------------------------------------------------------------- #
# artifacts cross between the packages                                        #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("wire", ["auto", "f16", "int8", "int4"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_between_the_packages(stores, tmp_path, writer,
                                              wire):
    """A readwrite miss in one package writes the artifact the other
    package then hits, with zero store reads; both packages' matrices are
    bit-equal and their wire tapes byte-equal (a ragged store: the tail
    chunk's pad rows ride the tape)."""
    js, ps = stores
    edges = js.quantile_edges(32)
    cache = str(tmp_path / "cache")
    jp = jfc.FeatureCacheParams(dir=cache, policy="readwrite", wire=wire)
    pp = fc.FeatureCacheParams(dir=cache, policy="readwrite", wire=wire)

    def port():
        return bd.dual_device_matrices(ps, edges, chunk_rows=CHUNK,
                                       cache=pp, return_stats=True,
                                       device="cpu")

    def jax_():
        return jbd.dual_device_matrices(js, edges, chunk_rows=CHUNK,
                                        cache=jp, return_stats=True)

    first, second = (jax_, port) if writer == "jax" else (port, jax_)
    x1, b1, s1 = first()
    x2, b2, s2 = second()
    assert (s1.cache, s2.cache) == ("miss", "hit")
    assert s1.cache_key == s2.cache_key
    assert s2.read_s == 0.0 and s2.bytes_read == 0
    assert s2.cache_bytes == os.path.getsize(
        os.path.join(cache, s1.cache_key, fc.WIRE))
    (px, pb), (jx, jb) = ((x2, b2), (x1, b1)) if writer == "jax" else \
        ((x1, b1), (x2, b2))
    np.testing.assert_array_equal(_bits(px), _jbits(jx))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    # the tape the port writes is the JAX package's, byte for byte
    other = str(tmp_path / "other")
    again = (bd.dual_device_matrices(
        ps, edges, chunk_rows=CHUNK, device="cpu", return_stats=True,
        cache=dataclasses.replace(pp, dir=other)) if writer == "jax" else
        jbd.dual_device_matrices(js, edges, chunk_rows=CHUNK,
                                 return_stats=True,
                                 cache=dataclasses.replace(jp, dir=other)))
    assert again[2].cache == "miss"
    assert pint.sha256_file(os.path.join(cache, s1.cache_key, fc.WIRE)) \
        == pint.sha256_file(os.path.join(other, s1.cache_key, fc.WIRE))
    with open(os.path.join(cache, s1.cache_key, fc.ARTIFACT)) as fh:
        m1 = json.load(fh)
    with open(os.path.join(other, s1.cache_key, fc.ARTIFACT)) as fh:
        m2 = json.load(fh)
    for m in (m1, m2):
        m.pop("created")
        m.pop("cold")
    assert m1 == m2  # the same manifest but for its clock and cold stats


def test_bf16_wire_artifact_crosses_without_ml_dtypes(tmp_path):
    """An f32 store built into bf16 ships a bf16 wire (the narrower
    dtype): the JAX package's bf16 tape is a hit for the port, read as
    raw uint16 bits, and the matrices are equal."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2048, 4)).astype(np.float32)
    built = []
    for mod in (jcs, pcs):
        w = mod.ColumnarStore.create(str(tmp_path / mod.__name__), 2048, 4,
                                     dtype="float32")
        w.write_chunk(0, X, np.zeros(2048, np.float32))
        built.append(w.close())
    cache = str(tmp_path / "c")
    jx, jst = jbd.device_matrix(
        built[0], chunk_rows=1024, return_stats=True,
        cache=jfc.FeatureCacheParams(dir=cache, policy="readwrite"))
    px, pst = bd.device_matrix(
        built[1], chunk_rows=1024, return_stats=True, device="cpu",
        cache=fc.FeatureCacheParams(dir=cache, policy="read"))
    assert jst.wire == pst.wire == "bfloat16"
    assert pst.cache == "hit" and pst.read_s == 0.0
    assert fc.FeatureCache(fc.FeatureCacheParams(dir=cache)).load(
        pst.cache_key).wire.dtype == np.uint16
    np.testing.assert_array_equal(_bits(px), _jbits(jx))


def test_fixture_quant_digests_equal_the_jax_packages(tmp_path):
    """The 16384 × 500 fixture store through int8 and int4 (every
    K12-dequant entry's plain version, at the card fixture's shape) equals
    the JAX package's committed digests: the quant plan, the wire tape and
    both matrices; `device_matrix` and `device_binned` equal the dual
    build's halves."""
    st = pcs.synth_binary_store(str(tmp_path / "s"), cs.BIG_FIXTURE_ROWS,
                                cs.BIG_D, seed=cs.BIG_SEED)
    edges = cs.load_big_fixture()["edges"]
    got = cs.port_quant_fixture(bd, fc, st, edges, str(tmp_path / "c"),
                                device="cpu")
    judged = cs.judge_quant_fixture(got)
    assert judged["ok"], judged


# --------------------------------------------------------------------------- #
# the JAX suite's cases, against the port                                     #
# --------------------------------------------------------------------------- #

class TestWarmPath:
    @pytest.mark.parametrize("kind", ["matrix", "binned", "dual"])
    def test_second_build_zero_store_reads_and_identical(self, store,
                                                         params, kind):
        edges = _edges(store)
        build = {"matrix": lambda: bd.device_matrix(
                     store, chunk_rows=CHUNK, cache=params,
                     return_stats=True, device="cpu"),
                 "binned": lambda: bd.device_binned(
                     store, edges, chunk_rows=CHUNK, cache=params,
                     return_stats=True, device="cpu"),
                 "dual": lambda: bd.dual_device_matrices(
                     store, edges, chunk_rows=CHUNK, cache=params,
                     return_stats=True, device="cpu")}[kind]
        *m1, st1 = build()
        assert st1.cache == "miss" and not st1.cache_hit
        assert st1.read_s > 0 and st1.bytes_read > 0
        assert st1.cache_write_s > 0
        *m2, st2 = build()
        assert st2.cache == "hit" and st2.cache_hit
        assert st2.read_s == 0.0 and st2.bytes_read == 0
        assert st2.cache_bytes > 0 and st2.cache_read_s >= 0.0
        assert st2.chunks == st1.chunks and st2.bytes_wire == st1.bytes_wire
        for a, b in zip(m1, m2):
            np.testing.assert_array_equal(_bits(a), _bits(b))

    def test_warm_binned_bit_identical_to_uncached_direct_build(
            self, store, params):
        edges = _edges(store)
        direct = bd.device_binned(store, edges, chunk_rows=CHUNK,
                                  device="cpu")
        bd.device_binned(store, edges, chunk_rows=CHUNK, cache=params,
                         device="cpu")
        warm, st = bd.device_binned(store, edges, chunk_rows=CHUNK,
                                    cache=params, return_stats=True,
                                    device="cpu")
        assert st.cache == "hit"
        np.testing.assert_array_equal(warm.numpy(), direct.numpy())

    def test_read_policy_does_not_write(self, store, params):
        ro = dataclasses.replace(params, policy="read")
        _, st = _matrix(store, cache=ro, return_stats=True)
        assert st.cache == "miss"
        assert not fc.FeatureCache(ro).probe(st.cache_key)
        _matrix(store, cache=params)
        _, st2 = _matrix(store, cache=ro, return_stats=True)
        assert st2.cache == "hit"

    def test_cache_off_is_legacy(self, store):
        _, st = _matrix(store, cache="off", return_stats=True)
        assert st.cache == "" and st.cache_key == ""
        assert "cache" not in st.to_extra()

    def test_stats_to_extra_carries_cache_fields(self, store, params):
        _matrix(store, cache=params)
        _, st = _matrix(store, cache=params, return_stats=True)
        extra = st.to_extra()
        assert extra["cache"] == "hit"
        assert extra["cache_key"] == st.cache_key
        assert extra["cache_bytes"] == st.cache_bytes
        assert extra["cache_read_s"] == st.cache_read_s

    def test_artifact_records_cold_wall(self, store, params):
        _, st = _matrix(store, cache=params, return_stats=True)
        art = fc.FeatureCache(params).load(st.cache_key)
        assert art.cold_wall_s > 0.0
        assert art.meta["cold"]["bytes_wire"] == st.bytes_wire


class TestKeyInvalidation:
    def test_mutating_store_column_misses(self, tmp_path, params):
        path = str(tmp_path / "store")
        store = pcs.synth_binary_store(path, N_ROWS, N_FEATS, seed=3,
                                       chunk_rows=CHUNK)
        _, st1 = _matrix(store, cache=params, return_stats=True)
        assert st1.cache == "miss"
        mutated = np.array(store.chunk(0, N_ROWS), copy=True)
        mutated[:, 0] = mutated[:, 0] + np.float16(1.0)
        w = ColumnarStore.create(path, N_ROWS, N_FEATS)
        w.write_chunk(0, mutated, np.asarray(store.y, np.float32))
        store2 = w.close()
        assert fc.store_fingerprint(store2) != fc.store_fingerprint(store)
        _, st2 = _matrix(store2, cache=params, return_stats=True)
        assert st2.cache == "miss", "stale artifact served for mutated data"

    def test_bin_plan_change_misses(self, store, params):
        e16 = store.quantile_edges(16, sample=N_ROWS)
        e8 = store.quantile_edges(8, sample=N_ROWS)
        kw = dict(chunk_rows=CHUNK, cache=params, return_stats=True,
                  device="cpu")
        _, st1 = bd.device_binned(store, e16, **kw)
        _, st2 = bd.device_binned(store, e8, **kw)
        assert st1.cache == st2.cache == "miss"
        assert st1.cache_key != st2.cache_key
        _, st3 = bd.device_binned(store, e16, **kw)
        assert st3.cache == "hit"

    @pytest.mark.parametrize("change", ["dtype", "wire", "chunk"])
    def test_plan_change_misses(self, store, params, change):
        _, st1 = _matrix(store, cache=params, return_stats=True)
        kw = {"dtype": dict(dtype=torch.float32),
              "wire": dict(cache=dataclasses.replace(params, wire="int8")),
              "chunk": dict(chunk_rows=CHUNK // 2)}[change]
        _, st2 = _matrix(store, **{"cache": params, "return_stats": True,
                                   **kw})
        assert st2.cache == "miss"
        assert st1.cache_key != st2.cache_key


def _artifact_dir(params, key):
    return os.path.join(params.resolved_dir(), key)


def _flip(path, at):
    with open(path, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 0xFF]))


def _corrupt_count() -> float:
    return get_registry().sum_family("feature_cache_corrupt_total")


class TestCorruptArtifacts:
    def _populate(self, store, params):
        _, st = _matrix(store, cache=params, return_stats=True)
        return st.cache_key

    @pytest.mark.parametrize("damage,reason", [
        ("bit_flip", "checksum mismatch"), ("truncate", "truncated"),
        ("mid_write_kill", "torn artifact"),
        ("garbage_manifest", "manifest unreadable")])
    def test_rejected_structured_then_rebuilt(self, store, params, damage,
                                              reason):
        key = self._populate(store, params)
        adir = _artifact_dir(params, key)
        wire = os.path.join(adir, fc.WIRE)
        if damage == "bit_flip":
            _flip(wire, 37)
        elif damage == "truncate":
            with open(wire, "r+b") as fh:
                fh.truncate(os.path.getsize(wire) // 2)
        elif damage == "mid_write_kill":
            os.unlink(os.path.join(adir, fc.ARTIFACT))
        else:
            with open(os.path.join(adir, fc.ARTIFACT), "w") as fh:
                fh.write("{not json")
        with pytest.raises(fc.FeatureCacheError) as ei:
            fc.FeatureCache(params).load(key)
        assert ei.value.key == key and reason in ei.value.reason
        # the builder: a counted rebuild, the right values, repaired
        before = _corrupt_count()
        ref = _matrix(store)
        got, st = _matrix(store, cache=params, return_stats=True)
        assert st.cache == "miss"
        assert _corrupt_count() == before + 1
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        _, st2 = _matrix(store, cache=params, return_stats=True)
        assert st2.cache == "hit"

    def test_staged_tmp_dir_is_not_an_artifact(self, store, params):
        key = self._populate(store, params)
        adir = _artifact_dir(params, key)
        shutil.move(adir, adir + ".tmp-99999")
        cache = fc.FeatureCache(params)
        assert not cache.probe(key)
        assert cache.load(key) is None

    def test_concurrent_writers_same_key_do_not_collide(self, tmp_path):
        final = str(tmp_path / "k1")
        meta = {"n_rows": 4, "n_pad": 4, "n_features": 2,
                "wire_dtype": "float16", "wire_cols": 2, "kind": "matrix",
                "wire": "float16", "chunk_rows": 4}
        w1 = fc.ArtifactWriter(final, "k1", meta)
        w2 = fc.ArtifactWriter(final, "k1", meta)
        assert w1.tmp != w2.tmp
        chunk = np.arange(8, dtype=np.float16).reshape(4, 2)
        w1.append(chunk)
        assert os.path.isdir(w1.tmp), "second writer clobbered the first"
        w2.append(chunk * 2)
        w1.finalize()
        w2.finalize()
        art = fc.FeatureCache(fc.FeatureCacheParams(
            dir=str(tmp_path), policy="read")).load("k1")
        np.testing.assert_array_equal(np.asarray(art.wire), chunk * 2)

    def test_commit_race_loser_does_not_strand_old_dir(self, tmp_path,
                                                       monkeypatch):
        final = str(tmp_path / "k")
        tmp = str(tmp_path / "k.tmp-1")
        os.makedirs(final)
        open(os.path.join(final, "v1"), "w").write("old")
        os.makedirs(tmp)
        open(os.path.join(tmp, "v2"), "w").write("mine")
        real_rename = os.rename

        def racing_rename(src, dst):
            if src == tmp:
                os.makedirs(final, exist_ok=True)
                open(os.path.join(final, "winner"), "w").write("w")
                raise OSError(39, "Directory not empty")
            return real_rename(src, dst)

        monkeypatch.setattr(pint.os, "rename", racing_rename)
        with pytest.raises(OSError, match="not empty"):
            pint.commit_staged_dir(tmp, final)
        monkeypatch.undo()
        assert os.path.exists(os.path.join(final, "winner"))
        assert not [p for p in os.listdir(str(tmp_path)) if ".old-" in p]

    def test_finalize_commit_failure_cleans_staged_dir(self, tmp_path,
                                                       monkeypatch):
        final = str(tmp_path / "kx")
        w = fc.ArtifactWriter(final, "kx", {"n_pad": 2, "wire_cols": 2,
                                            "wire_dtype": "float16"})
        w.append(np.zeros((2, 2), np.float16))
        tmp_dir = w.tmp

        def boom(staged_dir, key):
            raise OSError("rename race lost")
        monkeypatch.setattr(w.store.backend, "commit", boom)
        with pytest.raises(OSError):
            w.finalize()
        assert not os.path.exists(tmp_dir), "staged dir leaked"
        assert not os.path.exists(final)

    @pytest.mark.parametrize("stage", ["append", "finalize"])
    def test_failing_cache_disk_degrades_to_an_uncached_build(
            self, store, params, monkeypatch, stage):
        """A failing append or finalize warns and leaves an uncached
        build with the right values (the JAX package's behaviour): no
        artifact, no staged directory."""
        def boom(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(fc.ArtifactWriter, stage, boom)
        got, st = _matrix(store, cache=params, return_stats=True)
        np.testing.assert_array_equal(_bits(got), _bits(_matrix(store)))
        assert st.cache == "miss"
        monkeypatch.undo()
        assert not fc.FeatureCache(params).probe(st.cache_key)
        assert not [p for p in os.listdir(params.resolved_dir())
                    if p.startswith(".stage-")] or stage == "finalize"


class TestQuantizedWire:
    @pytest.mark.parametrize("wire,ratio_floor", [("int8", 1.9),
                                                  ("int4", 3.5)])
    def test_quant_wire_within_stated_tolerance(self, store, params,
                                                wire, ratio_floor):
        qp = dataclasses.replace(params, wire=wire, quant_sample=N_ROWS)
        x_q, st = _matrix(store, cache=qp, return_stats=True)
        x_f16 = _matrix(store)
        ratio = (st.bytes_wire + st.bytes_saved_wire) / st.bytes_wire
        assert ratio >= ratio_floor
        assert st.wire == wire
        plan = fc.compute_quant_plan(store, 8 if wire == "int8" else 4,
                                     sample=N_ROWS)
        a = x_q[:N_ROWS].float().numpy()
        b = x_f16[:N_ROWS].float().numpy()
        tol = plan.scale[None, :] * 0.5 + 0.02 * np.abs(b) + 1e-2
        assert (np.abs(a - b) <= tol).all()

    @pytest.mark.parametrize("kind", ["matrix", "binned", "dual"])
    @pytest.mark.parametrize("wire", ["int8", "int4"])
    def test_quant_warm_replay_bit_identical_to_quant_cold(
            self, store, params, wire, kind):
        qp = dataclasses.replace(params, wire=wire)
        edges = _edges(store)
        kw = dict(chunk_rows=CHUNK, cache=qp, return_stats=True,
                  device="cpu")
        build = {"matrix": lambda: bd.device_matrix(store, **kw),
                 "binned": lambda: bd.device_binned(store, edges, **kw),
                 "dual": lambda: bd.dual_device_matrices(store, edges,
                                                         **kw)}[kind]
        *m1, st1 = build()
        *m2, st2 = build()
        assert (st1.cache, st2.cache) == ("miss", "hit")
        assert st2.read_s == 0.0
        for a, b in zip(m1, m2):
            np.testing.assert_array_equal(_bits(a), _bits(b))

    def test_quant_tail_pads_with_the_quantized_zero_row(self, store,
                                                        params):
        qp = dataclasses.replace(params, wire="int8")
        _, st = _matrix(store, cache=qp, return_stats=True)
        art = fc.FeatureCache(qp).load(st.cache_key)
        tail = np.asarray(art.wire[N_ROWS:])
        assert tail.shape == (5 * CHUNK - N_ROWS, N_FEATS)
        assert (tail == art.quant.pad_row).all()

    def test_quant_dual_binned_matches_quant_direct_binned(self, store,
                                                           params):
        qp = dataclasses.replace(params, wire="int8")
        edges = _edges(store)
        _, b_dual = bd.dual_device_matrices(store, edges, chunk_rows=CHUNK,
                                            cache=qp, device="cpu")
        b_direct = bd.device_binned(store, edges, chunk_rows=CHUNK,
                                    device="cpu", cache=dataclasses.replace(
                                        qp, dir=qp.dir + "-2"))
        np.testing.assert_array_equal(b_dual.numpy(), b_direct.numpy())

    def test_nan_feature_does_not_poison_quant_plan(self, tmp_path,
                                                    params):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(2048, 4)).astype(np.float16)
        X[5, 2] = np.nan
        X[:, 3] = np.nan
        w = ColumnarStore.create(str(tmp_path / "nans"), 2048, 4)
        w.write_chunk(0, X, np.zeros(2048, np.float32))
        store = w.close()
        plan = fc.compute_quant_plan(store, 8, sample=2048)
        assert np.isfinite(plan.scale).all() and np.isfinite(plan.lo).all()
        qp = dataclasses.replace(params, wire="int8", quant_sample=2048)
        xq = _matrix(store, chunk_rows=1024, cache=qp)
        got = xq[:2048].float().numpy()
        assert np.isfinite(got).all()
        ref = np.asarray(X[:, :2], np.float32)
        tol = plan.scale[None, :2] * 0.5 + 0.02 * np.abs(ref) + 1e-2
        assert (np.abs(got[:, :2] - ref) <= tol).all()

    def test_explicit_f16_wire_narrows_a_wider_store(self, tmp_path,
                                                     params):
        rng = np.random.default_rng(2)
        X = rng.normal(size=(2048, 4)).astype(np.float32)
        w = ColumnarStore.create(str(tmp_path / "f32store"), 2048, 4,
                                 dtype="float32")
        w.write_chunk(0, X, np.zeros(2048, np.float32))
        store = w.close()
        fp = dataclasses.replace(params, wire="f16")
        _, st16 = _matrix(store, dtype=torch.float32, chunk_rows=1024,
                          cache=fp, return_stats=True)
        _, st32 = _matrix(store, dtype=torch.float32, chunk_rows=1024,
                          return_stats=True)
        assert st16.wire == "float16"
        assert st16.bytes_wire * 2 == st32.bytes_wire
        art = fc.FeatureCache(fp).load(st16.cache_key)
        assert art.meta["wire_dtype"] == "float16"

    def test_quant_plan_constant_feature_exact(self, tmp_path):
        w = ColumnarStore.create(str(tmp_path / "const"), 64, 3)
        X = np.zeros((64, 3), np.float16)
        X[:, 1] = 2.5
        X[:, 2] = np.arange(64)
        w.write_chunk(0, X, np.zeros(64, np.float32))
        plan = fc.compute_quant_plan(w.close(), 8, sample=64)
        deq = plan.dequantize_host(plan.quantize(X.astype(np.float32)), 3)
        np.testing.assert_allclose(deq[:, 1], 2.5, atol=0)
        np.testing.assert_allclose(deq[:, 0], 0.0, atol=0)

    def test_zero_row_store_builds_empty_through_the_cache(self, tmp_path,
                                                           params):
        st = ColumnarStore.create(str(tmp_path / "e"), 0, 7).close()
        for wire in ("auto", "int4"):
            qp = dataclasses.replace(params, wire=wire)
            for _ in range(2):
                x, b, s = bd.dual_device_matrices(
                    st, np.zeros((7, 3), np.float32), chunk_rows=128,
                    cache=qp, return_stats=True, device="cpu")
                assert x.shape == b.shape == (0, 7)
            assert s.cache == "hit"


class TestResident:
    def test_resident_reuse_returns_same_tensors(self, store, params):
        rp = dataclasses.replace(params, resident=True)
        edges = _edges(store)
        kw = dict(chunk_rows=CHUNK, cache=rp, return_stats=True,
                  device="cpu")
        x1, b1, st1 = bd.dual_device_matrices(store, edges, **kw)
        try:
            x2, b2, st2 = bd.dual_device_matrices(store, edges, **kw)
            assert st2.cache == "resident" and st2.cache_hit
            assert x2 is x1 and b2 is b1
            assert x2.data_ptr() == x1.data_ptr()
            assert st2.read_s == 0.0 and st2.cache_bytes == 0
            assert fc.resident_release(st1.cache_key) == 1
            _, _, st3 = bd.dual_device_matrices(store, edges, **kw)
            assert st3.cache == "hit"
        finally:
            fc.resident_release(st1.cache_key)

    def test_resident_off_by_default(self, store, params):
        _, st1 = _matrix(store, cache=params, return_stats=True)
        assert fc.resident_get(st1.cache_key) is None


class TestPolicyThreading:
    def test_process_default_scope(self, store, params):
        with fc.cache_scope(params.to_json()):
            assert fc.get_default_cache_params().policy == "readwrite"
            _, st = _matrix(store, return_stats=True)  # cache=None
            assert st.cache == "miss"
            _, st2 = _matrix(store, return_stats=True)
            assert st2.cache == "hit"
        assert fc.get_default_cache_params() is None
        _, st3 = _matrix(store, return_stats=True)
        assert st3.cache == ""

    def test_policy_string_uses_default_dir(self, store, params,
                                            monkeypatch):
        monkeypatch.setenv(fc.ENV_DIR, params.resolved_dir())
        _, st = _matrix(store, cache="readwrite", return_stats=True)
        assert st.cache == "miss"
        _, st2 = _matrix(store, cache="read", return_stats=True)
        assert st2.cache == "hit"
        assert os.path.isdir(os.path.join(params.resolved_dir(),
                                          st.cache_key))

    def test_env_policy(self, store, params, monkeypatch):
        monkeypatch.setenv(fc.ENV_POLICY, "readwrite")
        monkeypatch.setenv(fc.ENV_DIR, params.resolved_dir())
        _, st = _matrix(store, return_stats=True)
        assert st.cache == "miss"

    def test_env_wire_typo_degrades_not_crashes(self, store, params,
                                                monkeypatch):
        monkeypatch.setenv(fc.ENV_POLICY, "readwrite")
        monkeypatch.setenv(fc.ENV_DIR, params.resolved_dir())
        monkeypatch.setenv(fc.ENV_WIRE, "int16")
        _, st = _matrix(store, return_stats=True)
        assert st.cache in ("miss", "hit")
        assert st.wire != "int16"

    def test_store_root_env_moves_the_cache_dir(self, tmp_path,
                                                monkeypatch):
        """The JAX package's precedence: the subsystem's own variable,
        then `<TRANSMOGRIFAI_STORE_DIR>/feature_cache` — both packages
        resolve the same directory."""
        monkeypatch.delenv(fc.ENV_DIR, raising=False)
        monkeypatch.setenv("TRANSMOGRIFAI_STORE_DIR", str(tmp_path / "r"))
        assert fc.default_cache_dir() == jfc.default_cache_dir() \
            == str(tmp_path / "r" / "feature_cache")
        monkeypatch.setenv(fc.ENV_DIR, str(tmp_path / "own"))
        assert fc.default_cache_dir() == jfc.default_cache_dir() \
            == str(tmp_path / "own")

    def test_dir_only_json_enables_readwrite(self, tmp_path):
        p = fc.FeatureCacheParams.from_json({"dir": str(tmp_path / "d"),
                                             "resident": True})
        assert p.policy == "readwrite" and p.enabled
        with fc.cache_scope({"dir": str(tmp_path / "fc-d")}):
            installed = fc.get_default_cache_params()
            assert installed is not None
            assert installed.policy == "readwrite"
        assert fc.FeatureCacheParams.from_json(
            {"dir": str(tmp_path / "d"), "policy": "off"}).enabled is False
        with fc.cache_scope({"dir": str(tmp_path / "fc-d"),
                             "policy": "off"}):
            assert fc.resolve_cache_params(None) is None

    def test_overlapping_scopes_do_not_wipe_live_policy(self, tmp_path):
        a = fc.FeatureCacheParams(dir=str(tmp_path / "a"),
                                  policy="readwrite")
        b = fc.FeatureCacheParams(dir=str(tmp_path / "b"), policy="read")
        prev = fc.set_default_cache_params(None)
        try:
            scope_a = fc.cache_scope(a)
            scope_a.__enter__()
            scope_b = fc.cache_scope(b)
            scope_b.__enter__()
            scope_a.__exit__(None, None, None)
            assert fc.get_default_cache_params() is b
            scope_b.__exit__(None, None, None)
        finally:
            fc.set_default_cache_params(prev)

    def test_params_json_roundtrip_equals_the_jax_packages(self):
        p = fc.FeatureCacheParams(dir="/x", policy="read", wire="int4",
                                  verify="size", resident=True,
                                  quant_sample=100, quant_seed=3)
        assert p.to_json() == jfc.FeatureCacheParams(**p.to_json()).to_json()
        assert fc.FeatureCacheParams.from_json(p.to_json()) == p

    def test_bad_policy_and_wire_raise(self):
        with pytest.raises(ValueError):
            fc.FeatureCacheParams(policy="always")
        with pytest.raises(ValueError):
            fc.FeatureCacheParams(wire="fp8")
        with pytest.raises(ValueError):
            fc.resolve_cache_params("sometimes")
        with pytest.raises(TypeError):
            fc.resolve_cache_params(3)


def test_metrics_count_hits_misses_and_saved_bytes(store, params):
    reg = get_registry()
    names = ("feature_cache_hits_total", "feature_cache_misses_total",
             "feature_cache_bytes_saved_total")
    before = {n: reg.sum_family(n) for n in names}
    _matrix(store, cache=params)
    _matrix(store, cache=params)
    after = {n: reg.sum_family(n) for n in names}
    assert after["feature_cache_misses_total"] == \
        before["feature_cache_misses_total"] + 1
    assert after["feature_cache_hits_total"] == \
        before["feature_cache_hits_total"] + 1
    assert after["feature_cache_bytes_saved_total"] == \
        before["feature_cache_bytes_saved_total"] + store.nbytes()
    assert reg.find("store_puts_total", backend="localdir").value >= 1


# --------------------------------------------------------------------------- #
# regenerate the fixture's quantized digests with the JAX package             #
# --------------------------------------------------------------------------- #

def regenerate(out_path: str = cs.BIG_QUANT_DIGESTS) -> None:
    """The JAX package's dual build of the fixture store (seed 11, 16384 ×
    500, the fixture's 32-bin edges, chunk 4096) through the feature cache
    on each quantized wire: `chip_smoke.quant_digests` of the quant plan,
    the wire tape and both matrices, and the cache key."""
    n, d = cs.BIG_FIXTURE_ROWS, cs.BIG_D
    edges = cs.load_big_fixture()["edges"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        st = jcs.synth_binary_store(os.path.join(tmp, "store"), n, d,
                                    seed=cs.BIG_SEED)
        for wire in cs.QUANT_WIRES:
            params = jfc.FeatureCacheParams(dir=os.path.join(tmp, "c"),
                                            policy="readwrite", wire=wire)
            X16, Xb, stats = jbd.dual_device_matrices(
                st, edges, chunk_rows=cs.BIG_FIXTURE_CHUNK, cache=params,
                return_stats=True)
            art = jfc.FeatureCache(params).load(stats.cache_key)
            out[wire] = {**cs.quant_digests(
                art.quant.scale, art.quant.lo, art.quant.pad_row,
                art.meta["files"]["wire.bin"]["sha256"], _jbits(X16),
                np.asarray(Xb)), "cache_key": stats.cache_key}
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(json.dumps(out, indent=1, sort_keys=True))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_feature_cache.py regenerate
    if sys.argv[1:] != ["regenerate"]:
        raise SystemExit(
            "usage: python tests/test_torch_feature_cache.py regenerate")
    regenerate()
