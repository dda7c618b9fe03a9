"""Out-of-core model fitting: device-resident bf16 and int8 matrices fed by
row-chunk streaming from a `ColumnarStore`, through the feature cache.

The port's counterpart of the JAX package's `parallel/bigdata.py`
(BASELINE target 4: 10M rows × 500 features, `bench.py::run_big`):

- **builders** (`device_matrix`, `device_binned`, `dual_device_matrices`)
  stream the memmapped store through the pipelined upload
  (`data/pipeline.py`): worker threads read row chunks and cast them to the
  wire in a ring of pinned host buffers; each chunk is copied to the card
  on a side stream and written into the preallocated resident buffers by
  the hand kernel K12 (`csrc/write_rows.cu`): widened to bf16, binned to
  int8, or both from one read. The JAX package donates its buffers to
  `dynamic_update_slice`; here they are allocated once and written in
  place;
- **the feature cache** (`data/feature_cache.py`, ``cache=`` on the
  builders, the JAX package's policy and artifacts byte for byte): a
  `readwrite` miss tees each chunk's host bytes into a staged artifact in
  item order; a hit replays the artifact's wire tape through the same
  writes with zero store reads, bit-equal to the cold build. A quantized
  wire (``wire="int8"``/``"int4"``) quantizes on the host workers and
  ships 1 or 0.5 bytes per element; K12's dequant entries unpack it,
  compute x = fma(q, scale, lo) in f32 and write bf16 and/or int8 bins
  from that one value. A corrupt artifact is counted and rebuilt cold, a
  failing cache disk degrades to an uncached build (the JAX package's
  behaviour): the matrices are built on the card by the kernels either
  way;
- **linear family** (K14: `fit_logreg_enet_grids_big` and siblings):
  FISTA / L-BFGS over the bf16 matrix, every product bf16 × bf16 with an
  f32 result (`torch.mm(..., out_dtype=torch.float32)` on the card: no f32
  copy of X; TF32 is never enabled). On the CPU both operands widen to f32:
  products of bf16 values are exact in f32, so only the sum order differs
  from the JAX package;
- **tree families** (K13: `grow_trees_big_lockstep`, `fit_forest_big`,
  `fit_gbt_big_lockstep` and siblings): K learners grown level by level
  against the resident int8 matrix, every level one launch of K1
  (histograms), K2 (split search) and K3 (routing) over the K learners
  along the kernels' pair axis, then K3's leaf pass. The JAX package
  contracts a per-chunk bin one-hot on the MXU; K1 reads each row's bins
  directly. Value columns are rounded to bf16 and widened to f32 before
  K1 and K3, as the JAX package's matmuls quantize them;
- **prediction** (`predict_tree_big`, `predict_forest_big`) through K5 on
  the int8 matrix;
- **the data axis** (``sharding=data_sharding(mesh)`` on the builders):
  the rows split over the mesh's data axis in whole upload chunks, each
  chunk written into the shard that owns it on one side stream per card
  (`parallel/rowshards.py` has the design); the builders return
  `RowSplit`s and every learner and predictor here takes one in place of
  a tensor. Each reduction over rows is a sum of the shards' partials on
  the lead in shard order: the LR products (Σw and the penalty once), K1
  (K2 on the lead), K3's leaf sums with the formula on the lead; K3's
  routing and K5 run a shard at a time. The JAX package's builders take
  any `NamedSharding` and GSPMD does the rest; the port takes the data
  axis's and refuses any other, and a split inside a chunk, by name.

F2: the JAX package's chunked helpers drop tail rows when the row count is
not a multiple of `chunk` (`n // chunk` chunks). The builders pad to a
chunk multiple (pad rows carry zero weight downstream; on a quantized wire
they are the quantized zero row, `QuantPlan.pad_row`, as in the JAX
package), and every function here that takes `chunk` raises when n % chunk
!= 0. K1 and K3 take all rows in one launch, so `chunk` only bounds the
plain versions' working set on the CPU.

Chunk reads retry transient IO under `retry=` (a `runtime.retry.
RetryPolicy`; by default `_default_ingest_retry`, whose attempts
``TRANSMOGRIFAI_INGEST_RETRIES`` sets), with attempts and backoff in the
returned `IngestStats`, as in the JAX package.

Not ported (ROADMAP.md, queue 1, item 10): the learned upload plan
(`workers`/`depth` default to `UPLOAD_WORKERS`/`UPLOAD_DEPTH`). The JAX
package's cache events for its trace (`record_event`) are absent with its
trace (queue 1, item 10). The JAX package's dispatch-time bound in
`lockstep_width` guards a TPU's execution limit and is left out
(ROADMAP.md says so).
"""

from __future__ import annotations

import bisect
import ctypes
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from transmogrifai_tpu_torch import cuda_build
from transmogrifai_tpu_torch.data import feature_cache as fc
from transmogrifai_tpu_torch.data.columnar_store import ColumnarStore
from transmogrifai_tpu_torch.data.pipeline import (
    IngestStats, ChunkRing, run_chunk_pipeline)
from transmogrifai_tpu_torch.device import resolve_device
from transmogrifai_tpu_torch.evaluators.device_metrics import sigmoid
from transmogrifai_tpu_torch.models import lbfgs
from transmogrifai_tpu_torch.models.trees import (  # noqa: F401
    _f32, _histograms_chunked, _require, bin_dtype, bin_features_plain,
    grow_trees, hist_scratch_bytes, level_times, predict_forest, tree_walk)
# (`level_times` and `_histograms_chunked` live with `grow_trees`; the big
# path's callers reach them here)
from transmogrifai_tpu_torch.parallel.mesh import DATA_AXIS, NamedSharding
from transmogrifai_tpu_torch.parallel.rowshards import (
    RowShards, RowSplit, chunk_shards, rows_of)
from transmogrifai_tpu_torch.stages.base import fma_f32

log = logging.getLogger(__name__)

UPLOAD_CHUNK_ROWS = 262_144   # 256 MB of f16 per chunk at d = 500
HIST_CHUNK_ROWS = 65_536      # the CPU plain versions' row chunk
UPLOAD_WORKERS = 2            # memmap read + cast threads
UPLOAD_DEPTH = 4              # chunk copies and writes in flight

QUANT_BITS = (8, 4)


def _pad_rows(n: int, chunk: int) -> int:
    return -(-n // chunk) * chunk


def _check_chunk(name: str, n: int, chunk: int) -> None:
    """F2: the JAX package's chunked helpers drop the rows past the last
    whole chunk; the port raises instead."""
    if chunk <= 0 or n % chunk != 0:
        raise ValueError(
            f"{name}: {n} rows are not a multiple of chunk={chunk}; pad the "
            "rows to a chunk multiple with zero-weight rows, as the "
            "builders do")


def _default_ingest_retry():
    """Bounded-retry policy for transient IO during bulk ingest (a single
    flaky read must not burn a long upload): the JAX package's, with
    ``TRANSMOGRIFAI_INGEST_RETRIES`` total attempts (1 disables
    retrying)."""
    from transmogrifai_tpu_torch.runtime.retry import RetryPolicy
    attempts = int(os.environ.get("TRANSMOGRIFAI_INGEST_RETRIES", "3"))
    return RetryPolicy(max_attempts=max(1, attempts),
                       base_delay_s=0.1, max_delay_s=5.0)


# --------------------------------------------------------------------------- #
# K12: chunk writes into the resident matrices                                #
# --------------------------------------------------------------------------- #

def write_cast_rows_plain(buf: torch.Tensor, chunk: torch.Tensor,
                          r0: int) -> None:
    """buf[r0:r0 + c] = chunk widened or narrowed to buf's dtype."""
    buf[r0:r0 + chunk.shape[0]] = chunk.to(buf.dtype)


def bin_write_rows_plain(bufb: torch.Tensor, chunk: torch.Tensor,
                         edges: torch.Tensor, r0: int) -> None:
    """bufb[r0:r0 + c] = the int8 bins of the chunk widened to f32 (K4's
    plain binning)."""
    bufb[r0:r0 + chunk.shape[0]] = bin_features_plain(
        chunk.to(torch.float32), edges).to(torch.int8)


def dual_write_rows_plain(buf16: torch.Tensor, bufb: torch.Tensor,
                          chunk: torch.Tensor, edges: torch.Tensor,
                          r0: int) -> None:
    write_cast_rows_plain(buf16, chunk, r0)
    bin_write_rows_plain(bufb, chunk, edges, r0)


def _write_shapes(name, chunk, r0, *bufs):
    _require(chunk.dim() == 2, f"{name}: chunk must be (c, d), got "
                               f"{tuple(chunk.shape)}")
    for b in bufs:
        _require(b.dim() == 2 and b.shape[1] == chunk.shape[1]
                 and 0 <= r0 and r0 + chunk.shape[0] <= b.shape[0],
                 f"{name}: rows {r0}..{r0 + chunk.shape[0]} of a chunk "
                 f"{tuple(chunk.shape)} do not fit a buffer "
                 f"{tuple(b.shape)}")


def _check_write_cuda(name, chunk, edges, *bufs):
    for b in bufs + ((edges,) if edges is not None else ()):
        _require(b.device == chunk.device,
                 f"{name}: chunk on {chunk.device}, an operand on "
                 f"{b.device}")
        _require(b.is_contiguous(), f"{name}: operands must be contiguous")
    _require(chunk.dtype == torch.float16 and chunk.is_contiguous(),
             f"{name}: the kernel takes a contiguous f16 chunk, got "
             f"{chunk.dtype}")
    if edges is not None:
        _require(edges.dtype == torch.float32 and edges.dim() == 2
                 and edges.shape[0] == chunk.shape[1]
                 and bin_dtype(edges.shape[1]) == torch.int8,
                 f"{name}: edges must be ({chunk.shape[1]}, n_edges <= 126) "
                 f"f32, got {tuple(edges.shape)} {edges.dtype}")


cuda_build.register("write_rows",
                    ("write_cast_rows_bf16", "write_cast_rows_f32"),
                    (ctypes.c_void_p,) * 2 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int, ctypes.c_void_p))
cuda_build.register("write_rows", "bin_write_rows",
                    (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
cuda_build.register("write_rows", "dual_write_rows",
                    (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


def _launch(fname, *args, ref, key="write_rows"):
    """Launch `fname` of csrc/write_rows.cu on `ref`'s current stream and
    count it under `key`."""
    err = cuda_build.launch(ref.get_device(),
                            cuda_build.entry("write_rows", fname), *args)
    cuda_build.check(fname, err)
    cuda_build.count(key)


def write_cast_rows(buf: torch.Tensor, chunk: torch.Tensor, r0: int) -> None:
    """Rows r0 .. r0 + c of `buf` (bf16 or f32) from an f16 chunk (c, d),
    widened on the device (f32 → bf16 to nearest even). A CUDA tensor
    launches K12 (or raises); a CPU tensor takes the plain version."""
    _write_shapes("write_cast_rows", chunk, r0, buf)
    if not chunk.is_cuda:
        return write_cast_rows_plain(buf, chunk, r0)
    _check_write_cuda("write_cast_rows", chunk, None, buf)
    _require(buf.dtype in (torch.bfloat16, torch.float32),
             f"write_cast_rows: the kernel writes bf16 or f32, got "
             f"{buf.dtype}")
    fname = ("write_cast_rows_bf16" if buf.dtype == torch.bfloat16
             else "write_cast_rows_f32")
    _launch(fname, chunk.data_ptr(), buf.data_ptr(), r0,
            chunk.shape[0], chunk.shape[1], ref=chunk)


def bin_write_rows(bufb: torch.Tensor, chunk: torch.Tensor,
                   edges: torch.Tensor, r0: int) -> None:
    """Rows r0 .. r0 + c of the int8 matrix `bufb`: the count of edges
    (d, n_edges) each f16 value widened to f32 is >= (NaN → 0). A CUDA
    tensor launches K12 (or raises); a CPU tensor takes the plain
    version."""
    _write_shapes("bin_write_rows", chunk, r0, bufb)
    if not chunk.is_cuda:
        return bin_write_rows_plain(bufb, chunk, edges, r0)
    _check_write_cuda("bin_write_rows", chunk, edges, bufb)
    _require(bufb.dtype == torch.int8, "bin_write_rows: bufb must be int8")
    _launch("bin_write_rows", chunk.data_ptr(), edges.data_ptr(),
            bufb.data_ptr(), r0, chunk.shape[0], chunk.shape[1],
            edges.shape[1], ref=chunk)


def dual_write_rows(buf16: torch.Tensor, bufb: torch.Tensor,
                    chunk: torch.Tensor, edges: torch.Tensor,
                    r0: int) -> None:
    """`write_cast_rows` into the bf16 `buf16` and `bin_write_rows` into
    `bufb` from one read of the chunk. A CUDA tensor launches K12 (or
    raises); a CPU tensor takes the plain version."""
    _write_shapes("dual_write_rows", chunk, r0, buf16, bufb)
    if not chunk.is_cuda:
        return dual_write_rows_plain(buf16, bufb, chunk, edges, r0)
    _check_write_cuda("dual_write_rows", chunk, edges, buf16, bufb)
    _require(buf16.dtype == torch.bfloat16 and bufb.dtype == torch.int8,
             "dual_write_rows: buffers must be bf16 and int8")
    _launch("dual_write_rows", chunk.data_ptr(),
            edges.data_ptr(), buf16.data_ptr(), bufb.data_ptr(), r0,
            chunk.shape[0], chunk.shape[1], edges.shape[1], ref=chunk)


# --------------------------------------------------------------------------- #
# K12-dequant: the quantized wire dequantized as it is written                #
# --------------------------------------------------------------------------- #

F32_TINY = 2.0 ** -126  # f32's least normal magnitude


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values to zero of the same sign. The JAX package's
    jitted dequant writes run on XLA's CPU programs, which treat subnormal
    inputs as zero and flush subnormal results to zero (measured on its
    `_dequant_write_rows`: q·scale + lo landing at ±2^-128 comes out ±0,
    and a subnormal scale, lo or edge acts as ±0)."""
    return torch.where(x.abs() < F32_TINY, x * 0.0, x)


def wire_cols(d: int, bits: int) -> int:
    """Bytes per row of the quantized wire: d (int8) or ceil(d/2) (int4,
    feature 2j in the low nibble of byte j, 2j + 1 in the high)."""
    return (d + 1) // 2 if bits == 4 else d


def unpack_dequant_plain(chunk_q: torch.Tensor, scale: torch.Tensor,
                         lo: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(c, d) f32 features of a uint8 wire chunk: the int4 nibbles
    unpacked (the JAX package's `_unpack_dequant`), then x = q·scale + lo
    rounded once (the fused multiply-add XLA contracts it into, `fma_f32`),
    with subnormal scale, lo and results flushed to signed zero as XLA's
    CPU program does (`_flush`)."""
    q = chunk_q
    if bits == 4:
        q = torch.stack([q & 0x0F, q >> 4], dim=-1).reshape(
            q.shape[0], -1)[:, :d]
    c = q.shape[0]
    return _flush(fma_f32(q.to(torch.float32),
                          _flush(scale.float())[None, :].expand(c, d),
                          _flush(lo.float())[None, :].expand(c, d)))


def dequant_write_rows_plain(buf: torch.Tensor, chunk_q: torch.Tensor,
                             scale: torch.Tensor, lo: torch.Tensor, r0: int,
                             bits: int) -> None:
    """buf[r0:r0 + c] = the dequantized chunk in buf's dtype (bf16 to
    nearest even)."""
    x = unpack_dequant_plain(chunk_q, scale, lo, bits, buf.shape[1])
    buf[r0:r0 + x.shape[0]] = x.to(buf.dtype)


def _dequant_bins_plain(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return bin_features_plain(x, _flush(edges.float())).to(torch.int8)


def dequant_bin_write_rows_plain(bufb: torch.Tensor, chunk_q: torch.Tensor,
                                 scale: torch.Tensor, lo: torch.Tensor,
                                 edges: torch.Tensor, r0: int,
                                 bits: int) -> None:
    """bufb[r0:r0 + c] = the int8 bins of the dequantized f32 chunk: the
    count of edges each value is >= (K4's rule; subnormal edges act as
    zero, as on XLA's CPU)."""
    x = unpack_dequant_plain(chunk_q, scale, lo, bits, bufb.shape[1])
    bufb[r0:r0 + x.shape[0]] = _dequant_bins_plain(x, edges)


def dequant_dual_write_rows_plain(buf16: torch.Tensor, bufb: torch.Tensor,
                                  chunk_q: torch.Tensor, scale: torch.Tensor,
                                  lo: torch.Tensor, edges: torch.Tensor,
                                  r0: int, bits: int) -> None:
    """Both writes from one dequantized f32 value per element."""
    x = unpack_dequant_plain(chunk_q, scale, lo, bits, buf16.shape[1])
    buf16[r0:r0 + x.shape[0]] = x.to(buf16.dtype)
    bufb[r0:r0 + x.shape[0]] = _dequant_bins_plain(x, edges)


def _dequant_shapes(name, chunk_q, scale, lo, edges, r0, bits, *bufs):
    _require(bits in QUANT_BITS, f"{name}: bits must be 8 or 4, got {bits}")
    d = bufs[0].shape[1] if bufs[0].dim() == 2 else -1
    _require(chunk_q.dim() == 2 and chunk_q.dtype == torch.uint8
             and chunk_q.shape[1] == wire_cols(d, bits),
             f"{name}: the chunk must be ({wire_cols(d, bits)},)-wide uint8 "
             f"for d = {d} at {bits} bits, got {tuple(chunk_q.shape)} "
             f"{chunk_q.dtype}")
    for v in (scale, lo):
        _require(v.dim() == 1 and v.shape[0] == d
                 and v.dtype == torch.float32,
                 f"{name}: scale and lo must be ({d},) f32")
    for b in bufs:
        _require(b.dim() == 2 and b.shape[1] == d and 0 <= r0
                 and r0 + chunk_q.shape[0] <= b.shape[0],
                 f"{name}: rows {r0}..{r0 + chunk_q.shape[0]} do not fit a "
                 f"buffer {tuple(b.shape)}")
    if edges is not None:
        _require(edges.dtype == torch.float32 and edges.dim() == 2
                 and edges.shape[0] == d
                 and bin_dtype(edges.shape[1]) == torch.int8,
                 f"{name}: edges must be ({d}, n_edges <= 126) f32, got "
                 f"{tuple(edges.shape)} {edges.dtype}")


def _check_dequant_cuda(name, chunk_q, *operands):
    for t in operands:
        _require(t.device == chunk_q.device,
                 f"{name}: chunk on {chunk_q.device}, an operand on "
                 f"{t.device}")
        _require(t.is_contiguous(), f"{name}: operands must be contiguous")
    _require(chunk_q.is_contiguous(), f"{name}: the chunk must be "
                                      "contiguous")


cuda_build.register("write_rows",
                    ("dequant_write_rows_bf16", "dequant_write_rows_f32"),
                    (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
cuda_build.register("write_rows", "dequant_bin_write_rows",
                    (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
cuda_build.register("write_rows", "dequant_dual_write_rows",
                    (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 2
                    + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def dequant_write_rows(buf: torch.Tensor, chunk_q: torch.Tensor,
                       scale: torch.Tensor, lo: torch.Tensor, r0: int,
                       bits: int) -> None:
    """Rows r0 .. r0 + c of `buf` (bf16 or f32) from a uint8 wire chunk
    (c, d) (int8) or (c, ceil(d/2)) (int4): x = fma(q, scale, lo) in f32,
    subnormals flushed, then buf's dtype. A CUDA tensor launches
    K12-dequant (or raises); a CPU tensor takes the plain version."""
    name = "dequant_write_rows"
    _dequant_shapes(name, chunk_q, scale, lo, None, r0, bits, buf)
    if not chunk_q.is_cuda:
        return dequant_write_rows_plain(buf, chunk_q, scale, lo, r0, bits)
    _check_dequant_cuda(name, chunk_q, scale, lo, buf)
    _require(buf.dtype in (torch.bfloat16, torch.float32),
             f"{name}: the kernel writes bf16 or f32, got {buf.dtype}")
    fname = name + ("_bf16" if buf.dtype == torch.bfloat16 else "_f32")
    _launch(fname, chunk_q.data_ptr(), scale.data_ptr(),
            lo.data_ptr(), buf.data_ptr(), r0, chunk_q.shape[0],
            buf.shape[1], bits, ref=chunk_q, key=f"{name}_int{bits}")


def dequant_bin_write_rows(bufb: torch.Tensor, chunk_q: torch.Tensor,
                           scale: torch.Tensor, lo: torch.Tensor,
                           edges: torch.Tensor, r0: int, bits: int) -> None:
    """Rows r0 .. r0 + c of the int8 matrix `bufb`: the count of edges
    (d, n_edges) each dequantized f32 value is >=. A CUDA tensor launches
    K12-dequant (or raises); a CPU tensor takes the plain version."""
    name = "dequant_bin_write_rows"
    _dequant_shapes(name, chunk_q, scale, lo, edges, r0, bits, bufb)
    if not chunk_q.is_cuda:
        return dequant_bin_write_rows_plain(bufb, chunk_q, scale, lo, edges,
                                            r0, bits)
    _check_dequant_cuda(name, chunk_q, scale, lo, edges, bufb)
    _require(bufb.dtype == torch.int8, f"{name}: bufb must be int8")
    _launch(name, chunk_q.data_ptr(), scale.data_ptr(),
            lo.data_ptr(), edges.data_ptr(), bufb.data_ptr(), r0,
            chunk_q.shape[0], bufb.shape[1], edges.shape[1], bits,
            ref=chunk_q, key=f"{name}_int{bits}")


def dequant_dual_write_rows(buf16: torch.Tensor, bufb: torch.Tensor,
                            chunk_q: torch.Tensor, scale: torch.Tensor,
                            lo: torch.Tensor, edges: torch.Tensor, r0: int,
                            bits: int) -> None:
    """`dequant_write_rows` into the bf16 `buf16` and
    `dequant_bin_write_rows` into `bufb` from one read of the chunk and
    one f32 value per element. A CUDA tensor launches K12-dequant (or
    raises); a CPU tensor takes the plain version."""
    name = "dequant_dual_write_rows"
    _dequant_shapes(name, chunk_q, scale, lo, edges, r0, bits, buf16, bufb)
    if not chunk_q.is_cuda:
        return dequant_dual_write_rows_plain(buf16, bufb, chunk_q, scale, lo,
                                             edges, r0, bits)
    _check_dequant_cuda(name, chunk_q, scale, lo, edges, buf16, bufb)
    _require(buf16.dtype == torch.bfloat16 and bufb.dtype == torch.int8,
             f"{name}: buffers must be bf16 and int8")
    _launch(name, chunk_q.data_ptr(), scale.data_ptr(),
            lo.data_ptr(), edges.data_ptr(), buf16.data_ptr(),
            bufb.data_ptr(), r0, chunk_q.shape[0], buf16.shape[1],
            edges.shape[1], bits, ref=chunk_q, key=f"{name}_int{bits}")


# --------------------------------------------------------------------------- #
# builders                                                                    #
# --------------------------------------------------------------------------- #

_NP_TO_TORCH = {np.dtype(np.float16): torch.float16,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _wire_of(store: ColumnarStore, target: torch.dtype) -> torch.dtype:
    """The narrower of the store's dtype and the target's (the JAX
    package's rule): an f16 store ships f16 to a bf16 or f32 buffer."""
    sdt = _NP_TO_TORCH[store.dtype]
    return target if target.itemsize < sdt.itemsize else sdt


def _np_view(host: torch.Tensor) -> np.ndarray:
    """A numpy view of a host buffer's bytes in the wire's numpy storage
    dtype (`feature_cache.WIRE_DTYPES`: raw uint16 bits for bf16)."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _chunk_prepare(store: ColumnarStore, chunk_rows: int,
                   stats: IngestStats):
    """prepare(r0, acquire) for a store sweep on the classic wire: the
    memmap read (copied, so the page faults land on the worker), then the
    cast into a ring buffer and the zero pad of the tail chunk."""
    def prepare(r0: int, acquire):
        t0 = time.perf_counter()
        c = np.array(store.chunk(r0, r0 + chunk_rows), copy=True)
        stats.note_read(time.perf_counter() - t0, c.nbytes)
        host = acquire()  # its wait is no cast time
        t0 = time.perf_counter()
        host[:len(c)].copy_(torch.from_numpy(c))
        if len(c) < chunk_rows:  # the tail chunk, padded to the chunk shape
            host[len(c):].zero_()
        stats.note_cast(time.perf_counter() - t0,
                        host.numel() * host.element_size())
        return host

    return prepare


def _quant_prepare(store: ColumnarStore, chunk_rows: int,
                   plan: fc.QuantPlan, stats: IngestStats):
    """prepare(r0, acquire) for the compressed wire: the memmap read, the
    per-feature affine quantize (+ int4 nibble pack) on the worker, then
    the copy into a ring buffer and the tail padded with the quantized
    zero row (`plan.pad_row`), as the JAX package's does."""
    def prepare(r0: int, acquire):
        t0 = time.perf_counter()
        c = np.array(store.chunk(r0, r0 + chunk_rows), copy=True)
        stats.note_read(time.perf_counter() - t0, c.nbytes)
        t0 = time.perf_counter()
        q = plan.quantize(c)
        quant_s = time.perf_counter() - t0
        host = acquire()
        t0 = time.perf_counter()
        hn = host.numpy()
        hn[:len(q)] = q
        if len(q) < chunk_rows:
            hn[len(q):] = plan.pad_row
        stats.note_cast(quant_s + time.perf_counter() - t0, host.numel())
        return host

    return prepare


def _artifact_prepare(art: fc.CacheArtifact, chunk_rows: int,
                      stats: IngestStats):
    """prepare(r0, acquire) for a cache HIT: the artifact's wire tape, already
    cast or quantized and padded, copied from its memmap straight into a
    ring buffer. No store read and no cast: the IO lands in
    `stats.cache_read_s`, and `read_s`/`bytes_read` stay 0."""
    mm = art.wire

    def prepare(r0: int, acquire):
        host = acquire()
        t0 = time.perf_counter()
        np.copyto(_np_view(host), mm[r0:r0 + chunk_rows], casting="no")
        nbytes = host.numel() * host.element_size()
        stats.note_cache_read(time.perf_counter() - t0, nbytes)
        stats.note_cast(0.0, nbytes)  # wire-ready: nothing to cast
        return host

    return prepare


class _CacheSession:
    """Per-build feature-cache orchestration shared by the three builders
    (the JAX package's `_CacheSession`): resolves the `cache=` policy,
    computes the content address, consults the resident registry and the
    on-disk cache, picks warm replay or cold sweep, tees the wire stream
    into a staged artifact on a readwrite miss, and counts hits, misses
    and rejects. Corrupt or torn artifacts are REJECTED (structured
    `FeatureCacheError`, counted) and rebuilt cold — never a crash, never
    stale data."""

    def __init__(self, kind: str, store: ColumnarStore, chunk_rows: int, *,
                 legacy_wire: torch.dtype, target_name: str, edges=None,
                 sharding: Optional[str] = None, cache=None):
        self.kind = kind
        self.store = store
        self.chunk_rows = int(chunk_rows)
        self.edges = edges
        self.sharding = sharding
        self.d = store.n_features
        self.n_pad = _pad_rows(store.n_rows, chunk_rows)
        self.params = fc.resolve_cache_params(cache)
        self.legacy_wire = legacy_wire
        mode = self.params.wire if self.params is not None else "auto"
        if mode in ("int8", "int4"):
            self.wire_mode = mode
            self.bits: Optional[int] = 8 if mode == "int8" else 4
        else:
            if mode == "f16":
                # explicit f16 wire: 2-byte chunks even when the
                # narrowest-dtype rule would keep a wider store dtype
                self.legacy_wire = torch.float16
            self.wire_mode = fc.dtype_name(self.legacy_wire)
            self.bits = None
        self.quant: Optional[fc.QuantPlan] = None
        self.cache_obj: Optional[fc.FeatureCache] = None
        self.key = ""
        if self.params is not None:
            self.cache_obj = fc.FeatureCache(self.params)
            self.key = fc.cache_key(
                kind, store, target_dtype=target_name, wire=self.wire_mode,
                chunk_rows=self.chunk_rows, edges=edges, sharding=sharding,
                quant_sample=self.params.quant_sample,
                quant_seed=self.params.quant_seed)
        self.artifact: Optional[fc.CacheArtifact] = None
        self.writer: Optional[fc.ArtifactWriter] = None
        self._stats: Optional[IngestStats] = None

    @property
    def ring_dtype(self) -> torch.dtype:
        return torch.uint8 if self.bits is not None else self.legacy_wire

    @property
    def wire_cols(self) -> int:
        return wire_cols(self.d, self.bits) if self.bits else self.d

    # -- resident layer -------------------------------------------------- #

    def resident(self) -> Optional[Tuple[Tuple, IngestStats]]:
        """The live device tensors of this exact key, when the policy opts
        in: a rebuild in the same process gets them with zero IO."""
        if self.params is None or not self.params.resident or not self.key:
            return None
        entry = fc.resident_get(self.key)
        if entry is None:
            return None
        stats = IngestStats(label=f"{self.kind}_resident")
        stats.cache = "resident"
        stats.cache_key = self.key
        stats.wire = self.wire_mode
        fc.count_hit(self.store.nbytes(),
                     float(entry["extra"].get("cold_wall_s", 0.0)))
        return entry["arrays"], stats

    # -- build-time hooks ------------------------------------------------ #

    def _check_meta(self, art: fc.CacheArtifact) -> None:
        meta = art.meta
        expect = {"kind": self.kind, "n_pad": self.n_pad,
                  "n_features": self.d, "wire": self.wire_mode,
                  "wire_cols": self.wire_cols,
                  "chunk_rows": self.chunk_rows}
        for field_, want in expect.items():
            if meta.get(field_) != want:
                raise fc.FeatureCacheError(
                    art.path, f"meta {field_}={meta.get(field_)!r} does "
                              f"not match the requested build ({want!r})",
                    self.key)
        if art.wire.dtype != fc.WIRE_DTYPES[fc.dtype_name(
                self.ring_dtype)][0]:
            raise fc.FeatureCacheError(
                art.path, f"wire dtype {meta.get('wire_dtype')!r} does not "
                          f"match the requested build", self.key)
        if self.bits is not None and art.quant is None:
            raise fc.FeatureCacheError(
                art.path, "quantized wire artifact lacks quant.npz",
                self.key)

    def _meta(self) -> dict:
        return {
            "kind": self.kind,
            "store_fingerprint": fc.store_fingerprint(self.store),
            "n_rows": int(self.store.n_rows),
            "n_pad": int(self.n_pad),
            "n_features": int(self.d),
            "store_dtype": self.store.dtype.name,
            "wire": self.wire_mode,
            "wire_dtype": fc.dtype_name(self.ring_dtype),
            "wire_cols": self.wire_cols,
            "chunk_rows": self.chunk_rows,
            "edges_sha": fc._edges_digest(self.edges),
            "sharding": self.sharding,
        }

    def begin(self, stats: IngestStats):
        """Resolve warm vs cold. Returns (prepare, items) for
        `_upload`."""
        self._stats = stats
        stats.wire = self.wire_mode
        stats.cache_key = self.key
        if self.cache_obj is not None:
            try:
                art = self.cache_obj.load(self.key)
                if art is not None:
                    self._check_meta(art)
                self.artifact = art
            except fc.FeatureCacheError as e:
                fc.count_corrupt()
                log.warning("feature cache: %s — rebuilding", e)
                self.artifact = None
        if self.artifact is not None:
            self.quant = self.artifact.quant
            stats.cache = "hit"
            return (_artifact_prepare(self.artifact, self.chunk_rows,
                                      stats),
                    range(0, self.n_pad, self.chunk_rows))
        if self.bits is not None:
            self.quant = fc.compute_quant_plan(
                self.store, self.bits, sample=self.params.quant_sample,
                seed=self.params.quant_seed)
        if self.cache_obj is not None:
            stats.cache = "miss"
            if self.params.writable:
                try:
                    self.writer = self.cache_obj.writer(self.key,
                                                        self._meta())
                except OSError:
                    log.warning("feature cache: cannot stage artifact "
                                "under %s; building uncached",
                                self.params.resolved_dir(), exc_info=True)
                    self.writer = None
        prepare = (
            _quant_prepare(self.store, self.chunk_rows, self.quant, stats)
            if self.quant is not None
            else _chunk_prepare(self.store, self.chunk_rows, stats))
        return prepare, range(0, self.store.n_rows, self.chunk_rows)

    def tee(self, host: torch.Tensor) -> None:
        """Artifact append off the upload stream (main thread, item order,
        before the chunk's ring buffer can be reused). A failing disk
        degrades to an uncached build — it must not kill the upload."""
        if self.writer is None:
            return
        t0 = time.perf_counter()
        try:
            self.writer.append(_np_view(host))
        except OSError:
            log.warning("feature cache: artifact append failed; "
                        "continuing uncached", exc_info=True)
            self.writer.abort()
            self.writer = None
            return
        if self._stats is not None:
            self._stats.cache_write_s += time.perf_counter() - t0

    def finish(self, stats: IngestStats, arrays: Tuple) -> None:
        """Post-pipeline bookkeeping: finalize the staged artifact
        (integrity manifest LAST → crash-consistent rename), count the hit
        or miss, stamp the wire savings, and publish the resident tensors
        when the policy keeps them."""
        if self.bits is not None:
            f16_equiv = self.n_pad * self.d * 2
            stats.bytes_saved_wire = max(0, f16_equiv - stats.bytes_wire)
        if self.params is None:
            return
        if stats.cache == "hit":
            saved = max(0.0, self.artifact.cold_wall_s - stats.wall_s)
            fc.count_hit(self.store.nbytes(), saved)
        else:
            fc.count_miss()
            if self.writer is not None:
                t0 = time.perf_counter()
                try:
                    self.writer.finalize(
                        quant=self.quant,
                        cold={"wall_s": round(stats.wall_s, 6),
                              "gbps": round(stats.gbps, 6),
                              "bytes_wire": stats.bytes_wire})
                except OSError:
                    log.warning("feature cache: artifact finalize failed; "
                                "next run rebuilds", exc_info=True)
                finally:
                    self.writer = None
                    stats.cache_write_s += time.perf_counter() - t0
        if self.params.resident and self.key:
            cold_wall = (self.artifact.cold_wall_s
                         if self.artifact is not None else stats.wall_s)
            fc.resident_put(self.key, arrays,
                            cold_wall_s=cold_wall or stats.wall_s)

    def abort(self) -> None:
        """The build died (deadline, worker error): remove the staged
        artifact so a torn tape can never be mistaken for a cache entry."""
        if self.writer is not None:
            self.writer.abort()
            self.writer = None


def _upload(sess: _CacheSession, prepare_chunk, items, writes, label: str,
            deadline_s, workers, depth, shards: RowShards,
            stats: IngestStats, retry=None) -> IngestStats:
    """Stream `items` (chunk start rows) through the shards' writes
    (`writes[k](chunk, local r0)` for the shard k that owns the chunk's
    rows): on worker threads `prepare_chunk` reads, quantizes or replays
    each chunk into a ring of `depth` host buffers (pinned on the card);
    on the main thread, in item order, the session tees the chunk's host
    bytes into its artifact, then on the card the chunk is copied to its
    shard's device on that device's side stream, where the write launches
    the kernel, in that device's context, after the copy in stream order;
    on the CPU the write reads the host buffer itself. One side stream per
    distinct device, each joined to that device's current stream at the
    end. A buffer is refilled only after its chunk was issued and its
    copy's event fired, so the tee always reads the chunk it was given."""
    stats.label = label
    cuda = shards.lead.type == "cuda"
    chunk_rows = sess.chunk_rows
    ring = ChunkRing(depth, (chunk_rows, sess.wire_cols), sess.ring_dtype,
                     pin=cuda)
    streams: Dict[torch.device, torch.cuda.Stream] = {}
    if cuda:
        for k, dev in enumerate(shards.devices):
            if dev not in streams:
                with shards.on(k):
                    streams[dev] = torch.cuda.Stream(dev)
                    # the resident buffers were allocated on the current
                    # stream
                    streams[dev].wait_stream(torch.cuda.current_stream(dev))

    def prepare(r0: int):
        j = r0 // chunk_rows
        return j, r0, prepare_chunk(r0, lambda: ring.acquire(j))

    def upload(prepared):
        j, r0, host = prepared
        k = bisect.bisect_right(shards.bounds, r0) - 1
        local = r0 - shards.bounds[k]
        sess.tee(host)
        if not cuda:
            writes[k](host, local)
            ring.issued(j, None)
            return None
        dev = shards.devices[k]
        with shards.on(k), torch.cuda.stream(streams[dev]):
            cdev = host.to(dev, non_blocking=True)
            writes[k](cdev, local)
            event = torch.cuda.Event()
            event.record(streams[dev])
        ring.issued(j, event)
        if r0 and (r0 // chunk_rows) % 8 == 0:
            log.info("%s: %d/%d rows", label, r0, sess.n_pad)
        return event

    try:
        run_chunk_pipeline(items, prepare, upload, workers=workers,
                           depth=depth, deadline_s=deadline_s,
                           label=f"{label} upload", stats=stats,
                           retry=retry, on_error=ring.abort)
    except BaseException:
        sess.abort()
        raise
    finally:
        for k, dev in enumerate(shards.devices):
            stream = streams.pop(dev, None)
            if stream is not None:
                with shards.on(k):
                    torch.cuda.current_stream(dev).wait_stream(stream)
    log.info("%s: %d rows in %.1fs (%.2f GB/s, overlap %.2f, retries %d%s)",
             label, sess.store.n_rows, stats.wall_s, stats.gbps,
             stats.overlap_frac, stats.retries,
             f", cache {stats.cache}" if stats.cache else "")
    return stats


def sharding_key(shards: RowShards) -> str:
    """The cache key's and the artifact meta's name of a data sharding:
    the axis, and each shard's device and rows (no object address), so
    the same layout hits and any other misses."""
    return (f"NamedSharding(spec=('{DATA_AXIS}',), devices="
            f"{[str(d) for d in shards.devices]}, rows={shards.sizes})")


def _plan(store, chunk_rows, workers, depth, sharding, retry, device):
    """(row shards, workers, depth, retry policy) of one build: one shard
    on `device` without a sharding; with a data sharding
    (`parallel.mesh.data_sharding(mesh)`), the rows of the mesh's data
    axis in whole upload chunks (`chunk_shards`)."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    n_pad = _pad_rows(store.n_rows, chunk_rows)
    if sharding is None:
        shards = RowShards(n_pad, [resolve_device(device)])
    else:
        if not (isinstance(sharding, NamedSharding)
                and sharding.spec == (DATA_AXIS,)):
            raise ValueError(
                f"sharding= takes a row sharding over a mesh's data axis, "
                f"data_sharding(mesh) (spec ('{DATA_AXIS}',)); got "
                f"{sharding!r}")
        shards = chunk_shards(n_pad, chunk_rows, sharding.data_devices)
    return (shards,
            UPLOAD_WORKERS if workers is None else int(workers),
            UPLOAD_DEPTH if depth is None else int(depth),
            retry if retry is not None else _default_ingest_retry())


def _build(sess: _CacheSession, label: str, alloc, writes, deadline_s,
           workers, depth, shards: RowShards, sharded: bool,
           return_stats: bool, retry=None, edges=None):
    """A builder's body: the resident registry, else each shard's buffers
    from `alloc(device, rows)` written by `writes(bufs, quant, edges)`'s
    per-chunk write (the classic write when quant is None, the dequant
    write with (scale, lo) on the shard's device otherwise; `edges` on
    that device) through the cache session's upload. Sharded, each result
    is a `RowSplit` of the shards' buffers."""
    res = sess.resident()
    if res is not None:
        out, stats = res
    else:
        stats = IngestStats(label=label)
        prepare, items = sess.begin(stats)
        bufs = shards.map(alloc, shards.devices, shards.sizes)
        none = [None] * shards.n_shards
        quant = none if sess.quant is None else list(zip(*(
            shards.broadcast(torch.from_numpy(a))
            for a in (sess.quant.scale, sess.quant.lo))))
        edges_k = none if edges is None else shards.broadcast(
            torch.from_numpy(np.asarray(edges, np.float32)))
        per_shard = shards.map(writes, bufs, quant, edges_k)
        _upload(sess, prepare, items, per_shard, label, deadline_s, workers,
                depth, shards, stats, retry)
        out = (tuple(RowSplit(shards, [b[i] for b in bufs])
                     for i in range(len(bufs[0])))
               if sharded else bufs[0])
        sess.finish(stats, out)
    return (*out, stats) if return_stats else (
        out[0] if len(out) == 1 else tuple(out))


def _session(kind: str, store: ColumnarStore, chunk_rows: int, shards,
             sharding, **kw) -> _CacheSession:
    return _CacheSession(kind, store, chunk_rows, cache=kw.pop("cache"),
                         sharding=(None if sharding is None
                                   else sharding_key(shards)), **kw)


def device_matrix(store: ColumnarStore, dtype=torch.bfloat16,
                  chunk_rows: int = UPLOAD_CHUNK_ROWS,
                  deadline_s: Optional[float] = None, *,
                  workers: Optional[int] = None,
                  depth: Optional[int] = None, sharding=None,
                  return_stats: bool = False, retry=None, cache=None,
                  device="cuda"):
    """The store as one (n_pad, d) `dtype` buffer on `device`, rows padded
    to a chunk multiple. The wire dtype is the narrower of the store's and
    `dtype`; an f16 wire widens on the device (K12), a wire of the
    buffer's own dtype is copied; a quantized wire dequantizes on the
    device (K12-dequant). `deadline_s` raises TimeoutError mid-upload.

    `sharding` (`parallel.mesh.data_sharding(mesh)`): the rows over the
    mesh's data axis in whole upload chunks, each chunk written into the
    shard that owns it on that shard's device (the mesh names the
    devices; `device` is not read); the buffer comes back as a
    `parallel.rowshards.RowSplit`, bit-equal row for row to the unsharded
    build. Any other sharding raises ValueError.

    `cache`: feature-cache policy (None → process default/env;
    "off"/"read"/"readwrite"; or a `FeatureCacheParams`). On a hit the
    build replays the content-addressed wire artifact — zero store reads
    — bit-equal to the cold build that wrote it; on a readwrite miss the
    wire stream tees into a crash-consistent artifact. The sharding is
    part of the key; the artifact's bytes are the same whatever it is.
    `FeatureCacheParams(wire="int8"/"int4")` ships a quantized wire (max
    abs error scale/2 per feature, see data/feature_cache.py). With
    `return_stats`, returns (buffer, IngestStats)."""
    shards, workers, depth, retry = _plan(store, chunk_rows, workers, depth,
                                          sharding, retry, device)
    sess = _session("matrix", store, chunk_rows, shards, sharding,
                    legacy_wire=_wire_of(store, dtype),
                    target_name=fc.dtype_name(dtype), cache=cache)
    wire = sess.legacy_wire
    if sess.bits is None and not (wire == dtype or wire == torch.float16):
        raise ValueError(f"device_matrix: no write from a {wire} wire into "
                         f"a {dtype} buffer")

    def alloc(dev, rows):
        return (torch.empty((rows, store.n_features), dtype=dtype,
                            device=dev),)

    def writes(bufs, quant, edges):
        (x,) = bufs
        if quant is not None:
            scale, lo = quant
            bits = sess.quant.bits
            return lambda c, r0: dequant_write_rows(x, c, scale, lo, r0, bits)
        if wire == dtype:
            return lambda c, r0: x[r0:r0 + c.shape[0]].copy_(c)
        return lambda c, r0: write_cast_rows(x, c, r0)

    return _build(sess, "device_matrix", alloc, writes, deadline_s, workers,
                  depth, shards, sharding is not None, return_stats, retry)


def device_binned(store: ColumnarStore, edges: np.ndarray,
                  chunk_rows: int = UPLOAD_CHUNK_ROWS,
                  deadline_s: Optional[float] = None, *,
                  workers: Optional[int] = None,
                  depth: Optional[int] = None, sharding=None,
                  return_stats: bool = False, retry=None, cache=None,
                  device="cuda"):
    """(n_pad, d) int8 quantile-binned buffer on `device`: chunks ship as
    f16 (an f32 store rounds through f16, as in the JAX package) and bin
    on the device (K12), or ship quantized and bin the dequantized f32
    values (K12-dequant). Pad rows are the bins of the pad row. `sharding`
    and `cache` as in `device_matrix`: a hit replays the wire tape, so the
    binned matrix is bit-equal to the build that wrote it."""
    shards, workers, depth, retry = _plan(store, chunk_rows, workers, depth,
                                          sharding, retry, device)
    sess = _session("binned", store, chunk_rows, shards, sharding,
                    legacy_wire=torch.float16, target_name="int8",
                    edges=edges, cache=cache)

    def alloc(dev, rows):
        return (torch.empty((rows, store.n_features), dtype=torch.int8,
                            device=dev),)

    def writes(bufs, quant, edges_dev):
        (b,) = bufs
        if quant is not None:
            scale, lo = quant
            bits = sess.quant.bits
            return lambda c, r0: dequant_bin_write_rows(
                b, c, scale, lo, edges_dev, r0, bits)
        return lambda c, r0: bin_write_rows(b, c, edges_dev, r0)

    return _build(sess, "device_binned", alloc, writes, deadline_s, workers,
                  depth, shards, sharding is not None, return_stats, retry,
                  edges)


def dual_device_matrices(store: ColumnarStore, edges: np.ndarray,
                         dtype=torch.bfloat16,
                         chunk_rows: int = UPLOAD_CHUNK_ROWS,
                         deadline_s: Optional[float] = None, *,
                         workers: Optional[int] = None,
                         depth: Optional[int] = None, sharding=None,
                         return_stats: bool = False, retry=None, cache=None,
                         device="cuda"):
    """One pass over the store → BOTH the (n_pad, d) bf16 matrix and the
    (n_pad, d) int8 binned matrix: each wire chunk crosses to the device
    once and K12's dual entry (or K12-dequant's) reads it once for both.
    For an f16 store both equal `device_matrix`'s and `device_binned`'s
    buffers. `sharding` and `cache` as in `device_matrix`: the artifact is
    the single wire tape, and a hit reproduces both matrices bit for bit.
    Returns (X16, Xb) or, with `return_stats`, (X16, Xb, IngestStats)."""
    if dtype != torch.bfloat16:
        raise ValueError(f"dual_device_matrices: the kernel writes bf16, "
                         f"got {dtype}")
    shards, workers, depth, retry = _plan(store, chunk_rows, workers, depth,
                                          sharding, retry, device)
    sess = _session("dual", store, chunk_rows, shards, sharding,
                    legacy_wire=torch.float16,
                    target_name=fc.dtype_name(dtype), edges=edges,
                    cache=cache)
    d = store.n_features

    def alloc(dev, rows):
        return (torch.empty((rows, d), dtype=torch.bfloat16, device=dev),
                torch.empty((rows, d), dtype=torch.int8, device=dev))

    def writes(bufs, quant, edges_dev):
        x, b = bufs
        if quant is not None:
            scale, lo = quant
            bits = sess.quant.bits
            return lambda c, r0: dequant_dual_write_rows(
                x, b, c, scale, lo, edges_dev, r0, bits)
        return lambda c, r0: dual_write_rows(x, b, c, edges_dev, r0)

    return _build(sess, "dual", alloc, writes, deadline_s, workers, depth,
                  shards, sharding is not None, return_stats, retry, edges)


# --------------------------------------------------------------------------- #
# linear family (K14)                                                         #
# --------------------------------------------------------------------------- #

def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 a and b with an f32 result, as the JAX package's
    `preferred_element_type=jnp.float32`. On the card one cuBLAS product
    with an f32 output (`aten::mm.dtype`), no widened copy of the operands;
    on the CPU both operands widen to f32 (exact: bf16 values and their
    products are f32 numbers), so only the sum order differs."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _one_hot(y: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(y.long(), k).to(torch.float32)


def fit_logreg_big(X16, y: torch.Tensor, w: torch.Tensor,
                   l2: float, n_classes: int, max_iter: int = 50
                   ) -> Dict[str, torch.Tensor]:
    """Pure-L2 multinomial logistic regression against the bf16 matrix by
    `max_iter` steps of the port's optax L-BFGS (`models/lbfgs.py`): loss
    Σ(ll·w)/max(Σw, 1) + l2/2·‖W‖², logits X16 @ bf16(W) with an f32
    result, the gradient written out ((softmax − Y)·w/Σw, its X product
    bf16 × bf16 → f32; the JAX package's autodiff rounds that product to
    bf16, the dtype of its bf16 W). Held at the metric level (F5). X16 may
    be a `RowSplit`: each shard's loss and products are partials added on
    the lead, W goes out once a step, Σw and the penalty are taken once.
    Returns {"W": (d, k), "b": (k,)}."""
    shards, X, y_s, w_s = rows_of(X16, y, w)
    d = X[0].shape[1]
    k = n_classes
    wsum = torch.clamp(shards.sum(shards.map(torch.sum, w_s)), min=1.0)
    parts = shards.map(lambda yk, wk, ws: (_one_hot(yk, k), wk,
                                           (wk / ws)[:, None]),
                       y_s, w_s, shards.broadcast(wsum))

    def partial(Xk, Wk, b, Y, wk, wn):
        logits = mm_f32(Xk, Wk) + b
        ll = -(Y * torch.log_softmax(logits, dim=-1)).sum(-1)
        R = (torch.softmax(logits, dim=-1) - Y) * wn
        return (ll * wk).sum(), mm_f32(Xk.T, _bf16(R)), R.sum(0)

    def value_and_grad(x):
        W, b = x[0, :d * k].reshape(d, k), x[0, d * k:]
        got = shards.map(lambda Xk, Wk, bk, p: partial(Xk, Wk, bk, *p), X,
                         shards.broadcast(_bf16(W)), shards.broadcast(b),
                         parts)
        ll, gW, gb = (shards.sum([g[i] for g in got]) for i in range(3))
        value = ll / wsum + 0.5 * l2 * (W ** 2).sum()
        return value[None], torch.cat([(gW + l2 * W).reshape(-1), gb])[None]

    x = lbfgs.minimize(value_and_grad, torch.zeros(
        (1, d * k + k), dtype=torch.float32, device=shards.lead), max_iter)
    return {"W": x[0, :d * k].reshape(d, k), "b": x[0, d * k:]}


def _lipschitz_big(shards, X, w_s, wsum: torch.Tensor) -> torch.Tensor:
    """λmax(Xᵀ diag(w) X)/Σw by 16 power iterations from 1/√d, every X
    product bf16 × bf16 → f32 (the JAX package's `pw` scan); over shards,
    v goes out once a step and each step's Xᵀ product is a sum of the
    shards' partials on the lead."""
    d = X[0].shape[1]
    v = (1.0 / torch.sqrt(torch.tensor(float(d), device=shards.lead))
         ).expand(d, 1).contiguous()
    nrm = None
    for _ in range(16):
        u = shards.sum(shards.map(
            lambda Xk, wk, vk: mm_f32(Xk.T, _bf16(wk[:, None]
                                                  * mm_f32(Xk, vk))),
            X, w_s, shards.broadcast(_bf16(v))))
        nrm = torch.linalg.vector_norm(u)
        v = u / torch.clamp(nrm, min=1e-12)
    return nrm / wsum


def fit_logreg_enet_grids_big(X16, y: torch.Tensor,
                              w: torch.Tensor, l1v, l2v, n_classes: int,
                              max_iter: int = 200
                              ) -> Dict[str, torch.Tensor]:
    """The whole elastic-net grid (g (l1, l2) pairs) by FISTA against the
    bf16 matrix with X read twice per step for all grids at once: weights
    live as (d, g·k), so the forward and adjoint products are single wide
    products (bf16 × bf16 → f32). Step 1/L with L = 0.525·λmax/Σw + l2 +
    1e-8, λmax by 16 power iterations. X16 may be a `RowSplit` (y and w
    whole on the lead): W goes out once a step, each shard's Xᵀ·R and
    bias sums are partials added on the lead in shard order, where the
    step and the prox run; Σw and the penalty are taken once. Returns
    {"W": (g, d, k), "b": (g, k)}."""
    shards, X, y_s, w_s = rows_of(X16, y, w)
    d = X[0].shape[1]
    dev = shards.lead
    l1v = torch.as_tensor(l1v, dtype=torch.float32, device=dev)
    l2v = torch.as_tensor(l2v, dtype=torch.float32, device=dev)
    g, k = l1v.shape[0], n_classes
    Y1 = shards.map(lambda yk: _one_hot(yk, k)[:, None, :], y_s)
    w3 = shards.map(lambda wk: wk[:, None, None], w_s)
    wsum = torch.clamp(shards.sum(shards.map(torch.sum, w_s)), min=1.0)
    lam = _lipschitz_big(shards, X, w_s, wsum)
    L = 0.5 * 1.05 * lam + l2v + 1e-8
    step = (1.0 / L)[None, :, None]
    step_b = (1.0 / L)[:, None]
    l1 = l1v[None, :, None]
    l2 = l2v[None, :, None]

    def partial(Xk, Wk, b, Yk, wk):
        logits = mm_f32(Xk, Wk).reshape(-1, g, k) + b
        R = (torch.softmax(logits, dim=-1) - Yk) * wk
        return mm_f32(Xk.T, _bf16(R.reshape(-1, g * k))), R.sum(0)

    def smooth_grads(W, b):                      # W (d, g, k), b (g, k)
        got = shards.map(partial, X,
                         shards.broadcast(_bf16(W.reshape(d, g * k))),
                         shards.broadcast(b), Y1, w3)
        gW, gb = (shards.sum([p[i] for p in got]) for i in range(2))
        return gW.reshape(d, g, k) / wsum + l2 * W, gb / wsum

    W = torch.zeros((d, g, k), dtype=torch.float32, device=dev)
    b = torch.zeros((g, k), dtype=torch.float32, device=dev)
    Wm, bm = W, b
    t = torch.tensor(1.0, dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        gW, gb = smooth_grads(Wm, bm)
        W1 = Wm - step * gW
        W1 = torch.sign(W1) * torch.clamp(torch.abs(W1) - step * l1, min=0.0)
        b1 = bm - step_b * gb
        t1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t1
        Wm, bm = W1 + beta * (W1 - W), b1 + beta * (b1 - b)
        W, b, t = W1, b1, t1
    return {"W": W.permute(1, 0, 2).contiguous(), "b": b}


def fit_logreg_enet_big(X16, y: torch.Tensor, w: torch.Tensor,
                        l1: float, l2: float, n_classes: int,
                        max_iter: int = 200) -> Dict[str, torch.Tensor]:
    """One elastic-net fit by FISTA against the bf16 matrix: the grid fit
    with g = 1. Returns {"W": (d, k), "b": (k,)}."""
    p = fit_logreg_enet_grids_big(X16, y, w, [l1], [l2], n_classes,
                                  max_iter)
    return {"W": p["W"][0], "b": p["b"][0]}


def predict_logreg_grids_big(W: torch.Tensor, b: torch.Tensor,
                             X16) -> torch.Tensor:
    """(g, n, k) probabilities for stacked grid weights W (g, d, k), b (g,
    k): one X pass (a shard at a time for a `RowSplit`, gathered on the
    lead in row order)."""
    (g, d, k) = W.shape
    shards, X = rows_of(X16)
    Wf = _bf16(W.permute(1, 0, 2).reshape(d, g * k))
    probs = shards.map(
        lambda Xk, Wk, bk: torch.softmax(
            mm_f32(Xk, Wk).reshape(-1, g, k) + bk, dim=-1).permute(1, 0, 2),
        X, shards.broadcast(Wf), shards.broadcast(b))
    return shards.gather(probs, 1)


def predict_logreg_big(W: torch.Tensor, b: torch.Tensor,
                       X16) -> Dict[str, torch.Tensor]:
    shards, X = rows_of(X16)

    def predict(Xk, Wk, bk):
        logits = mm_f32(Xk, Wk) + bk
        return [{"prediction": torch.argmax(logits, -1).to(torch.float32),
                 "rawPrediction": logits,
                 "probability": torch.softmax(logits, dim=-1)}]
    return RowSplit(shards, X).preds(predict, X, shards.broadcast(_bf16(W)),
                                     shards.broadcast(b))[0]


# --------------------------------------------------------------------------- #
# tree families (K13): K learners level by level over K1/K2/K3                #
# --------------------------------------------------------------------------- #

def _value_channels(V_K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value columns (K, n, p) → G (K, p − 1, n) and H (K, n) f32, each
    rounded to bf16 first, as the JAX package's big path casts them
    explicitly whatever its histogram precision says."""
    V = V_K.to(torch.bfloat16).to(torch.float32)
    return V[:, :, :-1].permute(0, 2, 1).contiguous(), \
        V[:, :, -1].contiguous()


def _grow_lockstep(shards, Xb, G, H, max_depth, n_bins, reg_lambda,
                   min_child_weight, min_gain, min_gain_norm, feature_mask_K,
                   chunk):
    """K trees from the shards' parts of Xb, of the bf16-rounded value
    channels G (K, m, n_k) and of the weights H (K, n_k) (lists, one
    entry a shard): `grow_trees` with every level's histograms built
    directly — per level K1 → K2 → K3 routing, all K learners in one
    launch of each on each shard, the partial histograms added on the
    lead — then the leaves (K3's leaf pass, Σ G / (Σ H + λ); over several
    shards each shard's sums added on the lead, the formula there).
    Returns (tree arrays, each shard's final node ids (K, n_k))."""
    _check_chunk("grow_trees_big_lockstep", shards.n, chunk)
    return grow_trees(RowSplit(shards, Xb), G, H, max_depth, n_bins,
                      reg_lambda, min_child_weight, min_gain, feature_mask_K,
                      min_gain_norm=min_gain_norm, chunk=chunk,
                      subtract=False)


def grow_trees_big_lockstep(Xb, V_K: torch.Tensor,
                            max_depth: int, n_bins: int, reg_lambda=1.0,
                            min_child_weight=1.0, min_gain=0.0,
                            min_gain_norm=0.0,
                            feature_mask_K: Optional[torch.Tensor] = None,
                            chunk: int = HIST_CHUNK_ROWS
                            ) -> Dict[str, torch.Tensor]:
    """Grow K trees level-synchronized against the resident int8 matrix Xb
    (n, d) (a tensor, or a `RowSplit` over row shards) from value columns
    V_K (K, n, m + 1) ([G·, H]: gradients or labels × bootstrap weights,
    then the weight column) whole on the lead, each learner with its own
    feature mask (K, d) if given. Returns {"feat", "bin": (K, depth,
    2^depth) int32, "leaf": (K, 2^depth, m) f32}."""
    shards, X = rows_of(Xb)
    G, H = _value_channels(V_K)
    trees, _ = _grow_lockstep(shards, X, shards.split(G, 2),
                              shards.split(H, 1), max_depth, n_bins,
                              reg_lambda, min_child_weight, min_gain,
                              min_gain_norm, feature_mask_K, chunk)
    return trees


def grow_tree_big(Xb, G: torch.Tensor, H: torch.Tensor,
                  max_depth: int, n_bins: int, reg_lambda=1.0,
                  min_child_weight=1.0, min_gain=0.0, min_gain_norm=0.0,
                  feature_mask: Optional[torch.Tensor] = None,
                  chunk: int = HIST_CHUNK_ROWS) -> Dict[str, torch.Tensor]:
    """One tree from gradients G (n, m) and weights H (n,): the lockstep
    growth with K = 1 (the JAX package's `_chunked_histograms` and
    `_chunked_leaf_sums` are its single-learner case). Returns {"feat",
    "bin": (depth, 2^depth), "leaf": (2^depth, m)}."""
    V = torch.cat([G, H[:, None]], dim=1)[None]
    t = grow_trees_big_lockstep(
        Xb, V, max_depth, n_bins, reg_lambda, min_child_weight, min_gain,
        min_gain_norm, None if feature_mask is None else feature_mask[None],
        chunk)
    return {k: v[0] for k, v in t.items()}


def lockstep_width(max_depth: int, d: int, n_bins: int, m: int,
                   requested: int, n: Optional[int] = None,
                   n_shards: int = 1) -> int:
    """Learners per lockstep batch: the deepest level's histograms
    (K·(m + 1)·2^(depth − 1)·d·bins f32), and with the row count n (the
    largest shard's) K1's piece scratch at that level
    (`hist_scratch_bytes`), held to ~800 MB, at most 16 and at most
    `requested`. Grown over `n_shards` row shards, the lead also holds
    every shard's partial histograms of that level before they are added,
    and each shard its own K1 scratch. (The JAX package's `n` also bounds
    a modeled dispatch time against a TPU's execution limit; the port has
    no such limit.)"""
    budget_elems = 2e8
    level = (m + 1) * (2 ** (max_depth - 1)) * d * n_bins
    per_learner = level + (n_shards * level if n_shards > 1 else 0)
    if n is not None:
        per_learner += n_shards * hist_scratch_bytes(
            1, n, 2 ** max(max_depth - 1, 0), m, d, n_bins) // 4
    k_mem = max(1, int(budget_elems // max(per_learner, 1)))
    return max(1, min(requested, k_mem, 16))


def _tree_seed(seed: int, t: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(t)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def forest_big_draws(seed: int, trees: range, n: int, d: int,
                     n_sub: Optional[int], bootstrap: bool, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Poisson(1) bootstrap counts (T, n) f32, feature masks (T, d) bool)
    for the listed tree indices, each tree from its own `torch.Generator`
    seeded by (seed, tree index), so a tree's draws do not depend on the
    lockstep width. A mask keeps the features whose uniform score is at or
    below the n_sub-th smallest, as the JAX package's."""
    boots, masks = [], []
    for t in trees:
        gen = torch.Generator(device=device)
        gen.manual_seed(_tree_seed(seed, t))
        ones = torch.ones(n, dtype=torch.float32, device=device)
        boots.append(torch.poisson(ones, generator=gen) if bootstrap
                     else ones)
        if n_sub is not None and n_sub < d:
            scores = torch.rand(d, generator=gen, device=device)
            masks.append(scores <= torch.sort(scores).values[n_sub - 1])
        else:
            masks.append(torch.ones(d, dtype=torch.bool, device=device))
    return torch.stack(boots), torch.stack(masks)


def _forest_lockstep_batch(shards, Xb, Y_s, w_s, boot, fmask,
                           max_depth: int, n_bins: int, min_child_weight,
                           min_gain, chunk: int):
    """One lockstep batch of bootstrap trees from their draws (counts (K,
    n) on the lead, split here; masks (K, d)): on each shard the value
    columns [Y·boot·w, boot·w] rounded to bf16, λ = 1e-6."""
    def channels(Yk, wk, bk):
        bw = bk * wk[None, :]
        return _value_channels(torch.cat(
            [Yk.to(torch.float32)[None] * bw[:, :, None], bw[:, :, None]],
            dim=2))
    GH = shards.map(channels, Y_s, w_s, shards.split(boot, 1))
    trees, _ = _grow_lockstep(
        shards, Xb, [g for g, _ in GH], [h for _, h in GH], max_depth,
        n_bins, 1e-6, min_child_weight, 0.0, min_gain,
        fmask, chunk)
    return trees


def fit_forest_big(Xb, Y: torch.Tensor, w: torch.Tensor,
                   n_trees: int, max_depth: int, n_bins: int,
                   n_outputs: int, seed: int = 0,
                   subsample_features: bool = True,
                   min_child_weight: float = 1.0, min_gain: float = 0.0,
                   bootstrap: bool = True, chunk: int = HIST_CHUNK_ROWS,
                   trees_per_dispatch: Optional[int] = None,
                   draws=None) -> Dict[str, torch.Tensor]:
    """A random forest of `n_trees` on the resident int8 matrix (a tensor,
    or a `RowSplit` over row shards), grown in lockstep batches of
    `lockstep_width` trees: labels Y (n, m) (one-hot classes), row weights
    w (n,), both whole on the lead. Tree t's bootstrap counts and feature
    mask (⌊√d⌋ features) come from `forest_big_draws` at the whole n on
    the lead (a draw at a shard's n would move every tree), or from
    `draws` = (counts (n_trees, n), masks (n_trees, d)) — e.g. the JAX
    package's threefry draws; each batch's counts are then split over the
    shards. Returns {"feat", "bin": (n_trees, depth, 2^depth), "leaf":
    (n_trees, 2^depth, m)}. (`n_outputs` is accepted for signature
    parity; the width comes from Y.)"""
    shards, X = rows_of(Xb)
    n, d = shards.n, X[0].shape[1]
    dev = shards.lead
    _check_chunk("fit_forest_big", n, chunk)
    n_sub = max(int(np.sqrt(d)), 1) if subsample_features else None
    m = int(Y.shape[1])
    K = min(lockstep_width(max_depth, d, n_bins, m,
                           trees_per_dispatch or 16, n=max(shards.sizes),
                           n_shards=shards.n_shards), n_trees)
    if draws is not None:
        boot_all, mask_all = (torch.as_tensor(np.array(a) if not isinstance(
            a, torch.Tensor) else a).to(dev) for a in draws)
        _require(boot_all.shape == (n_trees, n)
                 and mask_all.shape == (n_trees, d),
                 f"fit_forest_big: draws {tuple(boot_all.shape)} / "
                 f"{tuple(mask_all.shape)} must be ({n_trees}, {n}) / "
                 f"({n_trees}, {d})")
    Y_s, w_s = shards.split(Y), shards.split(w)
    parts = []
    for s in range(0, n_trees, K):
        idx = range(s, min(s + K, n_trees))
        if draws is None:
            boot, mask = forest_big_draws(seed, idx, n, d, n_sub, bootstrap,
                                          dev)
        else:
            boot = boot_all[s:idx.stop].to(torch.float32)
            mask = mask_all[s:idx.stop].to(torch.bool)
        if not bootstrap:
            boot = torch.ones_like(boot)
        if n_sub is None:
            mask = torch.ones_like(mask)
        parts.append(_forest_lockstep_batch(
            shards, X, Y_s, w_s, boot, mask, max_depth, n_bins,
            min_child_weight, min_gain, chunk))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _gradients(margin, y, w, objective):
    if objective == "logistic":
        p = sigmoid(margin)
        return (p - y) * w, torch.clamp(p * (1 - p), min=1e-6) * w
    if objective == "squared":
        return (margin - y) * w, w.expand_as(margin)
    raise ValueError(f"unknown objective {objective!r}")


def _gbt_round_big_lockstep(shards, Xb, y_s, w_s, margin_s, max_depth: int,
                            n_bins: int, learning_rate, reg_lambda,
                            objective: str, min_child_weight=1.0,
                            gamma=0.0, chunk: int = HIST_CHUNK_ROWS):
    """One boosting round for K lockstep (grid, fold) pairs, each with its
    own margin (K, n) and row weights w_K (K, n), both kept on the shards
    (lists of (K, n_k), as y): value columns [−g, h] rounded to bf16 on
    each shard, one tree per pair; margin += lr · the leaf each row
    reaches (its final node from the growth, where `predict_tree_big`'s
    walk lands it), the leaves sent to each shard once."""
    def channels(margin, yk, wk):
        g, h = _gradients(margin, yk[None, :], wk, objective)
        return ((-g).to(torch.bfloat16).to(torch.float32)[:, None, :]
                .contiguous(),
                h.to(torch.bfloat16).to(torch.float32).contiguous())
    GH = shards.map(channels, margin_s, y_s, w_s)
    trees, node = _grow_lockstep(shards, Xb, [g for g, _ in GH],
                                 [h for _, h in GH], max_depth, n_bins,
                                 reg_lambda, min_child_weight, gamma, 0.0,
                                 None, chunk)
    lr = _f32(learning_rate)
    margin_s = shards.map(
        lambda margin, leaf, nd: margin + lr * torch.gather(
            leaf[:, :, 0], 1, nd.long()),
        margin_s, shards.broadcast(trees["leaf"]), node)
    return margin_s, trees


def fit_gbt_big_lockstep(Xb, y: torch.Tensor,
                         w_K: torch.Tensor, n_estimators: int,
                         max_depth: int, n_bins: int, learning_rate,
                         reg_lambda, objective: str = "logistic",
                         min_child_weight: float = 1.0, gamma: float = 0.0,
                         chunk: int = HIST_CHUNK_ROWS
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Boost K lockstep pairs from a zero margin on the resident int8
    matrix (a tensor, or a `RowSplit` over row shards; y and w_K whole on
    the lead, split once): returns ({"feat", "bin": (rounds, K, depth,
    2^depth), "leaf": (rounds, K, 2^depth, 1)}, margins (K, n) on the
    lead). Over shards each shard keeps its margins and gradients; the
    margins are gathered once, at the end. No row or column sampling:
    deterministic rounds."""
    shards, X = rows_of(Xb)
    K = w_K.shape[0]
    y_s, w_s = shards.split(y), shards.split(w_K, 1)
    margin = shards.map(lambda wk: torch.zeros(
        (K, wk.shape[1]), dtype=torch.float32, device=wk.device), w_s)
    kept = []
    for _ in range(n_estimators):
        margin, tree = _gbt_round_big_lockstep(
            shards, X, y_s, w_s, margin, max_depth, n_bins, learning_rate,
            reg_lambda, objective, min_child_weight, gamma, chunk)
        kept.append(tree)
    return ({k: torch.stack([t[k] for t in kept]) for k in kept[0]},
            shards.gather(margin, 1))


def fit_gbt_big(Xb, y: torch.Tensor, w: torch.Tensor,
                n_estimators: int, max_depth: int, n_bins: int,
                learning_rate, reg_lambda, objective: str = "logistic",
                min_child_weight: float = 1.0, gamma: float = 0.0,
                seed: int = 0, chunk: int = HIST_CHUNK_ROWS
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One fit's boosting rounds (the JAX package's `_gbt_round_big` loop):
    the lockstep rounds with K = 1. Returns ({"feat", "bin": (rounds,
    depth, 2^depth), "leaf": (rounds, 2^depth, 1)}, margin (n,)). `seed`
    is accepted for signature parity: the rounds draw nothing."""
    trees, margin = fit_gbt_big_lockstep(
        Xb, y, w[None], n_estimators, max_depth, n_bins, learning_rate,
        reg_lambda, objective, min_child_weight, gamma, chunk)
    return {k: v[:, 0] for k, v in trees.items()}, margin[0]


def _walk_shards(trees: Dict[str, torch.Tensor], Xb, walk):
    """`walk(trees, Xb_k)` (K5) on each row shard's part, the tables sent
    to each shard's device once, gathered on the lead in row order (on a
    tensor, `walk(trees, Xb)`)."""
    shards, X = rows_of(Xb)
    sent = shards.map(lambda *tables: dict(zip(trees, tables)),
                      *(shards.broadcast(t) for t in trees.values()))
    return shards.gather(shards.map(walk, sent, X))


def predict_tree_big(tree: Dict[str, torch.Tensor],
                     Xb) -> torch.Tensor:
    """(n, m) leaf values of one tree ({"feat", "bin": (depth, width),
    "leaf": (width, m)}) on the int8 matrix (a tensor or a `RowSplit`),
    through K5 (a launch a shard)."""
    return _walk_shards(tree, Xb, lambda t, Xk: tree_walk(
        Xk, t["feat"][None], t["bin"][None], t["leaf"][None]))


def predict_forest_big(trees: Dict[str, torch.Tensor],
                       Xb) -> torch.Tensor:
    """(n, m) mean of stacked trees' leaf values (K5: the sum in tree
    order, then / T), a launch a shard of a `RowSplit`."""
    return _walk_shards(trees, Xb, predict_forest)
