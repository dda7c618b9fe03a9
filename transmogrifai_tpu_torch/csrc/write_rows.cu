// K12: one f16 wire chunk of c rows written into rows r0 .. r0 + c of the
// resident device matrices of the out-of-core path.
//
//   write_cast_rows : out16[r0 + r, f] = bf16(f32(chunk[r, f]))   (or f32)
//   bin_write_rows  : outb[r0 + r, f]  = #{e : f32(chunk[r, f]) >= edges[f, e]}
//   dual_write_rows : both, from one read of each f16 element
//
// Replaces `_write_cast_rows`, `_bin_write_rows` and `_dual_write_rows` in
// transmogrifai_tpu/parallel/bigdata.py:68-95. On the TPU each is a donated
// `dynamic_update_slice` whose update XLA fuses with the widening and with
// `bin_features`' broadcast compare (models/trees.py:63). Here the resident
// buffers are preallocated and written in place; the chunk lies on the
// device already (an asynchronous copy from pinned host memory on the same
// stream), so the kernel runs after the copy in stream order and never
// waits on a device sync.
//
// Rounding: f16 widens to f32 exactly; f32 rounds to bf16 to nearest even,
// as XLA's convert does. NaN becomes 0x7FFF, as PyTorch's conversion on the
// card gives it (its CPU conversion gives 0x7FC0; either is a NaN). The bin
// is the count of edges <= x over all edges, the linear compare set of K4
// (csrc/bin_features.cu); NaN compares false, so NaN lands in bin 0.
//
// Bound on this card: bytes. Each element is 2 bytes read and 2 + 1 bytes
// written (dual); the edges are d * n_edges * 4 bytes read once. The
// compares are c * d * n_edges f32 operations, a fifth of the byte time at
// 31 edges. Design: as K4, one thread per (row, feature) element; a block
// covers FEAT_TILE neighbouring features x ROW_TILE rows, so neighbouring
// threads read neighbouring f16 values of one row and write neighbouring
// outputs; the block's edge rows are staged once in shared memory and the
// block walks further rows with a grid-stride loop. Every flat offset is
// 64-bit: (r0 + r) * d passes 2^31 at millions of rows.
//
// K12-dequant: the same writes from a chunk of the quantized wire (the
// feature cache's int8 / int4 wire, transmogrifai_tpu_torch/data/
// feature_cache.py), dequantized as it is written:
//
//   dequant_write_rows     : out16[r0 + r, f] = bf16(x)   (or f32 x)
//   dequant_bin_write_rows : outb[r0 + r, f]  = #{e : x >= edges[f, e]}
//   dequant_dual_write_rows: both, from one x per element
//
//   x = fma(q[r, f], scale[f], lo[f]) in f32, rounded once
//
// q is chunk[r, f] (bits 8, a (c, d) uint8 chunk) or a nibble of
// chunk[r, f / 2] (bits 4, a (c, ceil(d/2)) chunk: feature 2j in the low
// nibble of byte j, 2j + 1 in the high nibble; with an odd d the last
// byte's high nibble is padding and nothing reads it).
//
// Replaces `_unpack_dequant`, `_dequant_write_rows`,
// `_dequant_bin_write_rows` and `_dequant_dual_write_rows` in
// transmogrifai_tpu/parallel/bigdata.py:109-146. Rounding follows the JAX
// package's jitted writes as XLA's CPU program runs them (measured): it
// contracts q * scale + lo into one fused multiply-add (`__fmaf_rn` here,
// as K10 in wire_dequant.cu), it treats a subnormal scale, lo or edge as
// a zero of the same sign and flushes a subnormal result to a zero of the
// same sign. The exact q * scale + lo is a multiple of 2^-149, so a tiny
// result is exact before it is flushed, and tininess before or after
// rounding cannot differ. The bf16 comes from that f32 x by round to
// nearest even, the bin counts the edges <= x by K4's rule.
//
// Bound on this card: bytes. Each element is 1 byte read (0.5 at 4 bits)
// and 2 + 1 bytes written (dual); scale, lo and the edges are read once
// per block from L2. The operations are one FMA and n_edges compares per
// element: at 31 edges and 8 bits their time at the f32 peak is about 0.4
// of the byte time (0.5 at 4 bits). Design: K12's, one
// thread per (row, feature) element in a FEAT_TILE x ROW_TILE block with
// a grid-stride loop over rows; the block's scale and lo sit in
// registers and its edge rows in shared memory (flushed as they are
// staged). At 4 bits two neighbouring threads read the same byte; the
// loads of a warp still fall in 16 neighbouring bytes. Flat offsets are
// 64-bit, as above.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FEAT_TILE = 32;
constexpr int ROW_TILE = 8;
constexpr int MAX_GRID_Y = 4096;

__device__ __forceinline__ uint16_t bf16_bits_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FFFu;  // NaN
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ void store_wide(uint16_t* out, int64_t i, float x) {
  out[i] = bf16_bits_rne(x);
}
__device__ __forceinline__ void store_wide(float* out, int64_t i, float x) {
  out[i] = x;
}

// WideT: uint16_t (bf16 bits) or float; nullptr skips that output.
template <typename WideT, bool BIN>
__global__ void write_rows_kernel(const __half* __restrict__ chunk,
                                  const float* __restrict__ edges,
                                  WideT* __restrict__ out16,
                                  int8_t* __restrict__ outb, int64_t r0,
                                  int64_t c, int d, int n_edges) {
  extern __shared__ float s_edges[];  // [nf][n_edges]
  const int f0 = blockIdx.x * FEAT_TILE;
  const int nf = min(FEAT_TILE, d - f0);
  if (BIN) {
    const int tid = threadIdx.y * FEAT_TILE + threadIdx.x;
    for (int i = tid; i < nf * n_edges; i += FEAT_TILE * ROW_TILE)
      s_edges[i] = edges[(int64_t)f0 * n_edges + i];
    __syncthreads();
  }
  if (threadIdx.x >= nf) return;
  const int f = f0 + threadIdx.x;
  const float* e = s_edges + threadIdx.x * n_edges;
  const int64_t row_step = (int64_t)gridDim.y * ROW_TILE;
  for (int64_t r = (int64_t)blockIdx.y * ROW_TILE + threadIdx.y; r < c;
       r += row_step) {
    const float x = __half2float(chunk[r * d + f]);
    const int64_t o = (r0 + r) * d + f;
    if (out16 != nullptr) store_wide(out16, o, x);
    if (BIN) {
      int cnt = 0;
      for (int j = 0; j < n_edges; ++j) cnt += (x >= e[j]) ? 1 : 0;
      outb[o] = (int8_t)cnt;
    }
  }
}

template <typename WideT, bool BIN>
int launch(const void* chunk, const void* edges, void* out16, void* outb,
           int64_t r0, int64_t c, int d, int n_edges, void* stream) {
  if (c <= 0 || d <= 0) return (int)cudaSuccess;
  const int64_t row_groups = (c + ROW_TILE - 1) / ROW_TILE;
  dim3 grid((d + FEAT_TILE - 1) / FEAT_TILE,
            (unsigned)(row_groups < MAX_GRID_Y ? row_groups : MAX_GRID_Y));
  dim3 block(FEAT_TILE, ROW_TILE);
  const size_t smem = BIN ? (size_t)FEAT_TILE * n_edges * sizeof(float) : 0;
  write_rows_kernel<WideT, BIN><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const __half*>(chunk), static_cast<const float*>(edges),
      static_cast<WideT*>(out16), static_cast<int8_t*>(outb), r0, c, d,
      n_edges);
  return (int)cudaGetLastError();
}


constexpr float F32_TINY = 1.17549435e-38f;  // 2^-126

// a subnormal to a zero of the same sign (XLA's CPU programs: inputs
// treated as zero, results flushed to zero)
__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < F32_TINY ? copysignf(0.0f, v) : v;
}

template <int BITS>
__device__ __forceinline__ int wire_code(const uint8_t* __restrict__ q,
                                         int64_t r, int f, int d) {
  if (BITS == 4) {
    const int64_t cols = (d + 1) / 2;
    const int byte = q[r * cols + (f >> 1)];
    return (f & 1) ? (byte >> 4) : (byte & 0x0F);
  }
  return q[r * d + f];
}

// WideT: uint16_t (bf16 bits) or float; nullptr skips that output.
template <int BITS, typename WideT, bool BIN>
__global__ void dequant_rows_kernel(const uint8_t* __restrict__ q,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ lo,
                                    const float* __restrict__ edges,
                                    WideT* __restrict__ out16,
                                    int8_t* __restrict__ outb, int64_t r0,
                                    int64_t c, int d, int n_edges) {
  extern __shared__ float s_edges[];  // [nf][n_edges]
  const int f0 = blockIdx.x * FEAT_TILE;
  const int nf = min(FEAT_TILE, d - f0);
  if (BIN) {
    const int tid = threadIdx.y * FEAT_TILE + threadIdx.x;
    for (int i = tid; i < nf * n_edges; i += FEAT_TILE * ROW_TILE)
      s_edges[i] = flush_subnormal(edges[(int64_t)f0 * n_edges + i]);
    __syncthreads();
  }
  if (threadIdx.x >= nf) return;
  const int f = f0 + threadIdx.x;
  const float sc = flush_subnormal(scale[f]);
  const float lf = flush_subnormal(lo[f]);
  const float* e = s_edges + threadIdx.x * n_edges;
  const int64_t row_step = (int64_t)gridDim.y * ROW_TILE;
  for (int64_t r = (int64_t)blockIdx.y * ROW_TILE + threadIdx.y; r < c;
       r += row_step) {
    const float x = flush_subnormal(
        __fmaf_rn((float)wire_code<BITS>(q, r, f, d), sc, lf));
    const int64_t o = (r0 + r) * d + f;
    if (out16 != nullptr) store_wide(out16, o, x);
    if (BIN) {
      int cnt = 0;
      for (int j = 0; j < n_edges; ++j) cnt += (x >= e[j]) ? 1 : 0;
      outb[o] = (int8_t)cnt;
    }
  }
}

template <int BITS, typename WideT, bool BIN>
int launch_dequant_bits(const void* q, const void* scale, const void* lo,
                        const void* edges, void* out16, void* outb,
                        int64_t r0, int64_t c, int d, int n_edges,
                        void* stream) {
  if (c <= 0 || d <= 0) return (int)cudaSuccess;
  const int64_t row_groups = (c + ROW_TILE - 1) / ROW_TILE;
  dim3 grid((d + FEAT_TILE - 1) / FEAT_TILE,
            (unsigned)(row_groups < MAX_GRID_Y ? row_groups : MAX_GRID_Y));
  dim3 block(FEAT_TILE, ROW_TILE);
  const size_t smem = BIN ? (size_t)FEAT_TILE * n_edges * sizeof(float) : 0;
  dequant_rows_kernel<BITS, WideT, BIN>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
          static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
          static_cast<const float*>(lo), static_cast<const float*>(edges),
          static_cast<WideT*>(out16), static_cast<int8_t*>(outb), r0, c, d,
          n_edges);
  return (int)cudaGetLastError();
}

template <typename WideT, bool BIN>
int launch_dequant(const void* q, const void* scale, const void* lo,
                   const void* edges, void* out16, void* outb, int64_t r0,
                   int64_t c, int d, int n_edges, int bits, void* stream) {
  if (bits == 8)
    return launch_dequant_bits<8, WideT, BIN>(q, scale, lo, edges, out16,
                                              outb, r0, c, d, n_edges,
                                              stream);
  if (bits == 4)
    return launch_dequant_bits<4, WideT, BIN>(q, scale, lo, edges, out16,
                                              outb, r0, c, d, n_edges,
                                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// chunk (c, d) f16 -> out16 rows r0 .. r0 + c, bf16 (as uint16 bits)
extern "C" int write_cast_rows_bf16(const void* chunk, void* out16,
                                    int64_t r0, int64_t c, int d,
                                    void* stream) {
  return launch<uint16_t, false>(chunk, nullptr, out16, nullptr, r0, c, d, 0,
                                 stream);
}

// chunk (c, d) f16 -> out rows r0 .. r0 + c, f32
extern "C" int write_cast_rows_f32(const void* chunk, void* out, int64_t r0,
                                   int64_t c, int d, void* stream) {
  return launch<float, false>(chunk, nullptr, out, nullptr, r0, c, d, 0,
                              stream);
}

// chunk (c, d) f16, edges (d, n_edges) f32 -> outb rows r0 .. r0 + c, int8
extern "C" int bin_write_rows(const void* chunk, const void* edges,
                              void* outb, int64_t r0, int64_t c, int d,
                              int n_edges, void* stream) {
  return launch<uint16_t, true>(chunk, edges, nullptr, outb, r0, c, d,
                                n_edges, stream);
}

// both outputs from one read of the chunk
extern "C" int dual_write_rows(const void* chunk, const void* edges,
                               void* out16, void* outb, int64_t r0,
                               int64_t c, int d, int n_edges, void* stream) {
  return launch<uint16_t, true>(chunk, edges, out16, outb, r0, c, d, n_edges,
                                stream);
}

// quantized chunk (c, d) uint8 or (c, ceil(d/2)) int4-packed, scale and lo
// (d,) f32 -> out rows r0 .. r0 + c, bf16 (as uint16 bits)
extern "C" int dequant_write_rows_bf16(const void* q, const void* scale,
                                       const void* lo, void* out, int64_t r0,
                                       int64_t c, int d, int bits,
                                       void* stream) {
  return launch_dequant<uint16_t, false>(q, scale, lo, nullptr, out, nullptr,
                                         r0, c, d, 0, bits, stream);
}

// the same into an f32 buffer
extern "C" int dequant_write_rows_f32(const void* q, const void* scale,
                                      const void* lo, void* out, int64_t r0,
                                      int64_t c, int d, int bits,
                                      void* stream) {
  return launch_dequant<float, false>(q, scale, lo, nullptr, out, nullptr,
                                      r0, c, d, 0, bits, stream);
}

// quantized chunk, scale, lo, edges (d, n_edges) f32 -> outb rows, int8
extern "C" int dequant_bin_write_rows(const void* q, const void* scale,
                                      const void* lo, const void* edges,
                                      void* outb, int64_t r0, int64_t c,
                                      int d, int n_edges, int bits,
                                      void* stream) {
  return launch_dequant<uint16_t, true>(q, scale, lo, edges, nullptr, outb,
                                        r0, c, d, n_edges, bits, stream);
}

// both outputs from one dequantized value per element
extern "C" int dequant_dual_write_rows(const void* q, const void* scale,
                                       const void* lo, const void* edges,
                                       void* out16, void* outb, int64_t r0,
                                       int64_t c, int d, int n_edges,
                                       int bits, void* stream) {
  return launch_dequant<uint16_t, true>(q, scale, lo, edges, out16, outb, r0,
                                        c, d, n_edges, bits, stream);
}
