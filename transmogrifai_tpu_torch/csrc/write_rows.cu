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
