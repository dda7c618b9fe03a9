// K10: the quantized request wire's dequantization,
// x[r, j] = q[r, j] * scale[j] + lo[j], for every wire leaf of a batch in
// one launch.
//
// Replaces `dequantize_leaf` / `dequantize_wire` in
// transmogrifai_tpu/workflow/compiled.py:170-243, which XLA fuses into the
// first consumer inside the scoring program (the int4 unpack is the same
// nibble layout as `parallel/bigdata._unpack_dequant`, :109): feature 2j in
// the low nibble of byte j, feature 2j + 1 in the high nibble. A mask leaf
// rides the wire as exact uint8 0/1 and comes back as f32 0/1.
//
// Rounding: one fused multiply-add, rounded once (`__fmaf_rn`). XLA's CPU
// program contracts the JAX package's q * scale + lo into an FMA (measured:
// its jitted `dequantize_leaf` equals the f64 product-sum rounded once, not
// the product and the sum rounded apart), so the kernel rounds as the JAX
// package's scoring program does, bit for bit.
//
// Bound on this card: memory. Each element is one byte in (half a byte in
// int4) and four bytes out, plus the (d,) scale and lo of each leaf; the
// operations (one multiply and one add per element) are far below the f32
// peak. At serving sizes (1-64 rows of a few dozen columns) the launch
// itself dominates, so the design spends one launch on the whole batch:
// the leaves travel by value in the kernel's parameters (up to MAX_LEAVES
// per launch, no table in device memory to copy first, so the launch can be
// captured in a CUDA graph), grid.y picks the leaf and a grid-stride loop
// over grid.x walks its elements. Thread 0 of a block picks its leaf out of
// the parameter table with constant indices (a run-time index into a
// by-value parameter makes the compiler copy the whole table, 2.3 KB, into
// each thread's local memory) and hands it to the block through shared
// memory; each thread keeps it in registers. Element indices are 32-bit where
// a leaf's elements fit (the row/column split is a division), 64-bit
// otherwise. Neighbouring threads write neighbouring outputs, so the stores
// coalesce.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int BLOCK = 256;
constexpr int MAX_GRID_X = 1024;

struct Leaf {
  const uint8_t* q;     // (n, d) uint8, or (n, ceil(d/2)) packed int4
  const float* scale;   // (d,) f32; null for a mask leaf
  const float* lo;      // (d,) f32; null for a mask leaf
  float* out;           // (n, d) f32
  int64_t n;
  int d;
  int bits;             // 8 or 4
};

struct LeafTable {
  Leaf leaf[MAX_LEAVES];
};

template <typename Index>
__device__ __forceinline__ void dequant_leaf(const Leaf& L, Index total) {
  const Index d = (Index)L.d;
  const Index packed = (d + 1) / 2;
  const Index step = (Index)gridDim.x * blockDim.x;
  for (Index i = (Index)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const Index r = d == 1 ? i : i / d;
    const int j = (int)(i - r * d);
    int q;
    if (L.bits == 4) {
      const int byte = L.q[r * packed + (j >> 1)];
      q = (j & 1) ? (byte >> 4) : (byte & 0x0F);
    } else {
      q = L.q[i];
    }
    const float x = (float)q;
    L.out[i] = L.scale == nullptr
                   ? x
                   : __fmaf_rn(x, __ldg(L.scale + j), __ldg(L.lo + j));
  }
}

__global__ void wire_dequant_kernel(const LeafTable table) {
  __shared__ Leaf s_leaf;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < MAX_LEAVES; ++k) {
      if (k == (int)blockIdx.y) s_leaf = table.leaf[k];
    }
  }
  __syncthreads();
  const Leaf L = s_leaf;
  const int64_t total = L.n * (int64_t)L.d;
  if (total <= 0x7fffffff) {
    dequant_leaf<uint32_t>(L, (uint32_t)total);
  } else {
    dequant_leaf<int64_t>(L, total);
  }
}

}  // namespace

extern "C" int wire_dequant_max_leaves() { return MAX_LEAVES; }

// One launch over `n_leaves` (<= MAX_LEAVES) leaves given as parallel
// arrays; a null scale marks a mask leaf.
extern "C" int wire_dequant(const void* const* q, const void* const* scale,
                            const void* const* lo, void* const* out,
                            const int64_t* n, const int* d, const int* bits,
                            int n_leaves, void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  LeafTable table;
  int64_t most = 1;
  for (int k = 0; k < n_leaves; ++k) {
    table.leaf[k] = Leaf{static_cast<const uint8_t*>(q[k]),
                         static_cast<const float*>(scale[k]),
                         static_cast<const float*>(lo[k]),
                         static_cast<float*>(out[k]), n[k], d[k], bits[k]};
    const int64_t total = n[k] * (int64_t)d[k];
    if (total > most) most = total;
  }
  int64_t blocks = (most + BLOCK - 1) / BLOCK;
  if (blocks > MAX_GRID_X) blocks = MAX_GRID_X;
  dim3 grid((unsigned)blocks, (unsigned)n_leaves);
  wire_dequant_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}
