// K10: the quantized request wire's dequantization,
// x[r, j] = q[r, j] * scale[j] + lo[j], for every wire leaf of a batch in
// one launch.
//
// Replaces `dequantize_leaf` / `dequantize_wire` in
// transmogrifai_tpu/workflow/compiled.py:170-243, which XLA fuses into the
// first consumer inside the scoring program (the int4 unpack is the same
// nibble layout as `parallel/bigdata._unpack_dequant`, :109): feature 2j in
// the low nibble of byte j of the row, feature 2j + 1 in the high nibble,
// a row of odd width padded by a nibble. A mask leaf rides the wire as
// exact uint8 0/1 and comes back as f32 0/1.
//
// Rounding: one fused multiply-add, rounded once (`__fmaf_rn`). XLA's CPU
// program contracts the JAX package's q * scale + lo into an FMA (measured:
// its jitted `dequantize_leaf` equals the f64 product-sum rounded once, not
// the product and the sum rounded apart), so the kernel rounds as the JAX
// package's scoring program does, bit for bit.
//
// Bound on this card: memory, each element one byte in (half a byte in
// int4) and four bytes out, plus each leaf's (d,) scale and lo; the
// operations are far below the f32 peak. At serving sizes (1-64 rows of a
// few dozen leaves) the launch itself dominates, so the whole batch is one
// launch, and the design keeps its grid no larger than the work:
// - One flat index space of warps over all the leaves: the leaves travel
//   by value in the kernel's parameters (up to MAX_LEAVES a launch; no
//   table in device memory to copy first, so the launch can be captured in
//   a CUDA graph), each with its first warp (`start`, set here from the
//   leaves' work), and the grid is the sum of the leaves' warps. A warp
//   finds its leaf by a binary search over the starts, read in place from
//   the parameter space (`__grid_constant__`: no per-thread copy), the
//   same address in every lane.
// - A warp takes a chunk of CHUNK = 512 elements of its leaf's flat (n, d)
//   output in STEPS = 4 steps of 128: lane l takes elements 4l .. 4l + 3 of
//   each step, from one 4-byte load at 8 bits (a 2-byte load of 4 nibbles
//   at 4 bits and even width), and writes them with one 16-byte store, so
//   a warp's loads and stores are contiguous; a lane issues its four loads
//   before it converts any. Its column comes from one division a chunk and
//   is then advanced (by 128 mod d a step, by 1 an element). A leaf of
//   width 1 (the scalar columns) reads its scale and lo once a thread, a
//   wider leaf reads them per element through L1.
// - An input view that is not 4-byte (2-byte) aligned, a leaf's last step
//   and a 4-bit leaf of odd width load byte by byte; outputs are always
//   aligned (the wrapper allocates one buffer for the batch's leaves, each
//   leaf's view at a multiple of 16 bytes), a last step stores element by
//   element.
// - Element indices are 32-bit where a leaf's elements fit, 64-bit
//   otherwise.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int BLOCK = 256;
constexpr int WARP = 32;
constexpr int STEPS = 4;
constexpr int STEP = 4 * WARP;         // elements of a warp step
constexpr int CHUNK = STEPS * STEP;    // elements of a warp
constexpr int FIELDS = 7;  // int64 fields a leaf in the host table

struct Leaf {
  const uint8_t* q;     // (n, d) uint8, or (n, ceil(d/2)) packed int4
  const float* scale;   // (d,) f32; null for a mask leaf
  const float* lo;      // (d,) f32; null for a mask leaf
  float* out;           // (n, d) f32, 16-byte aligned
  int64_t total;        // n * d elements
  int64_t start;        // the leaf's first warp
  int d;
  int bits;             // 8 or 4
};

struct LeafTable {
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
};

// the 4 codes of elements i .. i + 3 (i a multiple of 4; the first cnt)
template <typename I>
__device__ __forceinline__ uint32_t codes4(const Leaf& L, I i, int cnt,
                                           bool wide) {
  if (L.bits == 8 || L.d == 1) {  // a byte an element (4 bits: low nibble)
    const uint8_t* src = L.q + i;
    uint32_t w = 0;
    if (cnt == 4 && wide) {
      w = *reinterpret_cast<const uint32_t*>(src);
    } else {
      for (int e = 0; e < cnt; ++e) w |= (uint32_t)src[e] << (8 * e);
    }
    return L.bits == 8 ? w : (w & 0x0F0F0F0Fu);
  }
  // 4 bits, even width: nibble i of byte i / 2, 4 nibbles in 2 bytes
  const uint8_t* src = L.q + (i >> 1);
  uint32_t h = 0;
  if (cnt == 4 && wide) {
    h = *reinterpret_cast<const uint16_t*>(src);
  } else {
    for (int e = 0; e < (cnt + 1) >> 1; ++e) h |= (uint32_t)src[e] << (8 * e);
  }
  return (h & 0x0Fu) | ((h >> 4) & 0x0Fu) << 8 | ((h >> 8) & 0x0Fu) << 16 |
         ((h >> 12) & 0x0Fu) << 24;
}

// the codes of a 4-bit leaf of odd width: rows of (d + 1) / 2 bytes
template <typename I>
__device__ __forceinline__ uint32_t codes4_odd(const Leaf& L, I i, int cnt) {
  const I packed = ((I)L.d + 1) >> 1;
  I r = i / (I)L.d;
  int j = (int)(i - r * (I)L.d);
  uint32_t w = 0;
  for (int e = 0; e < cnt; ++e) {
    const uint8_t byte = L.q[r * packed + (j >> 1)];
    w |= (uint32_t)((j & 1) ? (byte >> 4) : (byte & 0x0F)) << (8 * e);
    if (++j == L.d) {
      j = 0;
      ++r;
    }
  }
  return w;
}

template <typename I>
__device__ __forceinline__ void dequant_chunk(const Leaf& L, I c0, int lane) {
  const bool odd4 = L.bits == 4 && L.d > 1 && (L.d & 1);
  const bool wide =
      ((uintptr_t)L.q & (L.bits == 8 || L.d == 1 ? 3u : 1u)) == 0;
  const I total = (I)L.total;
  I i[STEPS];
  int cnt[STEPS];
  uint32_t w[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    i[s] = c0 + (I)(s * STEP + 4 * lane);
    cnt[s] = i[s] < total ? (total - i[s] < (I)4 ? (int)(total - i[s]) : 4)
                          : 0;
  }
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    w[s] = cnt[s] == 0 ? 0u
           : odd4      ? codes4_odd<I>(L, i[s], cnt[s])
                       : codes4<I>(L, i[s], cnt[s], wide);
  const bool mask = L.scale == nullptr;
  float sc = 0.f, lc = 0.f;
  if (!mask && L.d == 1) {
    sc = __ldg(L.scale);
    lc = __ldg(L.lo);
  }
  // the column of element i[0], then advanced
  int j = L.d == 1 ? 0 : (int)(i[0] % (I)L.d);
  const int inc = STEP % L.d;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    float x[4];
    int jj = j;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = (float)((w[s] >> (8 * e)) & 0xFFu);
      if (mask) {
        x[e] = c;
      } else if (L.d == 1) {
        x[e] = __fmaf_rn(c, sc, lc);
      } else {
        x[e] = __fmaf_rn(c, __ldg(L.scale + jj), __ldg(L.lo + jj));
        if (++jj == L.d) jj = 0;
      }
    }
    float* dst = L.out + i[s];
    if (cnt[s] == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      for (int e = 0; e < cnt[s]; ++e) dst[e] = x[e];
    }
    j += inc;
    if (j >= L.d) j -= L.d;
  }
}

__global__ void __launch_bounds__(BLOCK)
    wire_dequant_kernel(const __grid_constant__ LeafTable t) {
  const int64_t wp = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  int a = 0, b = t.n_leaves;  // t.leaf[a].start <= wp < t.leaf[b].start
  while (b - a > 1) {
    const int mid = (a + b) >> 1;
    if (t.leaf[mid].start <= wp) a = mid; else b = mid;
  }
  const Leaf& L = t.leaf[a];
  const int64_t c0 = (wp - L.start) * CHUNK;
  if (c0 >= L.total) return;  // past the work of the last leaf
  if (L.total <= 0x7fffffffll - CHUNK)
    dequant_chunk<uint32_t>(L, (uint32_t)c0, lane);
  else
    dequant_chunk<int64_t>(L, c0, lane);
}

}  // namespace

extern "C" int wire_dequant_max_leaves() { return MAX_LEAVES; }

// One launch over `n_leaves` (1..MAX_LEAVES) leaves of work, given as a
// host table of FIELDS int64 a leaf: q, scale, lo, out (addresses; a null
// scale marks a mask leaf), n * d, d, bits. Each out is 16-byte aligned.
extern "C" int wire_dequant(const int64_t* leaves, int n_leaves,
                            void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  LeafTable t;
  t.n_leaves = n_leaves;
  int64_t warps = 0;
  for (int k = 0; k < n_leaves; ++k) {
    const int64_t* f = leaves + (int64_t)k * FIELDS;
    Leaf& L = t.leaf[k];
    L.q = reinterpret_cast<const uint8_t*>(f[0]);
    L.scale = reinterpret_cast<const float*>(f[1]);
    L.lo = reinterpret_cast<const float*>(f[2]);
    L.out = reinterpret_cast<float*>(f[3]);
    L.total = f[4];
    L.d = (int)f[5];
    L.bits = (int)f[6];
    if (L.d < 1 || (L.bits != 8 && L.bits != 4) || L.total < 0 ||
        ((uintptr_t)L.out & 15u) != 0)
      return (int)cudaErrorInvalidValue;
    L.start = warps;
    warps += (L.total + CHUNK - 1) / CHUNK;
  }
  for (int k = n_leaves; k < MAX_LEAVES; ++k) t.leaf[k] = t.leaf[0];
  if (warps == 0) return 0;
  const int64_t blocks = (warps * WARP + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  wire_dequant_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      t);
  return (int)cudaGetLastError();
}
