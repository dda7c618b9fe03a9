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
// is the count of edges <= x over all edges, K4's rule
// (csrc/bin_features.cu); NaN compares false, so NaN lands in bin 0.
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
// What bounds them on this card: bytes. Each element is 2 bytes read (1 at
// 8 bits, 0.5 at 4) and 2 + 1 bytes written (dual). The first design (one
// thread an element, 32 x 8 blocks) counted each element's 31 edges
// linearly in shared memory (about 4G shared loads a 262,144 x 500 chunk)
// and moved 1 and 2 bytes an access, and ran 2 to 15 times its bound. Its
// instructions an element bound it next: the search's shared loads (5 an
// element at 31 edges) and the per-element bookkeeping, which the design
// below keeps few.
//
// Design:
// - Windows of features. A chunk of c x d elements written at rows r0 ..
//   r0 + c of a contiguous (N, d) matrix is one flat range in the chunk and
//   in the outputs, with feature = flat index mod d. A thread takes groups
//   of 8 neighbouring elements: one 16-byte load of f16 (8 bytes of int8
//   codes, 4 of int4), one 16-byte store of bf16 (two of f32) and one
//   8-byte store of bins. The flat range repeats its features every L =
//   lcm(d, 8) elements; a super-row is the least multiple of that period
//   whose S groups are a multiple of 32, so group g and g + S hold the same
//   8 features at the same alignment. A block takes a window of 32
//   neighbouring groups of a super-row (one a lane: 256 neighbouring
//   features, mod d) and its 8 warps walk the super-rows with a grid
//   stride, so a thread's features, their staged columns and
//   (dequantizing) their scale and lo stay in registers, a warp reads and
//   writes 512 contiguous bytes of f16, and no lane idles, for any d.
// - K4's count. Each block stages its window's edges once, edge-major,
//   feature 8l + j of the window in column 32j + l (lane l, slot j), rows
//   of 256 floats, rows past n_edges up to 2^k - 1 NaN: every probe of any
//   edge falls in the lane's own bank, and at most 127 rows (126 edges)
//   take 127 KB. While staging it tests each feature's order: e[j] <=
//   e[j+1] for every j, false at NaN (on the flushed edges in the
//   dequantizing path). A non-decreasing feature is counted by a
//   branch-free binary search (5 shared loads at 31 edges, on 32-bit
//   offsets) with the same `>=` compare, which gives the same count and
//   still sends NaN to 0; any other feature is counted linearly. When
//   every feature of the window is non-decreasing (one block-wide vote)
//   the per-element test is skipped. No host check, no sync. The rule and
//   its search steps live in edge_count.cuh, shared with K4.
// - The 4-bit wire has 16 codes a feature, so its bins come from a table
//   [16][256] of every (code, feature)'s bin, built once a block from the
//   staged edges: one shared load an element instead of a search.
// - The next group's load is issued before this group's counts. bf16
//   comes from the card's conversion (`__floats2bfloat162_rn`: to nearest
//   even, NaN to 0x7FFF, as PyTorch's on the card). Where an address is
//   not aligned for the wide accesses, or at 4 bits with an odd d (rows are
//   not flat: the padding nibble), each element is loaded and stored alone
//   and a thread carries its row from stride to stride by an addition (the
//   scalar path); the last c*d mod 8 elements are stored alone too.
// - As many blocks as the card holds at once (the SM count times the
//   blocks an SM takes at the instance's registers and shared memory),
//   spread over the windows, so a block's staging (31 KB at 31 edges) is
//   paid once for many super-rows.
// Every flat offset is 64-bit: (r0 + r) * d passes 2^31 at millions of
// rows.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "edge_count.cuh"

// the window's staged edges [E][WIN] (rows past n_edges NaN), the 4-bit
// wire's bins table [16][WIN], then the order bits [WIN / 32] (dynamic
// shared memory)
extern __shared__ float k12_stage[];

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 32;
constexpr int WARPS = THREADS / LANES;  // super-rows a block walks at once
constexpr int V = 8;                    // elements a group
constexpr int WIN = LANES * V;          // features a window
constexpr int LOG_WIN = 8;
constexpr int MIN_BLOCKS = 3;
constexpr int SU = 8;  // staging loads a thread has in flight
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr float F32_TINY = 1.17549435e-38f;  // 2^-126

// f32 -> bf16 to nearest even by the card's conversion (NaN -> 0x7FFF, as
// PyTorch's conversion on the card gives it; subnormals kept)
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a subnormal to a zero of the same sign (XLA's CPU programs: inputs
// treated as zero, results flushed to zero)
__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < F32_TINY ? copysignf(0.0f, v) : v;
}

struct Rows {
  const void* in;  // (c, d) f16, or the (c, cols) uint8 wire
  const float* scale;
  const float* lo;
  const float* edges;  // (d, n_edges)
  void* out16;         // bf16 bits or f32; nullptr: no such output
  int8_t* outb;        // nullptr: no bins
  int64_t r0, c;
  int d, n_edges, cols;
  int top;      // the search's first step (`search_top`, staged)
  int E;        // staged rows of edges (`edge_rows`)
  int S;        // groups a super-row (a multiple of lcm(d, 8) / 8 and 32)
  int sr_rows;  // rows a super-row: 8 S / d
  int windows;  // windows a super-row: S / 32
  int64_t full;   // whole groups: c * d / 8
  int64_t groups;  // groups with an element: ceil(c * d / 8)
};

// IN: 0 for the f16 chunk, 8 or 4 for the quantized wire's bits. A group's
// 8 inputs as f32 (the f16 value, or the code)
template <int IN>
struct Raw;
template <>
struct Raw<0> {
  uint4 v;
  __device__ void load(const void* in, int64_t i0) {
    v = __ldg(reinterpret_cast<const uint4*>(static_cast<const __half*>(in) +
                                             i0));
  }
  __device__ float code(int k) const {
    const uint32_t w = (&v.x)[k >> 1];
    return __half2float(__ushort_as_half(
        (unsigned short)((k & 1) ? w >> 16 : w & 0xFFFFu)));
  }
};
template <>
struct Raw<8> {
  uint2 v;
  __device__ void load(const void* in, int64_t i0) {
    v = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(in) +
                                             i0));
  }
  __device__ float code(int k) const {
    return (float)(((k < 4 ? v.x : v.y) >> (8 * (k & 3))) & 0xFFu);
  }
};
template <>
struct Raw<4> {
  uint32_t v;
  __device__ void load(const void* in, int64_t i0) {
    v = __ldg(reinterpret_cast<const uint32_t*>(
        static_cast<const uint8_t*>(in) + (i0 >> 1)));
  }
  __device__ float code(int k) const { return (float)((v >> (4 * k)) & 0xFu); }
};

// element i = (r, f) of the chunk, loaded alone: its f16 value or its code
// (FLAT: rows without a padding nibble, so r and f are not needed)
template <int IN, bool FLAT>
__device__ __forceinline__ float load_one(const Rows& q, int64_t i,
                                          int64_t r, int f) {
  if constexpr (IN == 0) {
    return __half2float(static_cast<const __half*>(q.in)[i]);
  } else if constexpr (IN == 8) {
    return (float)static_cast<const uint8_t*>(q.in)[i];
  } else {
    const uint8_t* in = static_cast<const uint8_t*>(q.in);
    const int byte = FLAT ? in[i >> 1] : in[r * q.cols + (f >> 1)];
    return (float)(((FLAT ? (int)(i & 1) : (f & 1)) != 0) ? (byte >> 4)
                                                           : (byte & 0x0F));
  }
}

// a thread's slots: its lane (slot j's staged column is 32j + lane) and,
// dequantizing, the scale and lo of its 8 features
struct Slots {
  int lane;
  float sc[V], lo[V];
};

__device__ __forceinline__ bool mono(const uint32_t* s_mono, int col) {
  return (s_mono[col >> 5] >> (col & 31) & 1u) != 0u;
}

// the element values x and bins of a group's inputs v
template <int IN, bool BIN>
__device__ __forceinline__ void values(const Rows& q, const Slots& s,
                                       bool all_mono, const float (&v)[V],
                                       float (&x)[V], int (&cnt)[V]) {
  const int* lut_b = reinterpret_cast<const int*>(k12_stage + q.E * WIN);
  const uint32_t* s_mono = reinterpret_cast<const uint32_t*>(
      lut_b + (IN == 4 ? 16 * WIN : 0));
#pragma unroll
  for (int j = 0; j < V; ++j)
    x[j] = IN == 0 ? v[j]
                   : flush_subnormal(__fmaf_rn(v[j], s.sc[j], s.lo[j]));
  if constexpr (BIN && IN == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      cnt[j] = lut_b[((int)v[j] << LOG_WIN) + j * LANES + s.lane];
  } else if constexpr (BIN) {
    // binary lifting over the E staged rows (NaN past n_edges, which no x
    // reaches) in units of a row: o[j] is the float offset of row cnt - 1
    // of the slot's column, 32-bit, so each probe is one shared load
    const auto at = [](int o) { return k12_stage[o]; };
    int o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = j * LANES + s.lane - WIN;
    for (int hd = q.top << LOG_WIN; hd >= WIN; hd >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = lift_padded(at, x[j], o[j], hd);
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      cnt[j] = (o[j] - j * LANES - s.lane + WIN) >> LOG_WIN;
    if (!all_mono) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = j * LANES + s.lane;
        if (!mono(s_mono, col)) {
          const auto e = [&](int r) { return k12_stage[r * WIN + col]; };
          cnt[j] = count_linear(e, x[j], q.n_edges);
        }
      }
    }
  }
}

// the stores of a group at flat output offset o0: n elements (all 8 with
// VEC, as 16- and 8-byte stores)
template <typename WideT, bool BIN, bool VEC>
__device__ __forceinline__ void store(const Rows& q, int64_t o0,
                                      const float (&x)[V],
                                      const int (&cnt)[V], int n) {
  if constexpr (!std::is_same<WideT, void>::value) {
    WideT* out = static_cast<WideT*>(q.out16) + o0;
    if constexpr (VEC && std::is_same<WideT, uint16_t>::value) {
      uint32_t w[V / 2];
#pragma unroll
      for (int j = 0; j < V / 2; ++j) w[j] = bf16_pair(x[2 * j], x[2 * j + 1]);
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC) {
      reinterpret_cast<float4*>(out)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(out)[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < n) {
          if constexpr (std::is_same<WideT, uint16_t>::value) {
            out[j] = bf16_bits(x[j]);
          } else {
            out[j] = x[j];
          }
        }
      }
    }
  }
  if constexpr (BIN) {
    int8_t* ob = q.outb + o0;
    if constexpr (VEC) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < V; ++j)
        w[j >> 2] |= ((uint32_t)cnt[j] & 0xFFu) << (8 * (j & 3));
      *reinterpret_cast<uint2*>(ob) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < n) ob[j] = (int8_t)cnt[j];
    }
  }
}

// n (<= V) elements from flat index i0 = (r, f), each loaded alone
template <int IN, typename WideT, bool BIN, bool FLAT>
__device__ __forceinline__ void scalar_group(const Rows& q, const Slots& s,
                                             bool all_mono, int64_t i0,
                                             int64_t r, int f, int n) {
  float v[V], x[V];
  int cnt[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = j < n ? load_one<IN, FLAT>(q, i0 + j, r, f) : 0.0f;
    if (++f == q.d) {
      f = 0;
      ++r;
    }
  }
  values<IN, BIN>(q, s, all_mono, v, x, cnt);
  store<WideT, BIN, false>(q, q.r0 * q.d + i0, x, cnt, n);
}

template <int IN, typename WideT, bool BIN, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) rows_kernel(Rows q) {
  constexpr bool DEQ = IN != 0;
  constexpr bool TABLE = IN == 4 && BIN;
  const int tid = threadIdx.x, warp = tid / LANES;
  const int w = blockIdx.x % q.windows;
  const int rows_blocks = gridDim.x / q.windows;
  const int i = w * LANES + (tid & (LANES - 1));  // the thread's group
  const int fw = (int)((int64_t)w * WIN % q.d);   // the window's first feature
  Slots s;
  s.lane = tid & (LANES - 1);
  if constexpr (DEQ) {
    int f = (int)((int64_t)i * V % q.d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s.sc[j] = flush_subnormal(__ldg(q.scale + f));
      s.lo[j] = flush_subnormal(__ldg(q.lo + f));
      if (++f == q.d) f = 0;
    }
  }
  bool all_mono = true;
  if constexpr (BIN) {
    float* s_e = k12_stage;
    int* lut_b = reinterpret_cast<int*>(s_e + q.E * WIN);
    uint32_t* s_mono =
        reinterpret_cast<uint32_t*>(lut_b + (TABLE ? 16 * WIN : 0));
    const int ne = q.n_edges, total = WIN * ne;
    if (tid < WIN / 32) s_mono[tid] = ~0u;
    for (int k = ne * WIN + tid; k < q.E * WIN; k += THREADS)
      s_e[k] = __int_as_float(0x7fc00000);  // NaN
    __syncthreads();
    // the window's edges, feature by feature (coalesced), SU loads a thread
    // in flight: staged, and their order tested
    for (int k0 = tid; k0 < total; k0 += THREADS * SU) {
      float e[SU], e1[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int k = k0 + u * THREADS;
        const int l = k / ne, j = k - l * ne;
        const float* row = q.edges + (int64_t)((fw + l) % q.d) * ne;
        e[u] = k < total ? __ldg(row + j) : 0.0f;
        e1[u] = k < total && j + 1 < ne ? __ldg(row + j + 1) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int k = k0 + u * THREADS;
        if (k >= total) continue;
        const int l = k / ne, j = k - l * ne;
        const int col = (l & (V - 1)) * LANES + l / V;
        const float a = DEQ ? flush_subnormal(e[u]) : e[u];
        const float b = DEQ ? flush_subnormal(e1[u]) : e1[u];
        s_e[j * WIN + col] = a;
        if (j + 1 < ne && !in_order(a, b))
          atomicAnd(s_mono + (col >> 5), ~(1u << (col & 31)));
      }
    }
    __syncthreads();
    const bool ok = tid >= WIN / 32 || s_mono[tid] == ~0u;
    all_mono = __syncthreads_and(ok) != 0;
    if constexpr (TABLE) {
      // the bin of each of the 16 codes of the window's features
      for (int k = tid; k < 16 * WIN; k += THREADS) {
        const int code = k >> LOG_WIN, col = k & (WIN - 1);
        const int l = (col & (LANES - 1)) * V + col / LANES;
        const int f = (fw + l) % q.d;
        const float x = flush_subnormal(
            __fmaf_rn((float)code, flush_subnormal(__ldg(q.scale + f)),
                      flush_subnormal(__ldg(q.lo + f))));
        const auto at = [](int o) { return k12_stage[o]; };
        int o = col - WIN;
        for (int hd = q.top << LOG_WIN; hd >= WIN; hd >>= 1)
          o = lift_padded(at, x, o, hd);
        int c = (o - col + WIN) >> LOG_WIN;
        if (!mono(s_mono, col)) {
          const auto e = [&](int r) { return k12_stage[r * WIN + col]; };
          c = count_linear(e, x, ne);
        }
        lut_b[k] = c;
      }
      __syncthreads();
    }
  }
  // group g of super-row sr holds the features of group i; a step of the
  // grid stride is `rows_blocks` blocks of WARPS super-rows
  const int64_t sr0 = (int64_t)(blockIdx.x / q.windows) * WARPS + warp;
  const int64_t step = (int64_t)rows_blocks * WARPS * q.S;
  int64_t g = sr0 * q.S + i;
  if constexpr (VEC) {
    Raw<IN> cur, nxt;
    if (g < q.full) cur.load(q.in, g * V);
    for (; g < q.full; g += step) {
      if (g + step < q.full) nxt.load(q.in, (g + step) * V);
      float v[V], x[V];
      int cnt[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = cur.code(j);
      values<IN, BIN>(q, s, all_mono, v, x, cnt);
      store<WideT, BIN, true>(q, q.r0 * q.d + g * V, x, cnt, V);
      cur = nxt;
    }
    if (g < q.groups)  // the last c*d mod 8 elements
      scalar_group<IN, WideT, BIN, true>(q, s, all_mono, g * V, 0, 0,
                                         (int)(q.c * q.d - g * V));
  } else {
    // (row, feature) of the group's first element: the feature stays, the
    // row moves by a whole number of super-rows a step
    const int f = (int)((int64_t)i * V % q.d);
    int64_t r = sr0 * q.sr_rows + (int64_t)i * V / q.d;
    const int64_t rstep = (int64_t)rows_blocks * WARPS * q.sr_rows;
    for (; g < q.groups; g += step, r += rstep) {
      const int64_t left = q.c * q.d - g * V;
      scalar_group<IN, WideT, BIN, false>(q, s, all_mono, g * V, r, f,
                                          left < V ? (int)left : V);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

int64_t gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the instance's blocks an SM at `smem` bytes (registers and shared memory
// both counted; read once an instance, device and size), with shared
// memory past 48 KB allowed first
template <int IN, typename WideT, bool BIN, bool VEC>
int blocks_per_sm(size_t smem, int* out) {
  auto kernel = rows_kernel<IN, WideT, BIN, VEC>;
  static std::atomic<int> known[MAX_DEVICES];  // (smem << 4) | blocks
  int dev = 0;
  cudaGetDevice(&dev);
  const int key = (int)(smem << 4);
  const int seen = dev < MAX_DEVICES ? known[dev].load() : 0;
  if (seen != 0 && (seen & ~15) == key) {
    *out = seen & 15;
    return (int)cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  *out = blocks < 1 ? 1 : (blocks > 15 ? 15 : blocks);
  if (dev < MAX_DEVICES) known[dev].store(key | *out);
  return (int)cudaSuccess;
}

template <int IN, typename WideT, bool BIN, bool VEC>
int launch_one(const Rows& q, size_t smem, cudaStream_t stream) {
  int per_sm = 1;
  const int err = blocks_per_sm<IN, WideT, BIN, VEC>(smem, &per_sm);
  if (err != (int)cudaSuccess) return err;
  // blocks a window: the card's share, at most one per WARPS super-rows
  const int64_t super_rows = (q.groups + q.S - 1) / q.S;
  int64_t per_win = (int64_t)per_sm * sm_count() / q.windows;
  const int64_t need = (super_rows + WARPS - 1) / WARPS;
  if (per_win > need) per_win = need;
  if (per_win < 1) per_win = 1;
  rows_kernel<IN, WideT, BIN, VEC>
      <<<(unsigned)(per_win * q.windows), THREADS, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t byte_offset, int to) {
  return p == nullptr ||
         ((uintptr_t)p + (uint64_t)byte_offset) % (uint64_t)to == 0;
}

template <int IN, typename WideT, bool BIN>
int launch(Rows q, void* stream) {
  if (q.c <= 0 || q.d <= 0) return (int)cudaSuccess;
  const int ne = BIN ? q.n_edges : 0;
  q.n_edges = ne;
  q.E = edge_rows(ne);
  q.top = search_top(ne, true);
  q.cols = IN == 4 ? (q.d + 1) / 2 : q.d;
  // a super-row: lcm(d, 8) elements, times the least factor that makes
  // its groups a whole number of windows (no lane idles)
  int64_t S = q.d / gcd(q.d, V);
  S *= LANES / gcd((int)(S % LANES), LANES);
  if (S > (int64_t)1 << 30) return (int)cudaErrorInvalidValue;
  q.S = (int)S;
  q.sr_rows = (int)(S * V / q.d);
  q.windows = q.S / LANES;
  const int64_t total = q.c * q.d;
  q.full = total / V;
  q.groups = (total + V - 1) / V;
  // staged bytes: the window's edges [E][WIN], the 4-bit wire's table
  // [16][WIN], the order bits
  const size_t smem =
      BIN ? ((size_t)q.E * WIN + (IN == 4 ? 16 * WIN : 0) + WIN / 32) * 4
          : 0;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // 16-byte f16 loads (8 / 4 bytes of codes), 16-byte bf16 / f32 and 8-byte
  // bin stores where every address allows them and rows are flat
  const int in_align = IN == 0 ? 16 : (IN == 8 ? 8 : 4);
  const int64_t wide_bytes = std::is_same<WideT, float>::value ? 4 : 2;
  const bool vec = q.r0 * q.d % V == 0 && (IN != 4 || q.d % 2 == 0) &&
                   aligned(q.in, 0, in_align) &&
                   aligned(q.out16, q.r0 * q.d * wide_bytes, 16) &&
                   aligned(q.outb, q.r0 * q.d, 8);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) return launch_one<IN, WideT, BIN, true>(q, smem, s);
  return launch_one<IN, WideT, BIN, false>(q, smem, s);
}

Rows rows_of(const void* in, const void* scale, const void* lo,
             const void* edges, void* out16, void* outb, int64_t r0,
             int64_t c, int d, int n_edges) {
  Rows q{};
  q.in = in;
  q.scale = static_cast<const float*>(scale);
  q.lo = static_cast<const float*>(lo);
  q.edges = static_cast<const float*>(edges);
  q.out16 = out16;
  q.outb = static_cast<int8_t*>(outb);
  q.r0 = r0;
  q.c = c;
  q.d = d;
  q.n_edges = n_edges;
  return q;
}

template <typename WideT, bool BIN>
int launch_dequant(Rows q, int bits, void* stream) {
  if (bits == 8) return launch<8, WideT, BIN>(q, stream);
  if (bits == 4) return launch<4, WideT, BIN>(q, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// chunk (c, d) f16 -> out16 rows r0 .. r0 + c, bf16 (as uint16 bits)
extern "C" int write_cast_rows_bf16(const void* chunk, void* out16,
                                    int64_t r0, int64_t c, int d,
                                    void* stream) {
  return launch<0, uint16_t, false>(
      rows_of(chunk, nullptr, nullptr, nullptr, out16, nullptr, r0, c, d, 0),
      stream);
}

// chunk (c, d) f16 -> out rows r0 .. r0 + c, f32
extern "C" int write_cast_rows_f32(const void* chunk, void* out, int64_t r0,
                                   int64_t c, int d, void* stream) {
  return launch<0, float, false>(
      rows_of(chunk, nullptr, nullptr, nullptr, out, nullptr, r0, c, d, 0),
      stream);
}

// chunk (c, d) f16, edges (d, n_edges) f32 -> outb rows r0 .. r0 + c, int8
extern "C" int bin_write_rows(const void* chunk, const void* edges,
                              void* outb, int64_t r0, int64_t c, int d,
                              int n_edges, void* stream) {
  return launch<0, void, true>(
      rows_of(chunk, nullptr, nullptr, edges, nullptr, outb, r0, c, d,
              n_edges),
      stream);
}

// both outputs from one read of the chunk
extern "C" int dual_write_rows(const void* chunk, const void* edges,
                               void* out16, void* outb, int64_t r0,
                               int64_t c, int d, int n_edges, void* stream) {
  return launch<0, uint16_t, true>(
      rows_of(chunk, nullptr, nullptr, edges, out16, outb, r0, c, d, n_edges),
      stream);
}

// quantized chunk (c, d) uint8 or (c, ceil(d/2)) int4-packed, scale and lo
// (d,) f32 -> out rows r0 .. r0 + c, bf16 (as uint16 bits)
extern "C" int dequant_write_rows_bf16(const void* q, const void* scale,
                                       const void* lo, void* out, int64_t r0,
                                       int64_t c, int d, int bits,
                                       void* stream) {
  return launch_dequant<uint16_t, false>(
      rows_of(q, scale, lo, nullptr, out, nullptr, r0, c, d, 0), bits,
      stream);
}

// the same into an f32 buffer
extern "C" int dequant_write_rows_f32(const void* q, const void* scale,
                                      const void* lo, void* out, int64_t r0,
                                      int64_t c, int d, int bits,
                                      void* stream) {
  return launch_dequant<float, false>(
      rows_of(q, scale, lo, nullptr, out, nullptr, r0, c, d, 0), bits,
      stream);
}

// quantized chunk, scale, lo, edges (d, n_edges) f32 -> outb rows, int8
extern "C" int dequant_bin_write_rows(const void* q, const void* scale,
                                      const void* lo, const void* edges,
                                      void* outb, int64_t r0, int64_t c,
                                      int d, int n_edges, int bits,
                                      void* stream) {
  return launch_dequant<void, true>(
      rows_of(q, scale, lo, edges, nullptr, outb, r0, c, d, n_edges), bits,
      stream);
}

// both outputs from one dequantized value per element
extern "C" int dequant_dual_write_rows(const void* q, const void* scale,
                                       const void* lo, const void* edges,
                                       void* out16, void* outb, int64_t r0,
                                       int64_t c, int d, int n_edges,
                                       int bits, void* stream) {
  return launch_dequant<uint16_t, true>(
      rows_of(q, scale, lo, edges, out16, outb, r0, c, d, n_edges), bits,
      stream);
}
