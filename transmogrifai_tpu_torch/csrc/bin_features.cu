// K4: feature binning, Xb[r, f] = #{e : X[r, f] >= edges[f, e]}.
//
// Replaces `bin_features` in transmogrifai_tpu/models/trees.py:63-75, which
// on the TPU is a broadcast compare of every element against every edge
// followed by a sum. NaN compares false everywhere, so NaN lands in bin 0.
// The count is exactly that for any edges: unsorted, NaN, duplicated,
// +-inf or +-0.
//
// Bound on this card: memory. Each element is 4 bytes in and 1 byte out
// (4 with int32 output); the edges are read once. The broadcast compare
// is n*d*n_edges operations, but for non-decreasing edges the count is a
// prefix length, found in ceil(log2(n_edges + 1)) compares.
//
// Design:
// - A block takes a tile of TILE = 128 neighbouring features and walks
//   rows with a grid-stride loop, each warp UNROLL rows at a time with
//   their loads issued first (the first rows' while the edges are staged);
//   the grid fills the card a few times, so at large n a block's staging
//   of the tile's edges is paid once for many rows.
// - A thread takes 4 neighbouring features of a row: one 16-byte load of
//   X and one 4-byte store of int8 bins (16 bytes of int32) where d % 4 == 0
//   and X is 16-byte aligned; a scalar path otherwise.
// - The tile's edges are staged edge-major with the features lane-fastest:
//   feature 4l + k of the tile sits in column k*32 + l, so the 32 lanes of
//   a warp read 32 different banks whatever edge each one's search reaches.
//   (A feature-major layout with an odd stride is conflict-free only while
//   the lanes read the same edge.) The edges come in coalesced into a
//   feature-major scratch with an odd row stride, and are transposed from
//   there. Rows past n_edges up to 2^m - 1 hold NaN, which no value
//   reaches, so the search needs no bound check.
// - While transposing, the block tests each feature's edges: e[j] <=
//   e[j+1] for every j (false wherever an edge is NaN). A non-decreasing
//   feature takes a branch-free binary search with the same `>=` compare,
//   which gives the same count and still sends NaN to 0; any other feature
//   is counted linearly (the rule and its steps live in edge_count.cuh,
//   shared with K12). No host check, no sync. The UNROLL x 4 searches of a
//   thread step together: 16 independent shared loads a step.
// - Above STAGE_MAX_BYTES of shared memory a block (past 65 edges; 64 and
//   65 fill it exactly) the kernel reads each feature's edges from global
//   memory / L2 instead; the monotone test and the counts are the same.
//
// The f16-edge variant serves the quantized scoring mode, whose narrowed
// tables keep the edges in f16 (`narrow_device_constants`,
// models/trees.py:999): each edge is widened to f32 as it is read, and the
// compare runs in f32, as the JAX program promotes f16 edges against f32
// values.
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "edge_count.cuh"

// the staged edges, [E][TILE] f32, then the feature-major scratch they are
// transposed from, [TILE][S] (dynamic shared memory)
extern __shared__ float k4_stage[];

namespace {

constexpr int LANES = 32;
constexpr int FEATS = 4;               // features a thread
constexpr int TILE = LANES * FEATS;    // features a block
constexpr int ROWS = 8;                // warps a block
constexpr int THREADS = LANES * ROWS;
constexpr int UNROLL = 4;              // rows a warp has in flight
constexpr int MIN_ROWS = ROWS * UNROLL;  // rows a block at least
constexpr int BLOCKS = 132 * 4;        // the grid: 132 SMs a few times
constexpr int STAGE_MAX_BYTES = 96 * 1024;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float widen(float e) { return e; }
__device__ __forceinline__ float widen(__half e) { return __half2float(e); }

struct StagedEdges {
  int col;
  __device__ __forceinline__ float operator()(int j) const {
    return k4_stage[j * TILE + col];
  }
};

template <typename EdgeT>
struct GlobalEdges {
  const EdgeT* e;  // the feature's row of edges
  __device__ __forceinline__ float operator()(int j) const {
    return widen(e[j]);
  }
};

// rows r0, r0 + step, ... (UNROLL of them) of this thread's 4 features
template <bool VEC>
__device__ __forceinline__ void load_rows(const float* __restrict__ X,
                                          float (&x)[UNROLL][FEATS],
                                          int64_t r0, int64_t step,
                                          int64_t n, int d, int fb) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t r = r0 + u * step;
    const float* xr = X + r * d + fb;
    if (r >= n) {
#pragma unroll
      for (int k = 0; k < FEATS; ++k) x[u][k] = 0.f;
    } else if (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(xr);
      x[u][0] = v.x; x[u][1] = v.y; x[u][2] = v.z; x[u][3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < FEATS; ++k) x[u][k] = fb + k < d ? xr[k] : 0.f;
    }
  }
}

// staged: E = 2^m - 1 >= n_edges rows, scratch row stride S (odd)
struct Stage {
  int E, S;
};

__host__ __device__ inline Stage stage_of(int n_edges) {
  return {edge_rows(n_edges), n_edges | 1};
}

template <typename EdgeT, typename OutT, bool STAGED, bool VEC>
__global__ void __launch_bounds__(THREADS)
bin_features_kernel(const float* __restrict__ X,
                    const EdgeT* __restrict__ edges,
                    OutT* __restrict__ out, int64_t n, int d, int n_edges,
                    int top) {
  using Edges = std::conditional_t<STAGED, StagedEdges, GlobalEdges<EdgeT>>;
  __shared__ int s_mono[TILE];  // by column: edges non-decreasing
  const int f0 = blockIdx.x * TILE;
  const int nf = min(TILE, d - f0);
  const int tid = threadIdx.y * LANES + threadIdx.x;
  const int lane = threadIdx.x;
  const int fb = f0 + lane * FEATS;  // this thread's first feature
  const int64_t step = (int64_t)gridDim.y * ROWS;
  int64_t r0 = (int64_t)blockIdx.y * ROWS + threadIdx.y;
  // the first rows' loads are in flight while the edges are staged
  float x[UNROLL][FEATS];
  if (fb < d) load_rows<VEC>(X, x, r0, step, n, d, fb);
  for (int i = tid; i < TILE; i += THREADS) s_mono[i] = 1;
  if constexpr (STAGED) {
    const Stage st = stage_of(n_edges);
    float* scratch = k4_stage + st.E * TILE;
    // the tile's rows of edges are contiguous: read them coalesced
    const EdgeT* tile = edges + (int64_t)f0 * n_edges;
    for (int i = tid; i < nf * n_edges; i += THREADS) {
      const int fl = i / n_edges;
      scratch[fl * st.S + (i - fl * n_edges)] = widen(tile[i]);
    }
    __syncthreads();
    for (int i = tid; i < st.E * TILE; i += THREADS) {
      const int j = i / TILE, col = i % TILE;
      const int fl = (col % LANES) * FEATS + col / LANES;
      const bool real = j < n_edges && fl < nf;
      const float e = real ? scratch[fl * st.S + j]
                           : __int_as_float(0x7fc00000);  // NaN
      if (real && j + 1 < n_edges &&
          !in_order(e, scratch[fl * st.S + j + 1])) {
        s_mono[col] = 0;
      }
      k4_stage[i] = e;
    }
  } else {
    __syncthreads();
    for (int i = tid; i < n_edges * TILE; i += THREADS) {
      const int j = i / TILE, col = i % TILE;
      const int fl = (col % LANES) * FEATS + col / LANES;
      if (fl >= nf || j + 1 >= n_edges) continue;
      const int64_t g = (int64_t)(f0 + fl) * n_edges + j;
      if (!in_order(widen(edges[g]), widen(edges[g + 1]))) s_mono[col] = 0;
    }
  }
  __syncthreads();
  if (fb >= d) return;
  bool mono[FEATS];
  Edges edge[FEATS];
#pragma unroll
  for (int k = 0; k < FEATS; ++k) {
    mono[k] = s_mono[k * LANES + lane] != 0;
    if constexpr (STAGED) {
      edge[k] = Edges{k * LANES + lane};
    } else {
      edge[k] = Edges{edges + (int64_t)min(fb + k, d - 1) * n_edges};
    }
  }
  for (; r0 < n; r0 += step * UNROLL) {
    // binary lifting: c is the largest prefix length with x >= e(c - 1);
    // staged rows past n_edges are NaN, global reads are clamped
    int c[UNROLL][FEATS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < FEATS; ++k) c[u][k] = 0;
    }
    for (int h = top; h > 0; h >>= 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int k = 0; k < FEATS; ++k) {
          if constexpr (STAGED) {
            // `lift_padded`'s step written out: through the helper this
            // loop ran 6 % slower on the card (the same results)
            const int t = c[u][k] + h;
            c[u][k] = x[u][k] >= edge[k](t - 1) ? t : c[u][k];
          } else {
            c[u][k] = lift_clamped(edge[k], x[u][k], c[u][k], h, n_edges);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < FEATS; ++k) {
      if (!mono[k]) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          c[u][k] = count_linear(edge[k], x[u][k], n_edges);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = r0 + u * step;
      if (r >= n) continue;
      OutT* o = out + r * d + fb;
      if (VEC && sizeof(OutT) == 1) {
        *reinterpret_cast<char4*>(o) = make_char4(
            (char)c[u][0], (char)c[u][1], (char)c[u][2], (char)c[u][3]);
      } else if (VEC) {
        *reinterpret_cast<int4*>(o) =
            make_int4(c[u][0], c[u][1], c[u][2], c[u][3]);
      } else {
#pragma unroll
        for (int k = 0; k < FEATS; ++k) {
          if (fb + k < d) o[k] = static_cast<OutT>(c[u][k]);
        }
      }
    }
    load_rows<VEC>(X, x, r0 + step * UNROLL, step, n, d, fb);
  }
}

template <typename EdgeT, typename OutT, bool STAGED, bool VEC>
int launch_one(dim3 grid, size_t smem, cudaStream_t stream, const void* X,
               const void* edges, void* out, int64_t n, int d, int n_edges,
               int top) {
  auto kernel = bin_features_kernel<EdgeT, OutT, STAGED, VEC>;
  if constexpr (STAGED) {
    // shared memory past 48 KB, allowed once an instance and device
    static std::atomic<bool> raised[MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEVICES || !raised[dev].load()) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          STAGE_MAX_BYTES);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) raised[dev].store(true);
    }
  }
  kernel<<<grid, dim3(LANES, ROWS), smem, stream>>>(
      static_cast<const float*>(X), static_cast<const EdgeT*>(edges),
      static_cast<OutT*>(out), n, d, n_edges, top);
  return (int)cudaGetLastError();
}

template <typename EdgeT, typename OutT>
int launch(const void* X, const void* edges, void* out, int64_t n, int d,
           int n_edges, void* stream) {
  const int tiles = (d + TILE - 1) / TILE;
  const int64_t groups = (n + MIN_ROWS - 1) / MIN_ROWS;
  const int64_t want = BLOCKS / tiles > 0 ? BLOCKS / tiles : 1;
  const dim3 grid(tiles, (unsigned)(groups < want ? groups : want));
  const Stage st = stage_of(n_edges);
  const size_t smem = (size_t)(st.E + st.S) * TILE * sizeof(float);
  const bool staged = smem <= (size_t)STAGE_MAX_BYTES;
  const int top = search_top(n_edges, staged);
  const bool vec = d % FEATS == 0 && (uintptr_t)X % 16 == 0 &&
                   (uintptr_t)out % (FEATS * sizeof(OutT)) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (staged && vec) {
    return launch_one<EdgeT, OutT, true, true>(grid, smem, s, X, edges, out,
                                               n, d, n_edges, top);
  }
  if (staged) {
    return launch_one<EdgeT, OutT, true, false>(grid, smem, s, X, edges,
                                                out, n, d, n_edges, top);
  }
  if (vec) {
    return launch_one<EdgeT, OutT, false, true>(grid, 0, s, X, edges, out,
                                                n, d, n_edges, top);
  }
  return launch_one<EdgeT, OutT, false, false>(grid, 0, s, X, edges, out, n,
                                               d, n_edges, top);
}

}  // namespace

extern "C" int bin_features_i8(const void* X, const void* edges, void* out,
                               int64_t n, int d, int n_edges, void* stream) {
  return launch<float, int8_t>(X, edges, out, n, d, n_edges, stream);
}

extern "C" int bin_features_i32(const void* X, const void* edges, void* out,
                                int64_t n, int d, int n_edges, void* stream) {
  return launch<float, int32_t>(X, edges, out, n, d, n_edges, stream);
}

extern "C" int bin_features_f16_i8(const void* X, const void* edges,
                                   void* out, int64_t n, int d, int n_edges,
                                   void* stream) {
  return launch<__half, int8_t>(X, edges, out, n, d, n_edges, stream);
}

extern "C" int bin_features_f16_i32(const void* X, const void* edges,
                                    void* out, int64_t n, int d, int n_edges,
                                    void* stream) {
  return launch<__half, int32_t>(X, edges, out, n, d, n_edges, stream);
}
