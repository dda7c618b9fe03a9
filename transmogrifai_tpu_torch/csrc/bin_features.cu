// K4: feature binning, Xb[r, f] = #{e : X[r, f] >= edges[f, e]}.
//
// Replaces `bin_features` in transmogrifai_tpu/models/trees.py:63-75, which
// on the TPU is a broadcast compare of every element against every edge
// followed by a sum. The count equals searchsorted(edges[f], x, "right")
// for ascending edges; NaN compares false everywhere, so NaN lands in
// bin 0, exactly as in the JAX program.
//
// Bound on this card: memory. Each element is 4 bytes in and 1 byte out
// (4 with int32 output), the edges are d*n_edges*4 bytes read once, and the
// compares are n*d*n_edges f32 operations, far below the f32 peak for
// n_edges ~ 31. Design: one thread per (row, feature) element. A block
// covers FEAT_TILE neighbouring features x ROW_TILE rows; neighbouring
// threads read neighbouring features of one row, so the loads coalesce.
// The block's edge rows are staged once in shared memory, and a thread
// walks further rows with a grid-stride loop so the staging is amortised.
// The count is a linear scan over all edges: it needs no sorted edges and
// is exactly the TPU program's comparison set.
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FEAT_TILE = 32;
constexpr int ROW_TILE = 8;
constexpr int MAX_GRID_Y = 2048;

template <typename OutT>
__global__ void bin_features_kernel(const float* __restrict__ X,
                                    const float* __restrict__ edges,
                                    OutT* __restrict__ out,
                                    int64_t n, int d, int n_edges) {
  extern __shared__ float s_edges[];  // [nf][n_edges]
  const int f0 = blockIdx.x * FEAT_TILE;
  const int nf = min(FEAT_TILE, d - f0);
  const int tid = threadIdx.y * FEAT_TILE + threadIdx.x;
  for (int i = tid; i < nf * n_edges; i += FEAT_TILE * ROW_TILE) {
    s_edges[i] = edges[(int64_t)f0 * n_edges + i];
  }
  __syncthreads();
  if (threadIdx.x >= nf) return;
  const int f = f0 + threadIdx.x;
  const float* e = s_edges + threadIdx.x * n_edges;
  const int64_t row_step = (int64_t)gridDim.y * ROW_TILE;
  for (int64_t r = (int64_t)blockIdx.y * ROW_TILE + threadIdx.y; r < n;
       r += row_step) {
    const float x = X[r * d + f];
    int c = 0;
    for (int j = 0; j < n_edges; ++j) c += (x >= e[j]) ? 1 : 0;
    out[r * d + f] = static_cast<OutT>(c);
  }
}

template <typename OutT>
int launch(const void* X, const void* edges, void* out, int64_t n, int d,
           int n_edges, void* stream) {
  const int64_t row_groups = (n + ROW_TILE - 1) / ROW_TILE;
  dim3 grid((d + FEAT_TILE - 1) / FEAT_TILE,
            (unsigned)(row_groups < MAX_GRID_Y ? row_groups : MAX_GRID_Y));
  dim3 block(FEAT_TILE, ROW_TILE);
  size_t smem = (size_t)FEAT_TILE * n_edges * sizeof(float);
  bin_features_kernel<OutT><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(X), static_cast<const float*>(edges),
      static_cast<OutT*>(out), n, d, n_edges);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bin_features_i8(const void* X, const void* edges, void* out,
                               int64_t n, int d, int n_edges, void* stream) {
  return launch<int8_t>(X, edges, out, n, d, n_edges, stream);
}

extern "C" int bin_features_i32(const void* X, const void* edges, void* out,
                                int64_t n, int d, int n_edges, void* stream) {
  return launch<int32_t>(X, edges, out, n, d, n_edges, stream);
}
