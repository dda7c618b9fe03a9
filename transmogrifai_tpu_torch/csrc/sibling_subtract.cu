// K1-sub: histogram subtraction, the children's histograms of one level
// from their parents' and their right children's.
//
//   child[r, 2k,     e] = parent[r, k, e] - right[r, k, e]   (left child)
//   child[r, 2k + 1, e] = right[r, k, e]                      (right child)
//
// for every histogram row r (a (pair, channel) of the value histograms,
// (P * m, K, d * bins), and a pair of the weight histograms, (P, K, d *
// bins)), node k < K and cell e < d * bins, both tensors in one launch.
//
// Replaces the subtraction branch of `grow_tree` in
// transmogrifai_tpu/models/trees.py:258 and :278-284 (the XGBoost/LightGBM
// histogram trick of deep trees: K1 builds the histograms of the rows
// routed right only, grouped by parent, and the left child is the parent
// minus the right one). The left child is one f32 subtraction, so from
// equal parent and right histograms it is bit-equal to the JAX package's
// `jnp.stack([hg - hg_r, hg_r], axis=2)`.
//
// Design: one thread per four neighbouring cells of a (row, k) when d *
// bins is a multiple of 4 (float4 loads and stores), else per cell; a
// grid-stride loop over 64-bit flat indices (the children of 64 trees at
// level 11 hold more than 2^31 cells). Bound on this card: bytes, each
// input read once and each output written once.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

template <typename V>
__device__ __forceinline__ V minus(V a, V b);

template <>
__device__ __forceinline__ float minus(float a, float b) {
  return a - b;
}

template <>
__device__ __forceinline__ float4 minus(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// `cells` counts elements of type V per (row, node)
template <typename V>
__global__ void sibling_subtract_kernel(
    const V* __restrict__ pg, const V* __restrict__ rg, V* __restrict__ cg,
    int64_t rows_g, const V* __restrict__ ph, const V* __restrict__ rh,
    V* __restrict__ ch, int64_t rows_h, int64_t K, int64_t cells) {
  const int64_t per_row = K * cells;
  const int64_t total_g = rows_g * per_row;
  const int64_t total = total_g + rows_h * per_row;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * THREADS) {
    const bool is_g = i < total_g;
    const int64_t j = is_g ? i : i - total_g;
    const V* par = is_g ? pg : ph;
    const V* rig = is_g ? rg : rh;
    V* out = is_g ? cg : ch;
    const int64_t row = j / per_row;
    const int64_t rest = j - row * per_row;
    const int64_t k = rest / cells;
    const int64_t e = rest - k * cells;
    const V r = rig[j];
    const int64_t o = (row * 2 * K + 2 * k) * cells + e;
    out[o] = minus(par[j], r);
    out[o + cells] = r;
  }
}

template <typename V>
int launch(const void* pg, const void* rg, void* cg, int64_t rows_g,
           const void* ph, const void* rh, void* ch, int64_t rows_h,
           int64_t K, int64_t cells, void* stream) {
  const int64_t total = (rows_g + rows_h) * K * cells;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  sibling_subtract_kernel<V><<<(unsigned)blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const V*>(pg), static_cast<const V*>(rg),
      static_cast<V*>(cg), rows_g, static_cast<const V*>(ph),
      static_cast<const V*>(rh), static_cast<V*>(ch), rows_h, K, cells);
  return (int)cudaGetLastError();
}

}  // namespace

// cells = d * bins per (row, node); the float4 path needs cells % 4 == 0
// and 16-byte aligned tensors
extern "C" int sibling_subtract(const void* pg, const void* rg, void* cg,
                                int64_t rows_g, const void* ph, const void* rh,
                                void* ch, int64_t rows_h, int64_t K,
                                int64_t cells, void* stream) {
  const uintptr_t align = (uintptr_t)pg | (uintptr_t)rg | (uintptr_t)cg |
                          (uintptr_t)ph | (uintptr_t)rh | (uintptr_t)ch;
  if (cells % 4 == 0 && align % 16 == 0)
    return launch<float4>(pg, rg, cg, rows_g, ph, rh, ch, rows_h, K,
                          cells / 4, stream);
  return launch<float>(pg, rg, cg, rows_g, ph, rh, ch, rows_h, K, cells,
                       stream);
}
