// K5: tree-ensemble walk, out[r, c] = sum_t leaf[t, walk_t(r), c].
//
// Replaces the TPU walk in transmogrifai_tpu/models/trees.py: `_tree_walk`
// (:334-364) with `_table_lookup2`/`_select_bin`/`_leaf_lookup`, summed over
// trees by `_scan_tree_chunks`/`_predict_trees_sum`/`_predict_trees_margin`
// (:477-544) for `predict_forest` and `predict_gbt_margin` (:813). On the
// TPU every table read is a one-hot compare-and-sum over 2^level nodes and
// every feature read a masked reduction over all d columns, because gathers
// serialise there.
//
// Walk per tree, level by level: node = 2*node + (Xb[r, feat[t,l,node]] >
// bin[t,l,node]); a split bin equal to n_bins never fires, so such a node
// always goes left, as in the JAX program. After `depth` levels the node
// is the leaf index.
//
// Bound on this card: memory. The walk reads each table slot it reaches
// once, and level l of a tree reaches at most min(2^l, width) slots of feat
// and of bin (int32 each): at most 1023 of each tree's 10240 slots at the
// Titanic model, 200*1023*2*4 B ~ 1.6 MB, not the whole 16 MB tables (all
// of which fit the 50 MB L2). Add the leaves it lands on (at most
// n_trees*n_leaves*m f32), the Xb cells it reads (at most n*d int8) and the
// n*m f32 output. Design: one thread per row walks every
// tree in a fixed order with direct gathers (no one-hot passes over 2^level
// or d) and keeps up to MAX_M class sums in f32 registers; the row is
// written once, with no atomics, so the result is deterministic and sums
// the trees in index order. Classes beyond MAX_M are covered by further
// launches over class chunks [c0, c0 + mc).
//
// Known limit, for later work: with one thread per row, n = 891 rows make
// only 7 blocks of 128 threads on a 132-SM card, and each thread runs
// n_trees*depth dependent loads. A grid split over trees as well, with a
// second pass that sums the per-tree-chunk partials, would fill the card.
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_M = 8;
constexpr int BLOCK = 128;

template <typename BinT>
__global__ void tree_walk_kernel(const BinT* __restrict__ Xb,
                                 const int32_t* __restrict__ feat,
                                 const int32_t* __restrict__ bins,
                                 const float* __restrict__ leaf,
                                 float* __restrict__ out, int64_t n, int d,
                                 int n_trees, int depth, int width,
                                 int n_leaves, int m, int c0, int mc) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const BinT* x = Xb + r * d;
  float acc[MAX_M];
#pragma unroll
  for (int c = 0; c < MAX_M; ++c) acc[c] = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const int64_t table = (int64_t)t * depth * width;
    int node = 0;
    for (int l = 0; l < depth; ++l) {
      const int64_t at = table + (int64_t)l * width + node;
      const int f = __ldg(feat + at);
      const int b = __ldg(bins + at);
      const int xb = static_cast<int>(x[f]);
      node = 2 * node + (xb > b ? 1 : 0);
    }
    const float* lt = leaf + ((int64_t)t * n_leaves + node) * m + c0;
#pragma unroll
    for (int c = 0; c < MAX_M; ++c) {
      if (c < mc) acc[c] += __ldg(lt + c);
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_M; ++c) {
    if (c < mc) out[r * m + c0 + c] = acc[c];
  }
}

template <typename BinT>
int launch(const void* Xb, const void* feat, const void* bins,
           const void* leaf, void* out, int64_t n, int d, int n_trees,
           int depth, int width, int n_leaves, int m, int c0, int mc,
           void* stream) {
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  tree_walk_kernel<BinT><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const int32_t*>(feat),
      static_cast<const int32_t*>(bins), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_trees, depth, width, n_leaves, m, c0,
      mc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tree_walk_max_m() { return MAX_M; }

extern "C" int tree_walk_i8(const void* Xb, const void* feat,
                            const void* bins, const void* leaf, void* out,
                            int64_t n, int d, int n_trees, int depth,
                            int width, int n_leaves, int m, int c0, int mc,
                            void* stream) {
  return launch<int8_t>(Xb, feat, bins, leaf, out, n, d, n_trees, depth,
                        width, n_leaves, m, c0, mc, stream);
}

extern "C" int tree_walk_i32(const void* Xb, const void* feat,
                             const void* bins, const void* leaf, void* out,
                             int64_t n, int d, int n_trees, int depth,
                             int width, int n_leaves, int m, int c0, int mc,
                             void* stream) {
  return launch<int32_t>(Xb, feat, bins, leaf, out, n, d, n_trees, depth,
                         width, n_leaves, m, c0, mc, stream);
}
