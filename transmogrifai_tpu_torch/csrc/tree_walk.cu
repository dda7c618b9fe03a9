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
// K5-mc, the class-tree walk: out[r, k] = sum_t leaf[t, k, walk_{t,k}(r)]
// over tables laid out (T rounds, K classes, depth, width) and leaves
// (T, K, n_leaves, 1) -- a softmax-boosted ensemble, one tree per (round,
// class). Replaces `predict_gbt_multiclass_margin` (models/trees.py:797),
// which vmaps the one-hot walk over rounds and classes and sums the rounds
// in an order XLA picks. Design: one thread per (row, class), a grid of
// (row blocks, K), so any class count works (one class per grid row); each
// thread walks its class's T trees in round order with direct gathers,
// adds the leaves in f32 and writes its output once, with no atomics. The
// learning rate is applied by the caller, as for K5.
//
// Narrowed tables (the quantized scoring mode, `narrow_device_constants`
// in models/trees.py:999): split features as int16 when d < 2^15 and split
// bins as uint8 when there are at most 255 edges, both lossless. Both walks
// are templates over the table types; `tree_walk_typed` and
// `tree_walk_classes_typed` pick the instance from the element sizes. The
// narrowed walk reads 2 + 1 bytes per slot instead of 8.
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_M = 8;
constexpr int BLOCK = 128;

template <typename BinT, typename FeatT, typename SplitT>
__global__ void tree_walk_kernel(const BinT* __restrict__ Xb,
                                 const FeatT* __restrict__ feat,
                                 const SplitT* __restrict__ bins,
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
      const int f = static_cast<int>(__ldg(feat + at));
      const int b = static_cast<int>(__ldg(bins + at));
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

template <typename BinT, typename FeatT = int32_t, typename SplitT = int32_t>
int launch(const void* Xb, const void* feat, const void* bins,
           const void* leaf, void* out, int64_t n, int d, int n_trees,
           int depth, int width, int n_leaves, int m, int c0, int mc,
           void* stream) {
  const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
  tree_walk_kernel<BinT, FeatT, SplitT>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const FeatT*>(feat),
      static_cast<const SplitT*>(bins), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_trees, depth, width, n_leaves, m, c0,
      mc);
  return (int)cudaGetLastError();
}

template <typename BinT, typename FeatT, typename SplitT>
__global__ void tree_walk_classes_kernel(const BinT* __restrict__ Xb,
                                         const FeatT* __restrict__ feat,
                                         const SplitT* __restrict__ bins,
                                         const float* __restrict__ leaf,
                                         float* __restrict__ out, int64_t n,
                                         int d, int n_rounds, int n_classes,
                                         int depth, int width,
                                         int n_leaves) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= n) return;
  const BinT* x = Xb + r * d;
  float acc = 0.0f;
  for (int t = 0; t < n_rounds; ++t) {
    const int64_t tree = (int64_t)t * n_classes + k;
    const int64_t table = tree * depth * width;
    int node = 0;
    for (int l = 0; l < depth; ++l) {
      const int64_t at = table + (int64_t)l * width + node;
      const int f = static_cast<int>(__ldg(feat + at));
      const int b = static_cast<int>(__ldg(bins + at));
      const int xb = static_cast<int>(x[f]);
      node = 2 * node + (xb > b ? 1 : 0);
    }
    acc += __ldg(leaf + tree * n_leaves + node);
  }
  out[r * n_classes + k] = acc;
}

template <typename BinT, typename FeatT = int32_t, typename SplitT = int32_t>
int launch_classes(const void* Xb, const void* feat, const void* bins,
                   const void* leaf, void* out, int64_t n, int d,
                   int n_rounds, int n_classes, int depth, int width,
                   int n_leaves, void* stream) {
  const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)n_classes);
  tree_walk_classes_kernel<BinT, FeatT, SplitT>
      <<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const FeatT*>(feat),
      static_cast<const SplitT*>(bins), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_rounds, n_classes, depth, width,
      n_leaves);
  return (int)cudaGetLastError();
}

// the instance for element sizes (Xb 1 or 4 bytes, feat 2 or 4, bins 1 or 4)
template <template <typename, typename, typename> class Fn, typename... A>
int dispatch(int xb_bytes, int feat_bytes, int bin_bytes, A... args) {
#define TW_CASE(XB, FT, ST)                                                \
  if (xb_bytes == sizeof(XB) && feat_bytes == sizeof(FT) &&              \
      bin_bytes == sizeof(ST))                                             \
    return Fn<XB, FT, ST>::run(args...);
  TW_CASE(int8_t, int32_t, int32_t)
  TW_CASE(int8_t, int16_t, int32_t)
  TW_CASE(int8_t, int32_t, uint8_t)
  TW_CASE(int8_t, int16_t, uint8_t)
  TW_CASE(int32_t, int32_t, int32_t)
  TW_CASE(int32_t, int16_t, int32_t)
  TW_CASE(int32_t, int32_t, uint8_t)
  TW_CASE(int32_t, int16_t, uint8_t)
#undef TW_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename XB, typename FT, typename ST>
struct Walk {
  static int run(const void* Xb, const void* feat, const void* bins,
                 const void* leaf, void* out, int64_t n, int d, int n_trees,
                 int depth, int width, int n_leaves, int m, int c0, int mc,
                 void* stream) {
    return launch<XB, FT, ST>(Xb, feat, bins, leaf, out, n, d, n_trees,
                              depth, width, n_leaves, m, c0, mc, stream);
  }
};

template <typename XB, typename FT, typename ST>
struct WalkClasses {
  static int run(const void* Xb, const void* feat, const void* bins,
                 const void* leaf, void* out, int64_t n, int d, int n_rounds,
                 int n_classes, int depth, int width, int n_leaves,
                 void* stream) {
    return launch_classes<XB, FT, ST>(Xb, feat, bins, leaf, out, n, d,
                                      n_rounds, n_classes, depth, width,
                                      n_leaves, stream);
  }
};

}  // namespace

extern "C" int tree_walk_typed(const void* Xb, const void* feat,
                               const void* bins, const void* leaf, void* out,
                               int64_t n, int d, int n_trees, int depth,
                               int width, int n_leaves, int m, int c0, int mc,
                               int xb_bytes, int feat_bytes, int bin_bytes,
                               void* stream) {
  return dispatch<Walk>(xb_bytes, feat_bytes, bin_bytes, Xb, feat, bins,
                        leaf, out, n, d, n_trees, depth, width, n_leaves, m,
                        c0, mc, stream);
}

extern "C" int tree_walk_classes_typed(const void* Xb, const void* feat,
                                       const void* bins, const void* leaf,
                                       void* out, int64_t n, int d,
                                       int n_rounds, int n_classes, int depth,
                                       int width, int n_leaves, int xb_bytes,
                                       int feat_bytes, int bin_bytes,
                                       void* stream) {
  return dispatch<WalkClasses>(xb_bytes, feat_bytes, bin_bytes, Xb, feat,
                               bins, leaf, out, n, d, n_rounds, n_classes,
                               depth, width, n_leaves, stream);
}

extern "C" int tree_walk_max_m() { return MAX_M; }
