// K3: routing of rows down one level, and the leaf sums and leaf formula,
// for P trees at once.
//
// Replaces the routing and leaf steps of `grow_tree` in
// transmogrifai_tpu/models/trees.py:271-293 (`_table_lookup2` :307 and
// `_select_bin` :78). On the TPU every table read and the per-row feature
// pick are one-hot compare-and-sum passes over the node table and over all
// d features, and the leaf sums are a scatter-add. On Hopper they are
// direct gathers.
//
// route_level: one thread per (pair, row):
//   node[p, r] <- 2 * node[p, r] + (Xb[r, feat[p, node]] > bin[p, node])
// A bin of n_bins never fires, so a node that did not split sends every
// row left.
//
// leaf_values: one thread per (pair, leaf). The caller passes the rows
// grouped by final node in stable row order (`order`, `seg`, as for K1);
// the thread sums its leaf's H and each of its m value channels G_c in row
// order (no atomics: the same bits on every run, and the same f32 sequence
// as the JAX package's row-order scatter-add), then applies the XGBoost
// leaf formula per channel
//   g_c <- sign(g_c) * max(|g_c| - alpha, 0);   leaf_c = g_c / (h + lambda)
// (a forest's channels are its classes, with alpha = 0 and lambda = 1e-6).
//
// Bound on this card: bytes (routing reads one Xb cell and two table
// entries per row; the leaf pass reads G, H and the order once).
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename BinT>
__global__ void route_level_kernel(const BinT* __restrict__ Xb,
                                   const int32_t* __restrict__ feat,
                                   const int32_t* __restrict__ bins,
                                   int32_t* __restrict__ node, int P, int n,
                                   int d, int n_nodes) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)P * n) return;
  const int p = (int)(i / n);
  const int r = (int)(i - (int64_t)p * n);
  const int k = node[i];
  const int64_t t = (int64_t)p * n_nodes + k;
  const int f = __ldg(feat + t);
  const int b = __ldg(bins + t);
  const int x = (int)__ldg(Xb + (int64_t)r * d + f);
  node[i] = 2 * k + (x > b ? 1 : 0);
}

__global__ void leaf_values_kernel(const float* __restrict__ G,
                                   const float* __restrict__ H,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ seg,
                                   const float* __restrict__ lam,
                                   const float* __restrict__ alpha,
                                   float* __restrict__ leaf, int P, int n,
                                   int n_leaves, int m) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)P * n_leaves) return;
  const int p = (int)(i / n_leaves);
  const int k = (int)(i - (int64_t)p * n_leaves);
  const int64_t sbase = (int64_t)p * (n_leaves + 1);
  const int s0 = seg[sbase + k];
  const int s1 = seg[sbase + k + 1];
  const int32_t* ord = order + (int64_t)p * n;
  const float* Hp = H + (int64_t)p * n;
  float h = 0.f;
  for (int j = s0; j < s1; ++j) h = h + Hp[ord[j]];
  for (int c = 0; c < m; ++c) {
    const float* Gc = G + ((int64_t)p * m + c) * n;
    float g = 0.f;
    for (int j = s0; j < s1; ++j) g = g + Gc[ord[j]];
    const float sgn = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
    g = sgn * fmaxf(fabsf(g) - alpha[p], 0.f);
    leaf[i * m + c] = g / (h + lam[p]);
  }
}

template <typename BinT>
int launch_route(const void* Xb, const void* feat, const void* bins,
                 void* node, int P, int n, int d, int n_nodes, void* stream) {
  const int64_t total = (int64_t)P * n;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  route_level_kernel<BinT><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const int32_t*>(feat),
      static_cast<const int32_t*>(bins), static_cast<int32_t*>(node), P, n,
      d, n_nodes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int route_level_i8(const void* Xb, const void* feat,
                              const void* bins, void* node, int P, int n,
                              int d, int n_nodes, void* stream) {
  return launch_route<int8_t>(Xb, feat, bins, node, P, n, d, n_nodes, stream);
}

extern "C" int route_level_i32(const void* Xb, const void* feat,
                               const void* bins, void* node, int P, int n,
                               int d, int n_nodes, void* stream) {
  return launch_route<int32_t>(Xb, feat, bins, node, P, n, d, n_nodes,
                               stream);
}

extern "C" int leaf_values(const void* G, const void* H, const void* order,
                           const void* seg, const void* lam, const void* alpha,
                           void* leaf, int P, int n, int n_leaves, int m,
                           void* stream) {
  const int64_t total = (int64_t)P * n_leaves;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  leaf_values_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(G), static_cast<const float*>(H),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(seg),
      static_cast<const float*>(lam), static_cast<const float*>(alpha),
      static_cast<float*>(leaf), P, n, n_leaves, m);
  return (int)cudaGetLastError();
}
