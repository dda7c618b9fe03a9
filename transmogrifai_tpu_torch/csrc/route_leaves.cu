// K3: routing of rows down one level, and the leaf sums and leaf formula,
// for P trees at once.
//
// Replaces the routing and leaf steps of `grow_tree` in
// transmogrifai_tpu/models/trees.py:271-293 (`_table_lookup2` :307 and
// `_select_bin` :78; the chunked leaf sums of
// transmogrifai_tpu/parallel/bigdata.py:1061). On the TPU every table read
// and the per-row feature pick are one-hot compare-and-sum passes over the
// node table and over all d features, and the leaf sums are a scatter-add.
// On Hopper they are direct gathers.
//
// route_level: one thread per (pair, row):
//   node[p, r] <- 2 * node[p, r] + (Xb[r, feat[p, node]] > bin[p, node])
// A bin of n_bins never fires, so a node that did not split sends every
// row left.
//
// The leaf pass: per (pair, leaf) the sum of H and of each of the m value
// channels G_c over the leaf's rows, then the XGBoost leaf formula per
// channel
//   g_c <- sign(g_c) * max(|g_c| - alpha, 0);   leaf_c = g_c / (h + lambda)
// (a forest's channels are its classes, with alpha = 0 and lambda = 1e-6).
// Every sum is one chain of f32 adds that starts at 0 and takes the leaf's
// rows in ascending row order: the same bits on every run, and the same
// f32 sequence as the row-order scatter-add (`index_add_` on the CPU), in
// both of the two designs below. No atomics.
//
// Bound on this card: bytes (the leaf pass reads G, H and the node ids
// once); the old design, one thread per (pair, leaf) walking its segment
// m + 1 times through two dependent loads a row, ran at a few hundred
// times that at 16 x 64 leaves over 4.46M rows, and most of its time at
// 802 rows went to sorting the rows by leaf first.
//
// - leaf_scan (few rows a pair, no sort): a warp per (pair, 32 leaves),
//   lane l owning leaf 32 g + l. The warp reads the pair's node ids 32 at a
//   time (four groups of 32 in flight), asks with one ballot which of them
//   fall in its 32 leaves, loads those rows' values, and hands each such
//   row, in row order, to every lane with shuffles; the owning lane adds it.
//   The work is n / 32 ballots plus one step per row of the warp's leaves.
// - leaf_segments (many rows a pair): the caller groups the rows by leaf in
//   stable row order (`order`, `seg`, as for K1). A warp per (pair, leaf)
//   loads the next 128 `order` entries and all m + 1 channels' values of
//   those rows in coalesced steps (the segment is read once, not m + 1
//   times), stages them in shared memory, and lanes 0..m each run one
//   channel's chain over them; the next 128 rows' loads are issued before
//   the chains run, so memory latency overlaps the dependent adds.
//
// lambda and alpha come per pair (pointers) or as one value each (a null
// pointer and the value), so a scalar hyperparameter needs no tensor.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_M = 4;
constexpr int SCAN_AHEAD = 4;   // groups of 32 node ids a scan warp loads
constexpr int SEG_STEP = 128;   // rows a segment warp stages at once

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

struct LeafParams {
  const float* lam;
  float lam_v;
  const float* alpha;
  float alpha_v;
};

// the leaf formula of channel sums g (per channel) and weight sum h
template <int M>
__device__ __forceinline__ void write_leaf(const float (&acc)[M + 1],
                                           const LeafParams& lp, int p,
                                           float* __restrict__ out) {
  const float lam = lp.lam ? lp.lam[p] : lp.lam_v;
  const float alpha = lp.alpha ? lp.alpha[p] : lp.alpha_v;
  const float h = acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    float g = acc[c];
    const float sgn = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
    g = sgn * fmaxf(fabsf(g) - alpha, 0.f);
    out[c] = g / (h + lam);
  }
}

// a warp per (pair, 32 leaves), no sort
template <int M>
__global__ void leaf_scan_kernel(const float* __restrict__ G,
                                 const float* __restrict__ H,
                                 const int32_t* __restrict__ node,
                                 LeafParams lp, float* __restrict__ leaf,
                                 int P, int n, int n_leaves) {
  const int64_t w = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int groups = (n_leaves + WARP - 1) / WARP;
  if (w >= (int64_t)P * groups) return;
  const int p = (int)(w / groups);
  const int l0 = (int)(w - (int64_t)p * groups) * WARP;
  const int mine = l0 + lane;
  const int32_t* nd = node + (int64_t)p * n;
  const float* Gp = G + (int64_t)p * M * n;
  const float* Hp = H + (int64_t)p * n;
  float acc[M + 1];
#pragma unroll
  for (int c = 0; c <= M; ++c) acc[c] = 0.f;
  for (int r0 = 0; r0 < n; r0 += SCAN_AHEAD * WARP) {
    int k[SCAN_AHEAD];
#pragma unroll
    for (int a = 0; a < SCAN_AHEAD; ++a) {
      const int r = r0 + a * WARP + lane;
      k[a] = r < n ? nd[r] : -1;
    }
#pragma unroll
    for (int a = 0; a < SCAN_AHEAD; ++a) {
      const int r = r0 + a * WARP + lane;
      const bool in = (unsigned)(k[a] - l0) < (unsigned)WARP;
      unsigned hit = __ballot_sync(FULL, in);
      if (!hit) continue;
      float v[M + 1];
#pragma unroll
      for (int c = 0; c < M; ++c) v[c] = in ? Gp[(int64_t)c * n + r] : 0.f;
      v[M] = in ? Hp[r] : 0.f;
      while (hit) {  // the hits in row order
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const int ks = __shfl_sync(FULL, k[a], src);
#pragma unroll
        for (int c = 0; c <= M; ++c) {
          const float vs = __shfl_sync(FULL, v[c], src);
          if (ks == mine) acc[c] += vs;
        }
      }
    }
  }
  if (mine < n_leaves)
    write_leaf<M>(acc, lp, p, leaf + ((int64_t)p * n_leaves + mine) * M);
}

// a warp per (pair, leaf) over the leaf's segment of `order`
template <int M>
__global__ void leaf_segments_kernel(const float* __restrict__ G,
                                     const float* __restrict__ H,
                                     const int32_t* __restrict__ order,
                                     const int32_t* __restrict__ seg,
                                     LeafParams lp, float* __restrict__ leaf,
                                     int P, int n, int n_leaves) {
  // one channel's staged values a row of the buffer; +1 spreads the
  // channels over banks, since lanes 0..M read one channel each
  __shared__ float buf[WARPS][M + 1][SEG_STEP + 1];
  const int wl = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t w = (int64_t)blockIdx.x * WARPS + wl;
  if (w >= (int64_t)P * n_leaves) return;
  const int p = (int)(w / n_leaves);
  const int k = (int)(w - (int64_t)p * n_leaves);
  const int64_t sb = (int64_t)p * (n_leaves + 1);
  const int s0 = seg[sb + k];
  const int s1 = seg[sb + k + 1];
  const int32_t* ord = order + (int64_t)p * n;
  const float* Gp = G + (int64_t)p * M * n;
  const float* Hp = H + (int64_t)p * n;
  constexpr int PER = SEG_STEP / WARP;
  float v[PER][M + 1];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = base + u * WARP + lane;
      const int r = i < s1 ? ord[i] : -1;
#pragma unroll
      for (int c = 0; c < M; ++c)
        v[u][c] = r >= 0 ? Gp[(int64_t)c * n + r] : 0.f;
      v[u][M] = r >= 0 ? Hp[r] : 0.f;
    }
  };
  float acc = 0.f;  // lane c <= M: channel c's chain
  const int ch = lane <= M ? lane : M;
  if (s0 < s1) load(s0);
  for (int base = s0; base < s1; base += SEG_STEP) {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PER; ++u)
#pragma unroll
      for (int c = 0; c <= M; ++c) buf[wl][c][u * WARP + lane] = v[u][c];
    __syncwarp();
    if (base + SEG_STEP < s1) load(base + SEG_STEP);  // in flight meanwhile
    const int cnt = min(SEG_STEP, s1 - base);
    if (lane <= M) {
      const float* b = buf[wl][ch];
      if (cnt == SEG_STEP) {
#pragma unroll 16
        for (int t = 0; t < SEG_STEP; ++t) acc += b[t];
      } else {
        for (int t = 0; t < cnt; ++t) acc += b[t];
      }
    }
  }
  float sums[M + 1];
#pragma unroll
  for (int c = 0; c <= M; ++c) sums[c] = __shfl_sync(FULL, acc, c);
  if (lane == 0)
    write_leaf<M>(sums, lp, p, leaf + ((int64_t)p * n_leaves + k) * M);
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

template <int M>
int launch_leaves(const float* G, const float* H, const int32_t* node,
                  const int32_t* order, const int32_t* seg, LeafParams lp,
                  float* leaf, int P, int n, int n_leaves,
                  cudaStream_t stream) {
  if (order == nullptr) {
    const int64_t warps =
        (int64_t)P * ((n_leaves + WARP - 1) / WARP);
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    leaf_scan_kernel<M><<<blocks, THREADS, 0, stream>>>(G, H, node, lp, leaf,
                                                        P, n, n_leaves);
  } else {
    const int64_t warps = (int64_t)P * n_leaves;
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    leaf_segments_kernel<M><<<blocks, THREADS, 0, stream>>>(
        G, H, order, seg, lp, leaf, P, n, n_leaves);
  }
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

extern "C" int leaf_values_max_m() { return MAX_M; }

// `order` null: the scan design over `node`; else the segment design over
// `order` and `seg`
extern "C" int leaf_values(const void* G, const void* H, const void* node,
                           const void* order, const void* seg,
                           const void* lam, float lam_v, const void* alpha,
                           float alpha_v, void* leaf, int P, int n,
                           int n_leaves, int m, void* stream) {
  const LeafParams lp{static_cast<const float*>(lam), lam_v,
                      static_cast<const float*>(alpha), alpha_v};
  const float* g = static_cast<const float*>(G);
  const float* h = static_cast<const float*>(H);
  const int32_t* nd = static_cast<const int32_t*>(node);
  const int32_t* ord = static_cast<const int32_t*>(order);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  float* out = static_cast<float*>(leaf);
  cudaStream_t st = (cudaStream_t)stream;
#define LEAF_CASE(M_)                                                    \
  case M_:                                                               \
    return launch_leaves<M_>(g, h, nd, ord, sg, lp, out, P, n, n_leaves, \
                             st);
  switch (m) {
    LEAF_CASE(1)
    LEAF_CASE(2)
    LEAF_CASE(3)
    LEAF_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LEAF_CASE
}
