// K2: the best split of every node of P trees, from K1's histograms of m
// value channels and one weight channel.
//
// Replaces `split_from_histograms` in transmogrifai_tpu/models/trees.py:170.
// For each (pair p, node k), over every feature f and split bin b:
//   left sums  cg_c = sum_{b' <= b} hist_G[c], ch likewise (running sums)
//   totals     tg_c, th = the running sums at the last bin
//   score      S(g, h) = (g_0^2 + g_1^2 + ... + g_{m-1}^2) / (h + lambda),
//              the class terms added in channel order
//   gain       (S(cg, ch) + S(tg - cg, th - ch)) - S(tg, th)
//   valid      ch >= min_child_weight and th - ch >= min_child_weight and
//              the feature is in the pair's mask; invalid cells are -inf
// then the argmax over the flat (f * bins + b) axis with the FIRST index
// winning ties (jnp.argmax), and the threshold: the node splits only if
// the best gain > max(min_gain, min_gain_norm * th of feature 0) and
// level < active_depth; otherwise its bin is n_bins ("no split": every row
// goes left). Boosting has m = 1 (XGBoost's G^2 / (H + lambda)); a forest
// has one channel per class, which makes the score the Gini gain.
//
// Rounding: every operation is a separate IEEE f32 add, multiply or
// divide, in the order written above and in the plain PyTorch version
// (the running sums are sequential over bins in both). The file is built
// with --fmad=false so no multiply-add is contracted, so the kernel and
// the plain version compute the same bits from the same histograms, and a
// near-tie resolves the same way in both.
//
// Design: one block per (pair, node); each thread scans whole features (a
// feature's bins are contiguous), keeps its best (gain, index) with the
// first-index rule, and a shared-memory tree reduction orders candidates
// by (gain, -index). The channel count is a template parameter (1 to 4),
// so the per-channel sums live in registers. Bound on this card: bytes,
// each histogram cell is read once.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_M = 4;

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

template <int M>
__global__ void split_search_kernel(
    const float* __restrict__ hg, const float* __restrict__ hh,
    const float* __restrict__ lam, const float* __restrict__ mcw,
    const float* __restrict__ min_gain, const float* __restrict__ min_gain_norm,
    const uint8_t* __restrict__ fmask, const int32_t* __restrict__ active_depth,
    int level, int n_nodes, int d, int n_bins, int32_t* __restrict__ out_feat,
    int32_t* __restrict__ out_bin) {
  __shared__ float s_gain[THREADS];
  __shared__ int s_idx[THREADS];
  const int node = blockIdx.x;
  const int p = blockIdx.y;
  const float L = lam[p];
  const float Wmin = mcw[p];
  const int64_t cells = (int64_t)d * n_bins;
  const float* g[M];
  for (int c = 0; c < M; ++c)
    g[c] = hg + (((int64_t)p * M + c) * n_nodes + node) * cells;
  const float* h = hh + ((int64_t)p * n_nodes + node) * cells;

  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int f = threadIdx.x; f < d; f += THREADS) {
    const int64_t fo = (int64_t)f * n_bins;
    const float* hf = h + fo;
    float tg[M];
    float th = 0.f;
    for (int c = 0; c < M; ++c) tg[c] = 0.f;
    for (int b = 0; b < n_bins; ++b) {
      for (int c = 0; c < M; ++c) tg[c] = tg[c] + g[c][fo + b];
      th = th + hf[b];
    }
    const bool fok = fmask == nullptr || fmask[(int64_t)p * d + f] != 0;
    float np_ = tg[0] * tg[0];
    for (int c = 1; c < M; ++c) np_ = np_ + tg[c] * tg[c];
    const float sp = np_ / (th + L);
    float cg[M];
    float ch = 0.f;
    for (int c = 0; c < M; ++c) cg[c] = 0.f;
    for (int b = 0; b < n_bins; ++b) {
      for (int c = 0; c < M; ++c) cg[c] = cg[c] + g[c][fo + b];
      ch = ch + hf[b];
      const float rh = th - ch;
      float gain = -CUDART_INF_F;
      if (fok && ch >= Wmin && rh >= Wmin) {
        float nl = cg[0] * cg[0];
        const float r0 = tg[0] - cg[0];
        float nr = r0 * r0;
        for (int c = 1; c < M; ++c) {
          nl = nl + cg[c] * cg[c];
          const float rc = tg[c] - cg[c];
          nr = nr + rc * rc;
        }
        const float sl = nl / (ch + L);
        const float sr = nr / (rh + L);
        gain = (sl + sr) - sp;
      }
      const int idx = f * n_bins + b;
      if (better(gain, idx, best, best_i)) {
        best = gain;
        best_i = idx;
      }
    }
  }
  s_gain[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_i;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const float og = s_gain[threadIdx.x + s];
      const int oi = s_idx[threadIdx.x + s];
      if (better(og, oi, s_gain[threadIdx.x], s_idx[threadIdx.x])) {
        s_gain[threadIdx.x] = og;
        s_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float th0 = 0.f;  // the node's total weight as feature 0 sums it
    for (int b = 0; b < n_bins; ++b) th0 = th0 + h[b];
    const float thr = fmaxf(min_gain[p], min_gain_norm[p] * th0);
    bool split = s_gain[0] > thr;
    if (active_depth != nullptr) split = split && level < active_depth[p];
    const int bi = s_idx[0] == 0x7fffffff ? 0 : s_idx[0];
    out_feat[(int64_t)p * n_nodes + node] = bi / n_bins;
    out_bin[(int64_t)p * n_nodes + node] = split ? bi % n_bins : n_bins;
  }
}

template <int M>
int launch(const void* hg, const void* hh, const void* lam, const void* mcw,
           const void* min_gain, const void* min_gain_norm, const void* fmask,
           const void* active_depth, int P, int level, int n_nodes, int d,
           int n_bins, void* out_feat, void* out_bin, void* stream) {
  dim3 grid(n_nodes, P);
  split_search_kernel<M><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(hg), static_cast<const float*>(hh),
      static_cast<const float*>(lam), static_cast<const float*>(mcw),
      static_cast<const float*>(min_gain),
      static_cast<const float*>(min_gain_norm),
      static_cast<const uint8_t*>(fmask),
      static_cast<const int32_t*>(active_depth), level, n_nodes, d, n_bins,
      static_cast<int32_t*>(out_feat), static_cast<int32_t*>(out_bin));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_search_max_m() { return MAX_M; }

extern "C" int split_search(const void* hg, const void* hh, const void* lam,
                            const void* mcw, const void* min_gain,
                            const void* min_gain_norm, const void* fmask,
                            const void* active_depth, int P, int level,
                            int n_nodes, int d, int n_bins, int m,
                            void* out_feat, void* out_bin, void* stream) {
#define SPLIT_SEARCH_CASE(M_)                                               \
  case M_:                                                                  \
    return launch<M_>(hg, hh, lam, mcw, min_gain, min_gain_norm, fmask,     \
                      active_depth, P, level, n_nodes, d, n_bins, out_feat, \
                      out_bin, stream);
  switch (m) {
    SPLIT_SEARCH_CASE(1)
    SPLIT_SEARCH_CASE(2)
    SPLIT_SEARCH_CASE(3)
    SPLIT_SEARCH_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPLIT_SEARCH_CASE
}
