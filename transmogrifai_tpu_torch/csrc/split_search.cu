// K2: the best split of every node of P trees, from K1's histograms.
//
// Replaces `split_from_histograms` in transmogrifai_tpu/models/trees.py:170.
// For each (pair p, node k), over every feature f and split bin b:
//   left sums  cg = sum_{b' <= b} hist_G,  ch likewise (a running sum)
//   totals     tg, th = the running sums at the last bin
//   gain       (cg^2/(ch+lambda) + (tg-cg)^2/((th-ch)+lambda))
//              - tg^2/(th+lambda)
//   valid      ch >= min_child_weight and th - ch >= min_child_weight and
//              the feature is in the pair's mask; invalid cells are -inf
// then the argmax over the flat (f * bins + b) axis with the FIRST index
// winning ties (jnp.argmax), and the threshold: the node splits only if
// the best gain > max(min_gain, min_gain_norm * th of feature 0) and
// level < active_depth; otherwise its bin is n_bins ("no split": every row
// goes left).
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
// by (gain, -index). Bound on this card: bytes, each histogram cell is read
// once.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

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
  const float M = mcw[p];
  const int64_t base = ((int64_t)p * n_nodes + node) * d * n_bins;
  const float* g = hg + base;
  const float* h = hh + base;

  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  for (int f = threadIdx.x; f < d; f += THREADS) {
    const float* gf = g + (int64_t)f * n_bins;
    const float* hf = h + (int64_t)f * n_bins;
    float tg = 0.f, th = 0.f;
    for (int b = 0; b < n_bins; ++b) {
      tg = tg + gf[b];
      th = th + hf[b];
    }
    const bool fok = fmask == nullptr || fmask[(int64_t)p * d + f] != 0;
    const float sp = (tg * tg) / (th + L);
    float cg = 0.f, ch = 0.f;
    for (int b = 0; b < n_bins; ++b) {
      cg = cg + gf[b];
      ch = ch + hf[b];
      const float rg = tg - cg;
      const float rh = th - ch;
      float gain = -CUDART_INF_F;
      if (fok && ch >= M && rh >= M) {
        const float sl = (cg * cg) / (ch + L);
        const float sr = (rg * rg) / (rh + L);
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

}  // namespace

extern "C" int split_search(const void* hg, const void* hh, const void* lam,
                            const void* mcw, const void* min_gain,
                            const void* min_gain_norm, const void* fmask,
                            const void* active_depth, int P, int level,
                            int n_nodes, int d, int n_bins, void* out_feat,
                            void* out_bin, void* stream) {
  dim3 grid(n_nodes, P);
  split_search_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(hg), static_cast<const float*>(hh),
      static_cast<const float*>(lam), static_cast<const float*>(mcw),
      static_cast<const float*>(min_gain),
      static_cast<const float*>(min_gain_norm),
      static_cast<const uint8_t*>(fmask),
      static_cast<const int32_t*>(active_depth), level, n_nodes, d, n_bins,
      static_cast<int32_t*>(out_feat), static_cast<int32_t*>(out_bin));
  return (int)cudaGetLastError();
}
