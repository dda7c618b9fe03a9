// K8 (binned AuPR): the sort-free area under the precision-recall curve of
// P score vectors at once, over n_bins score buckets.
//
// Replaces the "aupr" branch of `_gbt_val_loss` in
// transmogrifai_tpu/models/trees.py:564-580 (margins in, 512 buckets, the
// per-round early-stopping metric) and `aupr_binned_dev` in
// transmogrifai_tpu/evaluators/device_metrics.py:72 (scores in, 4096
// buckets). On the TPU the two weight histograms are one-hot matmuls; here
// they are shared-memory adds.
//
//   s    = sigmoid(m) = 1 / (1 + exp(-m))   (from_margin; computed in f64
//          and rounded to f32 once, as the plain version's
//          `bucket_sigmoid`, so that a score near a bucket edge takes the
//          same bucket on every path) or m (scores), clipped to [0, 1]
//          (NaN -> 0)
//   b    = min(int(s * n_bins), n_bins - 1)
//   hp[b] += w * y,  ha[b] += w              (w: the pair's row weights)
//   reversed running sums tp, n_at from the top bucket down; with
//   n_pos = tp at the bottom: precision = tp / n_at (1 where n_at == 0),
//   recall = tp / n_pos, and the trapezoid area from (r = 0, p = 1);
//   0 when n_pos == 0.
//
// The histograms are f32 shared-memory atomics: exact, and so the same on
// every run, for integer-valued weights below 2^24 (the 0/1 fold and
// holdout masks of the training path). The curve is summed by one thread
// in f64 from the top bucket down and rounded to f32 once.
//
// Design: one block per pair. Bound on this card: bytes (each margin,
// label and weight read once).
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

__global__ void binned_aupr_kernel(const float* __restrict__ m,
                                   const float* __restrict__ y,
                                   const float* __restrict__ w, int n,
                                   int n_bins, int from_margin,
                                   float* __restrict__ out) {
  extern __shared__ float sm[];  // hp[n_bins], ha[n_bins]
  float* hp = sm;
  float* ha = sm + n_bins;
  const int p = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * n_bins; i += THREADS) sm[i] = 0.f;
  __syncthreads();
  const float* mp = m + (int64_t)p * n;
  const float* wp = w + (int64_t)p * n;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const float wr = wp[r];
    if (wr == 0.f) continue;
    float s = from_margin ? (float)(1.0 / (1.0 + exp(-(double)mp[r])))
                          : mp[r];
    s = fminf(fmaxf(s, 0.f), 1.f);  // also NaN -> 0
    const int b = min((int)(s * (float)n_bins), n_bins - 1);
    atomicAdd(&hp[b], wr * y[r]);
    atomicAdd(&ha[b], wr);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double n_pos = 0.0;
    for (int b = 0; b < n_bins; ++b) n_pos += (double)hp[b];
    double tp = 0.0, n_at = 0.0, r_prev = 0.0, p_prev = 1.0, area = 0.0;
    for (int b = n_bins - 1; b >= 0; --b) {
      tp += (double)hp[b];
      n_at += (double)ha[b];
      const double prec = n_at > 0.0 ? tp / n_at : 1.0;
      const double rec = n_pos > 0.0 ? tp / n_pos : 0.0;
      area += (rec - r_prev) * (prec + p_prev) * 0.5;
      r_prev = rec;
      p_prev = prec;
    }
    out[p] = n_pos > 0.0 ? (float)area : 0.f;
  }
}

}  // namespace

extern "C" int binned_aupr(const void* m, const void* y, const void* w, int P,
                           int n, int n_bins, int from_margin, void* out,
                           void* stream) {
  size_t smem = (size_t)2 * n_bins * sizeof(float);
  binned_aupr_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(m), static_cast<const float*>(y),
      static_cast<const float*>(w), n, n_bins, from_margin,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
