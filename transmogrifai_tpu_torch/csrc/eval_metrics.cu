// K8-mc and K8-reg: the masked evaluation sums of the model sweep, for P
// (config, fold) pairs at once, one block per pair.
//
// `confusion_counts` replaces the scatter `.at[yi, pi].add(mask)` of
// `multiclass_dev` in transmogrifai_tpu/evaluators/device_metrics.py:139-145:
//
//   conf[p, clip(y[r]), clip(pred[p, r])] += mask[p, r]   (clip to [0, k-1])
//
// On the TPU the scatter is serialized by XLA; a float atomicAdd per row
// would sum fractional weights in a different order on every run. Here
// the block stages a tile of rows' cell ids and weights in shared memory;
// thread (s, c) owns cell c of slice s of every tile and adds the weights
// of the slice's rows that fall in cell c, in row order, into an f64
// register. The slices' sums are then added in slice order and rounded to
// f32 once. No atomics, so every run gives the same bits; 0/1 masks give
// exact counts.
//
// `regression_moments` replaces the reductions of `regression_dev`
// (device_metrics.py:159-170). With e = (pred - y) * w and t = y - ybar in
// f32, as the JAX formula rounds them:
//
//   out[p] = [ sum w, sum e*e, sum |e|, sum y*w, sum t*t*w ]
//   ybar   = f32(sum y*w) / max(f32(sum w), 1)
//
// Pass 1 sums the first four over the pair's rows, each thread over a
// fixed stride of rows in f64, then a fixed-order tree over the block;
// ybar follows from the rounded sums; pass 2 runs over the rows again for
// the last. Every sum is rounded to f32 once. The elementwise products
// use the round-to-nearest intrinsics, so nothing is contracted into a
// fused multiply-add.
//
// Both are bound by bytes on this card (each label, prediction and weight
// read once; regression_moments reads y and w twice).
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int TILE = 1024;  // rows staged per step of confusion_counts
constexpr int MAX_K = 32;   // k * k cells <= THREADS

__global__ void confusion_kernel(const int* __restrict__ y,
                                 const int* __restrict__ pred,
                                 const float* __restrict__ mask, int n, int k,
                                 float* __restrict__ out) {
  __shared__ int cell_s[TILE];
  __shared__ float w_s[TILE];
  __shared__ double red[THREADS];
  const int p = blockIdx.x;
  const int cells = k * k;
  const int slices = THREADS / cells;  // >= 1
  const int c = threadIdx.x % cells;
  const int s = threadIdx.x / cells;
  const int per = (TILE + slices - 1) / slices;
  const int* pp = pred + (int64_t)p * n;
  const float* mp = mask + (int64_t)p * n;
  double acc = 0.0;
  for (int base = 0; base < n; base += TILE) {
    const int rows = min(TILE, n - base);
    for (int i = threadIdx.x; i < rows; i += THREADS) {
      const int yi = min(max(y[base + i], 0), k - 1);
      const int pi = min(max(pp[base + i], 0), k - 1);
      cell_s[i] = yi * k + pi;
      w_s[i] = mp[base + i];
    }
    __syncthreads();
    if (s < slices) {
      const int lo = s * per;
      const int hi = min(lo + per, rows);
      for (int i = lo; i < hi; ++i)
        if (cell_s[i] == c) acc += (double)w_s[i];
    }
    __syncthreads();
  }
  red[threadIdx.x] = (s < slices) ? acc : 0.0;
  __syncthreads();
  if (threadIdx.x < cells) {
    double total = 0.0;
    for (int j = 0; j < slices; ++j) total += red[j * cells + threadIdx.x];
    out[(int64_t)p * cells + threadIdx.x] = (float)total;
  }
}

// fixed-order tree over the block: red[0] ends as the block's sum
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

__global__ void moments_kernel(const float* __restrict__ pred,
                               const float* __restrict__ y,
                               const float* __restrict__ mask, int n,
                               float* __restrict__ out) {
  __shared__ double red[THREADS];
  const int p = blockIdx.x;
  const float* pp = pred + (int64_t)p * n;
  const float* mp = mask + (int64_t)p * n;
  double sw = 0.0, see = 0.0, sae = 0.0, syw = 0.0;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const float w = mp[r];
    const float e = __fmul_rn(__fsub_rn(pp[r], y[r]), w);
    sw += (double)w;
    see += (double)__fmul_rn(e, e);
    sae += (double)fabsf(e);
    syw += (double)__fmul_rn(y[r], w);
  }
  const float m0 = (float)block_sum(sw, red);
  const float m1 = (float)block_sum(see, red);
  const float m2 = (float)block_sum(sae, red);
  const float m3 = (float)block_sum(syw, red);
  const float ybar = __fdiv_rn(m3, fmaxf(m0, 1.f));
  double stt = 0.0;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const float t = __fsub_rn(y[r], ybar);
    stt += (double)__fmul_rn(__fmul_rn(t, t), mp[r]);
  }
  const float m4 = (float)block_sum(stt, red);
  if (threadIdx.x == 0) {
    float* o = out + (int64_t)p * 5;
    o[0] = m0;
    o[1] = m1;
    o[2] = m2;
    o[3] = m3;
    o[4] = m4;
  }
}

}  // namespace

extern "C" int eval_metrics_max_k() { return MAX_K; }

extern "C" int confusion_counts(const void* y, const void* pred,
                                const void* mask, int P, int n, int k,
                                void* out, void* stream) {
  confusion_kernel<<<P, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(y), static_cast<const int*>(pred),
      static_cast<const float*>(mask), n, k, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int regression_moments(const void* pred, const void* y,
                                  const void* mask, int P, int n, void* out,
                                  void* stream) {
  moments_kernel<<<P, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(pred), static_cast<const float*>(y),
      static_cast<const float*>(mask), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
