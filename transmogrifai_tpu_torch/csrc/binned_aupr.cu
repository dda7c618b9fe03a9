// K8 (binned AuPR): the sort-free area under the precision-recall curve of
// P score vectors at once, over n_bins score buckets.
//
// Replaces the "aupr" branch of `_gbt_val_loss` in
// transmogrifai_tpu/models/trees.py:564-580 (margins in, 512 buckets, the
// per-round early-stopping metric) and `aupr_binned_dev` in
// transmogrifai_tpu/evaluators/device_metrics.py:72 (scores in, 4096
// buckets by default, any count). On the TPU the two weight histograms are
// one-hot matmuls; here they are shared-memory adds.
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
// Bound on this card: bytes (each margin, label and weight read once).
//
// Design: each pair's rows split into G ranges of `chunk` rows, one block
// of THREADS a range (grid P x G; the wrapper picks G from n and P so that
// P x G fills the card, and G = 1 for small inputs).
// - A block keeps private f32 histograms of w and w * y in shared memory
//   (in its own slice of the global scratch above SHARED_MAX_BINS
//   buckets). Each thread has UNROLL rows' loads in flight and adds each
//   row with a weight once. (Grouping the lanes of a warp that share a
//   bucket with `__match_any_sync` did not pay on the training path's
//   margins; clustered scores still contend for one address.)
// - G = 1: the block walks the curve itself. G > 1: each block writes its
//   histogram to scratch; a second kernel sums each bucket's G partials in
//   block order (the same bits on every run) and a third walks each pair's
//   curve. The three launch from one C call.
// - The curve: a block scan in f64 over chunks of THREADS buckets from the
//   top bucket down, each thread's trapezoid terms summed by the block and
//   rounded to f32 once. Its full-mask warp shuffles run where every
//   thread of the block does (no lane has left or branched off).
//
// The histograms are f32 atomics inside a block (each bucket's adds in no
// fixed order) and f32 sums of the partials in block order: exact, and so
// the same on every run, for integer-valued weights whose bucket sums stay
// below 2^24 (the 0/1 fold and holdout masks of the training path).
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue when the global scratch the
// launch needs is missing).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct CurveScratch {
  double a[WARPS], b[WARPS];    // warp totals of a scan or a sum
  double rec[WARPS], prec[WARPS];  // each warp's last recall, precision
};

// two f32 histograms and the curve's scratch within 48 KB of shared memory
// (6016; `binned_aupr_shared_max_bins` tells the wrapper)
constexpr int SHARED_MAX_BINS =
    (48 * 1024 - (int)sizeof(CurveScratch)) / (2 * (int)sizeof(float));

__device__ __forceinline__ int bucket_of(float v, int from_margin,
                                         int n_bins) {
  float s = from_margin ? (float)(1.0 / (1.0 + exp(-(double)v))) : v;
  s = fminf(fmaxf(s, 0.f), 1.f);  // also NaN -> 0
  return min((int)(s * (float)n_bins), n_bins - 1);
}

// ha[b] += a, hp[b] += p: f32 atomic adds (compare-and-swap loops on this
// card, spinning in hardware); adding 0 changes no sum
__device__ __forceinline__ void add2(float* ha, float* hp, int b, float a,
                                     float p) {
  atomicAdd(ha + b, a);
  if (p != 0.f) atomicAdd(hp + b, p);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}

// the sum of v over the block, the same value in every thread
__device__ double block_sum(double v, CurveScratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) s.a[warp] = v;
  __syncthreads();
  return warp_sum(s.a[lane]);
}

// inclusive scan of (x, y) over the block in thread order; (tx, ty): the
// block's totals
__device__ void block_scan2(double& x, double& y, double& tx, double& ty,
                            CurveScratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const double ux = __shfl_up_sync(FULL, x, o);
    const double uy = __shfl_up_sync(FULL, y, o);
    if (lane >= o) {
      x += ux;
      y += uy;
    }
  }
  __syncthreads();
  if (lane == 31) {
    s.a[warp] = x;
    s.b[warp] = y;
  }
  __syncthreads();
  double px = 0.0, py = 0.0;
  tx = 0.0;
  ty = 0.0;
  for (int k = 0; k < WARPS; ++k) {
    if (k < warp) {
      px += s.a[k];
      py += s.b[k];
    }
    tx += s.a[k];
    ty += s.b[k];
  }
  x += px;
  y += py;
}

// The AuPR of one pair from its bucket sums ha (w) and hp (w * y), shared
// or global; every thread of a THREADS block calls it, thread 0 writes
// *out.
__device__ void pr_curve(const float* ha, const float* hp, int n_bins,
                         float* out, CurveScratch& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double own = 0.0;
  for (int b = t; b < n_bins; b += THREADS) own += (double)hp[b];
  const double n_pos = block_sum(own, s);
  double carry_tp = 0.0, carry_at = 0.0, r_prev = 0.0, p_prev = 1.0;
  double area = 0.0;
  for (int c0 = 0; c0 < n_bins; c0 += THREADS) {
    const int i = c0 + t;  // i-th bucket from the top
    const bool on = i < n_bins;
    double tp = on ? (double)hp[n_bins - 1 - i] : 0.0;
    double n_at = on ? (double)ha[n_bins - 1 - i] : 0.0;
    double tot_tp, tot_at;
    block_scan2(tp, n_at, tot_tp, tot_at, s);
    tp += carry_tp;
    n_at += carry_at;
    const double prec = n_at > 0.0 ? tp / n_at : 1.0;
    const double rec = n_pos > 0.0 ? tp / n_pos : 0.0;
    double rp = __shfl_up_sync(FULL, rec, 1);
    double pp = __shfl_up_sync(FULL, prec, 1);
    if (lane == 31) {
      s.rec[warp] = rec;
      s.prec[warp] = prec;
    }
    __syncthreads();
    if (lane == 0) {
      rp = warp ? s.rec[warp - 1] : r_prev;
      pp = warp ? s.prec[warp - 1] : p_prev;
    }
    if (on) area += (rec - rp) * (prec + pp) * 0.5;
    r_prev = s.rec[WARPS - 1];
    p_prev = s.prec[WARPS - 1];
    carry_tp += tot_tp;
    carry_at += tot_at;
    __syncthreads();
  }
  const double total = block_sum(area, s);
  if (t == 0) *out = n_pos > 0.0 ? (float)total : 0.f;
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
aupr_hist_kernel(const float* __restrict__ m, const float* __restrict__ y,
                 const float* __restrict__ w, int n, int n_bins,
                 int from_margin, int G, int chunk, float* __restrict__ part,
                 float* __restrict__ out) {
  extern __shared__ float s_hist[];  // SHARED: ha[n_bins], hp[n_bins]
  __shared__ CurveScratch cs;
  const int p = blockIdx.x, g = blockIdx.y;
  float* slice = part + ((int64_t)p * G + g) * 2 * n_bins;
  float* hist = SHARED ? s_hist : slice;
  for (int i = threadIdx.x; i < 2 * n_bins; i += THREADS) hist[i] = 0.f;
  __syncthreads();
  const int64_t r0 = (int64_t)g * chunk;
  const int64_t r1 = r0 + chunk < n ? r0 + chunk : (int64_t)n;
  const float* mp = m + (int64_t)p * n;
  const float* wp = w + (int64_t)p * n;
  for (int64_t base = r0; base < r1; base += (int64_t)THREADS * UNROLL) {
    float wv[UNROLL], mv[UNROLL], yv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t r = base + u * THREADS + threadIdx.x;
      const bool in = r < r1;
      wv[u] = in ? wp[r] : 0.f;
      mv[u] = in ? mp[r] : 0.f;
      yv[u] = in ? y[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (wv[u] != 0.f) {
        add2(hist, hist + n_bins, bucket_of(mv[u], from_margin, n_bins),
             wv[u], wv[u] * yv[u]);
      }
    }
  }
  __syncthreads();
  if (G == 1) {
    pr_curve(hist, hist + n_bins, n_bins, out + p, cs);
  } else if (SHARED) {
    for (int i = threadIdx.x; i < 2 * n_bins; i += THREADS) {
      slice[i] = s_hist[i];
    }
  }
}

// each pair's G partial histograms summed per bucket in block order, into
// the pair's first slice
__global__ void __launch_bounds__(REDUCE_THREADS)
aupr_reduce_kernel(float* __restrict__ part, int n_bins, int G) {
  const int p = blockIdx.x;
  const int64_t width = 2 * (int64_t)n_bins;
  float* pp = part + (int64_t)p * G * width;
  for (int64_t i = (int64_t)blockIdx.y * REDUCE_THREADS + threadIdx.x;
       i < width; i += (int64_t)gridDim.y * REDUCE_THREADS) {
    float acc = pp[i];
    for (int g = 1; g < G; ++g) acc += pp[g * width + i];
    pp[i] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
aupr_curve_kernel(const float* __restrict__ part, int n_bins, int G,
                  float* __restrict__ out) {
  __shared__ CurveScratch cs;
  const int p = blockIdx.x;
  const float* hist = part + (int64_t)p * G * 2 * n_bins;
  pr_curve(hist, hist + n_bins, n_bins, out + p, cs);
}

}  // namespace

extern "C" int binned_aupr(const void* m, const void* y, const void* w, int P,
                           int n, int n_bins, int from_margin, int G,
                           int chunk, void* part, void* out, void* stream) {
  const bool shared = n_bins <= SHARED_MAX_BINS;
  if ((G > 1 || !shared) && part == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(P, G);
  const float* mf = static_cast<const float*>(m);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (shared) {
    aupr_hist_kernel<true><<<grid, THREADS, 2 * n_bins * sizeof(float), s>>>(
        mf, yf, wf, n, n_bins, from_margin, G, chunk, pf, of);
  } else {
    aupr_hist_kernel<false><<<grid, THREADS, 0, s>>>(
        mf, yf, wf, n, n_bins, from_margin, G, chunk, pf, of);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return (int)err;
  const int64_t blocks = (2 * (int64_t)n_bins + REDUCE_THREADS - 1) /
                         REDUCE_THREADS;
  aupr_reduce_kernel<<<dim3(P, (unsigned)(blocks < 65535 ? blocks : 65535)),
                       REDUCE_THREADS, 0, s>>>(pf, n_bins, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  aupr_curve_kernel<<<P, THREADS, 0, s>>>(pf, n_bins, G, of);
  return (int)cudaGetLastError();
}

// buckets up to which a block's histograms live in shared memory; above
// it the launch needs `part` whatever G is
extern "C" int binned_aupr_shared_max_bins() { return SHARED_MAX_BINS; }
