// K8-mc and K8-reg: the masked evaluation sums of the model sweep, for P
// (config, fold) pairs at once, each pair's rows split over G blocks.
//
// `confusion_counts` replaces the scatter `.at[yi, pi].add(mask)` of
// `multiclass_dev` in transmogrifai_tpu/evaluators/device_metrics.py:139-145:
//
//   conf[p, clip(y[r]), clip(pred[p, r])] += mask[p, r]   (clip to [0, k-1])
//
// for any class count k >= 1, as the JAX package takes it. On the TPU XLA
// serializes the scatter; a float atomicAdd per row would sum fractional
// weights in another order on every run. Design:
// - Each pair's rows are cut into G ranges of `chunk` rows, one block a
//   range (grid G x P; the wrapper picks G from P, n and k so that P x G
//   fills the card, G = 1 for small inputs). A block has `warps` warps.
// - Each warp keeps a private f64 histogram of the k * k cells: in shared
//   memory while `warps` of them fit a block (k <= 170), else in the
//   block's own slice of a global scratch buffer (one warp a block then).
// - A row adds its weight once, to cell clip(y) * k + clip(pred) (rows of
//   weight 0 add nothing). The lanes of a warp step that share a cell are
//   found by `__match_any_sync`; the lowest of them sums the group's
//   weights in lane order and adds the sum to the warp's histogram, so no
//   two lanes write one cell at once and no atomics are needed. The work
//   is one shared (or L2) update a row, not the old n * k^2 compares.
// - The block sums its warps' histograms cell by cell in warp order. With
//   G = 1 it rounds them to f32 and writes the pair's cells; with G > 1 it
//   writes them to scratch in f64 and a second kernel (same C call) sums
//   each cell's G partials in block order and rounds once.
// So every sum has one order fixed by the design (rows in step order
// within a warp, lanes in lane order within a step, then warps, then
// blocks): the same bits on every run for any weights, and exact counts,
// equal to the plain version's, for 0/1 weights. Every output cell is
// written, so the wrapper allocates with torch.empty.
// Bound on this card: bytes, each label, prediction and weight read once
// and each cell written once; past k ~ 100 the zeroing and the partials of
// the cells (8 * k^2 bytes a block) join them. In practice a warp step's
// latency (the match, the group's shuffles, the histogram update) sets the
// time, so the plan gives every SM as many blocks as it holds.
//
// `regression_moments` replaces the reductions of `regression_dev`
// (device_metrics.py:159-170). With e = (pred - y) * w and t = y - ybar in
// f32, as the JAX formula rounds them:
//
//   out[p] = [ sum w, sum e*e, sum |e|, sum y*w, sum t*t*w ]
//   ybar   = f32(sum y*w) / max(f32(sum w), 1)
//
// ybar needs all of a pair's rows before the last sum. Two launches from
// one C call (G > 1): the first sums the first four over each block's rows
// and zeroes the pair's arrival counter; the second lets every block of
// the pair sum those partials (a warp a sum, lanes in a fixed order: the
// same bits in each block), take ybar, and sum t*t*w over its rows; the
// last block of the pair to arrive (an integer atomic on the counter) sums
// the G partials the same way and writes the five sums. Two plain launches rather than a cooperative one
// with a grid barrier: no co-residency requirement on the grid and nothing
// special for CUDA-graph capture; the second pass reads y and the weights
// again, from L2 at these sizes. G = 1 runs both passes in one block, one
// launch. A thread sums its rows in f64 in row order; a warp combines its
// lanes by a fixed xor butterfly (every lane ends with the same bits) and
// the block its warps in warp order, so every run gives the same bits.
// Every sum is rounded to f32 once. The elementwise products use the
// round-to-nearest intrinsics, so nothing is contracted into a fused
// multiply-add. Bound: bytes (each label, prediction and weight read
// once).
//
// No float atomics anywhere. C interface for ctypes: each entry point
// launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a plan it cannot run: scratch missing, too many warps).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 8;
constexpr int UNROLL = 4;  // rows a lane has in flight
constexpr int REDUCE_THREADS = 256;
constexpr int REG_THREADS = 256;
constexpr int REG_WARPS = REG_THREADS / WARP;

// one warp step: lane `lane` holds a row of cell `cell` (< 0: none) and
// weight w; the lanes of each cell sum their weights in lane order at the
// lowest of them, which adds the sum to the warp's histogram
__device__ __forceinline__ void add_step(double* hist, long long cell,
                                         double w, int lane) {
  const unsigned peers = __match_any_sync(FULL, (unsigned long long)cell);
  unsigned rest = cell >= 0 ? peers : 0u;
  double acc = 0.0;
  while (__any_sync(FULL, rest != 0u)) {
    const int src = rest != 0u ? __ffs(rest) - 1 : lane;
    const double v = __shfl_sync(FULL, w, src);
    if (rest != 0u) {
      acc += v;
      rest &= rest - 1u;
    }
  }
  if (cell >= 0 && lane == __ffs(peers) - 1) hist[cell] += acc;
  __syncwarp();  // the next step's leaders see this step's sums
}

template <bool SHARED>
__global__ void confusion_kernel(const int* __restrict__ y,
                                 const int* __restrict__ pred,
                                 const float* __restrict__ mask, int n, int k,
                                 int G, int chunk, double* __restrict__ part,
                                 float* __restrict__ out) {
  extern __shared__ double sh[];
  const int g = blockIdx.x, p = blockIdx.y;
  const int warps = blockDim.x / WARP;
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
  const long long cells = (long long)k * k;
  double* const slot =
      part != nullptr ? part + ((long long)p * G + g) * cells : nullptr;
  double* const hist = SHARED ? sh + warp * cells : slot;
  if (SHARED) {
    for (long long c = threadIdx.x; c < warps * cells; c += blockDim.x)
      sh[c] = 0.0;
    __syncthreads();
  } else {
    for (long long c = lane; c < cells; c += WARP) hist[c] = 0.0;
    __syncwarp();
  }
  const long long r0 = (long long)g * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const int* pp = pred + (long long)p * n;
  const float* mp = mask + (long long)p * n;
  const long long stride = (long long)warps * WARP * UNROLL;
  for (long long base = r0 + (long long)warp * WARP * UNROLL; base < r1;
       base += stride) {
    int yv[UNROLL], pv[UNROLL];
    float wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + u * WARP + lane;
      const bool in = r < r1;
      yv[u] = in ? y[r] : 0;
      pv[u] = in ? pp[r] : 0;
      wv[u] = in ? mp[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int yi = min(max(yv[u], 0), k - 1);
      const int pi = min(max(pv[u], 0), k - 1);
      const long long cell =
          wv[u] != 0.f ? (long long)yi * k + pi : -1ll;  // NaN adds
      add_step(hist, cell, (double)wv[u], lane);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (long long c = threadIdx.x; c < cells; c += blockDim.x) {
      double t = 0.0;
      for (int w = 0; w < warps; ++w) t += sh[w * cells + c];
      if (G == 1)
        out[(long long)p * cells + c] = (float)t;
      else
        slot[c] = t;
    }
  } else if (G == 1) {  // one warp: its histogram is the pair's sums
    for (long long c = lane; c < cells; c += WARP)
      out[(long long)p * cells + c] = (float)hist[c];
  }
}

// the G partials of each cell summed in block order and rounded once: a
// block takes REDUCE_CELLS cells of a pair, its threads load the cells'
// partials of REDUCE_THREADS / REDUCE_CELLS blocks at a time into shared
// memory together (all loads in flight at once), and thread c adds cell
// c's in block order
constexpr int REDUCE_CELLS = 32;
__global__ void __launch_bounds__(REDUCE_THREADS)
    confusion_reduce(const double* __restrict__ part, int G, long long cells,
                     float* __restrict__ out) {
  constexpr int ROWS = REDUCE_THREADS / REDUCE_CELLS;
  __shared__ double tile[ROWS][REDUCE_CELLS];
  const int p = blockIdx.y;
  const int c = threadIdx.x % REDUCE_CELLS, r = threadIdx.x / REDUCE_CELLS;
  for (long long c0 = (long long)blockIdx.x * REDUCE_CELLS; c0 < cells;
       c0 += (long long)gridDim.x * REDUCE_CELLS) {
    const bool in = c0 + c < cells;
    double t = 0.0;
    for (int g0 = 0; g0 < G; g0 += ROWS) {
      __syncthreads();
      if (in && g0 + r < G)
        tile[r][c] = part[((long long)p * G + g0 + r) * cells + c0 + c];
      __syncthreads();
      if (r == 0 && in)
        for (int j = 0; j < ROWS && g0 + j < G; ++j) t += tile[j][c];
    }
    if (r == 0 && in) out[(long long)p * cells + c0 + c] = (float)t;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the block's sums of N values, the same bits in every thread: lanes by
// the xor butterfly, then warps in warp order
template <int N>
__device__ __forceinline__ void block_sums(double (&v)[N],
                                           double (*s)[REG_WARPS]) {
  const int lane = threadIdx.x & (WARP - 1), warp = threadIdx.x / WARP;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  __syncthreads();  // the scratch's last readers are done
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j][warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double t = 0.0;
    for (int w = 0; w < REG_WARPS; ++w) t += s[j][w];
    v[j] = t;
  }
}

// sum w, e*e, |e|, y*w over rows [r0, r1) of pair p, this thread's rows
__device__ __forceinline__ void moments_rows(const float* pp, const float* y,
                                             const float* mp, long long r0,
                                             long long r1, double (&a)[4]) {
  for (long long base = r0 + threadIdx.x; base < r1;
       base += (long long)REG_THREADS * UNROLL) {
    float pv[UNROLL], yv[UNROLL], wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + (long long)u * REG_THREADS;
      const bool in = r < r1;
      pv[u] = in ? pp[r] : 0.f;
      yv[u] = in ? y[r] : 0.f;
      wv[u] = in ? mp[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + (long long)u * REG_THREADS >= r1) break;
      const float e = __fmul_rn(__fsub_rn(pv[u], yv[u]), wv[u]);
      a[0] += (double)wv[u];
      a[1] += (double)__fmul_rn(e, e);
      a[2] += (double)fabsf(e);
      a[3] += (double)__fmul_rn(yv[u], wv[u]);
    }
  }
}

// sum t*t*w, t = y - ybar, over this thread's rows of [r0, r1)
__device__ __forceinline__ double spread_rows(const float* y, const float* mp,
                                              float ybar, long long r0,
                                              long long r1) {
  double s = 0.0;
  for (long long base = r0 + threadIdx.x; base < r1;
       base += (long long)REG_THREADS * UNROLL) {
    float yv[UNROLL], wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = base + (long long)u * REG_THREADS;
      const bool in = r < r1;
      yv[u] = in ? y[r] : 0.f;
      wv[u] = in ? mp[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + (long long)u * REG_THREADS >= r1) break;
      const float t = __fsub_rn(yv[u], ybar);
      s += (double)__fmul_rn(__fmul_rn(t, t), wv[u]);
    }
  }
  return s;
}

// the J (<= REG_WARPS) sums over b = 0 .. B - 1 of v[b * J + j], read past
// L1 (other blocks wrote them): warp j takes sum j, lane l adds b = l,
// l + 32, ... in order, then the lanes combine by the xor butterfly (a
// fixed order; every lane of warp j ends with the sum)
__device__ __forceinline__ double partial_sum(const double* v, int B, int J) {
  const int lane = threadIdx.x & (WARP - 1), j = threadIdx.x / WARP;
  double t = 0.0;
  if (j < J)
    for (int b = lane; b < B; b += WARP) t += __ldcg(v + (long long)b * J + j);
  return warp_sum(t);
}

__device__ __forceinline__ float mean_of(float sw, float syw) {
  return __fdiv_rn(syw, fmaxf(sw, 1.f));
}

// G = 1: both passes over the pair's rows in one block
__global__ void __launch_bounds__(REG_THREADS)
    moments_one(const float* __restrict__ pred, const float* __restrict__ y,
                const float* __restrict__ mask, int n,
                float* __restrict__ out) {
  __shared__ double s[4][REG_WARPS];
  const int p = blockIdx.y;
  const float* pp = pred + (long long)p * n;
  const float* mp = mask + (long long)p * n;
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  moments_rows(pp, y, mp, 0, n, a);
  block_sums<4>(a, s);
  const float m0 = (float)a[0], m3 = (float)a[3];
  double b[1] = {spread_rows(y, mp, mean_of(m0, m3), 0, n)};
  block_sums<1>(b, s);
  if (threadIdx.x == 0) {
    float* o = out + (long long)p * 5;
    o[0] = m0;
    o[1] = (float)a[1];
    o[2] = (float)a[2];
    o[3] = m3;
    o[4] = (float)b[0];
  }
}

// G > 1, pass 1: each block's four sums to part[(p, g), 0..3]
__global__ void __launch_bounds__(REG_THREADS)
    moments_first(const float* __restrict__ pred, const float* __restrict__ y,
                  const float* __restrict__ mask, int n, int chunk,
                  double* __restrict__ part, unsigned* __restrict__ arrived) {
  __shared__ double s[4][REG_WARPS];
  const int g = blockIdx.x, G = gridDim.x, p = blockIdx.y;
  const long long r0 = (long long)g * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  moments_rows(pred + (long long)p * n, y, mask + (long long)p * n, r0, r1,
               a);
  block_sums<4>(a, s);
  if (threadIdx.x < 4) part[((long long)p * G + g) * 4 + threadIdx.x] =
      a[threadIdx.x];
  if (g == 0 && threadIdx.x == 0) arrived[p] = 0u;
}

// G > 1, pass 2: ybar from the pair's partials, each block's t*t*w, and
// the last block of the pair to arrive writes the five sums
__global__ void __launch_bounds__(REG_THREADS)
    moments_second(const float* __restrict__ y,
                   const float* __restrict__ mask, int n, int chunk,
                   const double* __restrict__ part, double* __restrict__ part2,
                   unsigned* __restrict__ arrived, float* __restrict__ out) {
  __shared__ double s[4][REG_WARPS];
  __shared__ double m[4];
  __shared__ bool last;
  const int g = blockIdx.x, G = gridDim.x, p = blockIdx.y;
  // the pair's four sums of its blocks' partials, warp j the j-th
  const double mj = partial_sum(part + (long long)p * G * 4, G, 4);
  if ((threadIdx.x & (WARP - 1)) == 0 && threadIdx.x / WARP < 4)
    m[threadIdx.x / WARP] = mj;
  __syncthreads();
  const float m0 = (float)m[0], m3 = (float)m[3];
  const long long r0 = (long long)g * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  double b[1] = {spread_rows(y, mask + (long long)p * n, mean_of(m0, m3), r0,
                             r1)};
  block_sums<1>(b, s);
  if (threadIdx.x == 0) {
    part2[(long long)p * G + g] = b[0];
    __threadfence();
    last = atomicAdd(arrived + p, 1u) == (unsigned)(G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double t = partial_sum(part2 + (long long)p * G, G, 1);
  if (threadIdx.x == 0) {
    float* o = out + (long long)p * 5;
    o[0] = m0;
    o[1] = (float)m[1];
    o[2] = (float)m[2];
    o[3] = m3;
    o[4] = (float)t;
  }
}

}  // namespace

// y (n,) int32, pred and mask (P, n) int32 / f32; out (P, k, k) f32. Each
// pair's rows in G ranges of `chunk`, `warps` warps a block; `shared`: the
// warps' histograms in shared memory, else (one warp a block) in `part`.
// `part`: (P, G, k * k) f64, needed when G > 1 or not `shared`.
extern "C" int confusion_counts(const void* y, const void* pred,
                                const void* mask, int P, int n, int k, int G,
                                int chunk, int warps, int shared, void* part,
                                void* out, void* stream) {
  if (P <= 0) return 0;
  if (k < 1 || G < 1 || warps < 1 || warps > MAX_WARPS ||
      (!shared && warps != 1) || ((G > 1 || !shared) && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long cells = (long long)k * k;
  dim3 grid((unsigned)G, (unsigned)P);
  const int* yi = static_cast<const int*>(y);
  const int* pi = static_cast<const int*>(pred);
  const float* mi = static_cast<const float*>(mask);
  double* pa = static_cast<double*>(part);
  float* o = static_cast<float*>(out);
  if (shared) {
    const long long smem = (long long)warps * cells * (long long)sizeof(double);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    static long long opted = 48 * 1024;
    if (smem > opted) {
      const cudaError_t e = cudaFuncSetAttribute(
          confusion_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted = smem;
    }
    confusion_kernel<true><<<grid, warps * WARP, (size_t)smem, st>>>(
        yi, pi, mi, n, k, G, chunk, pa, o);
  } else {
    confusion_kernel<false><<<grid, WARP, 0, st>>>(yi, pi, mi, n, k, G, chunk,
                                                   pa, o);
  }
  if (G > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (cells + REDUCE_CELLS - 1) / REDUCE_CELLS;
    dim3 rgrid((unsigned)(blocks < 4096 ? blocks : 4096), (unsigned)P);
    confusion_reduce<<<rgrid, REDUCE_THREADS, 0, st>>>(pa, G, cells, o);
  }
  return (int)cudaGetLastError();
}

// pred, mask (P, n) and y (n,) f32; out (P, 5) f32. Each pair's rows in G
// ranges of `chunk`; `part`: 5 * P * G f64 and then P uint32 counters,
// needed when G > 1.
extern "C" int regression_moments(const void* pred, const void* y,
                                  const void* mask, int P, int n, int G,
                                  int chunk, void* part, void* out,
                                  void* stream) {
  if (P <= 0) return 0;
  if (G < 1 || (G > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* pr = static_cast<const float*>(pred);
  const float* yv = static_cast<const float*>(y);
  const float* mv = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  if (G == 1) {
    moments_one<<<dim3(1, (unsigned)P), REG_THREADS, 0, st>>>(pr, yv, mv, n,
                                                              o);
    return (int)cudaGetLastError();
  }
  double* first = static_cast<double*>(part);
  double* second = first + 4ll * P * G;
  unsigned* arrived = reinterpret_cast<unsigned*>(second + (long long)P * G);
  dim3 grid((unsigned)G, (unsigned)P);
  moments_first<<<grid, REG_THREADS, 0, st>>>(pr, yv, mv, n, chunk, first,
                                              arrived);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moments_second<<<grid, REG_THREADS, 0, st>>>(yv, mv, n, chunk, first,
                                               second, arrived, o);
  return (int)cudaGetLastError();
}
