// K9-hits: the feature pairs of one block of the sanity checker's Gram
// product whose |correlation| exceeds a threshold, in row-major order, cut
// at a fixed capacity.
//
//   hit(r, j) = |C[r, j]| > thr  and  j < a + r  and  a + r < d
//
// over C (b, d) f32 row-major: the correlations of the checker's columns
// a .. a + b - 1 (rows) with every column j (one block product U_b^T U of
// the wide path). Outputs, each of length cap:
//   ri, ci  int64, a hit's row in the block and its column, in row-major
//           order; -1 past the last hit written;
//   vals    f32, C[ri, ci] bit for bit; past the last hit C[b - 1, d - 1],
//           which is what the JAX package's gather at index -1 reads;
// and total (int64), every hit of the block, cap or not.
//
// Replaces `block_hits` of `_corr_label_and_hits_blocked` in
// transmogrifai_tpu/automl/sanity_checker.py:173-180
// (`jnp.nonzero(mask, size=cap, fill_value=-1)`, the TPU's static-shape
// idiom). The plain torch version materializes a (b, d) mask and the
// indices of every hit before it cuts to cap; a wide one-hot table with
// many identical rare-level columns makes that index tensor far larger
// than cap. This kernel keeps no mask and writes at most cap hits.
//
// Design: three launches from one C call, in stream order.
//  1. count: a warp per row counts its hits over j < a + r in 32-column
//     steps (one coalesced 128-byte load, a ballot and a popcount a step);
//  2. scan: one block turns the b counts into exclusive row offsets (each
//     thread sums a contiguous run of rows, a block scan of the runs, then
//     each thread writes its run's offsets), writes total and fills the
//     positions past min(total, cap);
//  3. write: a warp per row whose offset is below cap and that has hits
//     walks its columns again and writes each hit at the row's offset plus
//     the hits before it (a ballot, the popcount of the lower lanes); it
//     stops at cap.
// No atomics: the output is deterministic and equal to the plain version
// on the same C. Bound on this card: bytes, the lower triangle of C read
// once (the rows with hits are read again; few by the checker's premise).
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // rows a block in the count and write passes
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) {
  return x < y ? x : y;
}

// the columns row r of the block tests: j < a + r, and none past d
__device__ __forceinline__ int64_t row_limit(int64_t a, int64_t r,
                                             int64_t d) {
  return a + r < d ? a + r : 0;
}

__global__ void count_kernel(const float* __restrict__ C, int64_t b,
                             int64_t d, int64_t a, float thr,
                             int64_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= b) return;
  const int64_t limit = row_limit(a, r, d);
  const float* row = C + r * d;
  int64_t n = 0;
  for (int64_t j0 = 0; j0 < limit; j0 += 32) {
    const int64_t j = j0 + lane;
    const bool hit = j < limit && fabsf(row[j]) > thr;
    n += __popc(__ballot_sync(0xffffffffu, hit));
  }
  if (lane == 0) counts[r] = n;
}

__global__ void scan_kernel(int64_t* __restrict__ offsets, int64_t b,
                            int64_t cap, const float* __restrict__ C,
                            int64_t last, int64_t* __restrict__ ri,
                            int64_t* __restrict__ ci,
                            float* __restrict__ vals,
                            int64_t* __restrict__ total) {
  __shared__ int64_t part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int64_t per = (b + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t lo = imin(b, (int64_t)t * per);
  const int64_t hi = imin(b, lo + per);
  int64_t s = 0;
  for (int64_t i = lo; i < hi; ++i) s += offsets[i];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int64_t v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int64_t base = t ? part[t - 1] : 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t c = offsets[i];
    offsets[i] = base;
    base += c;
  }
  const int64_t tot = part[SCAN_THREADS - 1];
  if (t == 0) *total = tot;
  const float fill = C[last];
  for (int64_t k = imin(tot, cap) + t; k < cap; k += SCAN_THREADS) {
    ri[k] = -1;
    ci[k] = -1;
    vals[k] = fill;
  }
}

__global__ void write_kernel(const float* __restrict__ C, int64_t b,
                             int64_t d, int64_t a, float thr, int64_t cap,
                             const int64_t* __restrict__ offsets,
                             const int64_t* __restrict__ total,
                             int64_t* __restrict__ ri,
                             int64_t* __restrict__ ci,
                             float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= b) return;
  int64_t base = offsets[r];
  const int64_t next = r + 1 < b ? offsets[r + 1] : *total;
  if (base >= cap || next == base) return;
  const int64_t limit = row_limit(a, r, d);
  const float* row = C + r * d;
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t j0 = 0; j0 < limit && base < cap; j0 += 32) {
    const int64_t j = j0 + lane;
    float v = 0.0f;
    bool hit = false;
    if (j < limit) {
      v = row[j];
      hit = fabsf(v) > thr;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    const int64_t pos = base + __popc(m & lower);
    if (hit && pos < cap) {
      ri[pos] = r;
      ci[pos] = j;
      vals[pos] = v;
    }
    base += __popc(m);
  }
}

}  // namespace

// C (b, d) f32 row-major; scratch int64 of length b; ri, ci int64 and
// vals f32 of length cap; total one int64. b >= 1, d >= 1.
extern "C" int corr_hits(const void* C, int64_t b, int64_t d, int64_t a,
                         float thr, int64_t cap, void* scratch, void* ri,
                         void* ci, void* vals, void* total, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = static_cast<const float*>(C);
  int64_t* offsets = static_cast<int64_t*>(scratch);
  const unsigned blocks = (unsigned)((b + WARPS - 1) / WARPS);
  count_kernel<<<blocks, WARPS * 32, 0, s>>>(c, b, d, a, thr, offsets);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      offsets, b, cap, c, b * d - 1, static_cast<int64_t*>(ri),
      static_cast<int64_t*>(ci), static_cast<float*>(vals),
      static_cast<int64_t*>(total));
  write_kernel<<<blocks, WARPS * 32, 0, s>>>(
      c, b, d, a, thr, cap, offsets, static_cast<const int64_t*>(total),
      static_cast<int64_t*>(ri), static_cast<int64_t*>(ci),
      static_cast<float*>(vals));
  return (int)cudaGetLastError();
}
