// K1: per-level histograms of m value channels and one weight channel, for
// P trees at once.
//
//   hist_G[p, c, k, f, b] = sum over rows r with node[p, r] == k and
//                           Xb[r, f] == b of G[p, c, r]     (c < m)
//   hist_H[p, k, f, b]    = the same sum of H[p, r]
//
// Replaces `_histograms` and `bins_onehot` in
// transmogrifai_tpu/models/trees.py:93-167. On the TPU these are one-hot
// matmuls, (nodes, n) @ (n, d * bins) per channel, so the MXU does the
// reduction. On Hopper the one-hot operand is pure waste: every row adds
// its values into exactly one bin per feature. Boosting has m = 1 (the
// gradient); a forest has one channel per class (one-hot labels times the
// bootstrap weight), so one pass over the rows fills every channel.
//
// Determinism: no float atomics in global memory. The caller passes the
// rows grouped by node in stable row order (`order`, with node k's rows at
// order[p, seg[p, k] .. seg[p, k + 1])); rows listed after the last
// segment are left out, which is how the sibling-subtraction path builds
// the histograms of the rows routed right only. A block owns one (pair,
// node) and FT = 32 neighbouring features, one warp lane per feature; its
// LANES row-lanes take every LANES-th row of the node's segment in order
// and add into private shared-memory histograms, which are then summed
// lane by lane in a fixed order. The result is the same bits on every run.
//
// Layout of the private histograms: [lane][channel 0..m-1, then H][bin]
// [FT + 1] floats; the +1 pad spreads a feature's bins over banks for the
// write-out, where neighbouring threads read neighbouring bins of one
// feature, so the global writes of (.., f, b) coalesce. Every output cell
// is written, so empty nodes come out as zeros with no memset. Above 48 KB
// of shared memory (m = 2 at 32 bins with 4 lanes) the launch opts in to
// the larger carve-out. The channel count m (1 to 4) is a template
// parameter, so the channel loops unroll.
//
// Bound on this card: bytes. The output is (m + 1) * P * nodes * d * bins
// f32 and dominates at deep levels; each row's Xb slice and values are
// read once per level. Offsets into the output pass 2^31 at deep levels
// of many trees, so every flat index is 64-bit.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 32;
constexpr int MAX_M = 4;

template <typename BinT, int M>
__global__ void histograms_kernel(const BinT* __restrict__ Xb,
                                  const float* __restrict__ G,
                                  const float* __restrict__ H,
                                  const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ seg,
                                  float* __restrict__ hg,
                                  float* __restrict__ hh, int n, int d,
                                  int n_nodes, int n_bins, int lanes) {
  extern __shared__ float sm[];
  const int stride = FT + 1;
  const int plane = n_bins * stride;
  const int lane_size = (M + 1) * plane;
  const int f0 = blockIdx.x * FT;
  const int node = blockIdx.y;
  const int p = blockIdx.z;
  const int tid = threadIdx.y * FT + threadIdx.x;
  const int nthreads = FT * lanes;
  for (int i = tid; i < lanes * lane_size; i += nthreads) sm[i] = 0.f;
  __syncthreads();

  const int64_t sbase = (int64_t)p * (n_nodes + 1);
  const int s0 = seg[sbase + node];
  const int s1 = seg[sbase + node + 1];
  const int f = f0 + threadIdx.x;
  if (f < d) {
    float* mine = sm + threadIdx.y * lane_size + threadIdx.x;
    const int32_t* ord = order + (int64_t)p * n;
    const float* Gp = G + (int64_t)p * M * n;
    const float* Hp = H + (int64_t)p * n;
    for (int i = s0 + threadIdx.y; i < s1; i += lanes) {
      const int r = ord[i];
      const int b = (int)Xb[(int64_t)r * d + f];
      if ((unsigned)b >= (unsigned)n_bins) continue;  // not a bin: dropped
      float* cell = mine + b * stride;
#pragma unroll
      for (int c = 0; c < M; ++c) cell[c * plane] += Gp[(int64_t)c * n + r];
      cell[M * plane] += Hp[r];
    }
  }
  __syncthreads();

  const int nf = min(FT, d - f0);
  for (int c = tid; c < nf * n_bins; c += nthreads) {
    const int fl = c / n_bins;
    const int b = c - fl * n_bins;
    const int off = b * stride + fl;
#pragma unroll
    for (int ch = 0; ch <= M; ++ch) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l)
        s += sm[l * lane_size + ch * plane + off];
      const int64_t row = ch < M ? ((int64_t)p * M + ch) * n_nodes + node
                                 : (int64_t)p * n_nodes + node;
      (ch < M ? hg : hh)[(row * d + f0 + fl) * n_bins + b] = s;
    }
  }
}

template <typename BinT, int M>
int launch(const void* Xb, const void* G, const void* H, const void* order,
           const void* seg, void* hg, void* hh, int P, int n, int d,
           int n_nodes, int n_bins, int lanes, void* stream) {
  dim3 grid((d + FT - 1) / FT, n_nodes, P);
  dim3 block(FT, lanes);
  size_t smem = (size_t)lanes * (M + 1) * n_bins * (FT + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        histograms_kernel<BinT, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  histograms_kernel<BinT, M><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const float*>(G),
      static_cast<const float*>(H), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(seg), static_cast<float*>(hg),
      static_cast<float*>(hh), n, d, n_nodes, n_bins, lanes);
  return (int)cudaGetLastError();
}

template <typename BinT>
int launch_m(const void* Xb, const void* G, const void* H, const void* order,
             const void* seg, void* hg, void* hh, int P, int n, int d,
             int n_nodes, int n_bins, int m, int lanes, void* stream) {
#define HISTOGRAMS_CASE(M_)                                                 \
  case M_:                                                                  \
    return launch<BinT, M_>(Xb, G, H, order, seg, hg, hh, P, n, d, n_nodes, \
                            n_bins, lanes, stream);
  switch (m) {
    HISTOGRAMS_CASE(1)
    HISTOGRAMS_CASE(2)
    HISTOGRAMS_CASE(3)
    HISTOGRAMS_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HISTOGRAMS_CASE
}

}  // namespace

extern "C" int histograms_max_m() { return MAX_M; }

extern "C" int histograms_i8(const void* Xb, const void* G, const void* H,
                             const void* order, const void* seg, void* hg,
                             void* hh, int P, int n, int d, int n_nodes,
                             int n_bins, int m, int lanes, void* stream) {
  return launch_m<int8_t>(Xb, G, H, order, seg, hg, hh, P, n, d, n_nodes,
                          n_bins, m, lanes, stream);
}

extern "C" int histograms_i32(const void* Xb, const void* G, const void* H,
                              const void* order, const void* seg, void* hg,
                              void* hh, int P, int n, int d, int n_nodes,
                              int n_bins, int m, int lanes, void* stream) {
  return launch_m<int32_t>(Xb, G, H, order, seg, hg, hh, P, n, d, n_nodes,
                           n_bins, m, lanes, stream);
}
