// K1: per-level gradient and hessian histograms of P trees at once.
//
//   hist_G[p, k, f, b] = sum over rows r with node[p, r] == k and
//                        Xb[r, f] == b of G[p, r]        (hist_H likewise)
//
// Replaces `_histograms` and `bins_onehot` in
// transmogrifai_tpu/models/trees.py:93-167. On the TPU these are one-hot
// matmuls, (nodes, n) @ (n, d * bins), so the MXU does the reduction. On
// Hopper the one-hot operand is pure waste: every row adds its value into
// exactly one bin per feature.
//
// Determinism: no float atomics in global memory. The caller passes the
// rows grouped by node in stable row order (`order`, with node k's rows at
// order[p, seg[p, k] .. seg[p, k + 1])). A block owns one (pair, node) and
// FT = 32 neighbouring features, one warp lane per feature; its LANES
// row-lanes take every LANES-th row of the node's segment in order and add
// into private shared-memory histograms, which are then summed lane by lane
// in a fixed order. The result is the same bits on every run.
//
// Layout of the private histograms: [lane][G|H][bin][FT + 1] floats; the
// +1 pad spreads a feature's bins over banks for the write-out, where
// neighbouring threads read neighbouring bins of one feature, so the
// global writes of (.., f, b) coalesce. Every output cell is written, so
// empty nodes come out as zeros with no memset.
//
// Bound on this card: bytes. The output is 2 * P * nodes * d * bins f32 and
// dominates at deep levels (390 MB at P = 6, 512 nodes, 496 features, 32
// bins); each row's Xb slice and G/H values are read once per level.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT = 32;

template <typename BinT>
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
  const int half = n_bins * stride;
  const int lane_size = 2 * half;
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
    float* mg = sm + threadIdx.y * lane_size;
    float* mh = mg + half;
    const int32_t* ord = order + (int64_t)p * n;
    const float* Gp = G + (int64_t)p * n;
    const float* Hp = H + (int64_t)p * n;
    for (int i = s0 + threadIdx.y; i < s1; i += lanes) {
      const int r = ord[i];
      const int b = (int)Xb[(int64_t)r * d + f];
      if ((unsigned)b >= (unsigned)n_bins) continue;  // not a bin: dropped
      mg[b * stride + threadIdx.x] += Gp[r];
      mh[b * stride + threadIdx.x] += Hp[r];
    }
  }
  __syncthreads();

  const int nf = min(FT, d - f0);
  const int64_t obase = ((int64_t)p * n_nodes + node) * d + f0;
  for (int c = tid; c < nf * n_bins; c += nthreads) {
    const int fl = c / n_bins;
    const int b = c - fl * n_bins;
    float sg = 0.f, sh = 0.f;
    for (int l = 0; l < lanes; ++l) {
      sg += sm[l * lane_size + b * stride + fl];
      sh += sm[l * lane_size + half + b * stride + fl];
    }
    const int64_t o = (obase + fl) * n_bins + b;
    hg[o] = sg;
    hh[o] = sh;
  }
}

template <typename BinT>
int launch(const void* Xb, const void* G, const void* H, const void* order,
           const void* seg, void* hg, void* hh, int P, int n, int d,
           int n_nodes, int n_bins, int lanes, void* stream) {
  dim3 grid((d + FT - 1) / FT, n_nodes, P);
  dim3 block(FT, lanes);
  size_t smem = (size_t)lanes * 2 * n_bins * (FT + 1) * sizeof(float);
  histograms_kernel<BinT><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const float*>(G),
      static_cast<const float*>(H), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(seg), static_cast<float*>(hg),
      static_cast<float*>(hh), n, d, n_nodes, n_bins, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int histograms_i8(const void* Xb, const void* G, const void* H,
                             const void* order, const void* seg, void* hg,
                             void* hh, int P, int n, int d, int n_nodes,
                             int n_bins, int lanes, void* stream) {
  return launch<int8_t>(Xb, G, H, order, seg, hg, hh, P, n, d, n_nodes,
                        n_bins, lanes, stream);
}

extern "C" int histograms_i32(const void* Xb, const void* G, const void* H,
                              const void* order, const void* seg, void* hg,
                              void* hh, int P, int n, int d, int n_nodes,
                              int n_bins, int lanes, void* stream) {
  return launch<int32_t>(Xb, G, H, order, seg, hg, hh, P, n, d, n_nodes,
                         n_bins, lanes, stream);
}
