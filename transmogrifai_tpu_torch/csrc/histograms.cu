// K1: per-level histograms of m value channels and one weight channel, for
// P trees at once.
//
//   hist_G[p, c, k, f, b] = sum over rows r with node[p, r] == k and
//                           Xb[r, f] == b of G[p, c, r]     (c < m)
//   hist_H[p, k, f, b]    = the same sum of H[p, r]
//
// Replaces `_histograms` and `bins_onehot` in
// transmogrifai_tpu/models/trees.py:93-167 (and the chunked
// `_chunked_histograms_multi`, transmogrifai_tpu/parallel/bigdata.py:1014).
// On the TPU these are one-hot matmuls, (nodes, n) @ (n, d * bins) per
// channel, so the MXU does the reduction. On Hopper the one-hot operand is
// pure waste: every row adds its values into exactly one bin per feature.
// Boosting has m = 1 (the gradient); a forest has one channel per class.
//
// Bound on this card. Bytes at deep levels: the output, (m + 1) * P *
// nodes * d * bins f32, most of it zeros for nodes that hold no rows (a
// depth-12 forest's levels 10-11). Operations at shallow levels of many
// rows: every (row, feature, channel) is one add into a histogram cell,
// (m + 1) * P * n * d of them; in shared memory each is a load and a store,
// so the shared-memory pipe (128 B a clock an SM) is the practical floor.
//
// The caller passes the rows grouped by node in stable row order (`order`,
// node k's rows at order[p, seg[p, k] .. seg[p, k + 1])). Rows listed after
// the last segment are left out, which is how the sibling-subtraction path
// builds the histograms of the rows routed right only. Bin ids outside
// [0, n_bins) are dropped. No float atomics in global memory: every output
// cell is written by exactly one thread, so the result is the same bits on
// every run. Every flat offset is 64-bit. Four launches, all on `stream`:
//
// 0. the plan (`plan_kernel`, a block a pair): `first`, the exclusive
//    cumulative count over the nodes of their pieces (⌈c / R⌉ for a node
//    of c > few rows, else none), and `slot`, that of the pieces of nodes
//    with more than one piece: their scratch slots. The wrapper's plain
//    `hist_piece_plan` is the same arithmetic.
// 1. few rows (`few_kernel`, a block per (cell chunk, node, pair), no shared
//    histograms): a node holding at most `few` rows. Each thread owns four
//    neighbouring cells of one feature and adds the node's rows into them
//    in row order, in registers, then writes them with 16-byte stores; an
//    empty node writes its zeros the same way. This is the deep levels of
//    a forest, where the old design zeroed and reduced 50 KB of shared
//    memory per (node, feature tile) for a node of 0-1 rows.
// 2. pieces (`piece_kernel`, a block per (pair, piece, feature tile), the
//    pair index fastest, so the P learners' blocks over one row piece run
//    together and read Xb from L2 once at level 0): every node with more
//    than `few` rows is cut into pieces of at most R rows at boundaries
//    fixed by `seg` and R. The block's row-lanes take every lanes-th row of
//    its piece in order and add into private shared-memory histograms,
//    summed lane by lane in a fixed order (with the old kernel's 4 lanes,
//    a node of one piece gets the old bits; with 1 lane, those of the
//    CPU's row-order `index_add_`). A thread covers F = 4 neighbouring
//    features through one 32-bit load of int8 bins (16 bytes for int32), so
//    a row's values are loaded once per 4 features (F = 1 where d % 4 != 0
//    or 4 features' histograms would not fit: many bins); the private
//    layout [lane][bin][channel][feature of F][thread] puts a thread's
//    cells in its own bank, so the adds never conflict, and a channel's
//    cells at a fixed offset from channel 0's, known at compile time; a
//    trash bin takes the adds of dropped bins and of features past d, so
//    every row is the same straight-line loads, adds and stores. A lane
//    keeps the next 8 rows' bins and values in flight while it adds 8,
//    and reads a row's cells of half its features while the row before
//    writes the other half.
//    The kernel is bound
//    by the latency of shared memory at the 4 warps a block's 200 KB of
//    histograms leave an SM, and by the issue of the per-row loads, not by
//    memory bandwidth (PERF.md).
//    A node of one piece writes straight to the output, a node of several
//    pieces writes each piece to the scratch buffer.
// 3. (only when n > R) `reduce_kernel`: sums each node's pieces from the
//    scratch buffer in piece order into the output (deterministic; within
//    the f32 summation bound of any other order).
//
// Any m: a launch takes M <= MAX_M value channels and the weight slot.
// The wrapper cuts m > MAX_M channels into launches over the same tensors
// through their strides (`g_ch` channels a pair in G and hg, `h_ch` in H
// and hh): the first takes channels 0..M-1 and the weights, each later one
// up to MAX_M channels and one more channel in the weight slot (h_ch =
// g_ch). So every channel's histograms are built once, each by the same
// arithmetic as in a launch of its own, and the weights once.
//
// C interface for ctypes: one entry point per bin type launches all four
// kernels on `stream` and returns the first cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_M = 4;
constexpr int FEW_MAX = 64;       // largest `few` the few-rows kernel takes
constexpr int FEW_THREADS = 256;
constexpr int FEW_GROUPS = 4;     // 4-cell groups per thread in a few block
constexpr int REDUCE_THREADS = 256;

struct Planes {
  float* hg;        // (P, g_ch, n_nodes, d, n_bins): channel c < M at c
  float* hh;        // (P, h_ch, n_nodes, d, n_bins): the weight slot at 0
  float* scratch;   // (P, n_slots, M + 1, d, n_bins)
  int64_t n_slots;
  int g_ch;         // channels a pair in G and hg
  int h_ch;         // in H and hh: 1, or g_ch when the weight slot carries
                    // a value channel of the same tensors
};

// the (d, n_bins) plane of channel c (c == M: the weights) of node k
template <int M>
__device__ __forceinline__ float* out_plane(const Planes& o, int p, int c,
                                            int k, int n_nodes,
                                            int64_t plane) {
  return c < M ? o.hg + (((int64_t)p * o.g_ch + c) * n_nodes + k) * plane
               : o.hh + ((int64_t)p * o.h_ch * n_nodes + k) * plane;
}

__device__ __forceinline__ float* slot_plane(const Planes& o, int p, int64_t s,
                                             int c, int channels,
                                             int64_t plane) {
  return o.scratch + (((int64_t)p * o.n_slots + s) * channels + c) * plane;
}

// the node k that owns piece q of pair p: first[k] <= q < first[k + 1]
__device__ __forceinline__ int piece_node(const int32_t* fp, int n_nodes,
                                          int q) {
  int lo = 0, hi = n_nodes;  // fp[lo] <= q < fp[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (fp[mid] <= q) lo = mid; else hi = mid;
  }
  return lo;
}

// --------------------------------------------------------------------------
// 1. nodes of at most `few` rows
// --------------------------------------------------------------------------
template <typename BinT, int M, bool VEC4>
__global__ void few_kernel(const BinT* __restrict__ Xb,
                           const float* __restrict__ G,
                           const float* __restrict__ H,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ seg, Planes o, int n,
                           int d, int n_nodes, int n_bins, int few) {
  __shared__ int rows[FEW_MAX];
  __shared__ float vals[M + 1][FEW_MAX];
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  const int64_t sb = (int64_t)p * (n_nodes + 1);
  const int s0 = seg[sb + k];
  const int cnt = seg[sb + k + 1] - s0;
  if (cnt > few) return;  // the piece kernel's node
  const int tid = threadIdx.x;
  if (tid < cnt) {
    const int r = order[(int64_t)p * n + s0 + tid];
    rows[tid] = r;
#pragma unroll
    for (int c = 0; c < M; ++c)
      vals[c][tid] = G[((int64_t)p * o.g_ch + c) * n + r];
    vals[M][tid] = H[(int64_t)p * o.h_ch * n + r];
  }
  __syncthreads();
  const int64_t plane = (int64_t)d * n_bins;
  if (VEC4) {
    // four cells (f, b0 .. b0 + 3) a group; n_bins % 4 == 0
    const int64_t groups = plane >> 2;
    const int64_t step = (int64_t)gridDim.x * FEW_THREADS;
    for (int64_t g = (int64_t)blockIdx.x * FEW_THREADS + tid; g < groups;
         g += step) {
      const int64_t e = g << 2;
      const int f = (int)(e / n_bins);
      const int b0 = (int)(e - (int64_t)f * n_bins);
      float acc[M + 1][4];
#pragma unroll
      for (int c = 0; c <= M; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
      for (int i = 0; i < cnt; ++i) {
        const unsigned off = (unsigned)((int)Xb[(int64_t)rows[i] * d + f] -
                                        b0);  // drops b >= n_bins
        if (off >= 4u) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (off == (unsigned)j) {
#pragma unroll
            for (int c = 0; c <= M; ++c) acc[c][j] += vals[c][i];
          }
        }
      }
#pragma unroll
      for (int c = 0; c <= M; ++c) {
        float4* dst = reinterpret_cast<float4*>(
            out_plane<M>(o, p, c, k, n_nodes, plane) + e);
        *dst = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
      }
    }
  } else {
    const int64_t step = (int64_t)gridDim.x * FEW_THREADS;
    for (int64_t e = (int64_t)blockIdx.x * FEW_THREADS + tid; e < plane;
         e += step) {
      const int f = (int)(e / n_bins);
      const int b = (int)(e - (int64_t)f * n_bins);
      float acc[M + 1];
#pragma unroll
      for (int c = 0; c <= M; ++c) acc[c] = 0.f;
      for (int i = 0; i < cnt; ++i) {
        if ((int)Xb[(int64_t)rows[i] * d + f] != b) continue;
#pragma unroll
        for (int c = 0; c <= M; ++c) acc[c] += vals[c][i];
      }
#pragma unroll
      for (int c = 0; c <= M; ++c)
        out_plane<M>(o, p, c, k, n_nodes, plane)[e] = acc[c];
    }
  }
}

// --------------------------------------------------------------------------
// 0. the plan: first[p, k] and slot[p, k], exclusive cumulative counts over
//    the nodes of the pieces (⌈c / R⌉ for a node of c > few rows, else 0)
//    and of the pieces of nodes with more than one piece; a block a pair
// --------------------------------------------------------------------------
constexpr int PLAN_THREADS = 256;

__global__ void plan_kernel(const int32_t* __restrict__ seg,
                            int32_t* __restrict__ first,
                            int32_t* __restrict__ slot, int n_nodes,
                            int piece_rows, int few) {
  __shared__ int warp_sum[2][PLAN_THREADS / WARP];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & (WARP - 1);
  const int w = threadIdx.x / WARP;
  const int64_t sb = (int64_t)p * (n_nodes + 1);
  int carry_f = 0, carry_s = 0;
  for (int base = 0; base < n_nodes; base += PLAN_THREADS) {
    const int k = base + threadIdx.x;
    int64_t cnt = 0;
    if (k < n_nodes) cnt = seg[sb + k + 1] - seg[sb + k];
    const int pieces =
        cnt > few ? (int)((cnt + piece_rows - 1) / piece_rows) : 0;
    const int multi = pieces > 1 ? pieces : 0;
    int inc_f = pieces, inc_s = multi;  // inclusive scans within the warp
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const int tf = __shfl_up_sync(0xffffffffu, inc_f, o);
      const int ts = __shfl_up_sync(0xffffffffu, inc_s, o);
      if (lane >= o) { inc_f += tf; inc_s += ts; }
    }
    if (lane == WARP - 1) { warp_sum[0][w] = inc_f; warp_sum[1][w] = inc_s; }
    __syncthreads();
    int before_f = carry_f, before_s = carry_s;
    int tot_f = 0, tot_s = 0;
    for (int i = 0; i < PLAN_THREADS / WARP; ++i) {
      if (i < w) { before_f += warp_sum[0][i]; before_s += warp_sum[1][i]; }
      tot_f += warp_sum[0][i];
      tot_s += warp_sum[1][i];
    }
    if (k < n_nodes) {
      first[sb + k] = before_f + inc_f - pieces;
      slot[sb + k] = before_s + inc_s - multi;
    }
    carry_f += tot_f;
    carry_s += tot_s;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    first[sb + n_nodes] = carry_f;
    slot[sb + n_nodes] = carry_s;
  }
}

// --------------------------------------------------------------------------
// 2. pieces of at most R rows of the other nodes
// --------------------------------------------------------------------------
constexpr int U = 8;  // rows a lane adds per batch; the next batch in flight

// the bins of F neighbouring features of one row: F = 4 is one aligned
// 32-bit load of int8 bins (16 bytes of int32), unpacked where used
template <typename BinT, int F> struct Bins;
template <> struct Bins<int8_t, 4> {
  uint32_t w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ int get(int j) const {
    return (int)(int8_t)(w >> (8 * j));
  }
};
template <> struct Bins<int32_t, 4> {
  int4 w;
  __device__ __forceinline__ void load(const int32_t* p) {
    w = *reinterpret_cast<const int4*>(p);
  }
  __device__ __forceinline__ int get(int j) const {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};
template <typename BinT> struct Bins<BinT, 1> {
  int w;
  __device__ __forceinline__ void load(const BinT* p) { w = (int)*p; }
  __device__ __forceinline__ int get(int) const { return w; }
};

// a row's loads, kept raw until the row's turn, so that no instruction
// waits for them while the batch before is added
template <typename BinT, int M, int F>
struct Row {
  Bins<BinT, F> x;
  float v[M + 1];
};

template <typename BinT, int M, int F>
__global__ void piece_kernel(const BinT* __restrict__ Xb,
                             const float* __restrict__ G,
                             const float* __restrict__ H,
                             const int32_t* __restrict__ order,
                             const int32_t* __restrict__ seg,
                             const int32_t* __restrict__ first,
                             const int32_t* __restrict__ slot, Planes o,
                             int n, int d, int n_nodes, int n_bins, int lanes,
                             int piece_rows) {
  extern __shared__ float sm[];
  const int p = blockIdx.x;
  const int64_t sb = (int64_t)p * (n_nodes + 1);
  const int32_t* fp = first + sb;
  const int total = fp[n_nodes];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // one bin of one lane: its M + 1 channels' cells of the F features of
  // every thread; n_bins bins and a trash bin that takes the adds of
  // dropped bin ids and of features past d, so that every row's update is
  // the same straight-line code
  constexpr int CH = F * WARP;         // a channel's offset in a bin
  constexpr int BIN = (M + 1) * CH;    // a bin's
  const int lane_size = (n_bins + 1) * BIN;
  const int tid = ty * WARP + tx;
  const int nthreads = WARP * lanes;
  const int f = blockIdx.z * WARP * F + tx * F;
  const bool active = f < d;
  const int my = ty * lane_size + tx;  // this thread's cells: my + k * WARP
  const BinT* xf = Xb + f;
  const int32_t* ord = order + (int64_t)p * n;
  const float* Gp = G + (int64_t)p * o.g_ch * n;
  const float* Hp = H + (int64_t)p * o.h_ch * n;
  const int64_t plane = (int64_t)d * n_bins;

  auto fetch = [&](Row<BinT, M, F>& w, int r) {
    if (active) w.x.load(xf + (int64_t)r * d);
#pragma unroll
    for (int c = 0; c < M; ++c) w.v[c] = Gp[(int64_t)c * n + r];
    w.v[M] = Hp[r];
  };
  // a row into this lane's histograms in two halves of its F features,
  // read (`take`) and then written (`put`). The halves' cells are
  // distinct, so a row's reads of one half may go out while the row
  // before writes the other: the latency of shared memory overlaps, and
  // every cell still sees its rows in order
  constexpr int HALF = (F + 1) / 2;
  int idx[F];
  float old[F][M + 1];
  auto take = [&](const Row<BinT, M, F>& w, int half) {
#pragma unroll
    for (int jj = half * HALF; jj < min(F, (half + 1) * HALF); ++jj) {
      const int b = w.x.get(jj);
      const bool ok = active && (unsigned)b < (unsigned)n_bins;  // else trash
      idx[jj] = my + (ok ? b : n_bins) * BIN + jj * WARP;
#pragma unroll
      for (int c = 0; c <= M; ++c) old[jj][c] = sm[idx[jj] + c * CH];
    }
  };
  auto put = [&](const Row<BinT, M, F>& w, int half) {
#pragma unroll
    for (int jj = half * HALF; jj < min(F, (half + 1) * HALF); ++jj)
#pragma unroll
      for (int c = 0; c <= M; ++c)
        sm[idx[jj] + c * CH] = old[jj][c] + w.v[c];
  };

  for (int q = blockIdx.y; q < total; q += gridDim.y) {
    const int k = piece_node(fp, n_nodes, q);
    const int j = q - fp[k];
    const int pieces = fp[k + 1] - fp[k];
    const int s0 = seg[sb + k] + j * piece_rows;
    const int s1 = min(s0 + piece_rows, seg[sb + k + 1]);
    {
      float4* s4 = reinterpret_cast<float4*>(sm);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = tid; i < (lanes * lane_size) >> 2; i += nthreads)
        s4[i] = z;
    }
    __syncthreads();

    // lane ty adds rows i0, i0 + lanes, ... of the piece in order, U at a
    // time, while the next U rows' bins and values (and, through `order`,
    // the row ids of the U after them) are in flight; the loads are kept
    // raw until the row's turn, so no instruction waits for them early
    const int i0 = s0 + ty;
    const int rows = s1 > i0 ? (s1 - i0 + lanes - 1) / lanes : 0;
    const int full = rows - rows % U;
    auto row_id = [&](int t) { return ord[i0 + t * lanes]; };
    Row<BinT, M, F> nxt[U];
    int ahead[U];
    if (full > 0) {
      int rr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rr[u] = row_id(u);
#pragma unroll
      for (int u = 0; u < U; ++u) fetch(nxt[u], rr[u]);
      if (full > U) {
#pragma unroll
        for (int u = 0; u < U; ++u) ahead[u] = row_id(U + u);
      }
    }
    int t = 0;
    for (; t < full; t += U) {
      Row<BinT, M, F> cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
      if (t + U < full) {
#pragma unroll
        for (int u = 0; u < U; ++u) fetch(nxt[u], ahead[u]);
        if (t + 2 * U < full) {
#pragma unroll
          for (int u = 0; u < U; ++u) ahead[u] = row_id(t + 2 * U + u);
        }
      }
      take(cur[0], 0);
      take(cur[0], 1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        put(cur[u], 0);
        if (u + 1 < U) take(cur[u + 1], 0);
        put(cur[u], 1);
        if (u + 1 < U) take(cur[u + 1], 1);
      }
    }
    for (; t < rows; ++t) {
      Row<BinT, M, F> w;
      fetch(w, row_id(t));
      take(w, 0);
      take(w, 1);
      put(w, 0);
      put(w, 1);
    }
    __syncthreads();

    // lanes summed in lane order; four bins a store where n_bins % 4 == 0
    const bool multi = pieces > 1;
    const int64_t sl = multi ? (int64_t)slot[sb + k] + j : 0;
    const bool vec_out = (n_bins & 3) == 0;
    const int per_f = vec_out ? n_bins >> 2 : n_bins;
    const int per_c = F * per_f;
    for (int it = ty; it < (M + 1) * per_c; it += lanes) {
      const int c = it / per_c;
      const int rem = it - c * per_c;
      const int jj = rem / per_f;
      const int bq = rem - jj * per_f;
      const int fo = f + jj;
      if (fo >= d) continue;
      float* dst = (multi ? slot_plane(o, p, sl, c, M + 1, plane)
                          : out_plane<M>(o, p, c, k, n_nodes, plane)) +
                   (int64_t)fo * n_bins;
      const float* src = sm + c * CH + jj * WARP + tx;
      if (vec_out) {
        float acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bb = bq * 4 + e;
          float s = 0.f;
          for (int l = 0; l < lanes; ++l)
            s += src[l * lane_size + bb * BIN];
          acc[e] = s;
        }
        *reinterpret_cast<float4*>(dst + bq * 4) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        float s = 0.f;
        for (int l = 0; l < lanes; ++l)
          s += src[l * lane_size + bq * BIN];
        dst[bq] = s;
      }
    }
    __syncthreads();  // the next piece zeroes the histograms
  }
}

// --------------------------------------------------------------------------
// 3. the pieces of a node summed in piece order
// --------------------------------------------------------------------------
template <int M>
__global__ void reduce_kernel(const int32_t* __restrict__ first,
                              const int32_t* __restrict__ slot, Planes o,
                              int d, int n_nodes, int n_bins) {
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  const int64_t sb = (int64_t)p * (n_nodes + 1);
  const int pieces = first[sb + k + 1] - first[sb + k];
  if (pieces <= 1) return;
  const int64_t s0 = slot[sb + k];
  const int64_t plane = (int64_t)d * n_bins;
  const int64_t total = (M + 1) * plane;
  const int64_t step = (int64_t)gridDim.x * REDUCE_THREADS;
  for (int64_t e = (int64_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
       e < total; e += step) {
    const int c = (int)(e / plane);
    const int64_t off = e - c * plane;
    float t = 0.f;
    for (int j = 0; j < pieces; ++j)
      t += slot_plane(o, p, s0 + j, c, M + 1, plane)[off];
    out_plane<M>(o, p, c, k, n_nodes, plane)[off] = t;
  }
}

template <typename BinT, int M, int F>
int launch_piece_kernel(const BinT* xb, const float* g, const float* h,
                        const int32_t* ord, const int32_t* sg,
                        const int32_t* fi, const int32_t* sl,
                        const Planes& o, int P, int n,
                        int d, int n_nodes, int n_bins, int lanes,
                        int piece_rows, int piece_grid, cudaStream_t st) {
  const size_t smem =
      (size_t)lanes * (M + 1) * (n_bins + 1) * F * WARP * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        piece_kernel<BinT, M, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(P, piece_grid, (d + WARP * F - 1) / (WARP * F));
  piece_kernel<BinT, M, F><<<grid, dim3(WARP, lanes), smem, st>>>(
      xb, g, h, ord, sg, fi, sl, o, n, d, n_nodes, n_bins, lanes,
      piece_rows);
  return (int)cudaGetLastError();
}

// F = 4 needs d % 4 == 0 and aligned rows (the wrapper checks)
template <typename BinT, int M>
int launch_pieces(const BinT* xb, const float* g, const float* h,
                  const int32_t* ord, const int32_t* sg, const int32_t* fi,
                  const int32_t* sl, const Planes& o, int P, int n, int d,
                  int n_nodes, int n_bins, int lanes, int features,
                  int piece_rows, int piece_grid, cudaStream_t st) {
  return (features == 4 ? launch_piece_kernel<BinT, M, 4>
                        : launch_piece_kernel<BinT, M, 1>)(
      xb, g, h, ord, sg, fi, sl, o, P, n, d, n_nodes, n_bins, lanes,
      piece_rows, piece_grid, st);
}

template <typename BinT, int M>
int launch(const void* Xb, const void* G, const void* H, const void* order,
           const void* seg, void* first, void* slot,
           void* hg, void* hh, void* scratch,
           int64_t n_slots, int P, int n, int d, int n_nodes, int n_bins,
           int lanes, int features, int piece_rows, int few, int piece_grid,
           int g_ch, int h_ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g_ch < M || h_ch < 1) return (int)cudaErrorInvalidValue;
  Planes o{static_cast<float*>(hg), static_cast<float*>(hh),
           static_cast<float*>(scratch), n_slots, g_ch, h_ch};
  const BinT* xb = static_cast<const BinT*>(Xb);
  const float* g = static_cast<const float*>(G);
  const float* h = static_cast<const float*>(H);
  const int32_t* ord = static_cast<const int32_t*>(order);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  int32_t* fi = static_cast<int32_t*>(first);
  int32_t* sl = static_cast<int32_t*>(slot);
  const int64_t plane = (int64_t)d * n_bins;
  if (few > FEW_MAX) return (int)cudaErrorInvalidValue;
  if (piece_grid > 0) {
    plan_kernel<<<P, PLAN_THREADS, 0, st>>>(sg, fi, sl, n_nodes, piece_rows,
                                            few);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  {
    const bool vec4 = (n_bins & 3) == 0;
    const int64_t items = vec4 ? plane >> 2 : plane;
    const int64_t per_block = (int64_t)FEW_THREADS * FEW_GROUPS;
    const unsigned cx = (unsigned)((items + per_block - 1) / per_block);
    dim3 grid(cx, n_nodes, P);
    if (vec4)
      few_kernel<BinT, M, true><<<grid, FEW_THREADS, 0, st>>>(
          xb, g, h, ord, sg, o, n, d, n_nodes, n_bins, few);
    else
      few_kernel<BinT, M, false><<<grid, FEW_THREADS, 0, st>>>(
          xb, g, h, ord, sg, o, n, d, n_nodes, n_bins, few);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (piece_grid > 0) {
    const int err = launch_pieces<BinT, M>(
        xb, g, h, ord, sg, fi, sl, o, P, n, d, n_nodes, n_bins, lanes,
        features, piece_rows, piece_grid, st);
    if (err != (int)cudaSuccess) return err;
  }
  if (n_slots > 0) {
    const int64_t total = (M + 1) * plane;
    const int64_t blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
    const unsigned cx = (unsigned)(blocks < 64 ? blocks : 64);
    dim3 grid(cx, n_nodes, P);
    reduce_kernel<M><<<grid, REDUCE_THREADS, 0, st>>>(fi, sl, o, d, n_nodes,
                                                      n_bins);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename BinT>
int launch_m(const void* Xb, const void* G, const void* H, const void* order,
             const void* seg, void* first, void* slot,
             void* hg, void* hh, void* scratch,
             int64_t n_slots, int P, int n, int d, int n_nodes, int n_bins,
             int m, int lanes, int features, int piece_rows, int few,
             int piece_grid, int g_ch, int h_ch, void* stream) {
#define HISTOGRAMS_CASE(M_)                                                  \
  case M_:                                                                   \
    return launch<BinT, M_>(Xb, G, H, order, seg, first, slot, hg, hh,       \
                            scratch, n_slots, P, n, d, n_nodes, n_bins,      \
                            lanes, features, piece_rows, few, piece_grid,  \
                            g_ch, h_ch, stream);
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
extern "C" int histograms_max_few() { return FEW_MAX; }

extern "C" int histograms_i8(const void* Xb, const void* G, const void* H,
                             const void* order, const void* seg,
                             void* first, void* slot, void* hg, void* hh,
                             void* scratch, int64_t n_slots, int P, int n,
                             int d, int n_nodes, int n_bins, int m, int lanes,
                             int features, int piece_rows, int few,
                             int piece_grid, int g_ch, int h_ch,
                             void* stream) {
  return launch_m<int8_t>(Xb, G, H, order, seg, first, slot, hg, hh,
                          scratch, n_slots, P, n, d, n_nodes, n_bins, m,
                          lanes, features, piece_rows, few, piece_grid, g_ch,
                          h_ch, stream);
}

extern "C" int histograms_i32(const void* Xb, const void* G, const void* H,
                              const void* order, const void* seg,
                              void* first, void* slot, void* hg, void* hh,
                              void* scratch, int64_t n_slots, int P, int n,
                              int d, int n_nodes, int n_bins, int m,
                              int lanes, int features, int piece_rows,
                              int few, int piece_grid, int g_ch, int h_ch,
                              void* stream) {
  return launch_m<int32_t>(Xb, G, H, order, seg, first, slot, hg, hh,
                           scratch, n_slots, P, n, d, n_nodes, n_bins, m,
                           lanes, features, piece_rows, few, piece_grid, g_ch,
                           h_ch, stream);
}
