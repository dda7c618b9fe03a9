// K3: routing of rows down one level, and the leaf sums and leaf formula,
// for P trees at once.
//
// Replaces the routing and leaf steps of `grow_tree` in
// transmogrifai_tpu/models/trees.py:271-293 (`_table_lookup2` :307 and
// `_select_bin` :78; the chunked leaf sums of
// transmogrifai_tpu/parallel/bigdata.py:1061). On the TPU every table read
// and the per-row feature pick are one-hot compare-and-sum passes over the
// node table and over all d features, and the leaf sums are a scatter-add.
// On Hopper they are direct gathers.
//
// route_level, out of place:
//   node_out[p, r] = 2 * k + (Xb[r, feat[p, k]] > bin[p, k]),  k = node_in[p, r]
// and, with `occupied`, occupied[p, node_out[p, r]] = 1: the next level's
// live set for K2 (every writer stores the same byte, so the order of the
// stores does not matter; the caller zeroes the flags). A bin of n_bins
// never fires, so a node that did not split sends every row left. The
// split tables are read in place through a row stride (a level's row of
// the learner's (P, depth, 2^depth) tables). Row-major over pairs: a block
// copies a tile of R consecutive rows of Xb (contiguous bytes) into shared
// memory with 16-byte loads, then its threads route every (row, pair) of
// the tile from there, rows fastest (the node ids' reads and writes
// coalesce), ROUTE_UNROLL items a thread at once. So each row of Xb comes
// from device memory once for all P learners: with 16 learners over
// millions of rows the bound is Xb's bytes, which pair-major order read as
// one 32-byte sector per (pair, row). The loads that need no tile (node
// ids, splits) are issued before the tile's are waited for. A few flags
// (P x 2 n_nodes <= 8 KB) are set in a shared copy of the card's, and a
// block stores only those the copy lacked: millions of rows set the same
// few bytes, which one store each would queue on a few L2 lines. R shrinks
// at small n so that the card has enough blocks; rows too wide for the
// tile (past 40 KB) take
// route_level_kernel instead: a row's S lanes (S a power of two, side by
// side in a warp) read their pairs' cells of the row straight from device
// memory, ROUTE_UNROLL pairs at once.
//
// The leaf pass: per (pair, leaf) the sum of H and of each of the m value
// channels G_c over the leaf's rows, then the XGBoost leaf formula per
// channel
//   g_c <- sign(g_c) * max(|g_c| - alpha, 0);   leaf_c = g_c / (h + lambda)
// (a forest's channels are its classes, with alpha = 0 and lambda = 1e-6).
// Every sum is one chain of f32 adds that starts at 0 and takes the leaf's
// rows in ascending row order: the same bits on every run, and the same
// f32 sequence as the row-order scatter-add (`index_add_` on the CPU), in
// both of the two designs below. No atomics.
//
// Bound on this card: bytes (routing reads the node ids and the rows'
// sectors of Xb once, and writes the node ids once; the leaf pass reads
// G, H and the node ids once); the old design, one thread per (pair, leaf) walking its segment
// m + 1 times through two dependent loads a row, ran at a few hundred
// times that at 16 x 64 leaves over 4.46M rows, and most of its time at
// 802 rows went to sorting the rows by leaf first.
//
// - leaf_scan (few rows a pair, no sort): a warp per (pair, 32 leaves),
//   lane l owning leaf 32 g + l. The warp reads the pair's node ids 32 at a
//   time (four groups of 32 in flight), asks with one ballot which of them
//   fall in its 32 leaves, loads those rows' values, and hands each such
//   row, in row order, to every lane with shuffles; the owning lane adds it.
//   The work is n / 32 ballots plus one step per row of the warp's leaves.
// - leaf_segments (many rows a pair): the caller groups the rows by leaf in
//   stable row order (`order`, `seg`, as for K1). A warp per (pair, leaf)
//   loads the next 128 `order` entries and all m + 1 channels' values of
//   those rows in coalesced steps (the segment is read once, not m + 1
//   times), stages them in shared memory, and lanes 0..m each run one
//   channel's chain over them; the next 128 rows' loads are issued before
//   the chains run, so memory latency overlaps the dependent adds.
//
// lambda and alpha come per pair (pointers) or as one value each (a null
// pointer and the value), so a scalar hyperparameter needs no tensor.
//
// C interface for ctypes: each entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int WARPS = THREADS / WARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_M = 4;
constexpr int SCAN_AHEAD = 4;   // groups of 32 node ids a scan warp loads
constexpr int SEG_STEP = 128;   // rows a segment warp stages at once

constexpr int ROUTE_UNROLL = 8;  // (row, pair) items a thread routes at once

constexpr int ROUTE_TILE_BYTES = 40 * 1024;  // a tile's rows of Xb
constexpr int ROUTE_TILE_ROWS = 128;
constexpr int STAGE_UNROLL = 12;  // 16-byte loads a thread has in flight
// flag bytes (P x 2 n_nodes) up to which a block sets them in a shared copy
constexpr int ROUTE_FLAG_SNAP = 8 * 1024;

// a block per tile of R rows; rows staged in shared memory. The loads
// that do not need the tile (each item's node id and split, the flags'
// copy) are issued before the tile's loads are waited for.
template <typename BinT>
__global__ void __launch_bounds__(THREADS)
    route_tile_kernel(const BinT* __restrict__ Xb,
                      const int32_t* __restrict__ feat,
                      const int32_t* __restrict__ bins, int64_t table_stride,
                      const int32_t* __restrict__ node_in,
                      int32_t* __restrict__ node_out,
                      uint8_t* __restrict__ occupied, int64_t occ_stride,
                      int P, int n, int d, int n_nodes, int R,
                      int tile_bytes) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int rows = n - r0 < R ? (int)(n - r0) : R;
  const int items = rows * P;  // item i: pair i / rows, row r0 + i % rows
  int k[ROUTE_UNROLL], f[ROUTE_UNROLL], b[ROUTE_UNROLL];
  auto fetch_nodes = [&](int i0) {
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      const int p = i / rows, r = i - p * rows;
      k[u] = i < items ? __ldg(node_in + (int64_t)p * n + r0 + r) : 0;
    }
  };
  auto fetch_splits = [&](int i0) {
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      const int64_t t = (int64_t)(i / rows) * table_stride + k[u];
      f[u] = i < items ? __ldg(feat + t) : 0;
      b[u] = i < items ? __ldg(bins + t) : 0;
    }
  };
  fetch_nodes(threadIdx.x);
  // the tile's bytes of Xb go to tile + shift (shift: the global start's
  // offset within 16 bytes), so global and shared 16-byte words align:
  // 16-byte copies over the middle, single bytes at the ragged ends
  const unsigned char* src = reinterpret_cast<const unsigned char*>(Xb) +
                             r0 * d * (int64_t)sizeof(BinT);
  const int64_t bytes = (int64_t)rows * d * (int64_t)sizeof(BinT);
  const int shift = (int)((uintptr_t)src & 15);
  const int head = bytes < ((16 - shift) & 15) ? (int)bytes
                                                : (16 - shift) & 15;
  const int64_t n16 = (bytes - head) / 16;
  unsigned char* dst = tile + shift;
  const uint4* src16 = reinterpret_cast<const uint4*>(src + head);
  uint4* dst16 = reinterpret_cast<uint4*>(dst + head);
  uint4 v[STAGE_UNROLL];
#pragma unroll
  for (int u = 0; u < STAGE_UNROLL; ++u)
    if (threadIdx.x + u * THREADS < n16)
      v[u] = __ldg(src16 + threadIdx.x + u * THREADS);
  fetch_splits(threadIdx.x);
  // the flags: with few of them, a shared copy of the card's (read from L2)
  // takes this block's sets, and only the flags the copy lacked are
  // stored, once a block (millions of rows set the same few bytes)
  const int W = 2 * n_nodes;
  unsigned char* snap = (occupied != nullptr && P * W <= ROUTE_FLAG_SNAP)
                            ? tile + tile_bytes
                            : nullptr;
  if (snap != nullptr)
    for (int j = threadIdx.x; j < P * W; j += THREADS) {
      const int p = j / W;
      snap[j] = __ldcg(occupied + (int64_t)p * occ_stride + (j - p * W));
    }
#pragma unroll
  for (int u = 0; u < STAGE_UNROLL; ++u)
    if (threadIdx.x + u * THREADS < n16)
      dst16[threadIdx.x + u * THREADS] = v[u];
  for (int64_t i = threadIdx.x + STAGE_UNROLL * THREADS; i < n16;
       i += THREADS)
    dst16[i] = __ldg(src16 + i);
  for (int i = threadIdx.x; i < head; i += THREADS) dst[i] = src[i];
  for (int64_t i = head + 16 * n16 + threadIdx.x; i < bytes; i += THREADS)
    dst[i] = src[i];
  __syncthreads();
  const BinT* xs = reinterpret_cast<const BinT*>(dst);
  for (int i0 = threadIdx.x; i0 < items; i0 += THREADS * ROUTE_UNROLL) {
    if (i0 != (int)threadIdx.x) {
      fetch_nodes(i0);
      fetch_splits(i0);
    }
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < items) {
        const int p = i / rows, r = i - p * rows;
        const int x = (int)xs[(int64_t)r * d + f[u]];
        const int child = 2 * k[u] + (x > b[u] ? 1 : 0);
        node_out[(int64_t)p * n + r0 + r] = child;
        if (snap != nullptr) {
          if (snap[p * W + child] == 0) snap[p * W + child] = 2;  // new
        } else if (occupied != nullptr) {
          occupied[(int64_t)p * occ_stride + child] = 1;
        }
      }
    }
  }
  if (snap != nullptr) {
    __syncthreads();
    for (int j = threadIdx.x; j < P * W; j += THREADS)
      if (snap[j] == 2) {
        const int p = j / W;
        occupied[(int64_t)p * occ_stride + (j - p * W)] = 1;
      }
  }
}

template <typename BinT>
__global__ void route_level_kernel(const BinT* __restrict__ Xb,
                                   const int32_t* __restrict__ feat,
                                   const int32_t* __restrict__ bins,
                                   int64_t table_stride,
                                   const int32_t* __restrict__ node_in,
                                   int32_t* __restrict__ node_out,
                                   uint8_t* __restrict__ occupied,
                                   int64_t occ_stride, int P, int n, int d,
                                   int log_s) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t r = i >> log_s;
  const int j = (int)(i & ((1 << log_s) - 1));
  if (r >= n) return;
  const int S = 1 << log_s;
  const BinT* xr = Xb + r * d;
  for (int p0 = j; p0 < P; p0 += S * ROUTE_UNROLL) {
    int k[ROUTE_UNROLL], f[ROUTE_UNROLL], b[ROUTE_UNROLL], x[ROUTE_UNROLL];
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int p = p0 + u * S;
      k[u] = p < P ? __ldg(node_in + (int64_t)p * n + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int p = p0 + u * S;
      const int64_t t = (int64_t)p * table_stride + k[u];
      f[u] = p < P ? __ldg(feat + t) : 0;
      b[u] = p < P ? __ldg(bins + t) : 0;
    }
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int p = p0 + u * S;
      x[u] = p < P ? (int)__ldg(xr + f[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < ROUTE_UNROLL; ++u) {
      const int p = p0 + u * S;
      if (p < P) {
        const int child = 2 * k[u] + (x[u] > b[u] ? 1 : 0);
        node_out[(int64_t)p * n + r] = child;
        if (occupied != nullptr)
          occupied[(int64_t)p * occ_stride + child] = 1;
      }
    }
  }
}

struct LeafParams {
  const float* lam;
  float lam_v;
  const float* alpha;
  float alpha_v;
};

// the leaf formula of channel sums g (per channel) and weight sum h
template <int M>
__device__ __forceinline__ void write_leaf(const float (&acc)[M + 1],
                                           const LeafParams& lp, int p,
                                           float* __restrict__ out) {
  const float lam = lp.lam ? lp.lam[p] : lp.lam_v;
  const float alpha = lp.alpha ? lp.alpha[p] : lp.alpha_v;
  const float h = acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    float g = acc[c];
    const float sgn = g > 0.f ? 1.f : (g < 0.f ? -1.f : 0.f);
    g = sgn * fmaxf(fabsf(g) - alpha, 0.f);
    out[c] = g / (h + lam);
  }
}

// a warp per (pair, 32 leaves), no sort
template <int M>
__global__ void leaf_scan_kernel(const float* __restrict__ G,
                                 const float* __restrict__ H,
                                 const int32_t* __restrict__ node,
                                 LeafParams lp, float* __restrict__ leaf,
                                 int P, int n, int n_leaves) {
  const int64_t w = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int groups = (n_leaves + WARP - 1) / WARP;
  if (w >= (int64_t)P * groups) return;
  const int p = (int)(w / groups);
  const int l0 = (int)(w - (int64_t)p * groups) * WARP;
  const int mine = l0 + lane;
  const int32_t* nd = node + (int64_t)p * n;
  const float* Gp = G + (int64_t)p * M * n;
  const float* Hp = H + (int64_t)p * n;
  float acc[M + 1];
#pragma unroll
  for (int c = 0; c <= M; ++c) acc[c] = 0.f;
  for (int r0 = 0; r0 < n; r0 += SCAN_AHEAD * WARP) {
    int k[SCAN_AHEAD];
#pragma unroll
    for (int a = 0; a < SCAN_AHEAD; ++a) {
      const int r = r0 + a * WARP + lane;
      k[a] = r < n ? nd[r] : -1;
    }
#pragma unroll
    for (int a = 0; a < SCAN_AHEAD; ++a) {
      const int r = r0 + a * WARP + lane;
      const bool in = (unsigned)(k[a] - l0) < (unsigned)WARP;
      unsigned hit = __ballot_sync(FULL, in);
      if (!hit) continue;
      float v[M + 1];
#pragma unroll
      for (int c = 0; c < M; ++c) v[c] = in ? Gp[(int64_t)c * n + r] : 0.f;
      v[M] = in ? Hp[r] : 0.f;
      while (hit) {  // the hits in row order
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        const int ks = __shfl_sync(FULL, k[a], src);
#pragma unroll
        for (int c = 0; c <= M; ++c) {
          const float vs = __shfl_sync(FULL, v[c], src);
          if (ks == mine) acc[c] += vs;
        }
      }
    }
  }
  if (mine < n_leaves)
    write_leaf<M>(acc, lp, p, leaf + ((int64_t)p * n_leaves + mine) * M);
}

// a warp per (pair, leaf) over the leaf's segment of `order`
template <int M>
__global__ void leaf_segments_kernel(const float* __restrict__ G,
                                     const float* __restrict__ H,
                                     const int32_t* __restrict__ order,
                                     const int32_t* __restrict__ seg,
                                     LeafParams lp, float* __restrict__ leaf,
                                     int P, int n, int n_leaves) {
  // one channel's staged values a row of the buffer; +1 spreads the
  // channels over banks, since lanes 0..M read one channel each
  __shared__ float buf[WARPS][M + 1][SEG_STEP + 1];
  const int wl = threadIdx.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t w = (int64_t)blockIdx.x * WARPS + wl;
  if (w >= (int64_t)P * n_leaves) return;
  const int p = (int)(w / n_leaves);
  const int k = (int)(w - (int64_t)p * n_leaves);
  const int64_t sb = (int64_t)p * (n_leaves + 1);
  const int s0 = seg[sb + k];
  const int s1 = seg[sb + k + 1];
  const int32_t* ord = order + (int64_t)p * n;
  const float* Gp = G + (int64_t)p * M * n;
  const float* Hp = H + (int64_t)p * n;
  constexpr int PER = SEG_STEP / WARP;
  float v[PER][M + 1];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = base + u * WARP + lane;
      const int r = i < s1 ? ord[i] : -1;
#pragma unroll
      for (int c = 0; c < M; ++c)
        v[u][c] = r >= 0 ? Gp[(int64_t)c * n + r] : 0.f;
      v[u][M] = r >= 0 ? Hp[r] : 0.f;
    }
  };
  float acc = 0.f;  // lane c <= M: channel c's chain
  const int ch = lane <= M ? lane : M;
  if (s0 < s1) load(s0);
  for (int base = s0; base < s1; base += SEG_STEP) {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PER; ++u)
#pragma unroll
      for (int c = 0; c <= M; ++c) buf[wl][c][u * WARP + lane] = v[u][c];
    __syncwarp();
    if (base + SEG_STEP < s1) load(base + SEG_STEP);  // in flight meanwhile
    const int cnt = min(SEG_STEP, s1 - base);
    if (lane <= M) {
      const float* b = buf[wl][ch];
      if (cnt == SEG_STEP) {
#pragma unroll 16
        for (int t = 0; t < SEG_STEP; ++t) acc += b[t];
      } else {
        for (int t = 0; t < cnt; ++t) acc += b[t];
      }
    }
  }
  float sums[M + 1];
#pragma unroll
  for (int c = 0; c <= M; ++c) sums[c] = __shfl_sync(FULL, acc, c);
  if (lane == 0)
    write_leaf<M>(sums, lp, p, leaf + ((int64_t)p * n_leaves + k) * M);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename BinT>
int launch_route(const void* Xb, const void* feat, const void* bins,
                 int64_t table_stride, const void* node_in, void* node_out,
                 void* occupied, int64_t occ_stride, int P, int n, int d,
                 int n_nodes, void* stream) {
  if (P <= 0 || n <= 0) return 0;
  const int64_t row_bytes = (int64_t)d * sizeof(BinT);
  const int64_t fit = (ROUTE_TILE_BYTES - 16) / row_bytes;
  const int max_rows = fit < ROUTE_TILE_ROWS ? (int)fit : ROUTE_TILE_ROWS;
  if (max_rows >= 4) {
    // tiles of R rows: two a SM at small n, else as many rows as fit
    const int64_t two = 2 * (int64_t)sm_count();
    int R = (int)((n + two - 1) / two);
    R = (R + 3) / 4 * 4;
    if (R > max_rows) R = max_rows;
    if (R < 4) R = 4;
    const unsigned blocks = (unsigned)((n + R - 1) / R);
    const int tile_bytes = (int)((R * row_bytes + 16 + 15) / 16 * 16);
    const int64_t flags = (int64_t)P * 2 * n_nodes;
    const size_t smem =
        tile_bytes + (occupied != nullptr && flags <= ROUTE_FLAG_SNAP
                          ? (size_t)flags
                          : 0);
    route_tile_kernel<BinT><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const BinT*>(Xb), static_cast<const int32_t*>(feat),
        static_cast<const int32_t*>(bins), table_stride,
        static_cast<const int32_t*>(node_in), static_cast<int32_t*>(node_out),
        static_cast<uint8_t*>(occupied), occ_stride, P, n, d, n_nodes, R,
        tile_bytes);
    return (int)cudaGetLastError();
  }
  // lanes a row: the least power of two with S * ROUTE_UNROLL >= P
  int log_s = 0;
  while ((ROUTE_UNROLL << log_s) < P && log_s < 5) ++log_s;
  const int64_t total = (int64_t)n << log_s;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  route_level_kernel<BinT><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const BinT*>(Xb), static_cast<const int32_t*>(feat),
      static_cast<const int32_t*>(bins), table_stride,
      static_cast<const int32_t*>(node_in), static_cast<int32_t*>(node_out),
      static_cast<uint8_t*>(occupied), occ_stride, P, n, d, log_s);
  return (int)cudaGetLastError();
}

template <int M>
int launch_leaves(const float* G, const float* H, const int32_t* node,
                  const int32_t* order, const int32_t* seg, LeafParams lp,
                  float* leaf, int P, int n, int n_leaves,
                  cudaStream_t stream) {
  if (order == nullptr) {
    const int64_t warps =
        (int64_t)P * ((n_leaves + WARP - 1) / WARP);
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    leaf_scan_kernel<M><<<blocks, THREADS, 0, stream>>>(G, H, node, lp, leaf,
                                                        P, n, n_leaves);
  } else {
    const int64_t warps = (int64_t)P * n_leaves;
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    leaf_segments_kernel<M><<<blocks, THREADS, 0, stream>>>(
        G, H, order, seg, lp, leaf, P, n, n_leaves);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Xb (n, d); feat, bins (P, >= n_nodes) int32 with row stride
// table_stride; node_in, node_out (P, n) int32; occupied (P, >= 2 n_nodes)
// uint8 with row stride occ_stride, or null
extern "C" int route_level_i8(const void* Xb, const void* feat,
                              const void* bins, int64_t table_stride,
                              const void* node_in, void* node_out,
                              void* occupied, int64_t occ_stride, int P,
                              int n, int d, int n_nodes, void* stream) {
  return launch_route<int8_t>(Xb, feat, bins, table_stride, node_in,
                              node_out, occupied, occ_stride, P, n, d,
                              n_nodes, stream);
}

extern "C" int route_level_i32(const void* Xb, const void* feat,
                               const void* bins, int64_t table_stride,
                               const void* node_in, void* node_out,
                               void* occupied, int64_t occ_stride, int P,
                               int n, int d, int n_nodes, void* stream) {
  return launch_route<int32_t>(Xb, feat, bins, table_stride, node_in,
                               node_out, occupied, occ_stride, P, n, d,
                               n_nodes, stream);
}

extern "C" int leaf_values_max_m() { return MAX_M; }

// `order` null: the scan design over `node`; else the segment design over
// `order` and `seg`
extern "C" int leaf_values(const void* G, const void* H, const void* node,
                           const void* order, const void* seg,
                           const void* lam, float lam_v, const void* alpha,
                           float alpha_v, void* leaf, int P, int n,
                           int n_leaves, int m, void* stream) {
  const LeafParams lp{static_cast<const float*>(lam), lam_v,
                      static_cast<const float*>(alpha), alpha_v};
  const float* g = static_cast<const float*>(G);
  const float* h = static_cast<const float*>(H);
  const int32_t* nd = static_cast<const int32_t*>(node);
  const int32_t* ord = static_cast<const int32_t*>(order);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  float* out = static_cast<float*>(leaf);
  cudaStream_t st = (cudaStream_t)stream;
#define LEAF_CASE(M_)                                                    \
  case M_:                                                               \
    return launch_leaves<M_>(g, h, nd, ord, sg, lp, out, P, n, n_leaves, \
                             st);
  switch (m) {
    LEAF_CASE(1)
    LEAF_CASE(2)
    LEAF_CASE(3)
    LEAF_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LEAF_CASE
}
