// K2: the best split of every node of P trees, from K1's histograms of m
// value channels and one weight channel.
//
// Replaces `split_from_histograms` in transmogrifai_tpu/models/trees.py:170.
// For each (pair p, node k), over every feature f and split bin b:
//   left sums  cg_c = sum_{b' <= b} hist_G[c], ch likewise (running sums)
//   totals     tg_c, th = the running sums at the last bin
//   score      S(g, h) = (g_0^2 + g_1^2 + ... + g_{m-1}^2) / (h + lambda),
//              the class terms added in channel order
//   gain       (S(cg, ch) + S(tg - cg, th - ch)) - S(tg, th)
//   valid      ch >= min_child_weight and th - ch >= min_child_weight and
//              the feature is in the pair's mask; invalid cells are -inf
// then the argmax over the flat (f * bins + b) axis with the FIRST index
// winning ties and a NaN gain counting as the largest (jnp.argmax and
// torch.argmax), and the threshold: the node splits only if the best gain
// > maximum(min_gain, min_gain_norm * th of feature 0) (NaN if either is)
// and level < active_depth; otherwise its bin is n_bins ("no split": every
// row goes left). Boosting has m = 1 (XGBoost's G^2 / (H + lambda)); a
// forest has one channel per class, which makes the score the Gini gain.
//
// Rounding: every operation is a separate IEEE f32 add, multiply or
// divide, in the order written above and in the plain PyTorch version
// (the running sums are sequential over bins in both). The file is built
// with --fmad=false so no multiply-add is contracted, so the kernel and
// the plain version compute the same bits from the same histograms, and a
// near-tie resolves the same way in both. A shuffle scan would change the
// order of the running sums; each lane runs its feature's sums alone.
//
// The live set. Deep levels hold few rows: at level 11 of a depth-12
// forest over 802 rows about 20 of a tree's 2048 nodes hold any. A node
// outside the pair's live set (`live`, one byte a node, written on the
// card by K3's routing and by this kernel's `mark`) has an all-zero
// histogram, and every such node gets the result of one search of a
// virtual all-zero histogram per pair: the same device code on zeros, so
// lambda = 0 (0/0 = NaN), min_child_weight <= 0, the feature mask and
// min_gain_norm act on it as on a real empty node. With `mark`, each
// searched node j sets mark[2 j] (its left child's flag at the next level:
// on the subtraction path a left child is parent - right, which can carry
// a rounding residue without rows). With no `live`, every node is searched.
//
// Design: a block per (pair, node), several nodes a block: blockIdx.y is
// the pair, and block x of G takes the pair's nodes x, x + G, x + 2G, ...
// that are live (one ballot a warp compacts them into a shared list), so a
// grid sized from the SM count and the blocks an SM holds fills the card
// at 53 pairs x 20 live nodes and at 6 x 512 alike, and no count of live
// nodes reaches the host. Block x = G (only with `live`) runs the pair's
// zero search and writes its result into every node outside the live set. A node is
// searched in tiles of up to 128 features: the tile's (features x bins x
// (m + 1) channels) are copied to shared memory by cp.async, a warp a
// feature row at a time (128 contiguous bytes a warp instruction, every
// cell read from device memory once), into rows padded to an odd length
// (bank-conflict-free for the next step); then lane f runs feature f's two
// sequential passes (totals, then running sums and gains) from shared
// memory, keeping its best (gain, index) with the first-index rule. Warp
// shuffles and one shared step reduce the block's candidates by (gain,
// -index), a total order, so the result does not depend on the order of
// the reduction. Results go straight into the caller's tables through a
// row stride (the (P, depth, 2^depth) tables of the level-wise learner).
//
// Bound on this card: bytes, each live node's cells read once (the dense
// bound counts every node's). A feature outside the pair's mask (a
// forest's trees see floor(sqrt(d)) features) is neither read nor
// scanned: a block lists the pair's unmasked features once, and its tiles
// take 128 features of that list.
//
// Any m: m <= 4 channels take fixed instances (tg[M], cg[M] in registers);
// more take the any-m instance, which stages the channels four at a time
// and keeps every bin's running left and right sums of squares in shared
// memory, one row each a feature, so a tile holds the same 7 rows a
// feature whatever m is. The sums run over the channels in the same order,
// so the tables stay bit-equal to the plain version's.
//
// C interface for ctypes: the entry point launches on `stream` and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 4;   // channels of the fixed instances
constexpr int GROUP = 4;   // channels a staging round of the any-m search
constexpr unsigned FULL = 0xffffffffu;
// shared memory a block's tile may take; its features shrink for wide bins
constexpr int TILE_BYTES = 96 * 1024;

struct Params {
  const float* hg;
  const float* hh;
  const float* lam;
  const float* mcw;
  const float* min_gain;
  const float* min_gain_norm;
  const uint8_t* fmask;
  const int32_t* active_depth;
  const uint8_t* live;   // (P, n_nodes) flags, row stride live_stride
  uint8_t* mark;         // (P, 2 n_nodes) flags, row stride mark_stride
  int32_t* out_feat;     // (P, n_nodes), row stride out_stride
  int32_t* out_bin;
  int64_t live_stride, mark_stride, out_stride;
  int level, n_nodes, d, n_bins, m, G, tile_f, row;
};

// rows of a feature in a tile: the M + 1 channels, or (any m, M = 0) the
// GROUP channels of a round, the weights and the left and right class
// terms of every bin
template <int M>
__host__ __device__ constexpr int tile_rows() {
  return M > 0 ? M + 1 : GROUP + 3;
}

// (g, i) before (bg, bi): NaN first, then the larger gain, then the
// smaller index
__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  const bool gn = isnan(g), bn = isnan(bg);
  if (gn || bn) return gn && (!bn || i < bi);
  return g > bg || (g == bg && i < bi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// feature f's passes over its staged rows S[c] (c = 0..M, M the weights).
// A feature outside the mask has -inf gains at every bin, whose first
// index idx0 is its only candidate under the first-index rule; only its
// weight total may be needed (feature 0's, for the threshold).
template <int M>
__device__ __forceinline__ void scan_feature(const float* S, int chan,
                                             int n_bins, float L, float Wmin,
                                             bool fok, int idx0, float& best,
                                             int& best_i, float& th_out) {
  if (!fok) {
    if (idx0 == 0) {
      float th = 0.f;
      for (int b = 0; b < n_bins; ++b) th = th + S[M * chan + b];
      th_out = th;
    }
    if (better(-CUDART_INF_F, idx0, best, best_i)) {
      best = -CUDART_INF_F;
      best_i = idx0;
    }
    return;
  }
  float tg[M];
  float th = 0.f;
#pragma unroll
  for (int c = 0; c < M; ++c) tg[c] = 0.f;
#pragma unroll 4
  for (int b = 0; b < n_bins; ++b) {
#pragma unroll
    for (int c = 0; c < M; ++c) tg[c] = tg[c] + S[c * chan + b];
    th = th + S[M * chan + b];
  }
  th_out = th;
  float np_ = tg[0] * tg[0];
#pragma unroll
  for (int c = 1; c < M; ++c) np_ = np_ + tg[c] * tg[c];
  const float sp = np_ / (th + L);
  float cg[M];
  float ch = 0.f;
#pragma unroll
  for (int c = 0; c < M; ++c) cg[c] = 0.f;
#pragma unroll 4
  for (int b = 0; b < n_bins; ++b) {
#pragma unroll
    for (int c = 0; c < M; ++c) cg[c] = cg[c] + S[c * chan + b];
    ch = ch + S[M * chan + b];
    const float rh = th - ch;
    float gain = -CUDART_INF_F;
    if (ch >= Wmin && rh >= Wmin) {
      float nl = cg[0] * cg[0];
      const float r0 = tg[0] - cg[0];
      float nr = r0 * r0;
#pragma unroll
      for (int c = 1; c < M; ++c) {
        nl = nl + cg[c] * cg[c];
        const float rc = tg[c] - cg[c];
        nr = nr + rc * rc;
      }
      const float sl = nl / (ch + L);
      const float sr = nr / (rh + L);
      gain = (sl + sr) - sp;
    }
    if (better(gain, idx0 + b, best, best_i)) {
      best = gain;
      best_i = idx0 + b;
    }
  }
}

// the block's best candidate (thread 0 returns it): warp shuffles and one
// shared step by (gain, -index), a total order; then the threshold
__device__ __forceinline__ void pick_split(const Params& q, int p, float best,
                                           int best_i, float th0, int& out_f,
                                           int& out_b) {
  __shared__ float s_gain[WARPS];
  __shared__ int s_idx[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = q.n_bins;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_down_sync(FULL, best, o);
    const int oi = __shfl_down_sync(FULL, best_i, o);
    if (better(og, oi, best, best_i)) {
      best = og;
      best_i = oi;
    }
  }
  if (lane == 0) {
    s_gain[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w)
      if (better(s_gain[w], s_idx[w], best, best_i)) {
        best = s_gain[w];
        best_i = s_idx[w];
      }
    const float a = q.min_gain[p];
    const float b = q.min_gain_norm[p] * th0;
    const float thr = (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
    bool split = best > thr;
    if (q.active_depth != nullptr) split = split && q.level < q.active_depth[p];
    const int bi = best_i == 0x7fffffff ? 0 : best_i;
    out_f = bi / nb;
    out_b = split ? bi % nb : nb;
  }
}

// one node's search by the whole block; `zero`: of an all-zero histogram.
// The features searched are flist[0 .. n_feat) (every feature when flist
// is null): the pair's unmasked features and feature 0, whose weights give
// the node's total for the threshold (its values are not read when it is
// masked: a masked feature's only candidate is (-inf, its first index),
// and feature 0's, index 0, precedes every other). Thread 0 returns the
// split (feature, bin).
template <int M>
__device__ void search_node(const Params& q, float* smem,
                            const uint16_t* flist, int n_feat, bool fok0,
                            int p, int k, bool zero, int& out_f,
                            int& out_b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = q.n_bins, row = q.row;
  const int chan = q.tile_f * row;  // floats a channel's tile takes
  const int64_t cells = (int64_t)q.d * nb;
  const float L = q.lam[p];
  const float Wmin = q.mcw[p];
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  float th0 = 0.f;
  for (int t0 = 0; t0 < n_feat; t0 += q.tile_f) {
    const int nf = min(q.tile_f, n_feat - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int j = warp; j < nf; j += WARPS) {
      const int f = flist != nullptr ? flist[t0 + j] : t0 + j;
      for (int c = (f == 0 && !fok0) ? M : 0; c <= M; ++c) {
        const float* src =
            (c < M ? q.hg + (((int64_t)p * M + c) * q.n_nodes + k) * cells
                   : q.hh + ((int64_t)p * q.n_nodes + k) * cells) +
            (int64_t)f * nb;
        float* dst = smem + c * chan + j * row;
        for (int b = lane; b < nb; b += 32) {
          if (zero)
            dst[b] = 0.f;
          else
            cp_async4(dst + b, src + b);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < nf) {
      const int f = flist != nullptr ? flist[t0 + tid] : t0 + tid;
      float th;
      scan_feature<M>(smem + tid * row, chan, nb, L, Wmin, f != 0 || fok0,
                      f * nb, best, best_i, th);
      if (f == 0) th0 = th;  // thread 0: the node's weight by feature 0
    }
  }
  pick_split(q, p, best, best_i, th0, out_f, out_b);
}

// the same search for any m (M = 0): the channels are staged GROUP at a
// time into rows 0 .. GROUP - 1 of each feature, the weights once into
// row GROUP. Each round adds its channels' terms to every bin's left and
// right sums of squares (rows GROUP + 1 and GROUP + 2, the lane's own) and
// to the total's, in channel order; a last pass over the weights forms
// the gains. Every operation is the fixed instances' (and the plain
// version's), in the same order: the same bits.
__device__ void search_node_any(const Params& q, float* smem,
                                const uint16_t* flist, int n_feat, bool fok0,
                                int p, int k, bool zero, int& out_f,
                                int& out_b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = q.n_bins, row = q.row, m = q.m;
  const int chan = q.tile_f * row;
  const int64_t cells = (int64_t)q.d * nb;
  const float L = q.lam[p];
  const float Wmin = q.mcw[p];
  float* const Wt = smem + GROUP * chan;
  float* const NL = smem + (GROUP + 1) * chan + tid * row;
  float* const NR = smem + (GROUP + 2) * chan + tid * row;
  const float* hg = q.hg + (int64_t)p * m * q.n_nodes * cells;
  const float* hh = q.hh + ((int64_t)p * q.n_nodes + k) * cells;
  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  float th0 = 0.f;
  for (int t0 = 0; t0 < n_feat; t0 += q.tile_f) {
    const int nf = min(q.tile_f, n_feat - t0);
    const int f_me =
        tid < nf ? (flist != nullptr ? flist[t0 + tid] : t0 + tid) : 0;
    const bool fok = f_me != 0 || fok0;
    __syncthreads();  // the previous tile's readers are done
    for (int j = warp; j < nf; j += WARPS) {
      const int f = flist != nullptr ? flist[t0 + j] : t0 + j;
      const float* src = hh + (int64_t)f * nb;
      float* dst = Wt + j * row;
      for (int b = lane; b < nb; b += 32) {
        if (zero)
          dst[b] = 0.f;
        else
          cp_async4(dst + b, src + b);
      }
    }
    float np_ = 0.f;  // the total's class terms, in channel order
    for (int c0 = 0; c0 < m; c0 += GROUP) {
      const int gc = min(GROUP, m - c0);
      if (c0 > 0) __syncthreads();  // the last round's readers are done
      for (int j = warp; j < nf; j += WARPS) {
        const int f = flist != nullptr ? flist[t0 + j] : t0 + j;
        if (f == 0 && !fok0) continue;
        for (int c = 0; c < gc; ++c) {
          const float* src =
              hg + ((int64_t)(c0 + c) * q.n_nodes + k) * cells +
              (int64_t)f * nb;
          float* dst = smem + c * chan + j * row;
          for (int b = lane; b < nb; b += 32) {
            if (zero)
              dst[b] = 0.f;
            else
              cp_async4(dst + b, src + b);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (tid < nf && fok) {
        const float* S = smem + tid * row;
        float tg[GROUP];
#pragma unroll
        for (int c = 0; c < GROUP; ++c) tg[c] = 0.f;
        for (int b = 0; b < nb; ++b) {
#pragma unroll
          for (int c = 0; c < GROUP; ++c)
            if (c < gc) tg[c] = tg[c] + S[c * chan + b];
        }
#pragma unroll
        for (int c = 0; c < GROUP; ++c)
          if (c < gc) np_ = c0 + c == 0 ? tg[0] * tg[0] : np_ + tg[c] * tg[c];
        float cg[GROUP];
#pragma unroll
        for (int c = 0; c < GROUP; ++c) cg[c] = 0.f;
        for (int b = 0; b < nb; ++b) {
          float l = c0 == 0 ? 0.f : NL[b];
          float r = c0 == 0 ? 0.f : NR[b];
#pragma unroll
          for (int c = 0; c < GROUP; ++c) {
            if (c < gc) {
              cg[c] = cg[c] + S[c * chan + b];
              const float rc = tg[c] - cg[c];
              if (c0 + c == 0) {
                l = cg[0] * cg[0];
                r = rc * rc;
              } else {
                l = l + cg[c] * cg[c];
                r = r + rc * rc;
              }
            }
          }
          NL[b] = l;
          NR[b] = r;
        }
      }
    }
    if (tid < nf) {
      const float* Wr = Wt + tid * row;
      const int idx0 = f_me * nb;
      float th = 0.f;
      for (int b = 0; b < nb; ++b) th = th + Wr[b];
      if (f_me == 0) th0 = th;  // thread 0: the node's weight by feature 0
      if (!fok) {
        if (better(-CUDART_INF_F, idx0, best, best_i)) {
          best = -CUDART_INF_F;
          best_i = idx0;
        }
      } else {
        const float sp = np_ / (th + L);
        float ch = 0.f;
        for (int b = 0; b < nb; ++b) {
          ch = ch + Wr[b];
          const float rh = th - ch;
          float gain = -CUDART_INF_F;
          if (ch >= Wmin && rh >= Wmin) {
            const float sl = NL[b] / (ch + L);
            const float sr = NR[b] / (rh + L);
            gain = (sl + sr) - sp;
          }
          if (better(gain, idx0 + b, best, best_i)) {
            best = gain;
            best_i = idx0 + b;
          }
        }
      }
    }
  }
  pick_split(q, p, best, best_i, th0, out_f, out_b);
}

// the node's search by the fixed instance or, for M = 0, by the any-m one
template <int M>
__device__ __forceinline__ void search(const Params& q, float* smem,
                                       const uint16_t* flist, int n_feat,
                                       bool fok0, int p, int k, bool zero,
                                       int& out_f, int& out_b) {
  if constexpr (M > 0)
    search_node<M>(q, smem, flist, n_feat, fok0, p, k, zero, out_f, out_b);
  else
    search_node_any(q, smem, flist, n_feat, fok0, p, k, zero, out_f, out_b);
}

template <int M>
__global__ void __launch_bounds__(THREADS)
    split_search_kernel(const Params q) {
  extern __shared__ float smem[];
  __shared__ int s_list[THREADS];
  __shared__ int s_count[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.y;
  const int x = blockIdx.x;
  // with a mask, the list of the pair's features to search (in order)
  // follows the tile in shared memory
  uint16_t* flist = nullptr;
  int n_feat = q.d;
  bool fok0 = true;
  if (q.fmask != nullptr) {
    const uint8_t* fm = q.fmask + (int64_t)p * q.d;
    flist = reinterpret_cast<uint16_t*>(smem + tile_rows<M>() * q.tile_f *
                                                   q.row);
    fok0 = fm[0] != 0;
    n_feat = 0;
    for (int c = 0; c < q.d; c += THREADS) {
      const int f = c + tid;
      const bool on = f < q.d && (f == 0 || fm[f] != 0);
      const unsigned bal = __ballot_sync(FULL, on);
      __syncthreads();
      if (lane == 0) s_count[warp] = __popc(bal);
      __syncthreads();
      int off = n_feat;
      for (int w = 0; w < WARPS; ++w) {
        off += w < warp ? s_count[w] : 0;
        n_feat += s_count[w];
      }
      if (on) flist[off + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)f;
    }
  }
  int fo = 0, bo = 0;
  if (x == q.G) {  // the pair's zero search, into every node not live
    search<M>(q, smem, flist, n_feat, fok0, p, 0, true, fo, bo);
    __shared__ int s_zero[2];
    if (tid == 0) {
      s_zero[0] = fo;
      s_zero[1] = bo;
    }
    __syncthreads();
    fo = s_zero[0];
    bo = s_zero[1];
    const uint8_t* lv = q.live + (int64_t)p * q.live_stride;
    for (int k = tid; k < q.n_nodes; k += THREADS)
      if (lv[k] == 0) {
        q.out_feat[(int64_t)p * q.out_stride + k] = fo;
        q.out_bin[(int64_t)p * q.out_stride + k] = bo;
      }
    return;
  }
  for (int64_t c = 0; x + (int64_t)q.G * c < q.n_nodes; c += THREADS) {
    const int64_t k64 = x + (int64_t)q.G * (c + tid);
    const int k = (int)k64;
    const bool on = k64 < q.n_nodes &&
                    (q.live == nullptr ||
                     q.live[(int64_t)p * q.live_stride + k] != 0);
    const unsigned bal = __ballot_sync(FULL, on);
    __syncthreads();  // the previous round's list is read
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (on) s_list[off + __popc(bal & ((1u << lane) - 1u))] = k;
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const int node = s_list[i];
      search<M>(q, smem, flist, n_feat, fok0, p, node, false, fo, bo);
      if (tid == 0) {
        q.out_feat[(int64_t)p * q.out_stride + node] = fo;
        q.out_bin[(int64_t)p * q.out_stride + node] = bo;
        if (q.mark != nullptr)
          q.mark[(int64_t)p * q.mark_stride + 2 * (int64_t)node] = 1;
      }
    }
  }
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

template <int M>
int launch(Params q, int P, void* stream) {
  const int row = q.n_bins | 1;  // odd: lanes' rows fall in distinct banks
  const int per_feature = tile_rows<M>() * row * (int)sizeof(float);
  int tile_f = TILE_BYTES / per_feature;
  if (tile_f > THREADS) tile_f = THREADS;
  if (tile_f > q.d) tile_f = q.d;
  if (tile_f < 1) tile_f = 1;
  // the tile, then (with a mask) the pair's list of features, 2 bytes each
  const size_t smem = (size_t)tile_f * per_feature +
                      (q.fmask != nullptr ? ((size_t)q.d * 2 + 15) / 16 * 16
                                          : 0);
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_search_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  // as many blocks as the card holds at once, divided over the pairs
  static size_t occ_smem = 0;
  static int per_sm = 0;
  if (occ_smem != smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, split_search_kernel<M>, THREADS, smem) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    occ_smem = smem;
  }
  int G = (sm_count() * per_sm + P - 1) / P;
  if (G > q.n_nodes) G = q.n_nodes;
  if (G < 1) G = 1;
  q.G = G;
  q.tile_f = tile_f;
  q.row = row;
  dim3 grid(G + (q.live != nullptr ? 1 : 0), P);
  split_search_kernel<M><<<grid, THREADS, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

}  // namespace

// hg (P, m, n_nodes, d, n_bins), hh (P, n_nodes, d, n_bins) f32 contiguous;
// per-pair lam, mcw, min_gain, min_gain_norm f32 (P,); fmask (P, d) uint8
// or null; active_depth (P,) int32 or null. live: (P, n_nodes) flags (row
// stride live_stride) or null (every node searched); mark: (P, 2 n_nodes)
// flags (row stride mark_stride) or null. Outputs (P, n_nodes) int32 with
// row stride out_stride.
extern "C" int split_search(const void* hg, const void* hh, const void* lam,
                            const void* mcw, const void* min_gain,
                            const void* min_gain_norm, const void* fmask,
                            const void* active_depth, const void* live,
                            int64_t live_stride, void* mark,
                            int64_t mark_stride, int P, int level,
                            int n_nodes, int d, int n_bins, int m,
                            void* out_feat, void* out_bin, int64_t out_stride,
                            void* stream) {
  if (P <= 0 || n_nodes <= 0 || d <= 0 || n_bins <= 0) return 0;
  if (fmask != nullptr && d > 65535) return (int)cudaErrorInvalidValue;
  Params q{static_cast<const float*>(hg),
           static_cast<const float*>(hh),
           static_cast<const float*>(lam),
           static_cast<const float*>(mcw),
           static_cast<const float*>(min_gain),
           static_cast<const float*>(min_gain_norm),
           static_cast<const uint8_t*>(fmask),
           static_cast<const int32_t*>(active_depth),
           static_cast<const uint8_t*>(live),
           static_cast<uint8_t*>(mark),
           static_cast<int32_t*>(out_feat),
           static_cast<int32_t*>(out_bin),
           live_stride, mark_stride, out_stride,
           level, n_nodes, d, n_bins, m, 0, 0, 0};
  switch (m) {
    case 1: return launch<1>(q, P, stream);
    case 2: return launch<2>(q, P, stream);
    case 3: return launch<3>(q, P, stream);
    case 4: return launch<4>(q, P, stream);
    default:
      return m > MAX_M ? launch<0>(q, P, stream)
                       : (int)cudaErrorInvalidValue;
  }
}
