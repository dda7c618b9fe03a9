// K5: tree-ensemble walk, out[r, c] = sum_t leaf[t, walk_t(r), c].
//
// Replaces the TPU walk in transmogrifai_tpu/models/trees.py: `_tree_walk`
// (:334-364) with `_table_lookup2`/`_select_bin`/`_leaf_lookup`, summed over
// trees by `_scan_tree_chunks`/`_predict_trees_sum`/`_predict_trees_margin`
// (:477-544) for `predict_forest` and `predict_gbt_margin` (:813). On the
// TPU every table read is a one-hot compare-and-sum over 2^level nodes and
// every feature read a masked reduction over all d columns, because gathers
// serialise there.
//
// Walk per tree, level by level: node = 2*node + (Xb[r, feat[t,l,node]] >
// bin[t,l,node]); a split bin equal to n_bins never fires, so such a node
// always goes left, as in the JAX program. After `depth` levels the node
// is the leaf index.
//
// K5-mc, the class-tree walk: out[r, k] = sum_t leaf[t, k, walk_{t,k}(r)]
// over tables laid out (T rounds, K classes, depth, width) and leaves
// (T, K, n_leaves, 1) -- a softmax-boosted ensemble, one tree per (round,
// class). Replaces `predict_gbt_multiclass_margin` (models/trees.py:797),
// which vmaps the one-hot walk over rounds and classes and sums the rounds
// in an order XLA picks. The learning rate is applied by the caller.
//
// Both are one kernel over "flat" trees u = t*K + k (K = 1 for K5) with m
// leaf channels: flat tree u adds its leaf's m values to output columns
// (u % K)*m .. (u % K)*m + m - 1, and every (row, column) sum takes its
// trees in index order, one f32 add after another from 0, as the plain
// versions' `acc = acc + vals[t]` do. So the result is bit-equal to them
// for any tree count, class count and channel count, in one launch.
//
// What bounds it. Each (row, tree) walk is `depth` dependent steps of three
// loads (feat and bin of the node, then the row's bin of that feature).
// At serving sizes (1 to 891 rows) the work is small and the time is the
// latency of those chains: the first design, one thread a row walking
// every tree in turn (n_trees*depth steps, 2,000 at the Titanic model),
// ran 0.7 ms whatever n was, on a handful of SMs. At large n the bound is
// the table reads through L1 (a warp's rows reach up to 32 slots of a
// level, each level row a few 128-byte lines, and the slots miss to L2)
// and, with few trees over millions of rows, the bytes of Xb: a warp of
// rows one thread each read one 32-byte sector per row and cell.
//
// Design: split the walk, not the sum.
// - A block of 256 threads takes a tile of R rows (R a power of two, 1 to
//   64, chosen from n and the SM count by `plan` below) and walks the
//   R x TC (row, tree) pairs of a chunk of TC = 1024 / R flat trees at
//   once: thread (row i, group g) walks trees g + k * 256/R of the chunk
//   for k = 0..3, the four chains interleaved.
//   So a thread's chain is `depth` steps a chunk, and rows are fastest
//   within a warp: at R >= 32 a warp walks one tree for 32 rows (its top
//   levels are one broadcast load), at small R a warp holds 32/R trees.
//   At 1 to 891 rows every tree of the Titanic model fits one chunk.
// - The tile's rows of Xb are staged in shared memory by coalesced 16-byte
//   copies (4-byte ones where the tile does not start on 16 bytes), each
//   row padded to an odd number of words (lanes reading one feature of
//   different rows fall in different banks); rows of an odd byte count, or
//   off a 4-byte boundary, are copied byte by byte as they lie, and rows
//   whose tile does not fit in shared memory are read from device memory.
//   With 16 trees over millions of rows, each row of Xb now comes from
//   device memory once, in whole sectors.
// - Each walker writes its leaf's values (MC = 4 channels a pass) to a
//   shared slab [TC][R][MC]; after a barrier the thread that owns a (row,
//   column) adds the chunk's values in tree order onto its running sum in
//   shared memory, and the next chunk's walks start after a second
//   barrier. The sum order is the plain version's exactly.
// - The tables are read in place through L1 (int32, or the quantized
//   mode's int16 features and uint8 bins: 3 bytes a slot).

// Narrowed tables (the quantized scoring mode, `narrow_device_constants`
// in models/trees.py:999): split features as int16 when d < 2^15 and split
// bins as uint8 when there are at most 255 edges, both lossless. The walk
// is a template over the table types; the entry points pick the instance
// from the element sizes.
//
// C interface for ctypes: each entry point launches on `stream` and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WALK_U = 4;                  // trees a thread walks at once
constexpr int PAIRS = THREADS * WALK_U;    // (row, tree) pairs a chunk
constexpr int MC = 4;                      // leaf channels a pass stages
constexpr int MAX_ROWS = 64;
constexpr int SMEM_MAX = 48 * 1024;        // no opt-in needed
constexpr int STAGE_UNROLL = 4;            // 16-byte loads in flight
constexpr int FILL = 2;  // blocks an SM the row tiles should give at least
constexpr int MAX_DEVICES = 64;

struct Walk {
  const void* Xb;
  const void* feat;
  const void* bins;
  const float* leaf;
  float* out;
  int64_t n;
  int d, n_flat, K, depth, width, n_leaves, m;
  int R, log_r;  // rows a block, log2 R
  int stride;    // staged row stride in Xb elements (0: not staged)
  int copy;      // staging copies: 16 or 4 bytes (rows padded), 1 (not)
};

template <typename BinT, typename FeatT, typename SplitT, bool STAGED>
__global__ void __launch_bounds__(THREADS) walk_kernel(Walk q) {
  constexpr int U = WALK_U;
  extern __shared__ __align__(16) float smem[];
  const int R = q.R;
  const int G = THREADS >> q.log_r;  // tree groups
  const int TC = G * U;              // flat trees a chunk
  const int ncols = q.K * q.m;
  const int mce = q.m < MC ? q.m : MC;
  float* slab = smem;                           // [TC][R][mce]
  float* acc = slab + (size_t)TC * R * mce;     // [R][ncols]
  BinT* tile = reinterpret_cast<BinT*>(acc + (size_t)R * ncols);
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int rows = q.n - r0 < R ? (int)(q.n - r0) : R;
  const int i = tid & (R - 1), g = tid >> q.log_r;
  for (int o = tid; o < R * ncols; o += THREADS) acc[o] = 0.0f;
  const BinT* Xb = static_cast<const BinT*>(q.Xb);
  const BinT* x;
  if constexpr (STAGED) {
    const int row_bytes = q.d * (int)sizeof(BinT);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(Xb) + r0 * row_bytes;
    if (q.copy > 1) {
      // rows of rw words to rows of sw words: 16-byte loads (4-byte ones
      // for the words past the last whole 16 bytes, or for all of them)
      const int rw = row_bytes >> 2, sw = q.stride * (int)sizeof(BinT) >> 2;
      const int total = rows * rw;
      const int n16 = q.copy == 16 ? total >> 2 : 0;
      const uint4* s16 = reinterpret_cast<const uint4*>(src);
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
      uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
      for (int v0 = tid; v0 < n16; v0 += THREADS * STAGE_UNROLL) {
        uint4 v[STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          const int j = v0 + u * THREADS;
          if (j < n16) v[u] = __ldg(s16 + j);
        }
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
          const int j = v0 + u * THREADS;
          if (j < n16) {
            int r = 4 * j / rw, c = 4 * j - r * rw;
            const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              t32[r * sw + c] = w[e];
              if (++c == rw) {
                c = 0;
                ++r;
              }
            }
          }
        }
      }
      for (int j = 4 * n16 + tid; j < total; j += THREADS) {
        const int r = j / rw;
        t32[r * sw + (j - r * rw)] = __ldg(s32 + j);
      }
    } else {  // stride == d: the rows are copied as they lie
      unsigned char* t8 = reinterpret_cast<unsigned char*>(tile);
      for (int j = tid; j < rows * row_bytes; j += THREADS) t8[j] = src[j];
    }
    x = tile + i * q.stride;
  } else {
    x = Xb + (r0 + (i < rows ? i : 0)) * q.d;
  }
  __syncthreads();
  const FeatT* feat = static_cast<const FeatT*>(q.feat);
  const SplitT* bins = static_cast<const SplitT*>(q.bins);
  const int64_t tree_slots = (int64_t)q.depth * q.width;
  for (int u0 = 0; u0 < q.n_flat; u0 += TC) {
    const int tc = q.n_flat - u0 < TC ? q.n_flat - u0 : TC;
    int node[U];
    int64_t base[U];
#pragma unroll
    for (int w = 0; w < U; ++w) {
      const int j = g + w * G;
      base[w] = (int64_t)(u0 + (j < tc ? j : tc - 1)) * tree_slots;
      node[w] = 0;
    }
    for (int l = 0; l < q.depth; ++l) {
      int f[U], b[U];
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int64_t at = base[w] + (int64_t)l * q.width + node[w];
        f[w] = static_cast<int>(__ldg(feat + at));
        b[w] = static_cast<int>(__ldg(bins + at));
      }
#pragma unroll
      for (int w = 0; w < U; ++w) {
        int xb;
        if constexpr (STAGED) {
          xb = static_cast<int>(x[f[w]]);
        } else {
          xb = static_cast<int>(__ldg(x + f[w]));
        }
        node[w] = 2 * node[w] + (xb > b[w] ? 1 : 0);
      }
    }
    const int k0 = u0 % q.K;
    for (int c0 = 0; c0 < q.m; c0 += MC) {
      const int mcur = q.m - c0 < MC ? q.m - c0 : MC;
#pragma unroll
      for (int w = 0; w < U; ++w) {
        const int j = g + w * G;
        if (j < tc) {
          const float* lv =
              q.leaf + ((int64_t)(u0 + j) * q.n_leaves + node[w]) * q.m + c0;
          float* s = slab + ((size_t)j * R + i) * mce;
          for (int c = 0; c < mcur; ++c) s[c] = __ldg(lv + c);
        }
      }
      __syncthreads();
      // owner o = (class k, channel c, row oi), rows fastest
      for (int o = tid; o < R * q.K * mcur; o += THREADS) {
        const int oi = o & (R - 1), rest = o >> q.log_r;
        const int c = rest % mcur, k = rest / mcur;
        if (oi < rows) {
          float* a = acc + (size_t)oi * ncols + k * q.m + c0 + c;
          float sum = *a;
          int j = k - k0;
          if (j < 0) j += q.K;
          for (; j < tc; j += q.K)
            sum = sum + slab[((size_t)j * R + oi) * mce + c];
          *a = sum;
        }
      }
      __syncthreads();
    }
  }
  float* out = q.out + r0 * ncols;
  for (int o = tid; o < rows * ncols; o += THREADS) out[o] = acc[o];
}

// the staged row stride in elements: 4-byte words, padded to an odd count
int staged_stride(int d, int es, bool words) {
  if (!words) return d;  // copied byte by byte, as they lie
  const int rw = (d * es + 3) / 4;
  return (rw | 1) * 4 / es;
}

// shared bytes of a block of R rows: the slab of min(m, MC) leaf channels
// a pair, the (R, n_cols) sums and, staged, R rows of Xb padded to an odd
// number of words (the most `staged_stride` pads)
int64_t block_smem(int R, int d, int es, int n_cols, int m, bool staged) {
  const int64_t row = ((((int64_t)d * es + 3) / 4) | 1) * 4;
  return (int64_t)PAIRS * (m < MC ? m : MC) * 4 + (int64_t)R * n_cols * 4 +
         (staged ? R * row : 0);
}

struct Plan {
  int rows, staged;  // rows 0: no plan fits
};

// R and whether the rows of Xb are staged, for n rows and n_flat trees on
// a card of `sms` SMs. R doubles from 1 while the shared memory allows it
// and either the tiles still give FILL blocks an SM or every tree still
// fits one chunk (PAIRS / R trees) of a tile that n fills; so small
// batches get many blocks of short chains and large n gets 64-row tiles
// whose warps walk one tree for 32 rows. A given `rows` (tests) is kept,
// staged where it fits.
Plan plan(int64_t n, int n_flat, int d, int es, int n_cols, int m, int sms,
          int rows) {
  const auto fits = [&](int r, bool st) {
    return block_smem(r, d, es, n_cols, m, st) <= SMEM_MAX;
  };
  if (rows != 0) {
    if (rows < 0 || rows > MAX_ROWS || (rows & (rows - 1)) != 0 ||
        !fits(rows, false))
      return {0, 0};
    return {rows, fits(rows, true)};
  }
  const bool staged = fits(1, true);
  if (!fits(1, false)) return {0, 0};
  int r = 1;
  while (2 * r <= MAX_ROWS && fits(2 * r, staged) &&
         ((n + 2 * r - 1) / (2 * r) >= (int64_t)FILL * sms ||
          (2 * r <= n && PAIRS / (2 * r) >= n_flat)))
    r *= 2;
  return {r, staged};
}

// the SM count of the current device (read once a device)
int sm_count() {
  static std::atomic<int> counts[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  int c = dev < MAX_DEVICES ? counts[dev].load() : 0;
  if (c == 0) {
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    if (c <= 0) c = 132;
    if (dev < MAX_DEVICES) counts[dev].store(c);
  }
  return c;
}

template <typename BinT, typename FeatT, typename SplitT>
int launch(Walk q, void* stream) {
  const int es = (int)sizeof(BinT);
  const Plan p = plan(q.n, q.n_flat, q.d, es, q.K * q.m, q.m, sm_count(),
                      q.R);
  if (p.rows == 0) return (int)cudaErrorInvalidValue;
  q.R = p.rows;
  q.log_r = 0;
  while ((1 << q.log_r) < q.R) ++q.log_r;
  const int row_bytes = q.d * es;
  const bool words = row_bytes % 4 == 0 && (uintptr_t)q.Xb % 4 == 0;
  q.copy = !words ? 1
           : ((uintptr_t)q.Xb % 16 == 0 && q.R * row_bytes % 16 == 0) ? 16
                                                                      : 4;
  q.stride = p.staged ? staged_stride(q.d, es, words) : 0;
  const int mce = q.m < MC ? q.m : MC;
  const size_t smem = (size_t)PAIRS * mce * sizeof(float) +
                      (size_t)q.R * q.K * q.m * sizeof(float) +
                      (size_t)q.R * q.stride * es;
  const unsigned blocks = (unsigned)((q.n + q.R - 1) / q.R);
  auto kernel = p.staged ? walk_kernel<BinT, FeatT, SplitT, true>
                         : walk_kernel<BinT, FeatT, SplitT, false>;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

// the instance for element sizes (Xb 1 or 4 bytes, feat 2 or 4, bins 1 or 4)
int dispatch(int xb_bytes, int feat_bytes, int bin_bytes, Walk q,
             void* stream) {
#define TW_CASE(XB, FT, ST)                                                \
  if (xb_bytes == sizeof(XB) && feat_bytes == sizeof(FT) &&              \
      bin_bytes == sizeof(ST))                                             \
    return launch<XB, FT, ST>(q, stream);
  TW_CASE(int8_t, int32_t, int32_t)
  TW_CASE(int8_t, int16_t, int32_t)
  TW_CASE(int8_t, int32_t, uint8_t)
  TW_CASE(int8_t, int16_t, uint8_t)
  TW_CASE(int32_t, int32_t, int32_t)
  TW_CASE(int32_t, int16_t, int32_t)
  TW_CASE(int32_t, int32_t, uint8_t)
  TW_CASE(int32_t, int16_t, uint8_t)
#undef TW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Xb (n, d), tables (n_trees, depth, width), leaf (n_trees, n_leaves, m)
// -> out (n, m); `rows` rows a block (0: planned)
extern "C" int tree_walk_typed(const void* Xb, const void* feat,
                               const void* bins, const void* leaf, void* out,
                               int64_t n, int d, int n_trees, int depth,
                               int width, int n_leaves, int m, int rows,
                               int xb_bytes, int feat_bytes, int bin_bytes,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Walk q{Xb, feat, bins, static_cast<const float*>(leaf),
         static_cast<float*>(out), n, d, n_trees, 1, depth, width, n_leaves,
         m, rows, 0, 0, 0};
  return dispatch(xb_bytes, feat_bytes, bin_bytes, q, stream);
}

// tables (n_rounds, n_classes, depth, width), leaf (n_rounds, n_classes,
// n_leaves, 1) -> out (n, n_classes)
extern "C" int tree_walk_classes_typed(const void* Xb, const void* feat,
                                       const void* bins, const void* leaf,
                                       void* out, int64_t n, int d,
                                       int n_rounds, int n_classes, int depth,
                                       int width, int n_leaves, int rows,
                                       int xb_bytes, int feat_bytes,
                                       int bin_bytes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Walk q{Xb, feat, bins, static_cast<const float*>(leaf),
         static_cast<float*>(out), n, d, n_rounds * n_classes, n_classes,
         depth, width, n_leaves, 1, rows, 0, 0, 0};
  return dispatch(xb_bytes, feat_bytes, bin_bytes, q, stream);
}

// the plan a walk of n rows and n_flat trees (n_cols output columns, m
// leaf channels a tree) takes on a card of `sms` SMs, for tests:
// out = {R, staged, trees a chunk}; `rows` 0 plans R, else forces it.
// Returns cudaErrorInvalidValue where no plan fits.
extern "C" int tree_walk_plan(int64_t n, int n_flat, int d, int xb_bytes,
                              int n_cols, int m, int sms, int rows,
                              int* out) {
  const Plan p = plan(n, n_flat, d, xb_bytes, n_cols, m, sms, rows);
  if (p.rows == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.rows;
  out[1] = p.staged;
  out[2] = PAIRS / p.rows;
  return (int)cudaSuccess;
}
