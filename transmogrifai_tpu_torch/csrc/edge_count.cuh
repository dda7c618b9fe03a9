// K4's counting rule, bin = #{e : x >= edges[e]} over one feature's
// n_edges edges, shared by K4 (bin_features.cu) and K12 (write_rows.cu) so
// that both give the same bins for any edges: unsorted, NaN, duplicated,
// +-inf or +-0.
//
// A feature whose edges are non-decreasing (`in_order` for every
// neighbouring pair, false at NaN) is counted by branch-free binary
// lifting with the same `>=` compare, which gives the same count and still
// sends NaN to 0; any other feature is counted linearly. The lifting
// raises the count by steps h from `search_top` down to 1 where x >= the
// count's next edge:
// - `lift_padded` over staged rows of edges padded with NaN up to
//   `edge_rows(n_edges)` = 2^k - 1 rows, which no x reaches, so no probe
//   needs a bound check. p and h are in whatever units the kernel's
//   accessor takes, and `e(p + h)` reads the last edge of the raised
//   count: K12 steps the shared offset of that edge (K4 keeps the count
//   and writes the same step out in its loop);
// - `lift_clamped` over the edges as they lie in device memory (`e(j)`
//   reads edge j), probes past the last edge clamped to it and not taken.

#pragma once

__host__ __device__ inline int edge_rows(int n_edges) {
  int E = 1;
  while (E < n_edges) E = 2 * E + 1;
  return E;
}

// the first step: half the padded rows when staged, else the largest power
// of two <= n_edges (0 for no edges)
__host__ __device__ inline int search_top(int n_edges, bool staged) {
  if (staged) return (edge_rows(n_edges) + 1) / 2;
  if (n_edges <= 0) return 0;
  int top = 1;
  while (top <= n_edges / 2) top *= 2;
  return top;
}

// one pair of neighbouring edges keeps the feature non-decreasing
__device__ __forceinline__ bool in_order(float a, float b) { return a <= b; }

template <typename I, typename E>
__device__ __forceinline__ I lift_padded(const E& e, float x, I p, I h) {
  const I t = p + h;
  return x >= e(t) ? t : p;
}

template <typename E>
__device__ __forceinline__ int lift_clamped(const E& e, float x, int c,
                                            int h, int n_edges) {
  const int t = c + h;
  const float v = e((t < n_edges ? t : n_edges) - 1);
  return (t <= n_edges && x >= v) ? t : c;
}

template <typename E>
__device__ __forceinline__ int count_linear(const E& e, float x,
                                            int n_edges) {
  int c = 0;
  for (int j = 0; j < n_edges; ++j) c += (x >= e(j)) ? 1 : 0;
  return c;
}
