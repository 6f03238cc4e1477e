// Pieces shared by the two log-space Sinkhorn kernels, sinkhorn.cu (the
// coupling resident in shared memory) and sinkhorn_stream.cu (the coupling
// streamed from device memory every iteration).
//
// Both run one persistent cooperative launch. The blocks of a pair split
// its rows; in each iteration every block updates u for its rows from the
// previous v, then writes per-column partials (max, sum of exp) of C + u
// over its rows; after a grid-wide barrier (cooperative groups'
// grid.sync(), which needs the cooperative launch but no -rdc) every block
// of the pair reduces the pair's partials into the new v, held in its
// shared memory. The partials are double-buffered by the parity of the
// iteration, so one barrier per iteration suffices: a block writes buffer
// p only after the barrier that every block passes once it has finished
// reading buffer p two iterations before.
#pragma once

#include <cooperative_groups.h>

#include <limits>

#include "common.cuh"

namespace sinkhorn {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
// Maxima start at -inf, and a merge with an empty accumulator takes the
// new (max, sum) as it is, so exp(-inf - -inf) never appears. (A start at
// the JAX package's NEG_INF = -1e9, as in the Pallas kernels, would make a
// column whose entries all lie more than about 104 below -1e9 sum to 0 in
// fp32, and its v infinite.)
constexpr float kEmpty = -std::numeric_limits<float>::infinity();

// Merge (m2, s2) into the running (m, s) of a log-sum-exp.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m == kEmpty) {
    m = m2, s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// u[i] = mu[i] - lse_j(C[i, j] + v[j]) for the nr rows of C (row pitch ld,
// n columns): a warp per row, max then sum of exp, as torch.logsumexp.
__device__ __forceinline__ void row_update(const float* C, int ld, int nr, int n,
                                           const float* v, const float* __restrict__ mu,
                                           float* u) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nr; i += blockDim.x >> 5) {
    const float* row = C + static_cast<size_t>(i) * ld;
    float mx = kEmpty;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j] + v[j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = lane; j < n; j += 32) s += expf(row[j] + v[j] - mx);
    s = warp_sum(s);
    if (lane == 0) u[i] = mu[i] - (mx + logf(s));
  }
}

// Column j's (max, sum of exp(x - max)) of C + u over the nr rows of C;
// (kEmpty, 0) for no rows.
__device__ __forceinline__ void column_stats(const float* C, int ld, int nr, const float* u,
                                             int j, float& m2, float& s2) {
  float mx = kEmpty;
  for (int i = 0; i < nr; ++i) mx = fmaxf(mx, C[static_cast<size_t>(i) * ld + j] + u[i]);
  float s = 0.f;
  for (int i = 0; i < nr; ++i) s += expf(C[static_cast<size_t>(i) * ld + j] + u[i] - mx);
  m2 = mx;
  s2 = s;
}

// The partials of block k of a pair: [max row of n, sum row of n].
__device__ __forceinline__ float* partial(float* part, int buf, int B, int b, int cpp, int k,
                                          int n) {
  return part + ((static_cast<size_t>(buf) * B + b) * cpp + k) * 2 * n;
}

// v[j] = nu[j] - lse over the pair's cpp partials of column j. The partials
// come from other blocks: read them past L1 (ld.global.cg).
__device__ __forceinline__ void reduce_v(const float* pair_part, int cpp, int n,
                                         const float* __restrict__ nu, float* v) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    // Every column has rows in some block, so mx ends finite and an empty
    // block's (kEmpty, 0) adds 0.
    float mx = kEmpty;
    for (int k = 0; k < cpp; ++k) mx = fmaxf(mx, __ldcg(pair_part + 2 * k * n + j));
    float s = 0.f;
    for (int k = 0; k < cpp; ++k)
      s += __ldcg(pair_part + (2 * k + 1) * n + j) * expf(__ldcg(pair_part + 2 * k * n + j) - mx);
    v[j] = nu[j] - (mx + logf(s));
  }
}

}  // namespace sinkhorn
