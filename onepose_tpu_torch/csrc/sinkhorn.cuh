// Pieces shared by the two log-space Sinkhorn kernels, sinkhorn.cu (the
// coupling resident in shared memory, K6) and sinkhorn_stream.cu (the
// coupling streamed from device memory every iteration, K7).
//
// Both run one cooperative launch of 512-thread blocks, so that every block
// is resident; the blocks of a pair split its rows. Inside a block, the 16
// warps form groups of W warps; a group takes RS rows at a time, side by
// side, and each of its threads owns a fixed set of columns for the call:
// chunks of 4 columns, chunk t + P * k for k < KC (P = 32 * W threads a
// group), and, when N is not a multiple of 4 * P, one "tail" column
// 4 * P * KC + t for t < tail (the dustbin column at N = 4097 or 1025).
// The thread keeps v and the online column accumulator (max, sum) of its
// columns in registers. For each row the group computes
//   u[i] = mu[i] - lse_j(C[i, j] + v[j])
// (per-warp max and sum of exponentials, one exchange through shared
// memory and one named barrier), then folds C[i, j] + u[i] into its
// columns' accumulators: one rescale per column and step, one exponential
// per entry.
//
// Everything runs in base 2: C, mu, nu, u and v are scaled by log2(e) as
// they are read, each exponential is one ex2.approx and each logarithm one
// lg2.approx, and u and v are scaled back by ln(2) on the way out.
//
// After its rows, the block merges its groups' accumulators in shared
// memory and writes them as its partial of the pair; the pair's blocks meet
// at an arrival counter in device memory (release / acquire; the wrapper
// zeroes the counters before every launch, and the targets grow with the
// barrier count); each block then reduces the partials of its own slice of
// columns into v, and after a second barrier every block reads the new v.
// No barrier spans pairs.
//
// Accumulators start empty (-inf, 0): the first fold scales the empty sum
// by exp(-inf) = 0, and the reduce and the group merge take an empty side
// as it is, so exp(-inf - -inf) never appears. (A start at the JAX
// package's NEG_INF = -1e9, as in the Pallas kernels, would make a column
// whose entries all lie more than about 104 below -1e9 sum to 0 in fp32,
// and its v infinite.)
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <limits>

#include "common.cuh"
#include "hopper.cuh"

namespace sinkhorn {

constexpr float kEmpty = -std::numeric_limits<float>::infinity();
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kPad = -1e9f;  // NEG_INF of the padding columns
constexpr int kMaxWarps = 16;
constexpr int kMaxRowsPerStep = 4;
// Bytes of the cross-warp exchange: [2 parities][kMaxWarps][kMaxRowsPerStep] float2.
constexpr int kRedBytes = 2 * kMaxWarps * kMaxRowsPerStep * 8;  // 1024
constexpr int kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr int kThreads = 512;  // threads of a block, both kernels (16 warps)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A named barrier of `threads` threads (barrier.sync, which a warp may reach
// diverged: in K7 one lane of a warp may have refilled a stage).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Merge (m2, s2) into the running (m, s) of a base-2 log-sum-exp; an empty
// side (max -inf) is taken over as it is.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == kEmpty) return;
  if (m == kEmpty) {
    m = m2, s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * ex2(m - mn) + s2 * ex2(m2 - mn);
  m = mn;
}

// Fold the RS entries y of one column (at least one finite) into its online
// (m, s): the new max, one rescale of s to it (exp(-inf) = 0 while s is
// still empty), then one exponential per entry.
template <int RS>
__device__ __forceinline__ void fold(float& m, float& s, const float (&y)[RS]) {
  float mn = m;
#pragma unroll
  for (int r = 0; r < RS; ++r) mn = fmaxf(mn, y[r]);
  float acc = s * ex2(m - mn);
#pragma unroll
  for (int r = 0; r < RS; ++r) acc += ex2(y[r] - mn);
  s = acc;
  m = mn;
}

// 4 stored entries as fp32 (bf16 is widened as it is read).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(q.x << 16), x[1] = __uint_as_float(q.x & 0xffff0000u);
  x[2] = __uint_as_float(q.y << 16), x[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The columns a thread owns, with their v and online accumulators (base 2).
template <int W, int KC>
struct Columns {
  static constexpr int P = 32 * W;
  float v[KC][4], m[KC][4], s[KC][4];
  float vt, mt, st;  // the tail column
  int t, tail;

  __device__ __forceinline__ int col(int k, int e) const { return 4 * (t + P * k) + e; }
  __device__ __forceinline__ int tail_col() const { return 4 * P * KC + t; }
  // Where chunk k and the tail column are read from in a row of pitch ld:
  // in range always (see row_step).
  __device__ __forceinline__ int chunk_at(int k, int ld) const { return min(col(k, 0), ld - 4); }
  __device__ __forceinline__ int tail_at(int N) const { return min(tail_col(), N - 1); }

  // Folds the RS rows of a step (base e, pitch ld; the invalid ones count
  // for nothing) plus their u2 into the accumulators: per column the step's
  // max, one rescale of the running sum to it, then one exponential per
  // entry.
  template <typename T, int RS>
  __device__ __forceinline__ void fold_rows(const T* const (&rows)[RS], const bool (&ok)[RS],
                                            int ld, int N, const float (&u2)[RS]) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float y[RS][4];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        float c[4];
        load4(rows[r] + chunk_at(k, ld), c);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[r][e] = ok[r] ? fmaf(c[e], kLog2e, u2[r]) : kEmpty;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float col_y[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) col_y[r] = y[r][e];
        fold(m[k][e], s[k][e], col_y);
      }
    }
    float yt[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
      yt[r] = ok[r] ? fmaf(load1(rows[r] + tail_at(N)), kLog2e, u2[r]) : kEmpty;
    fold(mt, st, yt);
  }

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[k][e] = kEmpty, s[k][e] = 0.f;
    mt = kEmpty, st = 0.f;
  }

  // v from the pair's published v (base 2; nullptr: 0); -inf past N.
  __device__ __forceinline__ void set_v(const float* V, int N) {
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = col(k, e);
        v[k][e] = j < N ? (V ? __ldcg(V + j) : 0.f) : kEmpty;
      }
    vt = t < tail ? (V ? __ldcg(V + tail_col()) : 0.f) : kEmpty;
  }

  // Merges the accumulators of the same thread in every group into group
  // 0's, through `buf` ([2][N] floats of shared memory), one group at a
  // time, with a block barrier (id 1) around each.
  __device__ __forceinline__ void merge_groups(float* buf, int N, int g, int groups) {
    for (int src = groups - 1; src > 0; --src) {
      if (g == src) store(buf, N, N);
      named_sync(1, kThreads);
      if (g == 0) {
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = col(k, e);
            if (j < N) lse_merge(m[k][e], s[k][e], buf[j], buf[N + j]);
          }
        if (t < tail) lse_merge(mt, st, buf[tail_col()], buf[N + tail_col()]);
      }
      named_sync(1, kThreads);
    }
  }

  // The accumulators of the N columns as one partial: maxima at pm, sums
  // `ld` floats after them.
  __device__ __forceinline__ void store(float* pm, int N, int ld) const {
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = col(k, e);
        if (j < N) pm[j] = m[k][e], pm[ld + j] = s[k][e];
      }
    if (t < tail) pm[tail_col()] = mt, pm[ld + tail_col()] = st;
  }
};

// The group's log-sum-exp (base 2) of C2[r, j] + v[j] over its columns for
// RS rows (row r at rows[r], pitch ld), side by side: on return every lane
// holds each row's (M, S), the max and the sum of exponentials scaled to
// it. `red` is the block's exchange, `parity` alternates between a group's
// steps, `wg` is the group's first warp, `bar` its named barrier. The loads
// take no branch: a chunk past the row reads the row's last chunk, the tail
// column of a thread without one reads column N - 1, and v = -inf there
// makes them count for nothing.
template <typename T, int W, int KC, int RS>
__device__ __forceinline__ void row_lse(const Columns<W, KC>& cs, const T* const (&rows)[RS], int N,
                                        int ld, float2* red, int parity, int wg, int bar,
                                        float (&M)[RS], float (&S)[RS]) {
  static_assert(RS <= kMaxRowsPerStep && W <= kMaxWarps, "the exchange holds this step");
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) - wg;
  float2* slot = red + (parity * kMaxWarps + wg) * kMaxRowsPerStep;
  // The RS rows side by side at every step, so that their shuffle chains
  // overlap: x, then the maxima, then the sums of exponentials (each a tree
  // over the chunks, then over the warp).
  float x[RS][KC][4], xt[RS], mx[RS], sm[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    xt[r] = fmaf(load1(rows[r] + cs.tail_at(N)), kLog2e, cs.vt);
    float mc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float c[4];
      load4(rows[r] + cs.chunk_at(k, ld), c);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[r][k][e] = fmaf(c[e], kLog2e, cs.v[k][e]);
      mc[k] = fmaxf(fmaxf(x[r][k][0], x[r][k][1]), fmaxf(x[r][k][2], x[r][k][3]));
    }
#pragma unroll
    for (int h = 1; h < KC; h *= 2)
#pragma unroll
      for (int k = 0; k + h < KC; k += 2 * h) mc[k] = fmaxf(mc[k], mc[k + h]);
    mx[r] = fmaxf(mc[0], xt[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RS; ++r) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const float sh = mx[r] == kEmpty ? 0.f : mx[r];  // a warp with no column in range
    float mc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k)
      mc[k] = (ex2(x[r][k][0] - sh) + ex2(x[r][k][1] - sh)) +
              (ex2(x[r][k][2] - sh) + ex2(x[r][k][3] - sh));
#pragma unroll
    for (int h = 1; h < KC; h *= 2)
#pragma unroll
      for (int k = 0; k + h < KC; k += 2 * h) mc[k] += mc[k + h];
    sm[r] = mc[0] + ex2(xt[r] - sh);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RS; ++r) sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], off);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RS; ++r) slot[w * kMaxRowsPerStep + r] = make_float2(mx[r], sm[r]);
  named_sync(bar, 32 * W);
  // Every aligned run of W lanes reads the W warps' (max, sum) and merges
  // them in a tree, so every lane holds the row's total.
  float Mp[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const float2 p = slot[(lane % W) * kMaxRowsPerStep + r];
    Mp[r] = p.x, S[r] = p.y;
  }
#pragma unroll
  for (int r = 0; r < RS; ++r) M[r] = Mp[r];
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RS; ++r) M[r] = fmaxf(M[r], __shfl_xor_sync(0xffffffffu, M[r], off));
#pragma unroll
  for (int r = 0; r < RS; ++r) S[r] = Mp[r] == kEmpty ? 0.f : S[r] * ex2(Mp[r] - M[r]);
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RS; ++r) S[r] += __shfl_xor_sync(0xffffffffu, S[r], off);
}

// One step of a group over RS rows (valid if ok[r], the valid rows first;
// mu2 already in base 2; the rest as row_lse): U[r] = mu2[r] -
// lse2_j(C2[r, j] + v[j]), then the rows are folded into the columns'
// accumulators. An invalid row reads a valid one.
template <typename T, int W, int KC, int RS>
__device__ __forceinline__ void row_step(Columns<W, KC>& cs, const T* const (&rows)[RS],
                                         const bool (&ok)[RS], const float (&mu2)[RS], int N,
                                         int ld, float2* red, int parity, int wg, int bar,
                                         float (&U)[RS]) {
  float M[RS], S[RS];
  row_lse<T, W, KC, RS>(cs, rows, N, ld, red, parity, wg, bar, M, S);
#pragma unroll
  for (int r = 0; r < RS; ++r) U[r] = mu2[r] - (M[r] + lg2(S[r]));
  // The fold reads the rows again from shared memory.
  cs.fold_rows(rows, ok, ld, N, U);
}

// The pair's barrier over the kThreads threads of each of its blocks:
// returns once `target` block arrivals are counted on ctr. Writes before it
// are visible to the pair's blocks after it (read them with __ldcg, past
// L1).
__device__ __forceinline__ void pair_barrier(unsigned* ctr, unsigned target) {
  named_sync(1, kThreads);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(ctr) : "memory");
    } while (seen < target);
  }
  named_sync(1, kThreads);
}

// v of columns [j0, j1) from the pair's `parts` partials ([parts][2][N]):
// `sub` threads a column (a power of two, as many as the block's threads
// allow), each taking every sub-th partial, kCh at a time with all their
// loads in flight: an online (max, sum) over the chunks, then the shuffle
// tree over the sub threads. Every column has entries in some partial, so
// its max is finite, and an empty partial (-inf, 0) adds 0. Writes v in
// base 2 to vbuf and, if v_out, in base e there.
__device__ __forceinline__ void reduce_slice(const float* part, int parts, int N, int j0, int j1,
                                             const float* __restrict__ nu, float* vbuf,
                                             float* v_out) {
  constexpr int kCh = 8;
  const int cols = j1 - j0;
  int sub = 32;
  while (sub > 1 && sub * cols > kThreads) sub >>= 1;
  for (int base = 0; base < cols * sub; base += kThreads) {
    const int item = base + threadIdx.x;
    const bool active = item < cols * sub;
    const int j = j0 + item / sub, l = item % sub;
    const float* pm = part + j;
    float M = kEmpty, S = 0.f;
    for (int p0 = l; active && p0 < parts; p0 += kCh * sub) {
      float mv[kCh], sv[kCh];
#pragma unroll
      for (int i = 0; i < kCh; ++i) {
        const int p = p0 + i * sub;
        mv[i] = p < parts ? __ldcg(pm + static_cast<size_t>(2 * p) * N) : kEmpty;
        sv[i] = p < parts ? __ldcg(pm + static_cast<size_t>(2 * p + 1) * N) : 0.f;
      }
      float cm = mv[0];
#pragma unroll
      for (int i = 1; i < kCh; ++i) cm = fmaxf(cm, mv[i]);
      if (cm > M) {
        S *= ex2(M - cm);
        M = cm;
      }
#pragma unroll
      for (int i = 0; i < kCh; ++i) S += sv[i] * ex2(mv[i] - M);
    }
    float Mw = M;
    for (int off = 1; off < sub; off <<= 1) Mw = fmaxf(Mw, __shfl_xor_sync(0xffffffffu, Mw, off));
    S = M == kEmpty ? 0.f : S * ex2(M - Mw);
    for (int off = 1; off < sub; off <<= 1) S += __shfl_xor_sync(0xffffffffu, S, off);
    if (active && l == 0) {
      const float V = nu[j] * kLog2e - (Mw + lg2(S));
      vbuf[j] = V;
      if (v_out) v_out[j] = V * kLn2;
    }
  }
}

}  // namespace sinkhorn
