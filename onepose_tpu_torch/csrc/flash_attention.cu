// Flash attention with a key mask, fp32: the forward and its two backward
// kernels (K8).
//
// Replaces the library Pallas kernels that
// onepose_tpu/models/common.py::_flash_softmax_attention (:119) reaches
// through jax.experimental.pallas.ops.tpu.flash_attention:
//   _flash_attention_impl (flash_attention.py:589, pallas_call :758),
//   _flash_attention_bwd_dkv (:941, pallas_call :1121),
//   _flash_attention_bwd_dq (:1287, pallas_call :1456),
// joined there by a custom VJP (:204-300), here by
// ops/kernels/flash_attention.py::FlashAttention.
//
// What they compute, for q [B, N, H, D], k and v [B, M, H, D] (the JAX
// layout, read through its strides: nothing is transposed) and a bool key
// mask [B, M] or none:
//   s   = (q . k) * scale                     (scale after the product)
//   o   = softmax_j(s + mask) . v,  lse = log-sum-exp_j of the row
// Masked keys weigh exactly 0, as -0.7 * FLT_MAX added in fp32 gives them
// wherever the row has a valid key. A row whose keys are all masked writes
// o = 0 (JAX zeroes it after its kernel) and lse = +inf, so every
// recomputed weight exp(s - lse) of it is 0 and its gradients are 0.
// Backward, with di = sum_d o * do (computed outside, as JAX does):
//   p = exp(s - lse), dp = do . v, ds = p * (dp - di)
//   dv = p^T do,  dk = scale * ds^T q,  dq = scale * ds k.
//
// Bound on the H100: operations, fp32 outside the tensor cores (67
// TFLOP/s). The forward is 4 B H N M D flops (120.3 GFLOP, 1.795 ms at
// [7, 4096, 4096, 4, 64]); the backward one recompute of S plus dV, dP,
// dQ and dK, 10 B H N M D (300.6 GFLOP, 4.49 ms). Bytes are far below
// (q, k, v, o are 29.4 MB each there), and so are the exponentials.
//
// Design: simple and fp32 throughout (no TF32, no tensor cores). A block
// of 256 threads owns a 64-row tile and loops over the 64-row tiles of the
// other side, staging them in shared memory (row pitch DP + 4 floats, so
// that 16 threads reading 16 rows at one column hit distinct banks). The
// 16 x 16 threads each own 4 rows (ty * 4 + i) and 4 strided columns
// (tx + 16 j) of a 64 x 64 score tile, then 4 rows and DP / 16 contiguous
// head channels (tx * DP / 16 + k) of the product with the other side; a
// row's max and sum are reduced over its 16 lanes by shuffles. A key tile
// with no valid key is skipped whole (__syncthreads_or); an example with
// none writes zeros. Ragged tails are zero-filled in shared memory and
// masked like invalid keys (queries: lse = +inf), and nothing past them is
// read or written. dK and dV are summed by the block that owns the key
// tile, in registers, so the backward needs no atomics and is
// deterministic. DP, the head dimension padded with zeros, is 64 or 128;
// every D <= 128 runs.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kTile = 64;      // rows of a tile on either side
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kTile + 4; // pitch of a 64 x 64 score tile in shared memory

template <int DP>
struct Layout {
  static constexpr int LD = DP + 4;  // pitch of a [64, DP] operand tile
  static constexpr int DC = DP / 16; // head channels a thread owns
  static constexpr int kOperand = kTile * LD;
};

// dst[r][d] = src[r * stride + d] for r < rows, d < D; zeros elsewhere.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          size_t stride, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (r < rows && d < D) x = src[static_cast<size_t>(r) * stride + d];
    dst[r * Layout<DP>::LD + d] = x;
  }
}

// acc[i][j] += a[ty * 4 + i] . b[tx + 16 j] over DP channels, both tiles [64][LD].
template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = Layout<DP>::LD;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][k] += sum_c w[ty * 4 + i][c] * x[c][tx * DC + k]: w [64][kLP], x [64][LD].
template <int DP>
__device__ __forceinline__ void mix_tile(float (&acc)[4][Layout<DP>::DC], const float* w,
                                         const float* x, int ty, int tx) {
  constexpr int LD = Layout<DP>::LD, DC = Layout<DP>::DC;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(w + (ty * 4 + i) * kLP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float xv[DC];
#pragma unroll
      for (int k = 0; k < DC; k += 4) {
        const float4 t = *reinterpret_cast<const float4*>(x + (c + cc) * LD + tx * DC + k);
        xv[k] = t.x;
        xv[k + 1] = t.y;
        xv[k + 2] = t.z;
        xv[k + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int k = 0; k < DC; ++k) acc[i][k] = fmaf(pi, xv[k], acc[i][k]);
      }
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool key_valid(const uint8_t* __restrict__ mask, int b, int M, int c) {
  return c < M && (mask == nullptr || mask[static_cast<size_t>(b) * M + c] != 0);
}

// Store acc * mul to out's rows r0 + ty * 4 + i (< rows), channels < D.
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&acc)[4][Layout<DP>::DC],
                                           const float (&mul)[4], int rows, size_t stride, int D,
                                           int ty, int tx) {
  constexpr int DC = Layout<DP>::DC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      const int d = tx * DC + k;
      if (d < D) out[static_cast<size_t>(r) * stride + d] = acc[i][k] * mul[i];
    }
  }
}

// Forward: grid (ceil(N / 64), H, B); one block per 64-query tile of (b, h).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const uint8_t* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int N,
          int M, int H, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::kOperand;
  float* vs = ks + L::kOperand;
  float* ps = vs + L::kOperand;  // [64][kLP]
  int* valid = reinterpret_cast<int*>(ps + kTile * kLP);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, n0 = blockIdx.x * kTile;
  const int nq = min(kTile, N - n0);
  const size_t stride = static_cast<size_t>(H) * D;
  load_tile<DP>(qs, q + (static_cast<size_t>(b) * N + n0) * stride + h * D, nq, stride, D);

  float m_run[4], l_run[4], acc[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L::DC; ++kk) acc[i][kk] = 0.f;
  }
  for (int c0 = 0; c0 < M; c0 += kTile) {
    const bool mine = threadIdx.x < kTile && key_valid(mask, b, M, c0 + threadIdx.x);
    if (!__syncthreads_or(mine)) continue;  // also: the last tile's readers are done
    if (threadIdx.x < kTile) valid[threadIdx.x] = mine;
    const int nk = min(kTile, M - c0);
    const size_t off = (static_cast<size_t>(b) * M + c0) * stride + h * D;
    load_tile<DP>(ks, k + off, nk, stride, D);
    load_tile<DP>(vs, v + off, nk, stride, D);
    __syncthreads();

    float s[4][4] = {};
    dot_tile<DP>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[tx + 16 * j] ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));  // finite: the tile has a valid key
      const float alpha = expf(m_run[i] - m_new);              // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + half_warp_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < L::DC; ++kk) acc[i][kk] *= alpha;
    }
    __syncthreads();
    mix_tile<DP>(acc, ps, vs, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;  // 0: no valid key
  store_rows<DP>(o + (static_cast<size_t>(b) * N + n0) * stride + h * D, acc, inv, nq, stride, D,
                 ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < nq)
        lse[(static_cast<size_t>(b) * N + n0 + r) * H + h] =
            l_run[i] > 0.f ? m_run[i] + logf(l_run[i]) : CUDART_INF_F;
    }
  }
}

// The query tile's lse (+inf past N: weight 0) and di (0 past N).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* di_s, const float* __restrict__ lse,
                                               const float* __restrict__ di, int b, int n0, int N,
                                               int H, int h) {
  if (threadIdx.x < kTile) {
    const int r = n0 + threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * N + r) * H + h;
    lse_s[threadIdx.x] = r < N ? lse[at] : CUDART_INF_F;
    di_s[threadIdx.x] = r < N ? di[at] : 0.f;
  }
}

// dK and dV: grid (ceil(M / 64), H, B); one block per 64-key tile of (b, h),
// looping over the query tiles. Rows of the score tiles here are keys.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ mask, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk,
              float* __restrict__ dv, int N, int M, int H, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + L::kOperand;
  float* qs = vs + L::kOperand;
  float* dos = qs + L::kOperand;
  float* pt = dos + L::kOperand;  // [64 keys][kLP queries]
  float* dst = pt + kTile * kLP;
  float* lse_s = dst + kTile * kLP;
  float* di_s = lse_s + kTile;
  int* valid = reinterpret_cast<int*>(di_s + kTile);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, c0 = blockIdx.x * kTile;
  const int nk = min(kTile, M - c0);
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t off = (static_cast<size_t>(b) * M + c0) * stride + h * D;

  float acc_k[4][L::DC], acc_v[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < L::DC; ++kk) acc_k[i][kk] = acc_v[i][kk] = 0.f;
  const bool mine = threadIdx.x < kTile && key_valid(mask, b, M, c0 + threadIdx.x);
  if (threadIdx.x < kTile) valid[threadIdx.x] = mine;
  if (__syncthreads_or(mine)) {  // else every key of the tile is masked: dk = dv = 0
    load_tile<DP>(ks, k + off, nk, stride, D);
    load_tile<DP>(vs, v + off, nk, stride, D);
    for (int n0 = 0; n0 < N; n0 += kTile) {
      __syncthreads();  // the last tile's readers are done
      const int nq = min(kTile, N - n0);
      const size_t qoff = (static_cast<size_t>(b) * N + n0) * stride + h * D;
      load_tile<DP>(qs, q + qoff, nq, stride, D);
      load_tile<DP>(dos, dout + qoff, nq, stride, D);
      load_row_stats(lse_s, di_s, lse, di, b, n0, N, H, h);
      __syncthreads();

      float p[4][4] = {}, dp[4][4] = {};
      dot_tile<DP>(p, ks, qs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool kv = valid[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          p[i][j] = kv ? expf(p[i][j] * scale - lse_s[r]) : 0.f;
          pt[(ty * 4 + i) * kLP + r] = p[i][j];
        }
      }
      dot_tile<DP>(dp, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          dst[(ty * 4 + i) * kLP + r] = p[i][j] * (dp[i][j] - di_s[r]);
        }
      __syncthreads();
      mix_tile<DP>(acc_v, pt, dos, ty, tx);
      mix_tile<DP>(acc_k, dst, qs, ty, tx);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f}, sc[4] = {scale, scale, scale, scale};
  store_rows<DP>(dv + off, acc_v, one, nk, stride, D, ty, tx);
  store_rows<DP>(dk + off, acc_k, sc, nk, stride, D, ty, tx);
}

// dQ: grid (ceil(N / 64), H, B); one block per 64-query tile of (b, h),
// looping over the key tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const uint8_t* __restrict__ mask, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq,
             int N, int M, int H, int D, float scale) {
  using L = Layout<DP>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + L::kOperand;
  float* ks = dos + L::kOperand;
  float* vs = ks + L::kOperand;
  float* dss = vs + L::kOperand;  // [64 queries][kLP keys]
  float* lse_s = dss + kTile * kLP;
  float* di_s = lse_s + kTile;
  int* valid = reinterpret_cast<int*>(di_s + kTile);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z, n0 = blockIdx.x * kTile;
  const int nq = min(kTile, N - n0);
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t qoff = (static_cast<size_t>(b) * N + n0) * stride + h * D;
  load_tile<DP>(qs, q + qoff, nq, stride, D);
  load_tile<DP>(dos, dout + qoff, nq, stride, D);
  load_row_stats(lse_s, di_s, lse, di, b, n0, N, H, h);

  float acc[4][L::DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < L::DC; ++kk) acc[i][kk] = 0.f;
  for (int c0 = 0; c0 < M; c0 += kTile) {
    const bool mine = threadIdx.x < kTile && key_valid(mask, b, M, c0 + threadIdx.x);
    if (!__syncthreads_or(mine)) continue;  // also: the last tile's readers are done
    if (threadIdx.x < kTile) valid[threadIdx.x] = mine;
    const int nk = min(kTile, M - c0);
    const size_t off = (static_cast<size_t>(b) * M + c0) * stride + h * D;
    load_tile<DP>(ks, k + off, nk, stride, D);
    load_tile<DP>(vs, v + off, nk, stride, D);
    __syncthreads();

    float p[4][4] = {}, dp[4][4] = {};
    dot_tile<DP>(p, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[i][j] = valid[tx + 16 * j] ? expf(p[i][j] * scale - lse_s[ty * 4 + i]) : 0.f;
    dot_tile<DP>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[r * kLP + tx + 16 * j] = p[i][j] * (dp[i][j] - di_s[r]);
    }
    __syncthreads();
    mix_tile<DP>(acc, dss, ks, ty, tx);
  }
  const float sc[4] = {scale, scale, scale, scale};
  store_rows<DP>(dq + qoff, acc, sc, nq, stride, D, ty, tx);
}

constexpr size_t fwd_smem(int dp) {
  return (3 * kTile * (dp + 4) + kTile * kLP) * sizeof(float) + kTile * sizeof(int);
}
constexpr size_t dkv_smem(int dp) {
  return (4 * kTile * (dp + 4) + 2 * kTile * kLP + 2 * kTile) * sizeof(float) + kTile * sizeof(int);
}
constexpr size_t dq_smem(int dp) {
  return (4 * kTile * (dp + 4) + kTile * kLP + 2 * kTile) * sizeof(float) + kTile * sizeof(int);
}

template <typename F>
cudaError_t launch(F* fn, size_t smem, int rows, int H, int B, cudaStream_t stream,
                   const void* const* args) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kTile - 1) / kTile, H, B);
  return cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, dim3(kThreads),
                          const_cast<void**>(args), smem, stream);
}

bool shape_ok(int B, int N, int M, int H, int D) {
  return B >= 0 && N >= 0 && M >= 0 && H > 0 && H <= 65535 && B <= 65535 && D > 0 && D <= 128;
}

}  // namespace

// q [B, N, H, D], k and v [B, M, H, D], mask [B, M] (uint8) or null; writes
// o [B, N, H, D] and lse [B, N, H]. D <= 128.
extern "C" int flash_attention_fwd_launch(const float* q, const float* k, const float* v,
                                          const uint8_t* mask, float* o, float* lse, int B, int N,
                                          int M, int H, int D, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const void* args[] = {&q, &k, &v, &mask, &o, &lse, &N, &M, &H, &D, &scale};
  cudaError_t err = D <= 64 ? launch(flash_fwd<64>, fwd_smem(64), N, H, B, stream, args)
                            : launch(flash_fwd<128>, fwd_smem(128), N, H, B, stream, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dK / dV kernel: dk and dv [B, M, H, D] from the forward's inputs, its
// lse, dout [B, N, H, D] and di [B, N, H].
extern "C" int flash_attention_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                              const uint8_t* mask, const float* dout,
                                              const float* lse, const float* di, float* dk,
                                              float* dv, int B, int N, int M, int H, int D,
                                              float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  const void* args[] = {&q, &k, &v, &mask, &dout, &lse, &di, &dk, &dv, &N, &M, &H, &D, &scale};
  cudaError_t err = D <= 64 ? launch(flash_bwd_dkv<64>, dkv_smem(64), M, H, B, stream, args)
                            : launch(flash_bwd_dkv<128>, dkv_smem(128), M, H, B, stream, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dQ kernel: dq [B, N, H, D].
extern "C" int flash_attention_bwd_dq_launch(const float* q, const float* k, const float* v,
                                             const uint8_t* mask, const float* dout,
                                             const float* lse, const float* di, float* dq, int B,
                                             int N, int M, int H, int D, float scale,
                                             cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const void* args[] = {&q, &k, &v, &mask, &dout, &lse, &di, &dq, &N, &M, &H, &D, &scale};
  cudaError_t err = D <= 64 ? launch(flash_bwd_dq<64>, dq_smem(64), N, H, B, stream, args)
                            : launch(flash_bwd_dq<128>, dq_smem(128), N, H, B, stream, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}
