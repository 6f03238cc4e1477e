// Log-space Sinkhorn with the coupling streamed from device memory (K7).
//
// Replaces onepose_tpu/ops/pallas/sinkhorn_stream.py::sinkhorn_potentials_streamed:
// the contract of sinkhorn.cu, for couplings too large to stay in shared
// memory (4097^2 fp32 is 67 MB a pair), in the Pallas kernel's order: each
// row block's u comes from the previous iteration's v, the block's share of
// lse_col(C + u) is folded into an online accumulator,
//   m_new = max(m_acc, m2), s = s * exp(m_acc - m_new) + s2 * exp(m2 - m_new),
// and v is finalised once every row block of the iteration is done. The
// accumulator starts empty (-inf, taken over as it is by the first merge)
// rather than at NEG_INF: see lse_merge in sinkhorn.cuh.
//
// Bound on the H100: counting each input byte once, the exponentials,
// 2 * B * M * N * iters = 2.35e10 at [7, 4097, 4097] x 100, about 5.6 ms;
// the design's own floor is one sweep of the coupling per iteration, 470 MB
// at that shape: 14 ms in fp32, 7 ms with the coupling stored in bf16.
//
// Design. One persistent cooperative launch (one per call). The blocks of
// a pair split its rows (18 blocks of 228 rows a pair at [7, 4097, 4097]);
// in every iteration each block streams its rows through shared memory in
// blocks of `block_rows` rows (11 at a row pitch of 4104), loaded with 16
// bytes per thread and converted to fp32, and uses each row block for both
// the row update and the column fold, so the coupling is read once per
// iteration. The column accumulators live in shared memory and go to the
// per-block partials at the end of the iteration; after a grid-wide
// barrier every block of the pair reduces them into v (sinkhorn.cuh).
// The coupling's row pitch `ldc` is a multiple of 8 elements, so that every
// row starts 16-byte aligned; columns at and past n are never read.

#include <cuda_bf16.h>

#include "sinkhorn.cuh"

namespace {

using namespace sinkhorn;

// 16 bytes of the stored coupling as fp32: 4 floats or 8 bf16.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float4 lo, hi;
  float2 f = __bfloat1622float2(h[0]);
  lo.x = f.x, lo.y = f.y;
  f = __bfloat1622float2(h[1]);
  lo.z = f.x, lo.w = f.y;
  f = __bfloat1622float2(h[2]);
  hi.x = f.x, hi.y = f.y;
  f = __bfloat1622float2(h[3]);
  hi.z = f.x, hi.w = f.y;
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_stream(const T* __restrict__ c, const float* __restrict__ mu,
                const float* __restrict__ nu, float* __restrict__ u_out,
                float* __restrict__ v_out, float* part, int B, int M, int N, int ldc, int iters,
                int block_rows, int rows, int cpp, int ppw) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* Cs = smem;                                       // [block_rows, ldc]
  float* v = Cs + static_cast<size_t>(block_rows) * ldc;  // [ldc]
  float* acc_m = v + ldc;                                 // [ldc]
  float* acc_s = acc_m + ldc;                             // [ldc]
  float* u = acc_s + ldc;                                 // [block_rows]
  const int slot = blockIdx.x / cpp, k = blockIdx.x - slot * cpp;
  const int r0 = k * rows;
  const int waves = (B + ppw - 1) / ppw;
  int step = 0;
  for (int w = 0; w < waves; ++w) {
    const int b = w * ppw + slot;
    const bool active = b < B;
    const int r1 = active ? min(M, r0 + rows) : r0;
    const float* mu_b = mu + static_cast<size_t>(b) * M;
    if (active)
      for (int j = threadIdx.x; j < N; j += blockDim.x) v[j] = 0.f;
    __syncthreads();
    for (int it = 0; it < iters; ++it, ++step) {
      if (active) {
        for (int j = threadIdx.x; j < N; j += blockDim.x) acc_m[j] = kEmpty, acc_s[j] = 0.f;
        for (int blk = r0; blk < r1; blk += block_rows) {
          const int nr = min(block_rows, r1 - blk);
          const T* src = c + (static_cast<size_t>(b) * M + blk) * ldc;
          const int n_vec = nr * ldc / kVec;
          for (int q = threadIdx.x; q < n_vec; q += blockDim.x)
            load16(src + q * kVec, Cs + q * kVec);
          __syncthreads();
          row_update(Cs, ldc, nr, N, v, mu_b + blk, u);  // u from the previous v
          __syncthreads();
          for (int i = threadIdx.x; i < nr; i += blockDim.x)
            u_out[static_cast<size_t>(b) * M + blk + i] = u[i];
          for (int j = threadIdx.x; j < N; j += blockDim.x) {  // fold C + u into the columns
            float m2, s2;
            column_stats(Cs, ldc, nr, u, j, m2, s2);
            float m = acc_m[j], s = acc_s[j];
            lse_merge(m, s, m2, s2);
            acc_m[j] = m;
            acc_s[j] = s;
          }
          __syncthreads();  // the next row block overwrites Cs and u
        }
        float* pk = partial(part, step & 1, B, b, cpp, k, N);
        for (int j = threadIdx.x; j < N; j += blockDim.x) {
          pk[j] = acc_m[j];
          pk[N + j] = acc_s[j];
        }
      }
      cg::this_grid().sync();
      if (active) reduce_v(partial(part, step & 1, B, b, cpp, 0, N), cpp, N,
                           nu + static_cast<size_t>(b) * N, v);
      __syncthreads();
    }
    if (active && k == 0)
      for (int j = threadIdx.x; j < N; j += blockDim.x)
        v_out[static_cast<size_t>(b) * N + j] = v[j];
    __syncthreads();
  }
}

template <typename T>
cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(sinkhorn_stream<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Blocks of the kernel resident on the card at once with `smem` bytes of
// dynamic shared memory each (the same for both storage types); a negative
// CUDA error code on failure.
extern "C" int sinkhorn_stream_max_blocks(int smem) {
  cudaError_t err = set_smem<float>(smem);
  if (err == cudaSuccess) err = set_smem<__nv_bfloat16>(smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_stream<float>, kThreads,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// c [B, M, ldc] fp32 or bf16 (bf16 != 0), ldc a multiple of 8 and >= N;
// mu [B, M]; nu [B, N]; outputs u [B, M], v [B, N]; scratch part
// [2, B, cpp, 2, N]. Grid cpp * ppw blocks;
// cudaErrorCooperativeLaunchTooLarge if they cannot all be resident.
extern "C" int sinkhorn_stream_launch(const void* c, int bf16, const float* mu, const float* nu,
                                      float* u, float* v, float* part, int B, int M, int N,
                                      int ldc, int iters, int block_rows, int rows, int cpp,
                                      int ppw, int smem, cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  if (ldc % 8 != 0 || ldc < N) return cudaErrorInvalidValue;
  cudaError_t err = bf16 ? set_smem<__nv_bfloat16>(smem) : set_smem<float>(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&c, &mu, &nu, &u, &v, &part, &B, &M, &N, &ldc, &iters, &block_rows, &rows,
                  &cpp, &ppw};
  const void* fn = bf16 ? reinterpret_cast<const void*>(sinkhorn_stream<__nv_bfloat16>)
                        : reinterpret_cast<const void*>(sinkhorn_stream<float>);
  err = cudaLaunchCooperativeKernel(fn, dim3(cpp * ppw), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
