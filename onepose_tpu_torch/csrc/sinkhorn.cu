// Log-space Sinkhorn with the coupling resident in shared memory (K6).
//
// Replaces onepose_tpu/ops/pallas/sinkhorn.py::sinkhorn_potentials:
//   u = mu - lse_row(C + v), then v = nu - lse_col(C + u), `iters` times
//   from u = v = 0, for couplings C [B, M, N] fp32 (masked slots -1e9).
//
// Bound on the H100: operations, the exponentials: one per coupling entry
// for the row update and one for the column update, 2 * B * M * N * iters
// = 3.4e9 at [16, 1025, 1025] x 100, about 0.8 ms at 16 per clock on each
// of the 132 SMs' special-function units. The coupling is read from device
// memory once.
//
// Design. A 1025^2 fp32 coupling is 4.2 MB, more than a block's 227 KB of
// shared memory and more than a 16-block cluster holds, so its rows are
// split in bands over the SMs: one persistent cooperative launch, one band
// of whole rows of one pair per block, in dynamic shared memory for all
// iterations (19 bands of 54 rows at 1025^2). The row update is local to
// the band; the column update goes through per-block partials and one
// grid-wide barrier per iteration (sinkhorn.cuh). Pairs that do not fit at
// once (16 x 4.2 MB > 132 x 227 KB) run in waves of `ppw` pairs, looped
// inside the launch: one launch per call. Blocks of a wave with no pair
// (the last wave) only take part in the barriers.

#include "sinkhorn.cuh"

namespace {

using namespace sinkhorn;

__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_resident(const float* __restrict__ c, const float* __restrict__ mu,
                  const float* __restrict__ nu, float* __restrict__ u_out,
                  float* __restrict__ v_out, float* part, int B, int M, int N, int iters, int rows,
                  int cpp, int ppw) {
  extern __shared__ float smem[];
  float* C = smem;                                // [rows, N]
  float* v = C + static_cast<size_t>(rows) * N;   // [N]
  float* u = v + N;                               // [rows]
  const int slot = blockIdx.x / cpp, k = blockIdx.x - slot * cpp;
  const int r0 = k * rows;
  const int waves = (B + ppw - 1) / ppw;
  int step = 0;
  for (int w = 0; w < waves; ++w) {
    const int b = w * ppw + slot;
    const bool active = b < B;
    const int nr = active ? max(0, min(rows, M - r0)) : 0;
    if (active) {
      const float* cb = c + (static_cast<size_t>(b) * M + r0) * N;
      for (int idx = threadIdx.x; idx < nr * N; idx += blockDim.x) C[idx] = cb[idx];
      for (int j = threadIdx.x; j < N; j += blockDim.x) v[j] = 0.f;
      for (int i = threadIdx.x; i < nr; i += blockDim.x) u[i] = 0.f;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it, ++step) {
      if (active) {
        row_update(C, N, nr, N, v, mu + static_cast<size_t>(b) * M + r0, u);
        __syncthreads();
        float* pk = partial(part, step & 1, B, b, cpp, k, N);
        for (int j = threadIdx.x; j < N; j += blockDim.x) {
          float m2, s2;
          column_stats(C, N, nr, u, j, m2, s2);
          pk[j] = m2;
          pk[N + j] = s2;
        }
      }
      cg::this_grid().sync();
      if (active) reduce_v(partial(part, step & 1, B, b, cpp, 0, N), cpp, N,
                           nu + static_cast<size_t>(b) * N, v);
      __syncthreads();
    }
    if (active) {
      for (int i = threadIdx.x; i < nr; i += blockDim.x)
        u_out[static_cast<size_t>(b) * M + r0 + i] = u[i];
      if (k == 0)
        for (int j = threadIdx.x; j < N; j += blockDim.x)
          v_out[static_cast<size_t>(b) * N + j] = v[j];
    }
    __syncthreads();  // the next wave overwrites shared memory
  }
}

}  // namespace

// Blocks of the kernel resident on the card at once with `smem` bytes of
// dynamic shared memory each; a negative CUDA error code on failure.
extern "C" int sinkhorn_max_blocks(int smem) {
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_resident,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_resident, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// c [B, M, N]; mu [B, M]; nu [B, N]; outputs u [B, M], v [B, N]; scratch
// part [2, B, cpp, 2, N]. Grid cpp * ppw blocks, each holding `rows` rows;
// cudaErrorCooperativeLaunchTooLarge if they cannot all be resident.
extern "C" int sinkhorn_launch(const float* c, const float* mu, const float* nu, float* u,
                               float* v, float* part, int B, int M, int N, int iters,
                               int rows, int cpp, int ppw, int smem, cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_resident,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&c, &mu, &nu, &u, &v, &part, &B, &M, &N, &iters, &rows, &cpp, &ppw};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sinkhorn_resident),
                                    dim3(cpp * ppw), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
