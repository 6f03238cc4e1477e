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
// iterations (22 bands of 47 rows at 1025^2, row pitch padded to 4, with
// the band's mu). The 16 warps form groups of W warps (4 at 1025^2) that
// each take RS rows at a time (sinkhorn.cuh: v and the column accumulators
// in registers, one exponential per entry and direction, plus one rescale
// per column and step); the column update goes through the groups' merge
// in shared memory, one partial per block, a barrier of the pair's blocks,
// a reduce of the block's slice of columns and a second barrier. Pairs that do not fit at
// once (16 x 4.2 MB > 132 x 227 KB) run in waves of `ppw` pairs, looped
// inside the launch: one launch per call.

#include "sinkhorn.cuh"

namespace {

using namespace sinkhorn;

template <int W, int KC, int RS>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_resident(const float* __restrict__ c, const float* __restrict__ mu,
                  const float* __restrict__ nu, float* __restrict__ u_out,
                  float* __restrict__ v_out, float* part, float* vbuf, unsigned* ctr, int B, int M,
                  int N, int iters, int rows, int cpp, int ppw) {
  constexpr int G = kMaxWarps / W;  // groups of the block (kThreads / 32 warps)
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = (N + 3) & ~3;
  float* band = reinterpret_cast<float*>(smem);                           // [rows, ld]
  float2* red = reinterpret_cast<float2*>(band + static_cast<size_t>(rows) * ld);
  float* merge = reinterpret_cast<float*>(red + kRedBytes / 8);             // [2, N]
  float* mu_s = merge + 2 * N;                                             // [rows]
  const int warp = threadIdx.x >> 5, g = warp / W;
  Columns<W, KC> cs;
  cs.t = threadIdx.x - g * 32 * W;
  cs.tail = max(0, N - 4 * 32 * W * KC);
  const int slot = blockIdx.x / cpp, k = blockIdx.x - slot * cpp;
  const int r0 = k * rows;
  const int cols = (N + cpp - 1) / cpp, j0 = min(N, k * cols), j1 = min(N, j0 + cols);
  int parity = 0;
  for (int b = slot; b < B; b += ppw) {  // the waves
    const int nr = max(0, min(rows, M - r0));
    const float* cb = c + (static_cast<size_t>(b) * M + r0) * N;
    for (int idx = threadIdx.x; idx < nr * ld; idx += kThreads) {
      const int i = idx / ld, j = idx - i * ld;
      band[idx] = j < N ? cb[static_cast<size_t>(i) * N + j] : kPad;
    }
    for (int i = threadIdx.x; i < nr; i += kThreads)
      mu_s[i] = mu[static_cast<size_t>(b) * M + r0 + i] * kLog2e;
    __syncthreads();
    if (iters <= 0) {
      for (int i = threadIdx.x; i < nr; i += kThreads)
        u_out[static_cast<size_t>(b) * M + r0 + i] = 0.f;
      for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
        v_out[static_cast<size_t>(b) * N + j] = 0.f;
      continue;
    }
    float* part_b = part + static_cast<size_t>(b) * cpp * 2 * N;
    float* vb = vbuf + static_cast<size_t>(b) * N;
    unsigned target = 0;
    cs.set_v(nullptr, N);
    for (int it = 0; it < iters; ++it) {
      const bool last = it == iters - 1;
      cs.reset();
      for (int i0 = g * RS; i0 < nr; i0 += G * RS, parity ^= 1) {
        const float* rp[RS];
        bool ok[RS];
        float mu2[RS], U[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          ok[r] = i0 + r < nr;
          rp[r] = band + static_cast<size_t>(ok[r] ? i0 + r : 0) * ld;
          mu2[r] = ok[r] ? mu_s[i0 + r] : 0.f;
        }
        row_step<float, W, KC, RS>(cs, rp, ok, mu2, N, ld, red, parity, g * W, 2 + g, U);
        if (last && cs.t == 0)
#pragma unroll
          for (int r = 0; r < RS; ++r)
            if (ok[r]) u_out[static_cast<size_t>(b) * M + r0 + i0 + r] = U[r] * kLn2;
      }
      cs.merge_groups(merge, N, g, G);
      if (g == 0) cs.store(part_b + static_cast<size_t>(k) * 2 * N, N, N);
      pair_barrier(ctr + b, target += cpp);
      reduce_slice(part_b, cpp, N, j0, j1, nu + static_cast<size_t>(b) * N, vb,
                   last ? v_out + static_cast<size_t>(b) * N : nullptr);
      if (!last) {
        pair_barrier(ctr + b, target += cpp);
        cs.set_v(vb, N);
      }
    }
    __syncthreads();  // the next wave overwrites the band
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, float*, float*,
                        unsigned*, int, int, int, int, int, int, int);

// The instantiations, X(W warps a group, KC chunks a thread, RS rows a
// step), RS as many as the registers allow. The one list of them: the
// wrapper (ops/kernels/sinkhorn.py, through _build.variants) reads it and
// plans only with its entries, and pick() expands it.
#define VARIANTS(X) \
  X(4, 1, 4) X(4, 2, 4) X(8, 1, 2) X(8, 2, 2) X(16, 1, 2) X(16, 2, 2) X(16, 3, 1) X(16, 4, 1)

Kernel pick(int W, int KC) {
#define CASE(w, kc, rs) \
  if (W == w && KC == kc) return sinkhorn_resident<w, kc, rs>;
  VARIANTS(CASE)
#undef CASE
  return nullptr;
}

cudaError_t allow(Kernel fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

}  // namespace

// Blocks of the (W, KC) instantiation resident on the card at once with
// `smem` bytes of dynamic shared memory each; a negative CUDA error code on
// failure.
extern "C" int sinkhorn_max_blocks(int W, int KC, int smem) {
  const Kernel fn = pick(W, KC);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow(fn);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// c [B, M, N]; mu [B, M]; nu [B, N]; outputs u [B, M], v [B, N]; scratch
// part [B, cpp, 2, N], vbuf [B, N], ctr [B] (zero at launch).
// Grid cpp * ppw blocks, each holding `rows` rows;
// cudaErrorCooperativeLaunchTooLarge if they cannot all be resident.
extern "C" int sinkhorn_launch(const float* c, const float* mu, const float* nu, float* u,
                               float* v, float* part, float* vbuf, unsigned* ctr, int B, int M,
                               int N, int iters, int rows, int cpp, int ppw, int W, int KC,
                               int smem, cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  const Kernel fn = pick(W, KC);
  if (fn == nullptr || N > 4 * 32 * W * KC + 32 * W) return cudaErrorInvalidValue;
  cudaError_t err = allow(fn);
  if (err != cudaSuccess) return err;
  void* args[] = {&c, &mu, &nu, &u, &v, &part, &vbuf, &ctr, &B, &M, &N, &iters, &rows, &cpp, &ppw};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(cpp * ppw),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
