// Log-space Sinkhorn with the coupling streamed from device memory (K7).
//
// Replaces onepose_tpu/ops/pallas/sinkhorn_stream.py::sinkhorn_potentials_streamed:
// the contract of sinkhorn.cu, for couplings too large to stay in shared
// memory (4097^2 fp32 is 67 MB a pair), in the Pallas kernel's order: each
// row's u comes from the previous iteration's v, the row's share of
// lse_col(C + u) is folded into online column accumulators at once, and v
// is finalised once every row of the iteration is done, so one iteration
// reads the coupling once.
//
// Bound on the H100: counting each input byte once, the exponentials,
// 2 * B * M * N * iters = 2.35e10 at [7, 4097, 4097] x 100, about 5.6 ms;
// the design's own floor is one sweep of the coupling per iteration, 470 MB
// at that shape: 14 ms in fp32, 7 ms with the coupling stored in bf16.
//
// Design. One persistent cooperative launch (one per call). The blocks of
// a pair split its rows (18 blocks of 228 rows a pair at [7, 4097, 4097]).
// Each block streams its rows, iteration after iteration and wave after
// wave, through a ring of `stages` slots of `stage_rows` rows in shared
// memory (3 slots of 4 fp32 or 8 bf16 rows, 64 KB each, at a pitch of
// 4104): one TMA bulk copy per stage, its completion counted on the slot's
// "full" mbarrier. The last of the 16 warps to finish a stage (a counter in
// shared memory) refills its slot with the stage `stages` ahead, so the
// loads run on across the iterations' ends while the pair's blocks reduce
// v, and no thread polls. (A producer warp of its own makes 544 threads,
// which ptxas caps at 96 registers: that version spilled and ran slower.)
// The warps form 16 / W groups of W warps, each taking RS rows of a stage
// at a time (two; one in the widest variants, see VARIANTS below;
// sinkhorn.cuh: v and the column accumulators in registers, one
// exponential per entry and direction, plus one rescale per column and
// step); bf16 entries are widened as they are read. The coupling's row
// pitch `ldc` is a multiple of 8 elements, so that every row starts
// 16-byte aligned and every stage is a whole number of 16-byte units;
// columns past N are padding (NEG_INF) or masked.

#include "sinkhorn.cuh"

namespace {

using namespace sinkhorn;

// The block's stages in the order they are consumed (over its waves,
// iterations and row range) and how to issue one: a TMA bulk copy into its
// slot, completion counted on the slot's "full" barrier.
template <typename T>
struct Feed {
  const T* c;
  unsigned char* ring;
  uint64_t* full;
  size_t stage_bytes;
  int M, ldc, stage_rows, stages, r0, r1, spi, slot, ppw;
  unsigned per_pair, total;  // stages per pair (iterations x spi), in all

  __device__ __forceinline__ void issue(unsigned gs) const {
    if (gs >= total) return;
    const unsigned s = gs % stages;
    const int b = slot + static_cast<int>(gs / per_pair) * ppw;
    const int row0 = r0 + static_cast<int>(gs % per_pair % spi) * stage_rows;
    const uint32_t bytes = static_cast<uint32_t>(min(stage_rows, r1 - row0)) * ldc * sizeof(T);
    hopper::mbar_expect_tx(&full[s], bytes);
    hopper::bulk_load(ring + s * stage_bytes, c + (static_cast<size_t>(b) * M + row0) * ldc, bytes,
                      &full[s]);
  }
};

template <typename T, int W, int KC, int RS>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_stream(const T* __restrict__ c, const float* __restrict__ mu,
                const float* __restrict__ nu, float* __restrict__ u_out,
                float* __restrict__ v_out, float* part, float* vbuf, unsigned* ctr, int B, int M,
                int N, int ldc, int iters, int stage_rows, int stages, int rows, int cpp,
                int ppw) {
  constexpr int G = kMaxWarps / W;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t stage_bytes = static_cast<size_t>(stage_rows) * ldc * sizeof(T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  unsigned* done = reinterpret_cast<unsigned*>(full + stages);  // warps done with a slot, mod 16
  float2* red = reinterpret_cast<float2*>(full + 2 * stages);
  // [2, N]; with one group (W = 16) there is nothing to merge, and the
  // wrapper leaves it out of the shared memory.
  float* merge = reinterpret_cast<float*>(red + kRedBytes / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x / cpp, k = blockIdx.x - slot * cpp;
  const int r0 = k * rows, r1 = min(M, r0 + rows);
  const int spi = r1 > r0 ? (r1 - r0 + stage_rows - 1) / stage_rows : 0;  // stages an iteration
  const unsigned per_pair = static_cast<unsigned>(max(iters, 0)) * spi;
  const unsigned waves = slot < B ? (B - slot + ppw - 1) / ppw : 0;
  const Feed<T> feed{c, smem, full, stage_bytes, M, ldc, stage_rows, stages, r0, r1, spi,
                     slot, ppw, per_pair, waves * per_pair};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    hopper::fence_mbar_init();
    for (int s = 0; s < stages; ++s) feed.issue(s);
  }
  __syncthreads();

  const int g = warp / W;
  Columns<W, KC> cs;
  cs.t = threadIdx.x - g * 32 * W;
  cs.tail = max(0, N - 4 * 32 * W * KC);
  const int cols = (N + cpp - 1) / cpp, j0 = min(N, k * cols), j1 = min(N, j0 + cols);
  int parity = 0;
  unsigned gs = 0;  // stages consumed
  for (int b = slot; b < B; b += ppw) {  // the waves
    if (iters <= 0) {
      for (int i = r0 + threadIdx.x; i < r1; i += kThreads)
        u_out[static_cast<size_t>(b) * M + i] = 0.f;
      for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
        v_out[static_cast<size_t>(b) * N + j] = 0.f;
      continue;
    }
    const float* mu_b = mu + static_cast<size_t>(b) * M;
    float* part_b = part + static_cast<size_t>(b) * cpp * 2 * N;
    float* vb = vbuf + static_cast<size_t>(b) * N;
    unsigned target = 0;
    cs.set_v(nullptr, N);
    for (int it = 0; it < iters; ++it) {
      const bool last = it == iters - 1;
      cs.reset();
      for (int row0 = r0; row0 < r1; row0 += stage_rows, ++gs) {
        const unsigned s = gs % stages;
        hopper::mbar_wait(&full[s], (gs / stages) & 1);
        const T* st = reinterpret_cast<const T*>(smem + s * stage_bytes);
        const int nr = min(stage_rows, r1 - row0);
        for (int i0 = g * RS; i0 < nr; i0 += G * RS, parity ^= 1) {
          const T* rp[RS];
          bool ok[RS];
          float mu2[RS], U[RS];
#pragma unroll
          for (int r = 0; r < RS; ++r) {
            ok[r] = i0 + r < nr;
            rp[r] = st + static_cast<size_t>(ok[r] ? i0 + r : 0) * ldc;
            mu2[r] = ok[r] ? mu_b[row0 + i0 + r] * kLog2e : 0.f;
          }
          row_step<T, W, KC, RS>(cs, rp, ok, mu2, N, ldc, red, parity, g * W, 2 + g, U);
          if (last && cs.t == 0)
#pragma unroll
            for (int r = 0; r < RS; ++r)
              if (ok[r]) u_out[static_cast<size_t>(b) * M + row0 + i0 + r] = U[r] * kLn2;
        }
        // The last of the 16 warps to leave the slot refills it with the
        // stage `stages` ahead.
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&done[s], 1u) % kMaxWarps == kMaxWarps - 1) {
            __threadfence_block();
            feed.issue(gs + stages);
          }
        }
      }
      cs.merge_groups(merge, N, g, G);
      if (g == 0) cs.store(part_b + static_cast<size_t>(k) * 2 * N, N);
      pair_barrier(ctr + b, target += cpp);
      reduce_slice(part_b, cpp, N, j0, j1, nu + static_cast<size_t>(b) * N, vb,
                   last ? v_out + static_cast<size_t>(b) * N : nullptr);
      if (!last) {
        pair_barrier(ctr + b, target += cpp);
        cs.set_v(vb, N);
      }
    }
  }
}

using Kernel = void (*)(const void*, const float*, const float*, float*, float*, float*, float*,
                        unsigned*, int, int, int, int, int, int, int, int, int, int);

template <typename T, int W, int KC, int RS>
Kernel as_kernel() {
  return reinterpret_cast<Kernel>(sinkhorn_stream<T, W, KC, RS>);
}

// The instantiations for each storage type, X(W warps a group, KC chunks a
// thread, RS rows a group step). The one list of them: the wrapper
// (ops/kernels/sinkhorn_stream.py, through _build.variants) reads it and
// plans only with its entries, and pick() expands it. 2 rows a step (4
// with bf16 storage, re-reading the stage for the sums to stay in 128
// registers, ran slower); one row at 5 to 7 chunks (8705 to 14848
// columns), where the column state alone takes 60 to 84 registers.
#define VARIANTS(X)                                                                   \
  X(8, 1, 2) X(8, 2, 2) X(8, 3, 2) X(8, 4, 2) X(16, 2, 2) X(16, 3, 2) X(16, 4, 2) \
  X(16, 5, 1) X(16, 6, 1) X(16, 7, 1)

template <typename T>
Kernel pick(int W, int KC) {
#define CASE(w, kc, rs) \
  if (W == w && KC == kc) return as_kernel<T, w, kc, rs>();
  VARIANTS(CASE)
#undef CASE
  return nullptr;
}

cudaError_t allow(Kernel fn) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

}  // namespace

// Blocks of the (W, KC) instantiation resident on the card at once with
// `smem` bytes of dynamic shared memory each (the same for both storage
// types); a negative CUDA error code on failure.
extern "C" int sinkhorn_stream_max_blocks(int W, int KC, int smem) {
  const Kernel fn = pick<float>(W, KC);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow(fn);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(fn), kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// c [B, M, ldc] fp32 or bf16 (bf16 != 0), ldc a multiple of 8 and >= N;
// mu [B, M]; nu [B, N]; outputs u [B, M], v [B, N]; scratch part
// [B, cpp, 2, N], vbuf [B, N], ctr [B] (zero at launch). Grid
// cpp * ppw blocks; cudaErrorCooperativeLaunchTooLarge if they cannot all
// be resident.
extern "C" int sinkhorn_stream_launch(const void* c, int bf16, const float* mu, const float* nu,
                                      float* u, float* v, float* part, float* vbuf,
                                      unsigned* ctr, int B, int M, int N, int ldc, int iters,
                                      int stage_rows, int stages, int rows, int cpp, int ppw,
                                      int W, int KC, int smem, cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  if (ldc % 8 != 0 || ldc < N || stages < 1 || stage_rows < 1) return cudaErrorInvalidValue;
  const Kernel fn = bf16 ? pick<__nv_bfloat16>(W, KC) : pick<float>(W, KC);
  if (fn == nullptr || N > 4 * 32 * W * KC + 32 * W) return cudaErrorInvalidValue;
  cudaError_t err = allow(fn);
  if (err != cudaSuccess) return err;
  void* args[] = {&c,   &mu,   &nu,         &u,      &v,    &part, &vbuf, &ctr, &B,  &M,
                  &N,   &ldc,  &iters,      &stage_rows, &stages, &rows, &cpp, &ppw};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(cpp * ppw),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
