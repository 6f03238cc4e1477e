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
//
// Rows wider than the widest instantiation (14848 columns) go, by width
// (the wrapper's `entry`), to one of two more entries:
// - up to kMaxCluster x 14848 columns (118784), the cluster entry,
//   sinkhorn_stream_cluster_launch (below): a thread-block cluster splits
//   the columns, each block streaming its slice of the rows through a TMA
//   ring, so that one iteration still reads the coupling once, as the TPU
//   kernel does at any width: its floor is one sweep a iteration, 1.07 GB
//   at [1, 16385, 16385], 32 ms x 100 in fp32 and 16 ms in bf16;
// - wider, the two-sweep entry, sinkhorn_stream_wide_launch (at the end):
//   column tiles read straight from device memory, column partials in
//   device memory; its own floor is two sweeps of the coupling per
//   iteration (100 ms in fp32 and 50 ms in bf16 at [1, 20481, 20481]).
// The bound by the contract's count is the same exponential count at any
// width, 2 * M * N * iters (8.4e10 at [1, 20481, 20481] x 100, about 20 ms).

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
      if (g == 0) cs.store(part_b + static_cast<size_t>(k) * 2 * N, N, N);
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

// The cluster entry: rows of up to kMaxCluster times the widest VARIANTS
// instantiation, one sweep of the coupling per iteration. A cluster of CL
// blocks takes a range of rows, each block a slice of the columns (slice s
// is columns [s * S, s * S + S), the last one up to N with the dustbin;
// S a multiple of 8, so that each row's slice starts 16 bytes aligned in
// both storage types). Each block streams its slice of its rows through a
// ring of stages, one TMA bulk copy a row, and keeps v and the online
// column accumulators of its slice in registers (Columns, one group of
// the 16 warps). The row's log-sum-exp needs every slice, so for each stage
// a block computes every row's partial (max, sum) of C + v over its slice
// (row_lse) and pushes it into each block of the cluster, itself included
// (st.async into slot gs % kXSlots of the receiver's exchange, the bytes
// counted on the slot's mbarrier). One stage behind, each block merges the
// CL partials of a row in rank order (so every block holds the same bits of
// u), then folds C + u from the same stage in shared memory: the coupling
// is read from device memory once an iteration, and the exchange's latency
// hides behind a stage of work.
//
// Why kXSlots = 4 slots suffice. A block runs A(0), A(1), B(0), A(2),
// B(1), ...: A(g) the partials and pushes of stage g, B(g) its merge and
// fold (at an iteration's end B(g) comes before the next A). Every stage
// holds a valid row, so A(g)'s pushes follow the block's named barrier in
// its first row_lse, which every thread reaches after B(g - 2). B(g) waits
// for every block's pushes of stage g. So a push of stage g + 4 into a
// block follows its sender's B(g + 2), which waited for the receiver's
// pushes of g + 2, which followed the receiver's B(g): the receiver has
// read slot g % 4 and waited on its barrier's phase before the slot's
// next bytes can arrive. Thread 0 re-arms the slot's barrier once it has
// seen the phase complete (bytes arriving before the arming count toward
// the next phase, which cannot complete without that arrival).
//
// After an iteration's rows, the blocks that own the same slice (the same
// rank in every cluster of the pair) meet at their own arrival counter
// (ctr [B, CL]) around a column reduce of the slice split over them, as
// the VARIANTS entry does over the whole row; each block then reads back
// the v of its slice only.
constexpr int kMaxCluster = 8;
constexpr int kXSlots = 4;

// The block's stages (over its waves, iterations and row range) as the
// VARIANTS entry's Feed, each row of a stage its own bulk copy of the
// block's slice (`width` stored columns at the coupling's pitch ldc) into
// the slot at pitch `pitch`.
template <typename T>
struct SliceFeed {
  const T* c;  // the coupling at the block's first column
  unsigned char* ring;
  uint64_t* full;
  size_t stage_bytes;
  int M, ldc, pitch, width, stage_rows, stages, r0, r1, spi, slot, ppw;
  unsigned per_pair, total;

  __device__ __forceinline__ void issue(unsigned gs) const {
    if (gs >= total) return;
    const unsigned s = gs % stages;
    const int b = slot + static_cast<int>(gs / per_pair) * ppw;
    const int row0 = r0 + static_cast<int>(gs % per_pair % spi) * stage_rows;
    const int nr = min(stage_rows, r1 - row0);
    const uint32_t row_bytes = static_cast<uint32_t>(width) * sizeof(T);
    hopper::mbar_expect_tx(&full[s], nr * row_bytes);
    unsigned char* dst = ring + s * stage_bytes;
    const T* src = c + (static_cast<size_t>(b) * M + row0) * ldc;
    for (int r = 0; r < nr; ++r)
      hopper::bulk_load(dst + static_cast<size_t>(r) * pitch * sizeof(T),
                        src + static_cast<size_t>(r) * ldc, row_bytes, &full[s]);
  }
};

// Shared memory: the ring (stages x stage_rows x S), then `stages` full
// barriers, kXSlots exchange barriers, `stages` slot counters (8 bytes
// each), the warps' exchange (kRedBytes) and the cluster's [kXSlots][CL]
// [stage_rows] float2 partials.
template <typename T, int KC, int RS>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_stream_cluster(const T* __restrict__ c, const float* __restrict__ mu,
                        const float* __restrict__ nu, float* __restrict__ u_out,
                        float* __restrict__ v_out, float* part, float* vbuf, unsigned* ctr,
                        int B, int M, int N, int ldc, int iters, int stage_rows, int stages,
                        int rows, int cpp, int ppw, int CL, int S) {
  constexpr int W = kMaxWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = stage_rows;
  const size_t stage_bytes = static_cast<size_t>(R) * S * sizeof(T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* xbar = full + stages;
  unsigned* done = reinterpret_cast<unsigned*>(xbar + kXSlots);  // warps done with a slot, mod 16
  float2* red = reinterpret_cast<float2*>(xbar + kXSlots + stages);
  float2* xbuf = red + kRedBytes / 8;
  const uint32_t xbytes = static_cast<uint32_t>(CL) * R * sizeof(float2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % CL, cid = blockIdx.x / CL;
  const int slot = cid / cpp, k = cid - slot * cpp;
  const int r0 = k * rows, r1 = min(M, r0 + rows);
  const int j0 = rank * S, ns = rank == CL - 1 ? N - j0 : S;  // the slice's columns
  const int ld = rank == CL - 1 ? ldc - j0 : S;  // its stored width, padding included
  const int spi = r1 > r0 ? (r1 - r0 + R - 1) / R : 0;  // stages an iteration
  const unsigned per_pair = static_cast<unsigned>(max(iters, 0)) * spi;
  const unsigned waves = slot < B ? (B - slot + ppw - 1) / ppw : 0;
  const SliceFeed<T> feed{c + j0, smem, full, stage_bytes, M, ldc, S, ld, R, stages, r0, r1, spi,
                          slot, ppw, per_pair, waves * per_pair};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    for (int x = 0; x < kXSlots; ++x) hopper::mbar_init(&xbar[x], 1);
    hopper::fence_mbar_init();
    for (int x = 0; x < kXSlots; ++x) hopper::mbar_expect_tx(&xbar[x], xbytes);
    for (int s = 0; s < stages; ++s) feed.issue(s);
  }
  hopper::cluster_sync();  // no push reaches a block before its barriers exist

  const bool pusher = warp == 0 && lane < CL;  // lane q pushes to block q

  Columns<W, KC> cs;
  cs.t = threadIdx.x;
  cs.tail = max(0, ns - 4 * 32 * W * KC);
  const int cols = (ns + cpp - 1) / cpp;
  const int ja = j0 + min(ns, k * cols), jb = j0 + min(ns, (k + 1) * cols);  // this block's reduce
  int parity = 0;
  unsigned gs = 0;  // stages begun
  for (int b = slot; b < B; b += ppw) {  // the waves
    if (iters <= 0) {
      if (rank == 0)
        for (int i = r0 + threadIdx.x; i < r1; i += kThreads)
          u_out[static_cast<size_t>(b) * M + i] = 0.f;
      for (int j = ja + threadIdx.x; j < jb; j += kThreads)
        v_out[static_cast<size_t>(b) * N + j] = 0.f;
      continue;
    }
    const float* mu_b = mu + static_cast<size_t>(b) * M;
    float* part_b = part + static_cast<size_t>(b) * cpp * 2 * N;
    float* vb = vbuf + static_cast<size_t>(b) * N;
    unsigned* my_ctr = ctr + static_cast<size_t>(b) * CL + rank;
    unsigned target = 0;
    cs.set_v(nullptr, ns);
    for (int it = 0; it < iters; ++it) {
      const bool last = it == iters - 1;
      cs.reset();
      for (int q = 0; q <= spi; ++q) {
        if (q < spi) {  // A: the stage's partials, pushed to the cluster
          const unsigned g = gs + q, s = g % stages, x = g % kXSlots;
          hopper::mbar_wait(&full[s], (g / stages) & 1);
          const T* st = reinterpret_cast<const T*>(smem + s * stage_bytes);
          const int nr = min(R, r1 - (r0 + q * R));
          for (int i0 = 0; i0 < R; i0 += RS, parity ^= 1) {
            float Mr[RS], Sr[RS];
            if (i0 < nr) {
              const T* rp[RS];
#pragma unroll
              for (int r = 0; r < RS; ++r)
                rp[r] = st + static_cast<size_t>(i0 + r < nr ? i0 + r : 0) * S;
              row_lse<T, W, KC, RS>(cs, rp, ns, ld, red, parity, 0, 2, Mr, Sr);
            } else {
#pragma unroll
              for (int r = 0; r < RS; ++r) Mr[r] = kEmpty, Sr[r] = 0.f;
            }
            if (pusher) {  // into slot x of block `lane`'s exchange, this block's row
              const uint32_t at = hopper::cluster_addr(xbuf + (x * CL + rank) * R + i0, lane);
              const uint32_t bar = hopper::cluster_addr(xbar + x, lane);
              if constexpr (RS == 2)
                hopper::st_async4(at, make_float4(Mr[0], Sr[0], Mr[1], Sr[1]), bar);
              else
                hopper::st_async2(at, make_float2(Mr[0], Sr[0]), bar);
            }
          }
        }
        if (q > 0) {  // B: the stage before, merged and folded
          const unsigned g = gs + q - 1, s = g % stages, x = g % kXSlots;
          hopper::mbar_wait(&xbar[x], (g / kXSlots) & 1);
          if (threadIdx.x == 0) hopper::mbar_expect_tx(&xbar[x], xbytes);  // its next phase
          const T* st = reinterpret_cast<const T*>(smem + s * stage_bytes);
          const int row0 = r0 + (q - 1) * R, nr = min(R, r1 - row0);
          const float2* xs = xbuf + x * CL * R;
          for (int i0 = 0; i0 < nr; i0 += RS) {
            const T* rp[RS];
            bool ok[RS];
            float U[RS];
#pragma unroll
            for (int r = 0; r < RS; ++r) {
              ok[r] = i0 + r < nr;
              rp[r] = st + static_cast<size_t>(ok[r] ? i0 + r : 0) * S;
              float Mq = kEmpty, Sq = 0.f;
              for (int p = 0; p < CL; ++p) {  // rank order: the same bits in every block
                const float2 e = xs[p * R + i0 + r];
                lse_merge(Mq, Sq, e.x, e.y);
              }
              U[r] = ok[r] ? mu_b[row0 + i0 + r] * kLog2e - (Mq + lg2(Sq)) : 0.f;
            }
            cs.fold_rows(rp, ok, ld, ns, U);
            if (last && rank == 0 && cs.t == 0)
#pragma unroll
              for (int r = 0; r < RS; ++r)
                if (ok[r]) u_out[static_cast<size_t>(b) * M + row0 + i0 + r] = U[r] * kLn2;
          }
          // The last of the 16 warps to leave the slot refills it.
          __syncwarp();
          if (lane == 0) {
            __threadfence_block();
            if (atomicAdd(&done[s], 1u) % kMaxWarps == kMaxWarps - 1) {
              __threadfence_block();
              feed.issue(g + stages);
            }
          }
        }
      }
      gs += spi;
      cs.store(part_b + static_cast<size_t>(k) * 2 * N + j0, ns, N);
      pair_barrier(my_ctr, target += cpp);
      reduce_slice(part_b, cpp, N, ja, jb, nu + static_cast<size_t>(b) * N, vb,
                   last ? v_out + static_cast<size_t>(b) * N : nullptr);
      if (!last) {
        pair_barrier(my_ctr, target += cpp);
        cs.set_v(vb + j0, ns);
      }
    }
  }
  hopper::cluster_sync();  // no block leaves while its pushes may be in flight
}

// The two-sweep entry: rows wider than the cluster entry takes, where a
// thread's column state no longer fits in registers. Same contract and
// order as sinkhorn_stream: u of a row from the previous iteration's v,
// the row's share of lse_col(C + u) folded into column accumulators at
// once, v finalised once every row of the iteration is done.
//
// The blocks of a pair split its rows, as above. A block takes kWideRows
// rows at a time and walks them in column tiles of 4 * kThreads columns,
// straight from device memory (thread t reads the 4-column chunks t,
// t + kThreads, ...; no shared-memory staging, so no width limit):
//   pass 1: each thread's online (max, sum) of C + v_prev over its chunks,
//           merged over the warp and then the block: u of the rows;
//   pass 2: C + u folded into the block's column partial, which lives in
//           device memory (scratch part [B, cpp, 2, N], one row of maxima
//           and one of sums a block; each thread reads and writes only its
//           own chunks, so the partial needs no barrier inside the block).
// The pair's blocks then merge their partials with the arrival counters
// and the split column reduce of sinkhorn.cuh. Pass 2 reads the rows again
// (from L2 if they are still there): two sweeps of the coupling per
// iteration at most, and one read-modify-write of the partial per
// kWideRows rows.
constexpr int kWideRows = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_stream_wide(const T* __restrict__ c, const float* __restrict__ mu,
                     const float* __restrict__ nu, float* __restrict__ u_out,
                     float* __restrict__ v_out, float* part, float* vbuf, unsigned* ctr, int B,
                     int M, int N, int ldc, int iters, int rows, int cpp, int ppw) {
  constexpr int R = kWideRows;
  __shared__ float2 red[2][kMaxWarps][R];  // the warps' (max, sum), by parity of the row group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x / cpp, k = blockIdx.x - slot * cpp;
  const int r0 = k * rows, r1 = min(M, r0 + rows);
  const int cols = (N + cpp - 1) / cpp, j0 = min(N, k * cols), j1 = min(N, j0 + cols);
  const int chunks = (N + 3) / 4;
  int parity = 0;
  for (int b = slot; b < B; b += ppw) {  // the waves
    if (iters <= 0) {
      for (int i = r0 + threadIdx.x; i < r1; i += kThreads)
        u_out[static_cast<size_t>(b) * M + i] = 0.f;
      for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
        v_out[static_cast<size_t>(b) * N + j] = 0.f;
      continue;
    }
    const T* cb = c + static_cast<size_t>(b) * M * ldc;
    const float* mu_b = mu + static_cast<size_t>(b) * M;
    float* part_b = part + static_cast<size_t>(b) * cpp * 2 * N;
    float* pm = part_b + static_cast<size_t>(k) * 2 * N;  // this block's maxima, then sums
    float* ps = pm + N;
    float* vb = vbuf + static_cast<size_t>(b) * N;
    const float* V = nullptr;  // v of the previous iteration, base 2 (nullptr: 0)
    unsigned target = 0;
    for (int it = 0; it < iters; ++it) {
      const bool last = it == iters - 1;
      for (int q = threadIdx.x; q < chunks; q += kThreads)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < N) pm[4 * q + e] = kEmpty, ps[4 * q + e] = 0.f;
      for (int i0 = r0; i0 < r1; i0 += R, parity ^= 1) {
        const T* rp[R];
#pragma unroll
        for (int r = 0; r < R; ++r)  // rows past r1 read row r1 - 1 and count for nothing
          rp[r] = cb + static_cast<size_t>(min(i0 + r, r1 - 1)) * ldc;
        // Pass 1: the rows' online (max, sum) of C + v over the thread's chunks.
        float m[R], s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = kEmpty, s[r] = 0.f;
        for (int q = threadIdx.x; q < chunks; q += kThreads) {
          const int j = 4 * q;
          float v4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v4[e] = j + e < N ? (V ? __ldcg(V + j + e) : 0.f) : kEmpty;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x[4];
            load4(rp[r] + j, x);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = fmaf(x[e], kLog2e, v4[e]);
            const float cm = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
            if (cm == kEmpty) continue;
            if (cm > m[r]) s[r] *= ex2(m[r] - cm), m[r] = cm;
            s[r] += (ex2(x[0] - m[r]) + ex2(x[1] - m[r])) + (ex2(x[2] - m[r]) + ex2(x[3] - m[r]));
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, s[r], off);
            lse_merge(m[r], s[r], m2, s2);
          }
        if (lane == 0)
#pragma unroll
          for (int r = 0; r < R; ++r) red[parity][warp][r] = make_float2(m[r], s[r]);
        __syncthreads();
        float U[R];  // u of the rows, base 2
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float M2 = kEmpty, S2 = 0.f;
#pragma unroll
          for (int w = 0; w < kMaxWarps; ++w) lse_merge(M2, S2, red[parity][w][r].x,
                                                        red[parity][w][r].y);
          const int i = min(i0 + r, r1 - 1);
          U[r] = mu_b[i] * kLog2e - (M2 + lg2(S2));
        }
        if (last && threadIdx.x < R && i0 + threadIdx.x < r1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r == threadIdx.x) u_out[static_cast<size_t>(b) * M + i0 + r] = U[r] * kLn2;
        }
        // Pass 2: C + u of the valid rows folded into the block's partial.
        for (int q = threadIdx.x; q < chunks; q += kThreads) {
          const int j = 4 * q;
          float y[R][4];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x[4];
            load4(rp[r] + j, x);
#pragma unroll
            for (int e = 0; e < 4; ++e) y[r][e] = i0 + r < r1 ? fmaf(x[e], kLog2e, U[r]) : kEmpty;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j + e >= N) continue;
            float col[R];
#pragma unroll
            for (int r = 0; r < R; ++r) col[r] = y[r][e];
            float mj = pm[j + e], sj = ps[j + e];
            fold(mj, sj, col);  // row i0 is valid: at least one entry is finite
            pm[j + e] = mj, ps[j + e] = sj;
          }
        }
      }
      pair_barrier(ctr + b, target += cpp);
      reduce_slice(part_b, cpp, N, j0, j1, nu + static_cast<size_t>(b) * N, vb,
                   last ? v_out + static_cast<size_t>(b) * N : nullptr);
      if (!last) {
        pair_barrier(ctr + b, target += cpp);
        V = vb;
      }
    }
  }
}

using WideKernel = void (*)(const void*, const float*, const float*, float*, float*, float*,
                            float*, unsigned*, int, int, int, int, int, int, int, int);

template <typename T>
WideKernel wide_kernel() {
  return reinterpret_cast<WideKernel>(sinkhorn_stream_wide<T>);
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

using ClusterKernel = void (*)(const void*, const float*, const float*, float*, float*, float*,
                               float*, unsigned*, int, int, int, int, int, int, int, int, int,
                               int, int, int);

// The cluster entry's instantiations, X(16 warps, KC chunks a thread, RS
// rows a step): the VARIANTS entries of one group that a slice of more
// than half the widest row needs (7425 to 14848 columns; the wrapper reads
// this list too).
#define CLUSTER_VARIANTS(X) X(16, 4, 2) X(16, 5, 1) X(16, 6, 1) X(16, 7, 1)

template <typename T>
ClusterKernel pick_cluster(int KC) {
#define CASE(w, kc, rs) \
  if (KC == kc) return reinterpret_cast<ClusterKernel>(sinkhorn_stream_cluster<T, kc, rs>);
  CLUSTER_VARIANTS(CASE)
#undef CASE
  return nullptr;
}

// The launch configuration of the cluster entry: CL-block clusters, each
// block cooperative (every block resident, which the pair's arrival
// counters need; the runtime refuses a grid that cannot be).
struct ClusterLaunch {
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg;

  ClusterLaunch(int blocks, int CL, int smem, cudaStream_t stream) : cfg{} {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = CL;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
  }
};

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

// Blocks of the two-sweep entry resident on the card at once (the fewer of
// the two storage types'); a negative CUDA error code on failure.
extern "C" int sinkhorn_stream_wide_max_blocks() {
  int blocks = -1, dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const WideKernel fns[] = {wide_kernel<float>(), wide_kernel<__nv_bfloat16>()};
  for (const WideKernel fn : fns) {
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(fn), kThreads, 0);
    if (err == cudaSuccess && (blocks < 0 || per_sm * sms < blocks)) blocks = per_sm * sms;
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The two-sweep entry, for rows of any width: c [B, M, ldc] fp32 or bf16
// (bf16 != 0), ldc a multiple of 8 and >= N; mu [B, M]; nu [B, N]; outputs
// u [B, M], v [B, N]; scratch part [B, cpp, 2, N], vbuf [B, N], ctr [B]
// (zero at launch). Grid cpp * ppw blocks of `rows` rows of a pair each.
extern "C" int sinkhorn_stream_wide_launch(const void* c, int bf16, const float* mu,
                                           const float* nu, float* u, float* v, float* part,
                                           float* vbuf, unsigned* ctr, int B, int M, int N,
                                           int ldc, int iters, int rows, int cpp, int ppw,
                                           cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  if (ldc % 8 != 0 || ldc < N || rows < 1) return cudaErrorInvalidValue;
  const WideKernel fn = bf16 ? wide_kernel<__nv_bfloat16>() : wide_kernel<float>();
  void* args[] = {&c, &mu, &nu, &u, &v, &part, &vbuf, &ctr, &B, &M, &N, &ldc, &iters,
                  &rows, &cpp, &ppw};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                                dim3(cpp * ppw), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of CL blocks of the cluster entry (KC chunks a thread, `smem`
// bytes of dynamic shared memory a block) resident on the card at once;
// a negative CUDA error code on failure.
extern "C" int sinkhorn_stream_cluster_max_clusters(int KC, int CL, int smem) {
  const ClusterKernel fn = pick_cluster<float>(KC);
  if (fn == nullptr || CL < 1 || CL > kMaxCluster) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  ClusterLaunch launch(CL, CL, smem, nullptr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(fn),
                                         &launch.cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// The cluster entry: c [B, M, ldc] fp32 or bf16 (bf16 != 0), ldc a
// multiple of 8 and >= N; mu [B, M]; nu [B, N]; outputs u [B, M], v
// [B, N]; scratch part [B, cpp, 2, N], vbuf [B, N], ctr [B, CL] (zero at
// launch). Grid CL * cpp * ppw blocks in clusters of CL, each cluster
// `rows` rows of a pair, block s of a cluster columns [s * S, ...) (S a
// multiple of 8, the last slice up to N); a ring of `stages` stages of
// `stage_rows` rows at pitch S. cudaErrorCooperativeLaunchTooLarge if the
// blocks cannot all be resident.
extern "C" int sinkhorn_stream_cluster_launch(const void* c, int bf16, const float* mu,
                                              const float* nu, float* u, float* v, float* part,
                                              float* vbuf, unsigned* ctr, int B, int M, int N,
                                              int ldc, int iters, int stage_rows, int stages,
                                              int rows, int cpp, int ppw, int CL, int S, int KC,
                                              int smem, cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  if (ldc % 8 != 0 || ldc < N || S % 8 != 0 || stages < 2 || stage_rows < 1 || CL < 1 ||
      CL > kMaxCluster || (CL - 1) * S >= N || CL * S < N || rows < 1)
    return cudaErrorInvalidValue;
  const ClusterKernel fn = bf16 ? pick_cluster<__nv_bfloat16>(KC) : pick_cluster<float>(KC);
  if (fn == nullptr || S > 4 * kThreads * KC + kThreads) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return err;
  void* args[] = {&c,     &mu,         &nu,     &u,    &v,   &part, &vbuf, &ctr, &B,  &M, &N,
                  &ldc,   &iters,      &stage_rows, &stages, &rows, &cpp, &ppw, &CL, &S};
  ClusterLaunch launch(CL * cpp * ppw, CL, smem, stream);
  err = cudaLaunchKernelExC(&launch.cfg, reinterpret_cast<const void*>(fn), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
