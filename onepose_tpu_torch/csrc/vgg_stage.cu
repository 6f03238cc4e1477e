// One SuperPoint encoder stage: conv3x3 -> ReLU -> conv3x3 -> ReLU [-> 2x2 max-pool].
//
// Replaces onepose_tpu/ops/pallas/vgg_stage.py::_vgg_stage_pallas (public
// `vgg_stage`). Input x [B, H, W, Cin] NHWC: fp32 for the single-channel
// image stage, bf16 otherwise; conv1's weights [9 taps][C1] bf16 for the
// image stage, otherwise both convs' weights in the swizzled chunks of
// hopper.cuh ([9 taps][Cin / 64][Cout][64], Cin zero-padded to a multiple
// of 64); biases fp32. Output [B, H/2, W/2, C2] with the pool, [B, H, W,
// C2] without; fp32 for the image stage, bf16 otherwise. Rounding points
// are the Pallas kernel's: the input is rounded to bf16; conv1 sums bf16
// taps in fp32, adds the bias, applies ReLU, zeroes the ring outside the
// image (conv2's SAME padding needs true zeros, not relu(b1)) and rounds
// to bf16; conv2 does the same and its bf16 result is max-pooled.
//
// Bound on the H100: operations. The four production stages (batch 8,
// 512 x 512) take about 311 GFLOP, 0.32 ms at 989 TFLOP/s of bf16; their
// outputs are about 100 MB, 0.03 ms at 3.35 TB/s.
//
// Design: one block per TH x 32 output tile (TH = 16, 8 or 4: the largest
// whose tiles fit the shared memory), two warpgroups. Every count of the
// schedule is a template constant (one instantiation per channel
// configuration), so that no wgmma sits on a path the compiler must treat
// as divergent (ptxas then serialises them).
//   - The input tile (TH + 4 rows, 36 columns, pixel pitch Cin + 8 bf16 so
//     that ldmatrix rows fall in distinct banks) is loaded once with
//     cp.async (all of a thread's 16-byte copies in flight at once), zero
//     outside the image. conv1's output over the tile plus a 1-pixel ring
//     (TH + 2 rows, 34 columns) stays in shared memory and feeds conv2: the
//     inter-conv activation never reaches device memory.
//   - Both multi-channel convs are implicit GEMMs on wgmma m64n64k16: A
//     (64 pixels x 16 input channels of one tap) in registers, each lane's
//     ldmatrix row address the pixel its row needs, shifted by the tap, so
//     a task's 64 rows can be any 64 pixels; B, the tap's weights, from
//     shared memory. Accumulators fp32, four tasks of 64 pixels x 64 output
//     channels per warpgroup and round (rounds past the first stream the
//     weights again; a round's spare task slots repeat its last task).
//   - The weights stream through a ring of 3 slots (2 in the image stage)
//     of [Cout][64] chunks (one chunk per tap and 64 input channels, 8 or
//     16 KB), each filled by one TMA bulk copy counted on a "full"
//     mbarrier; each warp releases a slot on its "empty" mbarrier, and
//     thread 0 refills it once all eight have. The next chunks load while
//     the current one multiplies; the weights are read once per block and
//     round, not once per warp and k-step.
//   - Within a chunk the four k-steps alternate two sets of A registers,
//     so ldmatrix of step s + 1 overlaps the products of step s.
//   - conv2's tasks are 2 rows x 32 columns: warp w of a warpgroup holds
//     columns 8w .. 8w + 7 of both rows, so each thread holds the two
//     pixels of a pool window's column and a lane shuffle (xor 4) brings
//     the other column: the pool runs in registers and conv2's output goes
//     straight to device memory.
//   - The single-channel image conv (K = 9) runs as scalar fp32 FMAs of
//     bf16-rounded values in the Pallas kernel's order, while conv2's first
//     weight chunks load; the image stage runs two blocks per SM (two
//     tasks per warpgroup and round), so that one block's scalar conv1
//     overlaps the other's tensor-core conv2.
// Halo overhead left: conv2 computes exactly the output tile (ragged
// tiles at the image's right and bottom edges are computed and dropped);
// conv1 computes (TH + 2) x 34 pixels rounded up to 64 for 32 TH useful
// ones: 1.25x at TH = 16, 1.5x at TH = 8, 2x at TH = 4 (a flat tile of
// pitch 36, the earlier design, paid 1.5x for conv1 and 1.125x for
// conv2). Outside the image stage, tiles load without overlapping the
// products (one block per SM). The TPU kernel's workarounds (the input
// passed twice with 4/8-row halo blocks, pltpu.roll column taps,
// lane-multiple width padding) are not carried over.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TW = 32;                     // output tile columns (before the pool)
constexpr int WI = TW + 4;                 // input tile columns
constexpr int W1 = TW + 2;                 // conv1 region columns
constexpr int THREADS = 256;               // two warpgroups
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int pitch(int c) { return c + 8; }
__host__ __device__ constexpr int kpad(int cin) { return (cin + 63) / 64 * 64; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared-memory layout of a configuration (byte offsets from a 1024-byte
// aligned base) and its schedule: every count is a compile-time constant,
// so that no wgmma sits on a path the compiler must treat as divergent.
template <bool SINGLE, int KP, int C1, int C2>
struct Cfg {
  // The image stage runs two blocks per SM, so that one block's scalar
  // conv1 overlaps the other's tensor-core conv2: two weight slots and two
  // tasks per warpgroup and round (64 accumulators) fit it. The others run
  // one block per SM with three slots and up to four tasks.
  static constexpr int STAGES = SINGLE ? 2 : 3;  // weight ring slots
  static constexpr int MAXT = SINGLE ? 2 : 4;    // tasks per warpgroup and round
  static constexpr int MIN_BLOCKS = SINGLE ? 2 : 1;
  static constexpr int c1 = C1, c2 = C2;
  static constexpr int slot = 128 * (C1 > C2 ? C1 : C2);
  static constexpr int bars = STAGES * slot;
  static constexpr int in = bars + 128;
  static constexpr int in_bytes(int th) {
    return SINGLE ? (th + 4) * WI * 4 : (th + 4) * WI * pitch(KP) * 2;
  }
  static constexpr int total(int th) {
    return in + cdiv(in_bytes(th), 16) * 16 + (th + 2) * W1 * pitch(C1) * 2;
  }
  // The largest tile height whose layout fits (16, 8, 4 or 2).
  static constexpr int LIMIT = SMEM_LIMIT / MIN_BLOCKS - 1024 * (MIN_BLOCKS - 1);
  static constexpr int TH = total(16) + 1024 <= LIMIT  ? 16
                            : total(8) + 1024 <= LIMIT ? 8
                            : total(4) + 1024 <= LIMIT ? 4
                                                       : 2;
  static constexpr int t1 = in + cdiv(in_bytes(TH), 16) * 16;
  static constexpr int smem = total(TH) + 1024;
  static constexpr int Q1 = (TH + 2) * W1;                          // conv1 region pixels
  static constexpr int NB1 = C1 / 64, NB2 = C2 / 64, KC1 = KP / 64, KC2 = C1 / 64;
  static constexpr int NT1 = SINGLE ? 0 : cdiv(Q1, 64) * NB1;       // conv1 tasks
  static constexpr int NT2 = TH / 2 * NB2;                          // conv2 tasks
  static constexpr int R1 = cdiv(NT1, 2 * MAXT), R2 = cdiv(NT2, 2 * MAXT);  // rounds
  static constexpr int T1 = R1 ? cdiv(NT1, 2 * R1) : 1, T2 = cdiv(NT2, 2 * R2);  // tasks per warpgroup and round
  static constexpr int CH1 = R1 * 9 * KC1, CHUNKS = CH1 + R2 * 9 * KC2;  // weight chunks streamed
  static_assert(smem <= LIMIT, "no tile height fits shared memory");
};

// The weight stream: chunk n's source and size (conv1's rounds, then conv2's).
template <class C>
__device__ __forceinline__ void issue_chunk(int n, const bf16* w1, const bf16* w2,
                                            unsigned char* ring, uint64_t* full) {
  const int s = n % C::STAGES;
  const bf16* src;
  int bytes;
  if (n < C::CH1) {
    src = w1 + static_cast<size_t>(n % (9 * C::KC1)) * C::c1 * 64;
    bytes = C::c1 * 128;
  } else {
    src = w2 + static_cast<size_t>((n - C::CH1) % (9 * C::KC2)) * C::c2 * 64;
    bytes = C::c2 * 128;
  }
  mbar_expect_tx(full + s, bytes);
  bulk_load(ring + s * C::slot, src, bytes, full + s);
}

// The products of one round: for each chunk of the weight stream (9 taps
// x KC chunks of 64 input channels), acc[i] += A(task i, tap) * B(chunk)
// for the warpgroup's T tasks. abase[i]: the shared address of the lane's
// ldmatrix row (pixel and 8-column half) for tap 0; SW: the source row
// width in pixels; PS: its pixel pitch in elements; boff[i]: the byte
// offset of the task's 64 output channels in a slot. n counts the chunks
// consumed; thread 0 refills each slot once all eight warps released it.
template <class C, int T, int SW, int PS, int KC>
__device__ __forceinline__ void conv_round(float (&acc)[C::MAXT][32],
                                           const uint32_t (&abase)[C::MAXT],
                                           const int (&boff)[C::MAXT], unsigned char* ring,
                                           uint64_t* full, uint64_t* empty, int& n,
                                           const bf16* w1, const bf16* w2) {
  const int lane = threadIdx.x & 31;
  const uint32_t ring_a = smem_u32(ring);
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[i][j] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t toff = ((tap / 3) * SW + tap % 3) * PS * 2;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc, ++n) {
      constexpr int STAGES = C::STAGES, MAXT = C::MAXT;
      const int s = n % STAGES;
      mbar_wait(full + s, (n / STAGES) & 1);
      const uint32_t wslot = ring_a + s * C::slot;
      const uint32_t aoff = toff + kc * 128;
      uint32_t a0[MAXT][4], a1[MAXT][4];
      auto load = [&](uint32_t (&a)[MAXT][4], int ks) {
#pragma unroll
        for (int i = 0; i < T; ++i)
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
                       : "r"(abase[i] + aoff + ks * 32));
      };
      auto mma = [&](const uint32_t (&a)[MAXT][4], int ks) {
        wg_fence();
#pragma unroll
        for (int i = 0; i < T; ++i)
          wgmma_m64n64k16(acc[i], a[i], desc_b128(wslot + boff[i] + ks * 32));
        wg_commit();
      };
      load(a0, 0);
      mma(a0, 0);
      load(a1, 1);
      mma(a1, 1);
      wg_wait<1>();
      load(a0, 2);
      mma(a0, 2);
      wg_wait<1>();
      load(a1, 3);
      mma(a1, 3);
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < T; ++i) fence_regs(acc[i]);
      if (lane == 0) mbar_arrive(empty + s);
      if (threadIdx.x == 0 && n + STAGES < C::CHUNKS) {
        mbar_wait(empty + s, (n / STAGES) & 1);
        issue_chunk<C>(n + STAGES, w1, w2, ring, full);
      }
    }
  }
}

template <bool SINGLE, bool POOL, int KP, int C1, int C2>
__global__ void __launch_bounds__(THREADS, SINGLE ? 2 : 1)
vgg_stage_kernel(const void* __restrict__ x_, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, void* __restrict__ out_, int H, int W, int cin) {
  using C = Cfg<SINGLE, KP, C1, C2>;
  constexpr int TH = C::TH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::STAGES;
  bf16* t1 = reinterpret_cast<bf16*>(smem + C::t1);
  const int bimg = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  constexpr int P1 = pitch(C1);

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS / 32);
    }
    fence_mbar_init();
    for (int n = 0; n < C::STAGES && n < C::CHUNKS; ++n) issue_chunk<C>(n, w1, w2, smem, full);
  }

  // 1. Input tile rows y0 - 2 .. y0 + TH + 1, columns x0 - 2 .. x0 + 33,
  //    rounded to bf16, zero outside the image (and on padded channels).
  if (SINGLE) {
    const float* x = static_cast<const float*>(x_) + static_cast<size_t>(bimg) * H * W;
    float* tin = reinterpret_cast<float*>(smem + C::in);
    for (int q = tid; q < (TH + 4) * WI; q += THREADS) {
      const int gy = y0 - 2 + q / WI, gx = x0 - 2 + q % WI;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __bfloat162float(__float2bfloat16_rn(x[static_cast<size_t>(gy) * W + gx]));
      tin[q] = v;
    }
  } else {
    const bf16* x = static_cast<const bf16*>(x_) + static_cast<size_t>(bimg) * H * W * cin;
    bf16* tin = reinterpret_cast<bf16*>(smem + C::in);
    constexpr int chunks = KP / 8;
    for (int i = tid; i < (TH + 4) * WI * chunks; i += THREADS) {
      const int q = i / chunks, j = i % chunks;
      const int gy = y0 - 2 + q / WI, gx = x0 - 2 + q % WI;
      const bool ok = 8 * j < cin && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(tin + q * pitch(KP) + 8 * j,
                 ok ? x + (static_cast<size_t>(gy) * W + gx) * cin + 8 * j : x, ok);
    }
    cp_async_wait_all();
  }
  __syncthreads();

  const int wg = tid >> 7, wl = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // the lane's ldmatrix row
  const int lcol = (lane >> 4) * 8;                      // ... and 8-column half
  int n = 0;
  float acc[C::MAXT][32];
  uint32_t abase[C::MAXT];
  int boff[C::MAXT];

  // 2. conv1 over the (TH + 2) x 34 region: bias, ReLU, zero outside the
  //    image, round to bf16 into t1. Round r gives warpgroup wg the tasks
  //    (2 r + wg) T1 .. + T1 - 1; tasks past NT1 repeat the last one and
  //    are not stored.
  auto inside1 = [&](int q) {
    const int gy = y0 - 1 + q / W1, gx = x0 - 1 + q % W1;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  if (SINGLE) {
    // Thread (group, channel): rows group, group + G, ... of the region,
    // each swept left to right with a 3 x 3 window of inputs in registers
    // (3 shared loads per output, broadcast across the group's threads).
    constexpr int G = THREADS / C1;  // THREADS is a multiple of C1
    const float* tin = reinterpret_cast<const float*>(smem + C::in);
    const int ch = tid % C1;
    float wr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wr[k] = __bfloat162float(w1[k * C1 + ch]);
    const float bias = b1[ch];
    for (int rr = tid / C1; rr < TH + 2; rr += G) {
      const int gy = y0 - 1 + rr;
      const bool row_in = gy >= 0 && gy < H;
      const float* r0 = tin + rr * WI;
      float a0 = r0[0], a1 = r0[1], b0 = r0[WI], b1v = r0[WI + 1], c0 = r0[2 * WI],
            c1v = r0[2 * WI + 1];
      for (int cc = 0; cc < W1; ++cc) {
        const float a2 = r0[cc + 2], b2v = r0[WI + cc + 2], c2v = r0[2 * WI + cc + 2];
        // The Pallas kernel's order: for each column tap, a 3-term dot over
        // the row taps, then the three summed left to right.
        const float p0 = a0 * wr[0] + b0 * wr[3] + c0 * wr[6];
        const float p1 = a1 * wr[1] + b1v * wr[4] + c1v * wr[7];
        const float p2 = a2 * wr[2] + b2v * wr[5] + c2v * wr[8];
        const float a = (p0 + p1) + p2;
        const int gx = x0 - 1 + cc;
        const bool in = row_in && gx >= 0 && gx < W;
        t1[(rr * W1 + cc) * P1 + ch] = __float2bfloat16_rn(in ? fmaxf(a + bias, 0.f) : 0.f);
        a0 = a1, a1 = a2, b0 = b1v, b1v = b2v, c0 = c1v, c1v = c2v;
      }
    }
  } else {
    const uint32_t tin = smem_u32(smem + C::in);
    for (int r = 0; r < C::R1; ++r) {
#pragma unroll
      for (int i = 0; i < C::T1; ++i) {
        const int task = min((2 * r + wg) * C::T1 + i, C::NT1 - 1), pb = task / C::NB1;
        const int q = min(pb * 64 + wl * 16 + lrow, C::Q1 - 1);  // padded rows repeat a pixel
        abase[i] = tin + (((q / W1) * WI + q % W1) * pitch(KP) + lcol) * 2;
        boff[i] = (task % C::NB1) * 64 * 128;
      }
      conv_round<C, C::T1, WI, pitch(KP), C::KC1>(acc, abase, boff, smem, full, empty, n, w1, w2);
#pragma unroll
      for (int i = 0; i < C::T1; ++i) {
        const int task = (2 * r + wg) * C::T1 + i, pb = task / C::NB1, nb = task % C::NB1;
        if (task >= C::NT1) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = pb * 64 + wl * 16 + g + 8 * h;
          if (q >= C::Q1) continue;
          const bool in = inside1(q);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ch = nb * 64 + 8 * j + 2 * t;
            const float v0 = in ? fmaxf(acc[i][4 * j + 2 * h] + b1[ch], 0.f) : 0.f;
            const float v1 = in ? fmaxf(acc[i][4 * j + 2 * h + 1] + b1[ch + 1], 0.f) : 0.f;
            *reinterpret_cast<uint32_t*>(t1 + q * P1 + ch) = pack_bf16x2(v0, v1);
          }
        }
      }
    }
  }
  __syncthreads();

  // 3. conv2 over the TH x 32 tile, in tasks of 2 rows x 32 columns: bias,
  //    ReLU, bf16, [2 x 2 max-pool in registers,] store.
  constexpr int S = POOL ? 2 : 1;
  const int OH = H / S, OW = W / S;
  const uint32_t t1a = smem_u32(t1);
  for (int r = 0; r < C::R2; ++r) {
#pragma unroll
    for (int i = 0; i < C::T2; ++i) {
      const int task = min((2 * r + wg) * C::T2 + i, C::NT2 - 1), pb = task / C::NB2;
      const int rr = 2 * pb + (lrow >> 3), cc = 8 * wl + (lrow & 7);
      abase[i] = t1a + ((rr * W1 + cc) * P1 + lcol) * 2;
      boff[i] = (task % C::NB2) * 64 * 128;
    }
    conv_round<C, C::T2, W1, P1, C::KC2>(acc, abase, boff, smem, full, empty, n, w1, w2);
#pragma unroll
    for (int i = 0; i < C::T2; ++i) {
      const int task = (2 * r + wg) * C::T2 + i, pb = task / C::NB2, nb = task % C::NB2;
      if (task >= C::NT2) continue;
      const int gy = y0 + 2 * pb, gx = x0 + 8 * wl + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = nb * 64 + 8 * j + 2 * t;
        auto act = [&](float v, float b) {
          return __bfloat162float(__float2bfloat16_rn(fmaxf(v + b, 0.f)));
        };
        float v[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h][0] = act(acc[i][4 * j + 2 * h], b2[ch]);
          v[h][1] = act(acc[i][4 * j + 2 * h + 1], b2[ch + 1]);
        }
        if (POOL) {
          float m0 = fmaxf(v[0][0], v[1][0]), m1 = fmaxf(v[0][1], v[1][1]);
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
          const int oy = gy / 2, ox = gx / 2;
          if ((g & 1) || oy >= OH || ox >= OW) continue;
          const size_t o = ((static_cast<size_t>(bimg) * OH + oy) * OW + ox) * C2 + ch;
          if (SINGLE)
            *reinterpret_cast<float2*>(static_cast<float*>(out_) + o) = make_float2(m0, m1);
          else
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out_) + o) = pack_bf16x2(m0, m1);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (gy + h >= OH || gx >= OW) continue;
            const size_t o = ((static_cast<size_t>(bimg) * OH + gy + h) * OW + gx) * C2 + ch;
            if (SINGLE)
              *reinterpret_cast<float2*>(static_cast<float*>(out_) + o) =
                  make_float2(v[h][0], v[h][1]);
            else
              *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out_) + o) =
                  pack_bf16x2(v[h][0], v[h][1]);
          }
        }
      }
    }
  }
}

template <bool SINGLE, bool POOL, int KP, int C1, int C2>
int launch(const void* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
           void* out, int B, int H, int W, int cin, cudaStream_t stream) {
  using C = Cfg<SINGLE, KP, C1, C2>;
  constexpr auto kernel = vgg_stage_kernel<SINGLE, POOL, KP, C1, C2>;
  const cudaError_t err = allow_smem<kernel>(C::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + C::TH - 1) / C::TH, B);
  kernel<<<grid, THREADS, C::smem, stream>>>(x, w1, b1, w2, b2, out, H, W, cin);
  return cudaGetLastError();
}

// The configuration for runtime (pool, padded cin, c1, c2), as template arguments.
template <bool SINGLE, bool POOL, int KP, int C1>
int launch_c2(int c2, const void* x, const bf16* w1, const float* b1, const bf16* w2,
              const float* b2, void* out, int B, int H, int W, int cin, cudaStream_t stream) {
  return c2 == 64 ? launch<SINGLE, POOL, KP, C1, 64>(x, w1, b1, w2, b2, out, B, H, W, cin, stream)
                  : launch<SINGLE, POOL, KP, C1, 128>(x, w1, b1, w2, b2, out, B, H, W, cin, stream);
}

template <bool SINGLE, bool POOL, int KP>
int launch_c1(int c1, int c2, const void* x, const bf16* w1, const float* b1, const bf16* w2,
              const float* b2, void* out, int B, int H, int W, int cin, cudaStream_t stream) {
  return c1 == 64
             ? launch_c2<SINGLE, POOL, KP, 64>(c2, x, w1, b1, w2, b2, out, B, H, W, cin, stream)
             : launch_c2<SINGLE, POOL, KP, 128>(c2, x, w1, b1, w2, b2, out, B, H, W, cin, stream);
}

template <bool POOL>
int launch_cin(int c1, int c2, const void* x, const bf16* w1, const float* b1, const bf16* w2,
               const float* b2, void* out, int B, int H, int W, int cin, cudaStream_t stream) {
  if (cin == 1)
    return launch_c1<true, POOL, 64>(c1, c2, x, w1, b1, w2, b2, out, B, H, W, cin, stream);
  return kpad(cin) == 64
             ? launch_c1<false, POOL, 64>(c1, c2, x, w1, b1, w2, b2, out, B, H, W, cin, stream)
             : launch_c1<false, POOL, 128>(c1, c2, x, w1, b1, w2, b2, out, B, H, W, cin, stream);
}

template <bool SINGLE, int KP, int C1, int C2>
int rows_c2() { return Cfg<SINGLE, KP, C1, C2>::TH; }

template <bool SINGLE, int KP>
int rows_c1(int c1, int c2) {
  if (c1 == 64) return c2 == 64 ? rows_c2<SINGLE, KP, 64, 64>() : rows_c2<SINGLE, KP, 64, 128>();
  return c2 == 64 ? rows_c2<SINGLE, KP, 128, 64>() : rows_c2<SINGLE, KP, 128, 128>();
}

}  // namespace

// The output tile height the kernel uses for these channels.
extern "C" int vgg_stage_tile_rows(int cin, int c1, int c2) {
  if (cin == 1) return rows_c1<true, 64>(c1, c2);
  return kpad(cin) == 64 ? rows_c1<false, 64>(c1, c2) : rows_c1<false, 128>(c1, c2);
}

// x [B, H, W, cin] (fp32 if cin == 1, else bf16); w1 [9, c1] bf16 if
// cin == 1, else [9, ceil(cin / 64), c1, 64] swizzled; w2 [9, c1 / 64, c2,
// 64] swizzled; b1 [c1], b2 [c2] fp32; out fp32 if cin == 1, else bf16. H
// and W even with the pool (ragged tiles are masked); cin 1 or a multiple
// of 16 up to 128; c1 and c2 64 or 128.
extern "C" int vgg_stage_launch(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, void* out, int B, int H, int W, int cin, int c1,
                                int c2, int pool, cudaStream_t stream) {
  const bool single = cin == 1;
  if ((pool && (H % 2 || W % 2)) || (!single && (cin % 16 || cin > 128)) ||
      (c1 != 64 && c1 != 128) || (c2 != 64 && c2 != 128))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  return pool ? launch_cin<true>(c1, c2, x, w1b, b1, w2b, b2, out, B, H, W, cin, stream)
              : launch_cin<false>(c1, c2, x, w1b, b1, w2b, b2, out, B, H, W, cin, stream);
}
