// One SuperPoint encoder stage: conv3x3 -> ReLU -> conv3x3 -> ReLU [-> 2x2 max-pool].
//
// Replaces onepose_tpu/ops/pallas/vgg_stage.py::_vgg_stage_pallas (public
// `vgg_stage`). Input x [B, H, W, Cin] NHWC: fp32 for the single-channel
// image stage, bf16 otherwise; weights packed [9 taps][Cout][Cin] bf16;
// biases fp32. Output [B, H/2, W/2, C2] with the pool, [B, H, W, C2]
// without; fp32 for the image stage, bf16 otherwise. Rounding points are
// the Pallas kernel's: the input is rounded to bf16; conv1 sums bf16 taps
// in fp32, adds the bias, applies ReLU, zeroes the ring outside the image
// (conv2's SAME padding needs true zeros, not relu(b1)) and rounds to bf16;
// conv2 does the same and its bf16 result is max-pooled.
//
// Bound on the H100: operations. The four production stages (batch 8,
// 512 x 512) take about 311 GFLOP, 0.32 ms at 989 TFLOP/s of bf16; their
// outputs are about 100 MB, 0.03 ms at 3.35 TB/s.
//
// Design: one block per TH x TW output tile. The input tile with its
// 2-pixel halo is staged in shared memory as bf16 with a pixel pitch of
// Cin + 8 elements (the 16-byte pad spreads a fragment's 8 pixel rows over
// distinct banks). Both convolutions are implicit GEMMs on mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators): the tile is flattened with
// a row pitch of WI = TW + 4 pixels, so that tap (dy, dx) of output pixel
// p reads input pixel p + dy * WI + dx and 16 consecutive output pixels
// form one strided A fragment straight from the NHWC tile (the columns
// past the tile's width are computed and thrown away: 2 of 36 for conv1,
// 4 of 36 for conv2). The conv1 tile (TH + 2 rows) stays in shared
// memory and feeds conv2, so the inter-conv activation never reaches
// device memory, which is the point of the TPU kernel. conv2's bf16 result
// overwrites the dead input tile; a last pass pools it and writes the
// stage output with 16-byte stores. Weight fragments come from global
// memory (L1/L2-resident: at most 295 KB a conv). The single-channel
// image conv (K = 9) runs as scalar fp32 FMAs of bf16-rounded values.
// The TPU kernel's workarounds (the input passed twice with 4/8-row halo
// blocks, pltpu.roll column taps, lane-multiple width padding) are not
// carried over. Later work: wgmma with TMA-fed tiles and weights staged in
// shared memory.

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8;                         // output tile rows (before the pool)
constexpr int TW = 32;                        // output tile columns (before the pool)
constexpr int WI = TW + 4;                    // flat row pitch of every tile, in pixels
constexpr int M1 = (TH + 2) * WI;             // conv1 pixels: the output tile plus a 1-pixel ring
constexpr int M1P = (M1 + 31) / 32 * 32;      // ... rounded up to whole 32-pixel warp tasks
constexpr int M2 = TH * WI;                   // conv2 pixels
constexpr int IN_PX = (M1P + 2 * WI + 2 + 15) / 16 * 16;  // input pixels read by conv1
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(M2 % 32 == 0, "conv2 pixels must be whole warp tasks");
static_assert(M2 + 2 * WI + 2 <= M1P, "conv2 reads past the conv1 tile");
static_assert(IN_PX >= (TH + 4) * WI, "input tile too small");

__host__ __device__ constexpr int pitch(int c) { return c + 8; }

__host__ int smem_bytes(bool single, int cin, int c1, int c2) {
  const int in_bytes = single ? IN_PX * 4 : IN_PX * pitch(cin) * 2;
  const int out_bytes = M2 * pitch(c2) * 2;
  const int a = in_bytes > out_bytes ? in_bytes : out_bytes;
  return a + M1P * pitch(c1) * 2;
}

// acc[m][n] += sum over taps and k of src[p + tap offset][k] * w[tap][n][k]
// for the warp task of pixels p0 .. p0 + 31 and channels n0 .. n0 + 63.
__device__ __forceinline__ void conv_task(const bf16* src, int K, const bf16* __restrict__ w, int N,
                                          int p0, int n0, float (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ps = pitch(K);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int off = (tap / 3) * WI + tap % 3;
    const bf16* wt = w + static_cast<size_t>(tap) * N * K + static_cast<size_t>(n0 + g) * K + 2 * t;
    const bf16* s0 = src + (p0 + g + off) * ps + 2 * t;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const bf16* r0 = s0 + (m * 16) * ps + k0;
        const bf16* r1 = r0 + 8 * ps;
        a[m][0] = ld_bf16x2(r0);
        a[m][1] = ld_bf16x2(r1);
        a[m][2] = ld_bf16x2(r0 + 8);
        a[m][3] = ld_bf16x2(r1 + 8);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* wb = wt + static_cast<size_t>(n * 8) * K + k0;
        const uint32_t b0 = ldg_bf16x2(wb), b1 = ldg_bf16x2(wb + 8);
        mma_bf16_16816(acc[0][n], a[0], b0, b1);
        mma_bf16_16816(acc[1][n], a[1], b0, b1);
      }
    }
  }
}

template <bool SINGLE, bool POOL>
__global__ void __launch_bounds__(THREADS)
vgg_stage_kernel(const void* __restrict__ x_, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, void* __restrict__ out_, int H, int W, int cin,
                 int c1, int c2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_bytes = SINGLE ? IN_PX * 4 : IN_PX * pitch(cin) * 2;
  const int out_bytes = M2 * pitch(c2) * 2;
  bf16* t1 = reinterpret_cast<bf16*>(smem + (in_bytes > out_bytes ? in_bytes : out_bytes));
  const int bimg = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int p1 = pitch(c1), p2 = pitch(c2);

  // 1. Input tile rows y0 - 2 .. y0 + TH + 1, columns x0 - 2 .. x0 + TW + 1,
  //    rounded to bf16, zero outside the image and past the tile.
  if (SINGLE) {
    const float* x = static_cast<const float*>(x_) + static_cast<size_t>(bimg) * H * W;
    float* tin = reinterpret_cast<float*>(smem);
    for (int q = tid; q < IN_PX; q += THREADS) {
      const int r = q / WI, c = q % WI, gy = y0 - 2 + r, gx = x0 - 2 + c;
      float v = 0.f;
      if (r < TH + 4 && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __bfloat162float(__float2bfloat16_rn(x[static_cast<size_t>(gy) * W + gx]));
      tin[q] = v;
    }
  } else {
    const bf16* x = static_cast<const bf16*>(x_) + static_cast<size_t>(bimg) * H * W * cin;
    bf16* tin = reinterpret_cast<bf16*>(smem);
    const int chunks = cin / 8;
    for (int i = tid; i < IN_PX * chunks; i += THREADS) {
      const int q = i / chunks, j = i % chunks;
      const int r = q / WI, c = q % WI, gy = y0 - 2 + r, gx = x0 - 2 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < TH + 4 && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(reinterpret_cast<const uint4*>(x + (static_cast<size_t>(gy) * W + gx) * cin) + j);
      *reinterpret_cast<uint4*>(tin + q * pitch(cin) + 8 * j) = v;
    }
  }
  __syncthreads();

  // 2. conv1 over the flat (TH + 2) x WI tile: bias, ReLU, zero outside the
  //    image (and on the thrown-away columns), round to bf16 into t1.
  auto inside1 = [&](int p) {
    const int r = p / WI, c = p % WI, gy = y0 - 1 + r, gx = x0 - 1 + c;
    return r < TH + 2 && c < TW + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  if (SINGLE) {
    const float* tin = reinterpret_cast<const float*>(smem);
    const int n = tid % c1;  // fixed per thread: THREADS is a multiple of c1
    float wr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wr[k] = __bfloat162float(w1[k * c1 + n]);
    const float bias = b1[n];
    for (int i = tid; i < M1P * c1; i += THREADS) {
      const int p = i / c1;
      // The Pallas kernel's order: for each column tap, a 3-term dot over the row taps.
      float acc = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float part = tin[p + dx] * wr[dx] + tin[p + WI + dx] * wr[3 + dx] +
                           tin[p + 2 * WI + dx] * wr[6 + dx];
        acc = dx == 0 ? part : acc + part;
      }
      const float v = inside1(p) ? fmaxf(acc + bias, 0.f) : 0.f;
      t1[p * p1 + n] = __float2bfloat16_rn(v);
    }
  } else {
    const bf16* tin = reinterpret_cast<const bf16*>(smem);
    const int ntask = c1 / 64;
    for (int task = warp; task < (M1P / 32) * ntask; task += WARPS) {
      const int pb = (task / ntask) * 32, nb = (task % ntask) * 64;
      float acc[2][8][4];
      conv_task(tin, cin, w1, c1, pb, nb, acc);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pb + m * 16 + g + 8 * h;
          const bool in = inside1(p);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int ch = nb + n * 8 + 2 * t;
            const float v0 = in ? fmaxf(acc[m][n][2 * h] + b1[ch], 0.f) : 0.f;
            const float v1 = in ? fmaxf(acc[m][n][2 * h + 1] + b1[ch + 1], 0.f) : 0.f;
            *reinterpret_cast<uint32_t*>(t1 + p * p1 + ch) = pack_bf16x2(v0, v1);
          }
        }
    }
  }
  __syncthreads();

  // 3. conv2 over the flat TH x WI tile: bias, ReLU, round to bf16 into the
  //    (now dead) input tile.
  bf16* t2 = reinterpret_cast<bf16*>(smem);
  {
    const int ntask = c2 / 64;
    for (int task = warp; task < (M2 / 32) * ntask; task += WARPS) {
      const int pb = (task / ntask) * 32, nb = (task % ntask) * 64;
      float acc[2][8][4];
      conv_task(t1, c1, w2, c2, pb, nb, acc);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pb + m * 16 + g + 8 * h;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int ch = nb + n * 8 + 2 * t;
            *reinterpret_cast<uint32_t*>(t2 + p * p2 + ch) =
                pack_bf16x2(fmaxf(acc[m][n][2 * h] + b2[ch], 0.f),
                            fmaxf(acc[m][n][2 * h + 1] + b2[ch + 1], 0.f));
          }
        }
    }
  }
  __syncthreads();

  // 4. [2 x 2 max-pool and] store, 8 channels per thread and step.
  constexpr int S = POOL ? 2 : 1;
  const int OH = H / S, OW = W / S, oy0 = y0 / S, ox0 = x0 / S;
  const int chunks = c2 / 8;
  for (int i = tid; i < (TH / S) * (TW / S) * chunks; i += THREADS) {
    const int j = i % chunks, pix = i / chunks, r = pix / (TW / S), c = pix % (TW / S);
    if (ox0 + c >= OW || oy0 + r >= OH) continue;
    float v[8];
    {
      const uint4 u = *reinterpret_cast<const uint4*>(t2 + (S * r * WI + S * c) * p2 + 8 * j);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
    }
    if (POOL) {
#pragma unroll
      for (int d = 1; d < 4; ++d) {
        const int q = (2 * r + d / 2) * WI + 2 * c + d % 2;
        const uint4 u = *reinterpret_cast<const uint4*>(t2 + q * p2 + 8 * j);
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], __bfloat162float(e[k]));
      }
    }
    const size_t o = ((static_cast<size_t>(bimg) * OH + oy0 + r) * OW + ox0 + c) * c2 + 8 * j;
    if (SINGLE) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out_) + o);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      u.x = pack_bf16x2(v[0], v[1]);
      u.y = pack_bf16x2(v[2], v[3]);
      u.z = pack_bf16x2(v[4], v[5]);
      u.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(out_) + o) = u;
    }
  }
}

template <bool SINGLE, bool POOL>
int launch(const void* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
           void* out, int B, int H, int W, int cin, int c1, int c2, cudaStream_t stream) {
  const int bytes = smem_bytes(SINGLE, cin, c1, c2);
  cudaError_t err = cudaFuncSetAttribute(vgg_stage_kernel<SINGLE, POOL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  vgg_stage_kernel<SINGLE, POOL><<<grid, THREADS, bytes, stream>>>(x, w1, b1, w2, b2, out, H, W,
                                                                   cin, c1, c2);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, cin] (fp32 if cin == 1, else bf16); w1 [9, c1, cin] and
// w2 [9, c2, c1] bf16; b1 [c1], b2 [c2] fp32; out fp32 if cin == 1, else
// bf16. H and W even with the pool (ragged tiles are masked); cin 1 or a
// multiple of 16 up to 128; c1 and c2 64 or 128.
extern "C" int vgg_stage_launch(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, void* out, int B, int H, int W, int cin, int c1,
                                int c2, int pool, cudaStream_t stream) {
  const bool single = cin == 1;
  if ((pool && (H % 2 || W % 2)) || (!single && (cin % 16 || cin > 128)) ||
      (c1 != 64 && c1 != 128) ||
      (c2 != 64 && c2 != 128))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  if (single)
    return pool ? launch<true, true>(x, w1b, b1, w2b, b2, out, B, H, W, cin, c1, c2, stream)
                : launch<true, false>(x, w1b, b1, w2b, b2, out, B, H, W, cin, c1, c2, stream);
  return pool ? launch<false, true>(x, w1b, b1, w2b, b2, out, B, H, W, cin, c1, c2, stream)
              : launch<false, false>(x, w1b, b1, w2b, b2, out, B, H, W, cin, c1, c2, stream);
}
