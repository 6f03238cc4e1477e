// SuperPoint non-maximum suppression on [B, H, W] fp32 score maps.
//
// Replaces onepose_tpu/ops/pallas/score_path.py::simple_nms_pallas. Same
// function as simple_nms: a (2r+1)^2 window max, then two suppression
// rounds, five window-max passes in all; local maxima keep their score and
// every other pixel becomes 0. All max and compare, so bit-exact. Cells
// outside the image are -inf and never maxima.
//
// Bound on the H100: bytes. The map is read once and written once (8.4 MB
// each way at 8 x 512 x 512), about 5 us at 3.35 TB/s; the compares are
// far below the fp32 rate.
//
// Entry 1, nms_launch (radius 0 .. 9, the radius a template parameter):
// one launch; one block of 512 threads (two an SM at r = 4) per 64 x 64
// output tile of one image, which loads
// the tile and a halo of h = 5r rounded up to 4 (the receptive field of the
// five chained passes; 104 x 104 cells at r = 4, 2.6x the tile) into shared
// memory once, with 16-byte loads where W % 4 == 0 (all of a thread's
// loads in flight before its stores), and runs every pass
// there. Pass p computes the square [h - (5 - p) r, h + 64 + (5 - p) r) of
// the region, what pass p + 1 reads. The float passes (1, 3, 5) are
// separable: a row step, each thread taking 16 outputs of one row (lanes on
// neighbouring rows; the float buffers have an odd row pitch, so no bank
// conflict), then a column step, each thread sliding down 16 outputs of one
// column in registers. Both steps take a window max of 2r + 1 by log-step
// doubling (a 9-wide max in 4 fmaxf an output, whatever the radius costs
// in loads: 16 + 2r a task). The masks are bits, 32 columns a word: the
// column step of a float pass sets them by __ballot_sync (a warp owns a
// word-column), and the dilation passes (2, 4: supp = max_pool(max_mask) >
// 0) are ORs of funnel-shifted words along the row, then of r rows up and
// down. The last pass writes the output.
//
// Entry 2, nms_large_launch (any radius >= 0, runtime): the five passes one
// launch each, through device memory, with byte masks: a block takes a
// 32 x 32 output tile, writes the row maxima of its rows plus r above and
// below into shared memory (2r + 1 taps a cell, clipped to the image),
// then takes the column maxima and applies the pass's mask logic. A radius
// wider than the image acts as one as wide as the image.

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 512;  // two blocks an SM at r <= 4 (64 registers a thread)
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;  // outputs of one window-max task

template <int r>
struct Geo {
  static constexpr int h = (5 * r + 3) / 4 * 4;  // halo
  static constexpr int D = kTile + 2 * h;        // region side
  static constexpr int P = D + 1;                // row pitch of the float buffers
  static constexpr int WW = (D + 31) / 32;       // mask words a row
  static constexpr int smem = (2 * D * P + 2 * D * WW + WW) * 4;
  // Pass p computes [lo, hi)^2 of the region.
  __host__ __device__ static constexpr int lo(int p) { return h - (5 - p) * r; }
  __host__ __device__ static constexpr int hi(int p) { return h + kTile + (5 - p) * r; }
};

__host__ __device__ constexpr int pow2_floor(int w) { return w < 2 ? 1 : 2 * pow2_floor(w / 2); }

// The doubling steps from p on: before the step of p, a[i] = max(a0[i ..
// i + p)); after it, max(a0[i .. i + 2p)), for every i it still needs.
template <int r, int p>
__device__ __forceinline__ void double_steps(float (&a)[kSeg + 2 * r]) {
  if constexpr (2 * p <= 2 * r + 1) {
#pragma unroll
    for (int i = 0; i + 2 * p <= kSeg + 2 * r; ++i) a[i] = fmaxf(a[i], a[i + p]);
    double_steps<r, 2 * p>(a);
  }
}

// o[i] = max(a[i .. i + 2r]) for i < kSeg, by log-step doubling to the
// largest power of two P <= 2r + 1, then one max of two overlapping spans.
template <int r>
__device__ __forceinline__ void window_max(float (&a)[kSeg + 2 * r], float (&o)[kSeg]) {
  constexpr int w = 2 * r + 1, P = pow2_floor(w);
  double_steps<r, 1>(a);
#pragma unroll
  for (int i = 0; i < kSeg; ++i) o[i] = fmaxf(a[i], a[i + w - P]);
}

// Row step of float pass `pass`: tmp[y][x] = max over |d| <= r of v(y, x + d)
// for rows [lo - r, hi + r) and columns [lo, hi).
template <int r, int pass, class V>
__device__ __forceinline__ void row_step(V v, float* tmp) {
  using G = Geo<r>;
  constexpr int lo = G::lo(pass), hi = G::hi(pass);
  constexpr int ny = hi - lo + 2 * r, nseg = (hi - lo + kSeg - 1) / kSeg;
  for (int t = threadIdx.x; t < ny * nseg; t += kThreads) {
    const int y = lo - r + t % ny, x0 = lo + t / ny * kSeg;
    float a[kSeg + 2 * r], o[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg + 2 * r; ++i) a[i] = v(y, min(x0 - r + i, G::D - 1));
    window_max<r>(a, o);
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      if (x0 + i < hi) tmp[y * G::P + x0 + i] = o[i];
  }
}

// Column step of float pass `pass`: a warp takes a word-column (32
// columns) and 16 rows; f(y, w, x, in range, window max) for every row of
// [lo, hi), called by all 32 lanes together (f may ballot).
template <int r, int pass, class F>
__device__ __forceinline__ void col_step(const float* tmp, F f) {
  using G = Geo<r>;
  constexpr int lo = G::lo(pass), hi = G::hi(pass);
  constexpr int w_lo = lo / 32, nw = (hi + 31) / 32 - w_lo, nseg = (hi - lo + kSeg - 1) / kSeg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < nw * nseg; t += kWarps) {
    const int w = w_lo + t % nw, y0 = lo + t / nw * kSeg;
    const int x = 32 * w + lane, xr = min(x, G::D - 1);
    float a[kSeg + 2 * r], o[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg + 2 * r; ++i) a[i] = tmp[min(y0 - r + i, G::D - 1) * G::P + xr];
    window_max<r>(a, o);
    const bool in_x = x >= lo && x < hi;
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      if (y0 + i < hi) f(y0 + i, w, x, in_x, o[i]);  // warp-uniform
  }
}

// Dilation pass `pass` (2 or 4): supp = max_pool(max_mask) > 0 on [lo,
// hi)^2, cleared outside the image: the row ORs into hb, then the column ORs.
template <int r, int pass>
__device__ __forceinline__ void dilate(const unsigned* maxm, unsigned* hb, unsigned* supp,
                                       const unsigned* colin, int gy0, int H) {
  using G = Geo<r>;
  constexpr int lo = G::lo(pass), hi = G::hi(pass), WW = G::WW;
  constexpr int w_lo = lo / 32, nw = (hi + 31) / 32 - w_lo;
  constexpr int ny = hi - lo + 2 * r;
  for (int t = threadIdx.x; t < ny * nw; t += kThreads) {
    const int y = lo - r + t / nw, w = w_lo + t % nw;
    const unsigned* row = maxm + y * WW;
    const unsigned cur = row[w], prev = w > 0 ? row[w - 1] : 0u, next = w + 1 < WW ? row[w + 1] : 0u;
    unsigned acc = cur;
#pragma unroll
    for (int d = 1; d <= r; ++d)
      acc |= __funnelshift_r(cur, next, d) | __funnelshift_l(prev, cur, d);
    hb[y * WW + w] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < (hi - lo) * nw; t += kThreads) {
    const int y = lo + t / nw, w = w_lo + t % nw;
    unsigned acc = 0u;
#pragma unroll
    for (int d = -r; d <= r; ++d) acc |= hb[(y + d) * WW + w];
    supp[y * WW + w] = static_cast<unsigned>(gy0 + y) < static_cast<unsigned>(H) ? acc & colin[w] : 0u;
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit(const unsigned* m, int WW, int y, int x) {
  return (m[y * WW + (x >> 5)] >> (x & 31)) & 1u;
}

template <int r>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ scores, float* __restrict__ out, int H, int W) {
  using G = Geo<r>;
  constexpr int D = G::D, P = G::P, WW = G::WW, h = G::h;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);     // scores; -inf outside the image
  float* tmp = s + D * P;                            // a row step's result; dilation rows
  unsigned* maxm = reinterpret_cast<unsigned*>(tmp + D * P);  // max_mask bits
  unsigned* supp = maxm + D * WW;                    // supp_mask bits
  unsigned* colin = supp + D * WW;                   // columns inside the image
  unsigned* hb = reinterpret_cast<unsigned*>(tmp);

  const int gy0 = blockIdx.y * kTile - h, gx0 = blockIdx.x * kTile - h;
  const float* img = scores + static_cast<size_t>(blockIdx.z) * H * W;
  auto inside = [&](int y, int x) {
    return static_cast<unsigned>(gy0 + y) < static_cast<unsigned>(H) &&
           static_cast<unsigned>(gx0 + x) < static_cast<unsigned>(W);
  };

  for (int i = threadIdx.x; i < 2 * D * WW; i += kThreads) maxm[i] = 0u;  // and supp
  for (int w = threadIdx.x; w < WW; w += kThreads) {
    unsigned m = 0u;
    for (int b = 0; b < 32; ++b) {
      const int x = 32 * w + b;
      if (x < D && static_cast<unsigned>(gx0 + x) < static_cast<unsigned>(W)) m |= 1u << b;
    }
    colin[w] = m;
  }
  if (W % 4 == 0) {  // gx0 and W are multiples of 4: a 4-column chunk is all in or all out
    // Every load of the thread in flight at once, then the stores.
    constexpr int kChunks = D * (D / 4), kIters = (kChunks + kThreads - 1) / kThreads;
    float4 v[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int t = threadIdx.x + it * kThreads, y = t / (D / 4), x = t % (D / 4) * 4;
      v[it] = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      if (t < kChunks && inside(y, x))
        v[it] = __ldg(reinterpret_cast<const float4*>(img + static_cast<size_t>(gy0 + y) * W + gx0 + x));
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int t = threadIdx.x + it * kThreads, y = t / (D / 4), x = t % (D / 4) * 4;
      if (t < kChunks) {
        float* d = s + y * P + x;
        d[0] = v[it].x, d[1] = v[it].y, d[2] = v[it].z, d[3] = v[it].w;
      }
    }
  } else {
    for (int t = threadIdx.x; t < D * D; t += kThreads) {
      const int y = t / D, x = t % D;
      s[y * P + x] = inside(y, x) ? __ldg(img + static_cast<size_t>(gy0 + y) * W + gx0 + x)
                                  : -CUDART_INF_F;
    }
  }
  __syncthreads();

  const unsigned lane0 = (threadIdx.x & 31) == 0;
  // Pass 1: max_mask = scores == max_pool(scores).
  row_step<r, 1>([&](int y, int x) { return s[y * P + x]; }, tmp);
  __syncthreads();
  col_step<r, 1>(tmp, [&](int y, int w, int x, bool in_x, float m) {
    const unsigned word = __ballot_sync(0xffffffffu, in_x && inside(y, x) && s[y * P + x] == m);
    if (lane0) maxm[y * WW + w] = word;
  });
  __syncthreads();

  // work = supp ? 0 : scores (-inf outside the image, where supp is 0).
  auto work = [&](int y, int x) { return bit(supp, WW, y, x) ? 0.f : s[y * P + x]; };
  // Round 0: passes 2 and 3.
  dilate<r, 2>(maxm, hb, supp, colin, gy0, H);
  row_step<r, 3>(work, tmp);
  __syncthreads();
  col_step<r, 3>(tmp, [&](int y, int w, int x, bool in_x, float m) {
    const unsigned word = __ballot_sync(
        0xffffffffu, in_x && inside(y, x) && !bit(supp, WW, y, x) && s[y * P + x] == m);
    if (lane0) maxm[y * WW + w] |= word;
  });
  __syncthreads();

  // Round 1: passes 4 and 5; pass 5 covers the tile and writes it.
  dilate<r, 4>(maxm, hb, supp, colin, gy0, H);
  row_step<r, 5>(work, tmp);
  __syncthreads();
  float* dst = out + static_cast<size_t>(blockIdx.z) * H * W;
  col_step<r, 5>(tmp, [&](int y, int, int x, bool in_x, float m) {
    if (in_x && inside(y, x)) {
      const float v = s[y * P + x];
      const bool keep = bit(maxm, WW, y, x) || (!bit(supp, WW, y, x) && v == m);
      dst[static_cast<size_t>(gy0 + y) * W + gx0 + x] = keep ? v : 0.f;
    }
  });
}

template <int r>
cudaError_t launch(const float* scores, float* out, int B, int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(nms_kernel<r>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Geo<r>::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  nms_kernel<r><<<grid, kThreads, Geo<r>::smem, stream>>>(scores, out, H, W);
  return cudaGetLastError();
}

// Entry 2: one pass of simple_nms through device memory.
constexpr int kLT = 32;  // output tile side; threads 32 x 8
enum Kind { kFirst = 0, kDilate = 1, kSuppressed = 2 };

__global__ void __launch_bounds__(kLT * 8)
nms_pass(const float* __restrict__ scores, const unsigned char* __restrict__ in_mask,
         unsigned char* maxm, unsigned char* supp, float* __restrict__ out, int H, int W, int r,
         int kind, int last) {
  extern __shared__ float hm[];  // row maxima of rows [ylo, yhi), the tile's 32 columns
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const int x0 = blockIdx.x * kLT, y0 = blockIdx.y * kLT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ylo = max(0, y0 - r), yhi = min(H, y0 + kLT + r);
  auto v = [&](size_t i) {
    if (kind == kFirst) return __ldg(scores + i);
    if (kind == kDilate) return __ldg(in_mask + i) ? 1.f : 0.f;
    return __ldg(in_mask + i) ? 0.f : __ldg(scores + i);
  };
  const int x = x0 + tx;
  if (x < W) {
    const int xa = max(0, x - r), xb = min(W - 1, x + r);
    for (int y = ylo + ty; y < yhi; y += 8) {
      const size_t row = base + static_cast<size_t>(y) * W;
      float m = v(row + xa);
      for (int xx = xa + 1; xx <= xb; ++xx) m = fmaxf(m, v(row + xx));
      hm[(y - ylo) * kLT + tx] = m;
    }
  }
  __syncthreads();
  if (x >= W) return;
  for (int y = y0 + ty; y < min(H, y0 + kLT); y += 8) {
    const int ya = max(0, y - r), yb = min(H - 1, y + r);
    float m = hm[(ya - ylo) * kLT + tx];
    for (int yy = ya + 1; yy <= yb; ++yy) m = fmaxf(m, hm[(yy - ylo) * kLT + tx]);
    const size_t i = base + static_cast<size_t>(y) * W + x;
    if (kind == kFirst) {
      maxm[i] = __ldg(scores + i) == m;
    } else if (kind == kDilate) {
      supp[i] = m > 0.f;
    } else {
      const float s = __ldg(scores + i);
      const bool new_max = !__ldg(in_mask + i) && s == m;
      if (last) out[i] = (maxm[i] || new_max) ? s : 0.f;
      else if (new_max) maxm[i] = 1;
    }
  }
}

}  // namespace

// scores, out [B, H, W]; radius 0 .. 9 (the region of a 64 x 64 tile plus
// its halo must fit shared memory; larger radii take nms_large_launch).
extern "C" int nms_launch(const float* scores, float* out, int B, int H, int W, int radius,
                          cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  switch (radius) {
    case 0: return launch<0>(scores, out, B, H, W, stream);
    case 1: return launch<1>(scores, out, B, H, W, stream);
    case 2: return launch<2>(scores, out, B, H, W, stream);
    case 3: return launch<3>(scores, out, B, H, W, stream);
    case 4: return launch<4>(scores, out, B, H, W, stream);
    case 5: return launch<5>(scores, out, B, H, W, stream);
    case 6: return launch<6>(scores, out, B, H, W, stream);
    case 7: return launch<7>(scores, out, B, H, W, stream);
    case 8: return launch<8>(scores, out, B, H, W, stream);
    case 9: return launch<9>(scores, out, B, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

// scores, out [B, H, W]; scratch masks maxm, supp [B, H, W] bytes; any
// radius >= 0; `smem` bytes of row maxima a block (ops/kernels/
// score_path.py::large_smem). Five launches.
extern "C" int nms_large_launch(const float* scores, float* out, unsigned char* maxm,
                                unsigned char* supp, int B, int H, int W, int radius, int smem,
                                cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (radius < 0) return cudaErrorInvalidValue;
  const int r = min(radius, max(H, W));  // a wider window sees the same cells
  cudaError_t err = cudaFuncSetAttribute(nms_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kLT - 1) / kLT, (H + kLT - 1) / kLT, B), block(kLT, 8);
  // (mask read, kind, last) of passes 1 .. 5.
  const unsigned char* in[5] = {nullptr, maxm, supp, maxm, supp};
  const int kinds[5] = {kFirst, kDilate, kSuppressed, kDilate, kSuppressed};
  for (int p = 0; p < 5; ++p) {
    nms_pass<<<grid, block, smem, stream>>>(scores, in[p], maxm, supp, out, H, W, r, kinds[p],
                                            p == 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
