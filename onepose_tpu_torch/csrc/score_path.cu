// SuperPoint non-maximum suppression on [B, H, W] fp32 score maps.
//
// Replaces onepose_tpu/ops/pallas/score_path.py::simple_nms_pallas. Same
// function as simple_nms: a (2r+1)^2 window max, then two suppression
// rounds, five window-max passes in all; local maxima keep their score and
// every other pixel becomes 0. All max and compare, so bit-exact.
//
// Bound on the H100: bytes. The map is read once and written once (8.4 MB
// each way at 8 x 512 x 512), about 5 us at 3.35 TB/s; the compares are
// far below the fp32 rate. Design: one launch; one block per 32 x 32 output
// tile of one image, which loads the tile plus a halo of 5r pixels (the
// receptive field of the five chained passes) into shared memory once and
// runs every pass there, so the map is read from device memory once. Each
// pass is separable (row max, then column max) and shrinks the region it
// computes by r on every side, since the next pass needs no more: pass p
// writes the square [p r, R - p r) of the R x R region and reads only what
// pass p - 1 wrote. The radius is a template parameter, so every index is
// computed without division, and the threads walk the region as 32 x 8
// (x, y), neighbouring threads on neighbouring columns. Region cells outside
// the image hold -inf and are never maxima (the Pallas kernel needed
// `col_valid` for the same reason).

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreadsX = 32, kThreadsY = 8;

// rowmax[y][x] = max over |d| <= r of v(y, x + d), for rows [lo - r, hi + r)
// and columns [lo, hi): what the column pass over [lo, hi)^2 reads.
template <int R, int r, class V>
__device__ __forceinline__ void row_pass(V v, float* rowmax, int lo, int hi) {
  for (int y = lo - r + threadIdx.y; y < hi + r; y += kThreadsY)
    for (int x = lo + threadIdx.x; x < hi; x += kThreadsX) {
      float m = v(y, x - r);
#pragma unroll
      for (int d = 1 - r; d <= r; ++d) m = fmaxf(m, v(y, x + d));
      rowmax[y * R + x] = m;
    }
}

// f(y, x, window max) for every cell of [lo, hi)^2.
template <int R, int r, class F>
__device__ __forceinline__ void col_pass(const float* rowmax, int lo, int hi, F f) {
  for (int y = lo + threadIdx.y; y < hi; y += kThreadsY)
    for (int x = lo + threadIdx.x; x < hi; x += kThreadsX) {
      float m = rowmax[(y - r) * R + x];
#pragma unroll
      for (int d = 1 - r; d <= r; ++d) m = fmaxf(m, rowmax[(y + d) * R + x]);
      f(y, x, m);
    }
}

template <int r>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
nms_kernel(const float* __restrict__ scores, float* __restrict__ out, int H, int W) {
  constexpr int halo = 5 * r;
  constexpr int R = kTile + 2 * halo;
  extern __shared__ float smem[];
  float* s = smem;                  // scores; -inf outside the image
  float* rowmax = s + R * R;        // result of a row pass
  unsigned char* maxm = reinterpret_cast<unsigned char*>(rowmax + R * R);  // max_mask
  unsigned char* supp = maxm + R * R;                                      // supp_mask

  const int gy0 = blockIdx.y * kTile - halo;
  const int gx0 = blockIdx.x * kTile - halo;
  auto inside = [&](int y, int x) {
    return static_cast<unsigned>(gy0 + y) < static_cast<unsigned>(H) &&
           static_cast<unsigned>(gx0 + x) < static_cast<unsigned>(W);
  };

  const float* img = scores + static_cast<size_t>(blockIdx.z) * H * W;
  for (int y = threadIdx.y; y < R; y += kThreadsY)
    for (int x = threadIdx.x; x < R; x += kThreadsX)
      s[y * R + x] = inside(y, x) ? img[static_cast<size_t>(gy0 + y) * W + gx0 + x]
                                  : -CUDART_INF_F;
  __syncthreads();

  // Pass 1, on [r, R - r): max_mask = scores == max_pool(scores).
  row_pass<R, r>([&](int y, int x) { return s[y * R + x]; }, rowmax, r, R - r);
  __syncthreads();
  col_pass<R, r>(rowmax, r, R - r, [&](int y, int x, float m) {
    maxm[y * R + x] = inside(y, x) && s[y * R + x] == m;
  });
  __syncthreads();

  // Passes 2 + 3 (round 0) and 4 + 5 (round 1).
  auto work = [&](int y, int x) { return supp[y * R + x] ? 0.f : s[y * R + x]; };
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    // supp_mask = max_pool(max_mask) > 0, on [p r, R - p r) with p = 2 + 2 round.
    const int lo = (2 + 2 * round) * r;
    row_pass<R, r>([&](int y, int x) { return static_cast<float>(maxm[y * R + x]); },
                   rowmax, lo, R - lo);
    __syncthreads();
    col_pass<R, r>(rowmax, lo, R - lo, [&](int y, int x, float m) {
      supp[y * R + x] = inside(y, x) && m > 0.f;  // outside stays -inf in `work`
    });
    __syncthreads();
    // max_mask |= (work == max_pool(work)) & ~supp_mask, with work = supp ?
    // 0 : scores, on [(p + 1) r, R - (p + 1) r).
    row_pass<R, r>(work, rowmax, lo + r, R - lo - r);
    __syncthreads();
    col_pass<R, r>(rowmax, lo + r, R - lo - r, [&](int y, int x, float m) {
      if (inside(y, x) && !supp[y * R + x] && s[y * R + x] == m) maxm[y * R + x] = 1;
    });
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(blockIdx.z) * H * W;
  for (int ty = threadIdx.y; ty < kTile; ty += kThreadsY) {
    const int y = halo + ty, x = halo + threadIdx.x;
    if (inside(y, x))
      dst[static_cast<size_t>(gy0 + y) * W + gx0 + x] = maxm[y * R + x] ? s[y * R + x] : 0.f;
  }
}

template <int r>
cudaError_t launch(const float* scores, float* out, int B, int H, int W, cudaStream_t stream) {
  constexpr int R = kTile + 10 * r;
  constexpr int smem = R * R * (2 * sizeof(float) + 2);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel<r>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  nms_kernel<r><<<grid, dim3(kThreadsX, kThreadsY), smem, stream>>>(scores, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// scores, out [B, H, W]; radius 0 .. 9 (the region of a 32 x 32 tile plus
// its 5r halo must fit shared memory).
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
