// GATs leaf attention, fp32 arithmetic: the device kernel and its
// launcher, shared by gats.cu (K2) and gats_block.cu (the GATs part of the
// fused block, K4). See gats.cu for what it computes, its bound and its
// design. The leaves are fp32, or bf16 where their values are bf16 (the
// bf16 serving path): read as they are, widened to fp32 in registers.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace gats_leaf {

constexpr int kThreads = 256;  // 8 points per block

__device__ __forceinline__ float lrelu(float x, float alpha) { return x >= 0.f ? x : alpha * x; }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Four consecutive leaf values from chunk i (in units of 4 elements).
__device__ __forceinline__ float4 load4(const float* p, size_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, size_t i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + i);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// K4: float4 chunks per lane, ceil(C / 128); LT: the leaves' type.
template <int K4, typename LT>
__global__ void __launch_bounds__(kThreads)
gats_kernel(const LT* __restrict__ leaves, const float* __restrict__ d3,
            const float* __restrict__ mask_add, const float* __restrict__ wa,
            float* __restrict__ out, int P, int L, int C, float alpha) {
  const int point = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= P) return;
  const int C4 = C >> 2;
  const float4* wa_leaf = reinterpret_cast<const float4*>(wa);
  const float4* wa_self = wa_leaf + C4;
  const float4* x3 = reinterpret_cast<const float4*>(d3) + static_cast<size_t>(point) * C4;
  const size_t lv = static_cast<size_t>(point) * L * C4;  // the point's first leaf chunk

  float4 acc[K4], wl[K4];
  float e3 = 0.f;
#pragma unroll
  for (int k = 0; k < K4; ++k) {
    const int c = lane + 32 * k;
    if (c < C4) {
      acc[k] = __ldg(x3 + c);
      wl[k] = __ldg(wa_leaf + c);
      e3 += dot4(acc[k], __ldg(wa_self + c));
    } else {
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      wl[k] = acc[k];
    }
  }
  e3 = warp_sum(e3);
  // Online softmax, seeded with the self column (its weight is exp(0) = 1).
  float m = lrelu(2.f * e3, alpha);
  float denom = 1.f;

  for (int l = 0; l < L; ++l) {
    const size_t row = lv + static_cast<size_t>(l) * C4;
    float4 v[K4];
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < K4; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < C4 ? load4(leaves, row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      e += dot4(v[k], wl[k]);
    }
    e = warp_sum(e);
    float logit = lrelu(e + e3, alpha);
    if (mask_add != nullptr) logit += mask_add[static_cast<size_t>(point) * L + l];
    const float m_new = fmaxf(m, logit);
    const float scale = expf(m - m_new);
    const float p = expf(logit - m_new);
    denom = denom * scale + p;
#pragma unroll
    for (int k = 0; k < K4; ++k) {
      acc[k].x = acc[k].x * scale + p * v[k].x;
      acc[k].y = acc[k].y * scale + p * v[k].y;
      acc[k].z = acc[k].z * scale + p * v[k].z;
      acc[k].w = acc[k].w * scale + p * v[k].w;
    }
    m = m_new;
  }

  const float inv = 1.f / denom;
  float4* dst = reinterpret_cast<float4*>(out) + static_cast<size_t>(point) * C4;
#pragma unroll
  for (int k = 0; k < K4; ++k) {
    const int c = lane + 32 * k;
    if (c < C4) {
      float4 h = acc[k];
      h.x *= inv; h.y *= inv; h.z *= inv; h.w *= inv;
      h.x = h.x > 0.f ? h.x : expm1f(h.x);
      h.y = h.y > 0.f ? h.y : expm1f(h.y);
      h.z = h.z > 0.f ? h.z : expm1f(h.z);
      h.w = h.w > 0.f ? h.w : expm1f(h.w);
      dst[c] = h;
    }
  }
}

template <int K4, typename LT>
void launch(const LT* leaves, const float* d3, const float* mask_add, const float* wa,
            float* out, int P, int L, int C, float alpha, cudaStream_t stream) {
  const int warps_per_block = kThreads / 32;
  const int blocks = (P + warps_per_block - 1) / warps_per_block;
  gats_kernel<K4, LT><<<blocks, kThreads, 0, stream>>>(leaves, d3, mask_add, wa, out, P, L, C, alpha);
}

// The launch for C channels (a multiple of 4, at most 512).
template <typename LT>
void dispatch(const LT* leaves, const float* d3, const float* mask_add, const float* wa,
                     float* out, int P, int L, int C, float alpha, cudaStream_t stream) {
  switch ((C / 4 + 31) / 32) {
    case 1: launch<1, LT>(leaves, d3, mask_add, wa, out, P, L, C, alpha, stream); break;
    case 2: launch<2, LT>(leaves, d3, mask_add, wa, out, P, L, C, alpha, stream); break;
    case 3: launch<3, LT>(leaves, d3, mask_add, wa, out, P, L, C, alpha, stream); break;
    default: launch<4, LT>(leaves, d3, mask_add, wa, out, P, L, C, alpha, stream); break;
  }
}

}  // namespace gats_leaf
