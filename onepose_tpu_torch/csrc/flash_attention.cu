// Flash attention with a key mask, fp32: the forward and its two backward
// kernels (K8).
//
// Replaces the library Pallas kernels that
// onepose_tpu/models/common.py::_flash_softmax_attention (:119) reaches
// through jax.experimental.pallas.ops.tpu.flash_attention:
//   _flash_attention_impl (flash_attention.py:589, pallas_call :758),
//   _flash_attention_bwd_dkv (:941, pallas_call :1121),
//   _flash_attention_bwd_dq (:1287, pallas_call :1456),
// joined there by a custom VJP (:204-300), here by
// ops/kernels/flash_attention.py::FlashAttention.
//
// What they compute, for q [B, N, H, D], k and v [B, M, H, D] (the JAX
// layout, read through its strides: nothing is transposed in memory) and a
// bool key mask [B, M] or none:
//   s   = (q . k) * scale                     (scale after the product)
//   o   = softmax_j(s + mask) . v,  lse = log-sum-exp_j of the row
// Masked keys weigh exactly 0, as -0.7 * FLT_MAX added in fp32 gives them
// wherever the row has a valid key. A row whose keys are all masked writes
// o = 0 (JAX zeroes it after its kernel) and lse = +inf, so every
// recomputed weight exp(s - lse) of it is 0 and its gradients are 0.
// Backward, with di = sum_d o * do (computed outside, as JAX does):
//   p = exp(s - lse), dp = do . v, ds = p * (dp - di)
//   dv = p^T do,  dk = scale * ds^T q,  dq = scale * ds k.
// Heads: D <= 128, or D a multiple of 128 (JAX's condition).
//
// Bound on the H100: operations on the tensor cores in 3xTF32 (three tf32
// products for each fp32 one, 495 TFLOP/s): the forward is 4 B H N M D
// flops (96.5 GFLOP over the valid keys at [7, 4096, 4096, 4, 64], x 3:
// 0.585 ms), the backward 10 B H N M D (1.462 ms). Bytes are far below.
//
// Design. Every product runs on wgmma m64nNk8 .tf32 in 3xTF32: an fp32
// operand x is hi + lo, hi = x as the tensor cores read it (a probe on the
// H100 found that they drop the 13 low mantissa bits of an fp32 operand,
// in registers and in shared memory alike) and lo = x - hi, exact in fp32
// and read in tf32 again; a product is hi.hi + hi.lo + lo.hi, summed in
// fp32 (about 21 bits, where one tf32 product keeps 11). The tensor cores
// round their sums toward zero, so a product chain over every tile of the
// other side piles up a bias that grows with the tiles: each tile's P V,
// dS K, P^T dO and dS^T Q goes into a fresh accumulator that is added to
// the running one in fp32.
//
// A warpgroup owns 64 rows of one side (queries in the forward and dQ,
// keys in dK / dV) and one 64-channel slice of the output, and loops over
// tiles of the other side. Operands live in shared memory as "raw" tiles
// [rows][64 channels] in the K-major layout wgmma reads (two 128-byte
// swizzled chunks of 32 channels), copied in by cp.async (16 bytes, or 4
// where D % 4 != 0; zeros past the tails and past D). So a raw tile is the
// hi part of a B operand as it stands; a pass writes its lo part beside
// it. The owned side is the register operand A: each thread reads its
// fragments from a raw tile (the swizzle makes that conflict-free) and
// splits them. Four products need the other axis contiguous (tf32 has no
// transposed operand): O += P V needs V^T, dV += P^T dO needs dO^T, dK +=
// dS^T Q needs Q^T, dQ += dS K needs K^T. A pass writes those transposed,
// hi and lo, from the raw tile (split_trans: 4 x 4 blocks transposed in
// registers). P and dS stay in registers as their product's accumulator
// left them and feed the next product as operand A: the accumulator gives
// a thread columns 2t and 2t + 1 of each 8-column block where A's
// fragment wants t and t + 4, so the transposed tiles store their rows
// permuted inside each group of 8 (row 2t at position t, 2t + 1 at t + 4):
// the product is unchanged.
//
// Three layouts of blocks, all with every product on the tensor cores,
// chosen by shape alone:
// - heads of up to 64 channels (the port's: SuperGlue's 4 x 64), D % 4 ==
//   0 and 16-byte aligned tensors: a block of three warpgroups, two
//   consumers of 64 rows each and a producer that copies and splits the
//   other side's tiles for both, a stage ahead (the "warp-specialised"
//   section below);
// - heads of 65 to 128 channels and of 256, D % 4 == 0, aligned: a block of
//   three warpgroups again, whose two consumers share 64 rows and split the
//   head's channels, a 64-channel slice each, and sum their partial score
//   tiles in shared memory, so that each score tile is computed once; 256
//   channels take a cluster of two such blocks (the "wide" section);
// - the rest (D % 4 != 0, misaligned tensors, D = 384 and wider): a block of
//   one warpgroup that does all of it in turn, its score tiles summing the
//   head's 64-channel slices one at a time (each slice's partial S, and
//   dP in the backward, a fresh accumulator, added in fp32), so the scores
//   are recomputed once an output slice (grid.y = H x slices).
// No wgmma sits behind a runtime condition, and every loop bound is a
// kernel argument. There is no tile skip: a masked key's score is -inf by
// a select, and a row whose running max is still -inf weighs its tile
// with exp(-inf - 0) = 0, so a key tile with no valid key changes nothing,
// bit for bit. dK and dV are summed by the block that owns the key tile,
// so the backward needs no atomics and is deterministic.

#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kRows = 64;      // rows a block owns (one warpgroup of 128 threads)
constexpr int kCW = 64;        // channels a slice
constexpr int kThreads = 128;
constexpr int kFwdTile = 64;   // keys a forward tile
constexpr int kBwdTile = 32;   // queries (dK / dV) or keys (dQ) a backward tile
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Float offset of (row r, channel c) in a raw tile of ROWS rows: chunk
// c / 32 of [ROWS][32], 16-byte group (c % 32) / 4 of row r at (c % 32) / 4 ^ r % 8.
template <int ROWS>
__device__ __forceinline__ int raw_at(int r, int c) {
  return (c >> 5) * ROWS * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Float offset of (row r, channel c) in a transposed tile [kCW][ROWS]: row
// c holds the ROWS rows, r at position p (r permuted inside its group of
// 8), chunks of 32 positions, swizzled as a raw tile.
template <int ROWS>
__device__ __forceinline__ int trans_at(int r, int c) {
  const int p = (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
  return (p >> 5) * kCW * 32 + c * 32 + ((((p & 31) >> 2) ^ (c & 7)) << 2) + (p & 3);
}

// Copy channels [c0, c0 + 64) of ROWS rows (row r at src + r * stride) into
// a raw tile; rows >= valid and channels >= D are zero (their copies read
// nothing but name `safe`, a mapped address). One commit group.
template <int ROWS>
__device__ __forceinline__ void load_raw(float* dst, const float* __restrict__ src, size_t stride,
                                         int valid, int c0, int D, bool vec, const float* safe) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < ROWS * (kCW / 4) / kThreads; ++k) {
      const int i = (threadIdx.x & (kThreads - 1)) + k * kThreads, r = i >> 4, c = (i & 15) << 2;
      const bool ok = r < valid && c0 + c < D;
      hopper::cp_async16(dst + raw_at<ROWS>(r, c), ok ? src + r * stride + c0 + c : safe, ok);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < ROWS * kCW / kThreads; ++k) {
      const int i = (threadIdx.x & (kThreads - 1)) + k * kThreads, r = i >> 6, c = i & 63;
      const bool ok = r < valid && c0 + c < D;
      hopper::cp_async4(dst + raw_at<ROWS>(r, c), ok ? src + r * stride + c0 + c : safe, ok);
    }
  }
  hopper::cp_async_commit();
}

template <int ROWS>
__device__ __forceinline__ void load_raw(float* dst, const float* __restrict__ src, size_t stride,
                                         int valid, int c0, int D, bool vec) {
  load_raw<ROWS>(dst, src, stride, valid, c0, D, vec, src);
}

// lo = raw - tf32(raw), element by element (the same layout).
template <int ROWS>
__device__ __forceinline__ void split_lo(float* lo, const float* raw) {
#pragma unroll
  for (int k = 0; k < ROWS * kCW / 4 / kThreads; ++k) {
    const int i = (threadIdx.x & (kThreads - 1)) + k * kThreads;
    float4 x = reinterpret_cast<const float4*>(raw)[i];
    x.x = hopper::tf32_lo(x.x);
    x.y = hopper::tf32_lo(x.y);
    x.z = hopper::tf32_lo(x.z);
    x.w = hopper::tf32_lo(x.w);
    reinterpret_cast<float4*>(lo)[i] = x;
  }
}

// The transposed tiles (hi = the value, lo) of a raw tile. An item is the
// rows of one parity in a group of 8 (8a + e, + 2, + 4, + 6) by 4 channels
// 4c4 ..., whose permuted positions 8a + 4e .. + 3 are consecutive: 4
// float4 reads, a 4 x 4 transpose in registers, a float4 each of hi and lo
// a channel. Item i's bits: a's low bit, e, c4's bit 1, a's other bits, c4's
// bits 0, 2, 3; a search over such maps found this one to take 8 shared-
// memory wavefronts a warp-wide float4 access, twice the least (32 for
// the reads of the plain order), and no map to reach the least.
template <int ROWS>
__device__ __forceinline__ void split_trans(float* hi, float* lo, const float* raw) {
  constexpr int kGroups = ROWS / 8, kItems = kGroups * 2 * (kCW / 4);
  constexpr int kShift = 2 + (kGroups == 8 ? 3 : kGroups == 4 ? 2 : 1);  // 2 + log2(kGroups)
#pragma unroll
  for (int k = 0; k < kItems / kThreads; ++k) {
    const int i = (threadIdx.x & (kThreads - 1)) + k * kThreads, rest = i >> kShift;
    const int a = (i & 1) | (((i >> 3) & (kGroups / 2 - 1)) << 1), e = (i >> 1) & 1;
    const int c = ((rest & 1) | (((i >> 2) & 1) << 1) | ((rest >> 1) << 2)) << 2;
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = *reinterpret_cast<const float4*>(raw + raw_at<ROWS>(8 * a + e + 2 * u, c));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 y = j == 0   ? make_float4(x[0].x, x[1].x, x[2].x, x[3].x)
                       : j == 1 ? make_float4(x[0].y, x[1].y, x[2].y, x[3].y)
                       : j == 2 ? make_float4(x[0].z, x[1].z, x[2].z, x[3].z)
                                : make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
      const int at = trans_at<ROWS>(8 * a + e, c + j);
      *reinterpret_cast<float4*>(hi + at) = y;
      *reinterpret_cast<float4*>(lo + at) =
          make_float4(hopper::tf32_lo(y.x), hopper::tf32_lo(y.y), hopper::tf32_lo(y.z),
                      hopper::tf32_lo(y.w));
    }
  }
}

// The A fragments of an accumulator [64][8 KS] (P or dS) for a product over
// its columns against a transposed tile: k-step j takes columns 8j + 2t
// and 8j + 2t + 1 (the tile's positions t and t + 4).
template <int KS>
__device__ __forceinline__ void acc_frags(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4],
                                          const float (&acc)[4 * KS]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const float x[4] = {acc[4 * j], acc[4 * j + 2], acc[4 * j + 1], acc[4 * j + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[j][i] = __float_as_uint(x[i]);
      lo[j][i] = __float_as_uint(hopper::tf32_lo(x[i]));
    }
  }
}

struct NoOp {
  __device__ __forceinline__ void operator()() const {}
};

// d[64 x N] += A . B in 3xTF32 over KS k-steps: A in registers (hi, lo), B
// a raw or transposed tile (hi) and its lo tile, chunks `chunk` bytes
// apart. then() runs once the wgmmas are issued; returns with them complete.
template <int N, int KS, typename Then = NoOp>
__device__ __forceinline__ void mma3(float (&d)[N / 2], uint32_t (&hi)[KS][4],
                                     uint32_t (&lo)[KS][4], const float* b_hi, const float* b_lo,
                                     int chunk, Then then = {}) {
  const uint32_t bh = hopper::smem_u32(b_hi), bl = hopper::smem_u32(b_lo);
  hopper::fence_regs(d);
  hopper::wg_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t off = (s >> 2) * chunk + (s & 3) * 32;
    if constexpr (N == 64) {
      hopper::wgmma_m64n64k8_tf32(d, hi[s], hopper::desc_b128(bh + off));
      hopper::wgmma_m64n64k8_tf32(d, hi[s], hopper::desc_b128(bl + off));
      hopper::wgmma_m64n64k8_tf32(d, lo[s], hopper::desc_b128(bh + off));
    } else {
      hopper::wgmma_m64n32k8_tf32(d, hi[s], hopper::desc_b128(bh + off));
      hopper::wgmma_m64n32k8_tf32(d, hi[s], hopper::desc_b128(bl + off));
      hopper::wgmma_m64n32k8_tf32(d, lo[s], hopper::desc_b128(bh + off));
    }
  }
  hopper::wg_commit();
  then();
  hopper::wg_wait<0>();
  hopper::fence_regs(d);
  hopper::fence_regs(hi);
  hopper::fence_regs(lo);
}

// d[64 x N] += A . B in 3xTF32, A the 64 channels of a raw [64][64] tile
// (rows 16w + g (+ 8), channels 8s + t (+ 4) for k-step s), every k-step
// read and split before the wgmmas; B a raw tile of N rows and its lo
// tile. hi and lo are scratch. then() runs once the wgmmas are issued;
// returns with them complete.
template <int N, typename Then = NoOp>
__device__ __forceinline__ void mma3_raw(float (&d)[N / 2], uint32_t (&hi)[8][4],
                                         uint32_t (&lo)[8][4], const float* a_raw,
                                         const float* b_hi, const float* b_lo, int w, int g, int t,
                                         Then then = {}) {
  const uint32_t bh = hopper::smem_u32(b_hi), bl = hopper::smem_u32(b_lo);
  const int r0 = 16 * w + g;
  hopper::fence_regs(d);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float x[4] = {a_raw[raw_at<kRows>(r0, 8 * s + t)],
                        a_raw[raw_at<kRows>(r0 + 8, 8 * s + t)],
                        a_raw[raw_at<kRows>(r0, 8 * s + t + 4)],
                        a_raw[raw_at<kRows>(r0 + 8, 8 * s + t + 4)]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[s][i] = __float_as_uint(x[i]);
      lo[s][i] = __float_as_uint(hopper::tf32_lo(x[i]));
    }
  }
  hopper::wg_fence();  // the fragments before the wgmmas that read them
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t off = (s >> 2) * N * 128 + (s & 3) * 32;
    if constexpr (N == 64) {
      hopper::wgmma_m64n64k8_tf32(d, hi[s], hopper::desc_b128(bh + off));
      hopper::wgmma_m64n64k8_tf32(d, hi[s], hopper::desc_b128(bl + off));
      hopper::wgmma_m64n64k8_tf32(d, lo[s], hopper::desc_b128(bh + off));
    } else {
      hopper::wgmma_m64n32k8_tf32(d, hi[s], hopper::desc_b128(bh + off));
      hopper::wgmma_m64n32k8_tf32(d, hi[s], hopper::desc_b128(bl + off));
      hopper::wgmma_m64n32k8_tf32(d, lo[s], hopper::desc_b128(bh + off));
    }
  }
  hopper::wg_commit();
  then();
  hopper::wg_wait<0>();
  hopper::fence_regs(d);
  hopper::fence_regs(hi);
  hopper::fence_regs(lo);
}

__device__ __forceinline__ bool key_valid(const uint8_t* __restrict__ mask, int b, int M, int c) {
  return c < M && (mask == nullptr || mask[static_cast<size_t>(b) * M + c] != 0);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store acc * mul[row] (an accumulator [64][64]) to out's rows r < rows of
// the block and channels c0 + c < D.
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[32],
                                          const float (&mul)[2], int rows, size_t stride, int c0,
                                          int D, int w, int g, int t) {
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    const int r = 16 * w + g + 8 * v1;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        const int c = c0 + 8 * j + 2 * t + v0;
        if (c < D) out[r * stride + c] = acc[4 * j + v0 + 2 * v1] * mul[v1];
      }
  }
}

// The online softmax of a score tile in base 2, rows g (v1 = 0) and g + 8:
// masked keys -inf, the running max and this thread's part of the running
// sum updated, the weights left in sc, alpha = the old accumulator's rescale.
template <int T>
__device__ __forceinline__ void online_softmax(float (&sc)[T / 2], const bool (&valid)[T / 8][2],
                                               float sl2, float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        float& x = sc[4 * j + v0 + 2 * v1];
        x = valid[j][v0] ? x * sl2 : -CUDART_INF_F;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m_run[v1], quad_max(mx));
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no valid key yet: weights 0
    alpha[v1] = exp2f(m_run[v1] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        float& x = sc[4 * j + v0 + 2 * v1];
        x = exp2f(x - m_use);
        sum += x;
      }
    l_run[v1] = l_run[v1] * alpha[v1] + sum;  // this thread's columns; the quad's sum at the end
    m_run[v1] = m_new;
  }
}

// The forward's epilogue: o = acc / l (0 without a valid key) for rows
// n0 + r < n0 + nq and the block's channel slice os; lse (natural base;
// +inf without a valid key) from slice 0.
__device__ __forceinline__ void finish_forward(float* __restrict__ o, float* __restrict__ lse,
                                               const float (&acc)[32], const float (&m_run)[2],
                                               float (&l_run)[2], int b, int n0, int nq, int N,
                                               int H, int D, int h, int os, size_t stride, int w,
                                               int g, int t) {
  float inv[2];
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    l_run[v1] = quad_sum(l_run[v1]);
    inv[v1] = l_run[v1] > 0.f ? 1.f / l_run[v1] : 0.f;
  }
  store_acc(o + (static_cast<size_t>(b) * N + n0) * stride + h * D, acc, inv, nq, stride, os * kCW,
            D, w, g, t);
  if (os == 0 && t == 0) {
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      const int r = 16 * w + g + 8 * v1;
      if (r < nq)
        lse[(static_cast<size_t>(b) * N + n0 + r) * H + h] =
            l_run[v1] > 0.f ? m_run[v1] * kLn2 + logf(l_run[v1]) : CUDART_INF_F;
    }
  }
}

// This thread's key columns c0 + 8j + 2t (+ 1) of a score tile: valid?
template <int T>
__device__ __forceinline__ void column_valid(bool (&valid)[T / 8][2],
                                             const uint8_t* __restrict__ mask, int b, int M, int c0,
                                             int t) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) valid[j][v0] = key_valid(mask, b, M, c0 + 8 * j + 2 * t + v0);
}

// lse (base 2) and di of this thread's query columns n0 + 8j + 2t (+ 1) of
// a transposed score tile: +inf and 0 past N (weight 0).
template <int T>
__device__ __forceinline__ void column_stats(float (&lse_c)[T / 8][2], float (&di_c)[T / 8][2],
                                             const float* __restrict__ lse,
                                             const float* __restrict__ di, int b, int n0, int N,
                                             int H, int h, int t) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) {
      const int n = n0 + 8 * j + 2 * t + v0;
      const size_t at = (static_cast<size_t>(b) * N + n) * H + h;
      lse_c[j][v0] = n < N ? lse[at] * kLog2e : CUDART_INF_F;
      di_c[j][v0] = n < N ? di[at] : 0.f;
    }
}

// lse (base 2) and di of this thread's query rows n0 + 16w + g (+ 8).
__device__ __forceinline__ void row_stats(float (&lse_r)[2], float (&di_r)[2],
                                          const float* __restrict__ lse,
                                          const float* __restrict__ di, int b, int n0, int N, int H,
                                          int h, int w, int g) {
#pragma unroll
  for (int v1 = 0; v1 < 2; ++v1) {
    const int n = n0 + 16 * w + g + 8 * v1;
    const size_t at = (static_cast<size_t>(b) * N + n) * H + h;
    lse_r[v1] = n < N ? lse[at] * kLog2e : CUDART_INF_F;
    di_r[v1] = n < N ? di[at] : 0.f;
  }
}

// dK / dV: p^T = exp(s^T * scale - lse) on valid keys (rows) into st,
// ds^T = p^T (dp^T - di) into dpt.
template <int T>
__device__ __forceinline__ void dkv_weights(float (&st)[T / 2], float (&dpt)[T / 2],
                                            const bool (&kvalid)[2], const float (&lse_c)[T / 8][2],
                                            const float (&di_c)[T / 8][2], float sl2) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        const int i = 4 * j + v0 + 2 * v1;
        const float p = kvalid[v1] ? exp2f(fmaf(st[i], sl2, -lse_c[j][v0])) : 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - di_c[j][v0]);
      }
}

// dQ: ds = p (dp - di) into dp, p = exp(s * scale - lse) on valid keys (columns).
template <int T>
__device__ __forceinline__ void dq_weights(const float (&sc)[T / 2], float (&dp)[T / 2],
                                           const bool (&valid)[T / 8][2], const float (&lse_r)[2],
                                           const float (&di_r)[2], float sl2) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        const int i = 4 * j + v0 + 2 * v1;
        const float p = valid[j][v0] ? exp2f(fmaf(sc[i], sl2, -lse_r[v1])) : 0.f;
        dp[i] = p * (dp[i] - di_r[v1]);
      }
}

__device__ __forceinline__ float* align1024(unsigned char* p) {
  return reinterpret_cast<float*>(p + ((1024 - hopper::smem_u32(p) % 1024) % 1024));
}

// --- Heads above 64 channels: a block is one warpgroup (128 threads) that
// owns 64 rows and one 64-channel slice of the output; the score tiles sum
// the head's slices in turn, staged one at a time, and the block splits
// what it loaded between barriers. Shared memory: forward (key tiles of
// 64) q raw 16 KB, k raw + lo 32, v raw 16, v^T hi + lo 32: 96 KB; dK / dV
// (query tiles of 32) k and v raw 32, q and do raw + lo 32, q^T and do^T hi
// + lo 32: 96 KB; dQ (key tiles of 32) q and do raw 32, k and v raw + lo
// 32, k^T hi + lo 16: 80 KB; two blocks an SM.

// Forward: grid (ceil(N / 64), H x ns, B); one block per 64-query tile of
// (b, h) and 64-channel slice `os` of o.
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const uint8_t* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse, int N,
          int M, int H, int D, float scale) {
  constexpr int T = kFwdTile;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);  // [64][64] raw
  float* ks = qs + kRows * kCW;     // [T][64] raw (the hi part)
  float* kl = ks + T * kCW;         // its lo part
  float* vs = kl + T * kCW;         // [T][64] raw
  float* vth = vs + T * kCW;        // [64][T] transposed, hi
  float* vtl = vth + kCW * T;       //                     lo
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int ns = (D + kCW - 1) / kCW, h = blockIdx.y / ns, os = blockIdx.y % ns;
  const int b = blockIdx.z, n0 = blockIdx.x * kRows, nq = min(kRows, N - n0);
  const size_t stride = static_cast<size_t>(H) * D;
  const bool vec = (D & 3) == 0;
  const float* qb = q + (static_cast<size_t>(b) * N + n0) * stride + h * D;
  const float* kb = k + static_cast<size_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<size_t>(b) * M * stride + h * D;
  const int tiles = (M + T - 1) / T;
  const float sl2 = scale * kLog2e;  // the softmax runs in base 2: exp(x) = exp2(x log2 e)

  load_raw<kRows>(qs, qb, stride, nq, 0, D, vec);
  if (tiles > 0) {  // else k and v may hold nothing to point at
    load_raw<T>(ks, kb, stride, M, 0, D, vec);
    load_raw<T>(vs, vb, stride, M, os * kCW, D, vec);
  }

  float acc[32], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  for (int it = 0; it < tiles; ++it) {
    const int c0 = it * T;
    bool valid[T / 8][2];
    column_valid<T>(valid, mask, b, M, c0, t);
    float s[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = 0.f;
    for (int c = 0; c < ns; ++c) {
      hopper::cp_async_wait_all();
      __syncthreads();  // slice c's tiles are in; the last readers of kl, vth and vtl are done
      split_lo<T>(kl, ks);
      if (c == ns - 1) split_trans<T>(vth, vtl, vs);
      hopper::fence_proxy_async();
      __syncthreads();
      if (c == ns - 1 && it + 1 < tiles)
        load_raw<T>(vs, vb + static_cast<size_t>(c0 + T) * stride, stride, M - c0 - T, os * kCW, D,
                    vec);
      // Slice c's partial scores in a fresh accumulator, added in fp32: a
      // chain over every slice piles up the tensor cores' truncation (2.4e-5
      // in o at D = 384).
      float sp[T / 2];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sp[i] = 0.f;
      mma3_raw<T>(sp, fh, fl, qs, ks, kl, w, g, t);
#pragma unroll
      for (int i = 0; i < T / 2; ++i) s[i] += sp[i];
      __syncthreads();  // every warp is done with qs, ks and kl
      const int cn = c + 1 < ns ? c + 1 : 0, cc = c + 1 < ns ? c0 : c0 + T;
      if (c + 1 < ns || it + 1 < tiles) {  // the next slice's tiles
        load_raw<kRows>(qs, qb, stride, nq, cn * kCW, D, vec);
        load_raw<T>(ks, kb + static_cast<size_t>(cc) * stride, stride, M - cc, cn * kCW, D, vec);
      }
    }
    float alpha[2];
    online_softmax<T>(s, valid, sl2, m_run, l_run, alpha);
    // The tile's P V into a fresh accumulator, added in fp32: the tensor
    // cores round their sums toward zero, which a chain over every key tile
    // would pile up (1.2e-5 at [7, 4096, 4096, 4, 64]).
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(fh, fl, s);
    mma3<64, T / 8>(part, fh, fl, vth, vtl, kCW * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
  }
  finish_forward(o, lse, acc, m_run, l_run, b, n0, nq, N, H, D, h, os, stride, w, g, t);
}


// dK and dV: grid (ceil(M / 64), H x ns, B); one block per 64-key tile of
// (b, h) and 64-channel slice `os` of dk and dv, looping over the query
// tiles. The score tiles here are transposed: rows are keys.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const uint8_t* __restrict__ mask, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk,
              float* __restrict__ dv, int N, int M, int H, int D, float scale) {
  constexpr int T = kBwdTile;
  extern __shared__ unsigned char smem_raw[];
  float* ks = align1024(smem_raw);  // [64][64] raw
  float* vs = ks + kRows * kCW;
  float* qs = vs + kRows * kCW;     // [T][64] raw and lo
  float* ql = qs + T * kCW;
  float* dos = ql + T * kCW;
  float* dol = dos + T * kCW;
  float* qth = dol + T * kCW;       // [64][T] transposed, hi and lo
  float* qtl = qth + kCW * T;
  float* doth = qtl + kCW * T;
  float* dotl = doth + kCW * T;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int ns = (D + kCW - 1) / kCW, h = blockIdx.y / ns, os = blockIdx.y % ns;
  const int b = blockIdx.z, m0 = blockIdx.x * kRows, nk = min(kRows, M - m0);
  const size_t stride = static_cast<size_t>(H) * D;
  const bool vec = (D & 3) == 0;
  const size_t koff = (static_cast<size_t>(b) * M + m0) * stride + h * D;
  const float* qb = q + static_cast<size_t>(b) * N * stride + h * D;
  const float* dob = dout + static_cast<size_t>(b) * N * stride + h * D;
  const int tiles = (N + T - 1) / T;
  const float sl2 = scale * kLog2e;
  const bool kvalid[2] = {key_valid(mask, b, M, m0 + 16 * w + g),
                          key_valid(mask, b, M, m0 + 16 * w + g + 8)};

  load_raw<kRows>(ks, k + koff, stride, nk, 0, D, vec);
  load_raw<kRows>(vs, v + koff, stride, nk, 0, D, vec);
  if (tiles > 0) {  // else q and do may hold nothing to point at
    load_raw<T>(qs, qb, stride, N, 0, D, vec);
    load_raw<T>(dos, dob, stride, N, 0, D, vec);
  }

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  for (int it = 0; it < tiles; ++it) {
    const int n0 = it * T;
    float lse_c[T / 8][2], di_c[T / 8][2];
    column_stats<T>(lse_c, di_c, lse, di, b, n0, N, H, h, t);
    float st[T / 2], dpt[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) st[i] = dpt[i] = 0.f;
    for (int c = 0; c < ns; ++c) {
      hopper::cp_async_wait_all();
      __syncthreads();  // slice c's tiles are in; the lo and transposed tiles' readers are done
      split_lo<T>(ql, qs);
      split_lo<T>(dol, dos);
      if (c == os) {
        split_trans<T>(qth, qtl, qs);
        split_trans<T>(doth, dotl, dos);
      }
      hopper::fence_proxy_async();
      __syncthreads();
      // Slice c's partial S^T and dP^T, each in a fresh accumulator added
      // in fp32, as in the forward (C22: a chain over every slice read
      // 5.0e-5 of the gradients' max from float64 at D = 1024).
      float sp[T / 2], dpp[T / 2];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sp[i] = dpp[i] = 0.f;
      mma3_raw<T>(sp, fh, fl, ks, qs, ql, w, g, t);
      mma3_raw<T>(dpp, fh, fl, vs, dos, dol, w, g, t);
#pragma unroll
      for (int i = 0; i < T / 2; ++i) st[i] += sp[i], dpt[i] += dpp[i];
      __syncthreads();  // every warp is done with ks, vs, qs, ql, dos and dol
      const int cn = c + 1 < ns ? c + 1 : 0, nn = c + 1 < ns ? n0 : n0 + T;
      if (c + 1 < ns || it + 1 < tiles) {  // the next slice's tiles
        load_raw<kRows>(ks, k + koff, stride, nk, cn * kCW, D, vec);
        load_raw<kRows>(vs, v + koff, stride, nk, cn * kCW, D, vec);
        load_raw<T>(qs, qb + static_cast<size_t>(nn) * stride, stride, N - nn, cn * kCW, D, vec);
        load_raw<T>(dos, dob + static_cast<size_t>(nn) * stride, stride, N - nn, cn * kCW, D, vec);
      }
    }
    dkv_weights<T>(st, dpt, kvalid, lse_c, di_c, sl2);
    // Each tile's products into a fresh accumulator, added in fp32 (see the forward).
    uint32_t ph[T / 8][4], pl[T / 8][4];
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(ph, pl, st);
    mma3<64, T / 8>(part, ph, pl, doth, dotl, kCW * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[i] += part[i];
      part[i] = 0.f;
    }
    acc_frags<T / 8>(ph, pl, dpt);
    mma3<64, T / 8>(part, ph, pl, qth, qtl, kCW * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[i] += part[i];
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_acc(dv + koff, acc_v, one, nk, stride, os * kCW, D, w, g, t);
  store_acc(dk + koff, acc_k, sc, nk, stride, os * kCW, D, w, g, t);
}

// dQ: grid (ceil(N / 64), H x ns, B); one block per 64-query tile of (b,
// h) and 64-channel slice `os` of dq, looping over the key tiles.
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const uint8_t* __restrict__ mask, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq,
             int N, int M, int H, int D, float scale) {
  constexpr int T = kBwdTile;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);  // [64][64] raw
  float* dos = qs + kRows * kCW;
  float* ks = dos + kRows * kCW;    // [T][64] raw and lo
  float* kl = ks + T * kCW;
  float* vs = kl + T * kCW;
  float* vl = vs + T * kCW;
  float* kth = vl + T * kCW;        // [64][T] transposed, hi and lo
  float* ktl = kth + kCW * T;
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int ns = (D + kCW - 1) / kCW, h = blockIdx.y / ns, os = blockIdx.y % ns;
  const int b = blockIdx.z, n0 = blockIdx.x * kRows, nq = min(kRows, N - n0);
  const size_t stride = static_cast<size_t>(H) * D;
  const bool vec = (D & 3) == 0;
  const size_t qoff = (static_cast<size_t>(b) * N + n0) * stride + h * D;
  const float* kb = k + static_cast<size_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<size_t>(b) * M * stride + h * D;
  const int tiles = (M + T - 1) / T;
  const float sl2 = scale * kLog2e;
  float lse_r[2], di_r[2];
  row_stats(lse_r, di_r, lse, di, b, n0, N, H, h, w, g);

  load_raw<kRows>(qs, q + qoff, stride, nq, 0, D, vec);
  load_raw<kRows>(dos, dout + qoff, stride, nq, 0, D, vec);
  if (tiles > 0) {  // else k and v may hold nothing to point at
    load_raw<T>(ks, kb, stride, M, 0, D, vec);
    load_raw<T>(vs, vb, stride, M, 0, D, vec);
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  for (int it = 0; it < tiles; ++it) {
    const int c0 = it * T;
    bool valid[T / 8][2];
    column_valid<T>(valid, mask, b, M, c0, t);
    float s[T / 2], dp[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < ns; ++c) {
      hopper::cp_async_wait_all();
      __syncthreads();  // slice c's tiles are in; the lo and transposed tiles' readers are done
      split_lo<T>(kl, ks);
      split_lo<T>(vl, vs);
      if (c == os) split_trans<T>(kth, ktl, ks);
      hopper::fence_proxy_async();
      __syncthreads();
      // Slice c's partial S and dP, each in a fresh accumulator added in
      // fp32 (C22, see dK / dV).
      float sp[T / 2], dpp[T / 2];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sp[i] = dpp[i] = 0.f;
      mma3_raw<T>(sp, fh, fl, qs, ks, kl, w, g, t);
      mma3_raw<T>(dpp, fh, fl, dos, vs, vl, w, g, t);
#pragma unroll
      for (int i = 0; i < T / 2; ++i) s[i] += sp[i], dp[i] += dpp[i];
      __syncthreads();  // every warp is done with qs, dos, ks, kl, vs and vl
      const int cn = c + 1 < ns ? c + 1 : 0, cc = c + 1 < ns ? c0 : c0 + T;
      if (c + 1 < ns || it + 1 < tiles) {  // the next slice's tiles
        load_raw<kRows>(qs, q + qoff, stride, nq, cn * kCW, D, vec);
        load_raw<kRows>(dos, dout + qoff, stride, nq, cn * kCW, D, vec);
        load_raw<T>(ks, kb + static_cast<size_t>(cc) * stride, stride, M - cc, cn * kCW, D, vec);
        load_raw<T>(vs, vb + static_cast<size_t>(cc) * stride, stride, M - cc, cn * kCW, D, vec);
      }
    }
    dq_weights<T>(s, dp, valid, lse_r, di_r, sl2);
    uint32_t dh[T / 8][4], dl[T / 8][4];
    float part[32];  // a fresh accumulator, added in fp32 (see the forward)
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(dh, dl, dp);
    mma3<64, T / 8>(part, dh, dl, kth, ktl, kCW * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  const float sc[2] = {scale, scale};
  store_acc(dq + qoff, acc, sc, nq, stride, os * kCW, D, w, g, t);
}

// --- Heads of up to 64 channels (one slice, D % 4 == 0): warp-specialised
// blocks.
//
// A block is three warpgroups: two consumers, each owning 64 rows as
// above, and a producer that stages the other side's tiles for both, in
// two stages. Once the consumers are done with a stage (its "empty"
// barrier), one producer thread has the TMA unit copy the tile two ahead
// into it (a 4-D tensor map over [B, rows, H, D]: boxes of 32 channels x T
// rows, swizzled as raw tiles, zeros past the tails and past D; completion
// on an mbarrier); the producer then splits it (lo parts, transposed
// tiles) and arrives on the stage's "full" barriers, one a consumer. A
// consumer waits for its own, runs its products and softmax, and arrives
// on "empty". So the splits run beside the products. In the forward the
// two consumers also take turns to issue their products, so that one's
// softmax runs while the other's products do (in dK / dV and dQ, whose
// products outweigh their other work, turns measured slower).
// setmaxnreg gives the consumers 208 registers and the producer 88. Shared
// memory, one block an SM:
//   forward (key tiles of 64):   q raw 32 KB, 2 stages of k raw + lo, v raw
//                                and v^T hi + lo 160: 192 KB
//   dK / dV (query tiles of 32): k and v raw 64 KB, 2 stages of q and do raw
//                                + lo and q^T, do^T hi + lo 128: 192 KB
//   dQ (key tiles of 32):        q and do raw 64 KB, 2 stages of k and v raw
//                                + lo and k^T hi + lo 96: 160 KB
// scripts/profile_flash_phases.py times these kernels' phases on the card
// (an instrumented copy; PERF.md has its numbers).

constexpr int kWsThreads = 384;
constexpr int kWsRows = 2 * kRows;  // rows a block owns
constexpr int kAlign = 1024;        // room to align the tiles
constexpr size_t kFwdWsSmem = (2 * kRows * kCW + 10 * kFwdTile * kCW) * sizeof(float) + kAlign;
constexpr size_t kDkvWsSmem = (4 * kRows * kCW + 16 * kBwdTile * kCW) * sizeof(float) + kAlign;
constexpr size_t kDqWsSmem = (4 * kRows * kCW + 12 * kBwdTile * kCW) * sizeof(float) + kAlign;
// setmaxnreg moves registers inside the block's own pool (168 a thread at
// launch, 384 x 168 in all): 2 x 208 + 88 = 3 x 168.
constexpr int kConsumerRegs = 208, kProducerRegs = 88;
// Named barriers: full[stage][consumer] (producer + one consumer, 256
// threads), empty[stage] (all 384), the producer's own (128), the
// consumers' (256).
__device__ __forceinline__ int bar_full(int s, int wg) { return 1 + 2 * s + wg; }
__device__ __forceinline__ int bar_empty(int s) { return 5 + s; }
constexpr int kBarProducer = 7, kBarConsumers = 8;
// Turns (9 + consumer, 256 threads): the consumers issue their products in
// turn, consumer 0 first, so that one's softmax runs while the other's
// products do. Before each product a consumer waits for its turn; once the
// product is issued it passes the turn (no branch between the wgmmas and
// their wait: ptxas would serialise them). turns_open gives consumer 0 its
// first turn, turns_close takes consumer 1's last pass: every wait meets
// one pass.
__device__ __forceinline__ int bar_turn(int wg) { return 9 + wg; }
__device__ __forceinline__ void turns_open(int wg) {
  if (wg == 1) hopper::bar_arrive(bar_turn(0), 256);
}
__device__ __forceinline__ void turn_wait(int wg) { hopper::bar_sync(bar_turn(wg), 256); }
__device__ __forceinline__ void turn_pass(int wg) { hopper::bar_arrive(bar_turn(wg ^ 1), 256); }
__device__ __forceinline__ void turns_close(int wg) {
  if (wg == 0) hopper::bar_sync(bar_turn(0), 256);
}

// The producer's two mbarriers, in the last 16 bytes of the block's shared
// memory: the tiles end at least 16 bytes before (the base is 16-byte
// aligned, so the alignment takes at most kAlign - 16).
__device__ __forceinline__ uint64_t* landed(unsigned char* smem, size_t bytes) {
  return reinterpret_cast<uint64_t*>(smem + bytes - 16);
}

// Thread 0 of the producer: the TMA copies of tile `it` (T rows of batch b,
// head h) of each map into the raw tiles at dst[i], on bar.
template <int T, int NM>
__device__ __forceinline__ void tma_tile(const CUtensorMap* const (&maps)[NM],
                                         float* const (&dst)[NM], int it, int h, int b,
                                         uint64_t* bar) {
  hopper::mbar_expect_tx(bar, NM * T * kCW * sizeof(float));
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int j = 0; j < kCW / 32; ++j)
      hopper::tma_load_4d(dst[i] + j * T * 32, maps[i], 32 * j, h, it * T, b, bar);
}

// The producer's side of a stage handover: its splits of stage s are
// written; tell both consumers.
__device__ __forceinline__ void stage_full(int s) {
  hopper::fence_proxy_async();
  hopper::bar_arrive(bar_full(s, 0), 256);
  hopper::bar_arrive(bar_full(s, 1), 256);
}

// The producer's loop: load(it) (thread 0) has the TMA unit copy tile it
// into stage it % 2, tiles 0 and 1 at once, tile it once the consumers are
// done with tile it - 2; split(it) writes the stage's lo and transposed
// tiles once the copies have landed.
template <typename Load, typename Split>
__device__ __forceinline__ void produce(int tiles, uint64_t* landed, Load load, Split split) {
  const bool lead = threadIdx.x == 2 * kThreads;
  if (lead) {
    hopper::mbar_init(landed, 1);
    hopper::mbar_init(landed + 1, 1);
    hopper::fence_mbar_init();
    if (tiles > 0) load(0);
    if (tiles > 1) load(1);
  }
  hopper::bar_sync(kBarProducer, 128);  // the mbarriers are initialised
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1;
    if (it >= 2) {
      hopper::bar_sync(bar_empty(s), kWsThreads);  // tile it - 2 is done
      if (lead) load(it);
    }
    hopper::mbar_wait(landed + s, (it >> 1) & 1);  // tile it's rows are in
    split(it);
    stage_full(s);
  }
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_ws(const float* __restrict__ q, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
             float* __restrict__ o, float* __restrict__ lse, int N, int M, int H, int D,
             float scale) {
  constexpr int T = kFwdTile, kStage = 5 * T * kCW;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);      // [2][64][64] raw, a consumer's rows each
  float* stages = qs + 2 * kRows * kCW;  // per stage: k raw [T][64], k lo, v raw, v^T hi, v^T lo
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (M + T - 1) / T;

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kProducerRegs>();
    // The maps' own addresses (in the kernel's parameters, where the TMA
    // unit reads them), not a lambda's copies.
    const CUtensorMap* const ma = &tk;
    const CUtensorMap* const mb = &tv;
    produce(
        tiles, landed(smem_raw, kFwdWsSmem),
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2] = {st, st + 2 * T * kCW};
          tma_tile<T>(maps, dst, it, h, b, landed(smem_raw, kFwdWsSmem) + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          split_lo<T>(st + T * kCW, st);
          split_trans<T>(st + 3 * T * kCW, st + 4 * T * kCW, st + 2 * T * kCW);
        });
    return;
  }

  // A consumer: 64 queries.
  hopper::regs_alloc<kConsumerRegs>();
  const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int n0 = blockIdx.x * kWsRows + wg * kRows, nq = min(kRows, N - n0);
  const float sl2 = scale * kLog2e;
  float* qw = qs + wg * kRows * kCW;
  load_raw<kRows>(qw, q + (static_cast<size_t>(b) * N + n0) * stride + h * D, stride, nq, 0, D,
                  true, q);
  hopper::cp_async_wait_all();
  hopper::bar_sync(kBarConsumers, 256);

  float acc[32], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  turns_open(wg);
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, c0 = it * T;
    const float* st = stages + s * kStage;
    bool valid[T / 8][2];
    column_valid<T>(valid, mask, b, M, c0, t);
    float sc[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) sc[i] = 0.f;
    hopper::bar_sync(bar_full(s, wg), 256);
    turn_wait(wg);
    mma3_raw<T>(sc, fh, fl, qw, st, st + T * kCW, w, g, t, [=] { turn_pass(wg); });
    float alpha[2];
    online_softmax<T>(sc, valid, sl2, m_run, l_run, alpha);
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(fh, fl, sc);
    turn_wait(wg);
    mma3<64, T / 8>(part, fh, fl, st + 3 * T * kCW, st + 4 * T * kCW, kCW * 128,
                    [=] { turn_pass(wg); });
    if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
  }
  turns_close(wg);
  finish_forward(o, lse, acc, m_run, l_run, b, n0, nq, N, H, D, h, 0, stride, w, g, t);
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_ws(const __grid_constant__ CUtensorMap tq, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                 const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
                 int N, int M, int H, int D, float scale) {
  constexpr int T = kBwdTile, kStage = 8 * T * kCW;
  extern __shared__ unsigned char smem_raw[];
  float* ks = align1024(smem_raw);      // [2][64][64] raw k, a consumer's rows each
  float* vs = ks + 2 * kRows * kCW;     //                 v
  float* stages = vs + 2 * kRows * kCW;  // per stage: q raw [T][64], q lo, do raw, do lo,
                                         // q^T hi [64][T], q^T lo, do^T hi, do^T lo
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (N + T - 1) / T;

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kProducerRegs>();
    // The maps' own addresses (in the kernel's parameters, where the TMA
    // unit reads them), not a lambda's copies.
    const CUtensorMap* const ma = &tq;
    const CUtensorMap* const mb = &tdo;
    produce(
        tiles, landed(smem_raw, kDkvWsSmem),
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2] = {st, st + 2 * T * kCW};
          tma_tile<T>(maps, dst, it, h, b, landed(smem_raw, kDkvWsSmem) + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          split_lo<T>(st + T * kCW, st);
          split_lo<T>(st + 3 * T * kCW, st + 2 * T * kCW);
          split_trans<T>(st + 4 * T * kCW, st + 5 * T * kCW, st);
          split_trans<T>(st + 6 * T * kCW, st + 7 * T * kCW, st + 2 * T * kCW);
        });
    return;
  }

  // A consumer: 64 keys.
  hopper::regs_alloc<kConsumerRegs>();
  const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int m0 = blockIdx.x * kWsRows + wg * kRows, nk = min(kRows, M - m0);
  const size_t koff = (static_cast<size_t>(b) * M + m0) * stride + h * D;
  const float sl2 = scale * kLog2e;
  const bool kvalid[2] = {key_valid(mask, b, M, m0 + 16 * w + g),
                          key_valid(mask, b, M, m0 + 16 * w + g + 8)};
  float* kw = ks + wg * kRows * kCW;
  float* vw = vs + wg * kRows * kCW;
  load_raw<kRows>(kw, k + koff, stride, nk, 0, D, true, k);
  load_raw<kRows>(vw, v + koff, stride, nk, 0, D, true, v);
  hopper::cp_async_wait_all();
  hopper::bar_sync(kBarConsumers, 256);

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1;
    const float* st = stages + s * kStage;
    float lse_c[T / 8][2], di_c[T / 8][2];
    column_stats<T>(lse_c, di_c, lse, di, b, it * T, N, H, h, t);
    float sst[T / 2], dpt[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) sst[i] = dpt[i] = 0.f;
    hopper::bar_sync(bar_full(s, wg), 256);
    mma3_raw<T>(sst, fh, fl, kw, st, st + T * kCW, w, g, t);
    mma3_raw<T>(dpt, fh, fl, vw, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);
    dkv_weights<T>(sst, dpt, kvalid, lse_c, di_c, sl2);
    uint32_t ph[T / 8][4], pl[T / 8][4];
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(ph, pl, sst);
    mma3<64, T / 8>(part, ph, pl, st + 6 * T * kCW, st + 7 * T * kCW, kCW * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[i] += part[i];
      part[i] = 0.f;
    }
    acc_frags<T / 8>(ph, pl, dpt);
    mma3<64, T / 8>(part, ph, pl, st + 4 * T * kCW, st + 5 * T * kCW, kCW * 128);
    if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[i] += part[i];
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_acc(dv + koff, acc_v, one, nk, stride, 0, D, w, g, t);
  store_acc(dk + koff, acc_k, sc, nk, stride, 0, D, w, g, t);
}

__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_ws(const float* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, float* __restrict__ dq, int N, int M, int H, int D,
                float scale) {
  constexpr int T = kBwdTile, kStage = 6 * T * kCW;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);      // [2][64][64] raw q, a consumer's rows each
  float* dos = qs + 2 * kRows * kCW;    //                 do
  float* stages = dos + 2 * kRows * kCW;  // per stage: k raw [T][64], k lo, v raw, v lo,
                                          // k^T hi [64][T], k^T lo
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (M + T - 1) / T;

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kProducerRegs>();
    // The maps' own addresses (in the kernel's parameters, where the TMA
    // unit reads them), not a lambda's copies.
    const CUtensorMap* const ma = &tk;
    const CUtensorMap* const mb = &tv;
    produce(
        tiles, landed(smem_raw, kDqWsSmem),
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2] = {st, st + 2 * T * kCW};
          tma_tile<T>(maps, dst, it, h, b, landed(smem_raw, kDqWsSmem) + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          split_lo<T>(st + T * kCW, st);
          split_lo<T>(st + 3 * T * kCW, st + 2 * T * kCW);
          split_trans<T>(st + 4 * T * kCW, st + 5 * T * kCW, st);
        });
    return;
  }

  // A consumer: 64 queries.
  hopper::regs_alloc<kConsumerRegs>();
  const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int n0 = blockIdx.x * kWsRows + wg * kRows, nq = min(kRows, N - n0);
  const size_t qoff = (static_cast<size_t>(b) * N + n0) * stride + h * D;
  const float sl2 = scale * kLog2e;
  float lse_r[2], di_r[2];
  row_stats(lse_r, di_r, lse, di, b, n0, N, H, h, w, g);
  float* qw = qs + wg * kRows * kCW;
  float* dow = dos + wg * kRows * kCW;
  load_raw<kRows>(qw, q + qoff, stride, nq, 0, D, true, q);
  load_raw<kRows>(dow, dout + qoff, stride, nq, 0, D, true, dout);
  hopper::cp_async_wait_all();
  hopper::bar_sync(kBarConsumers, 256);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t fh[8][4], fl[8][4];
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1, c0 = it * T;
    const float* st = stages + s * kStage;
    bool valid[T / 8][2];
    column_valid<T>(valid, mask, b, M, c0, t);
    float sc[T / 2], dp[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::bar_sync(bar_full(s, wg), 256);
    mma3_raw<T>(sc, fh, fl, qw, st, st + T * kCW, w, g, t);
    mma3_raw<T>(dp, fh, fl, dow, st + 2 * T * kCW, st + 3 * T * kCW, w, g, t);
    dq_weights<T>(sc, dp, valid, lse_r, di_r, sl2);
    uint32_t dh[T / 8][4], dl[T / 8][4];
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    acc_frags<T / 8>(dh, dl, dp);
    mma3<64, T / 8>(part, dh, dl, st + 4 * T * kCW, st + 5 * T * kCW, kCW * 128);
    if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  const float sc2[2] = {scale, scale};
  store_acc(dq + qoff, acc, sc2, nq, stride, 0, D, w, g, t);
}

// --- Heads of 65 to 128 channels and of 256 (D % 4 == 0, 16-byte aligned
// tensors): warp-specialised blocks that compute each score tile once.
//
// A block owns 64 rows and a window of 128 channels (two 64-channel
// slices); a head of 256 channels takes a cluster of two blocks, one a
// window. Three warpgroups: two consumers that share the block's rows,
// consumer c owning slice c (its own tile of the rows, its output channels),
// and a producer that stages the other side's tiles of both slices, two
// stages, as above (TMA tensor maps, lo and transposed tiles). A consumer
// computes the partial score tile over its slice (and the partial dP in the
// backward), puts it in shared memory and, once every slice's is in, adds
// the others: (its block's two) + (the other block's two), the same sum in
// every consumer bit for bit (fp32 addition commutes), so each holds the
// whole tile, takes the same softmax (or weights) and runs its products over
// its slice. Every score tile is computed once, a slice a consumer, and the
// products are the bound's: forward 2 (S, P V), backward 4 + 3 as above.
// The two blocks of a cluster add their own pairs first, then push the pair
// sum into each other's shared memory through the cluster's shared window
// (st.async, 8 KB a tile each way), counted in bytes on an mbarrier of the
// receiving block.
//
// The tf32 wgmma costs nearly the same at N = 16 and 32, so the score
// products read their B tiles as pair tiles (raw rows and lo rows side by
// side, `pair_at`): hi . [raw | lo] is one wgmma of 2N columns, lo . raw
// another, two a k-step instead of three. A tile's mask bytes or lse / di
// are loaded a tile ahead. Key tiles of 32 in the forward, query (dK / dV)
// and key (dQ) tiles of 16 in the backward, whose transposed tiles [64][16]
// take the 64-byte swizzle. Shared memory, one block an SM:
//   forward: q raw 32 KB, 2 stages of 2 slices of a k pair, v raw and v^T
//            hi + lo 160, partials and the pushed sums 32: 224 KB
//   dK / dV: k and v raw 64 KB, 2 stages of 2 slices of q and do pairs and
//            q^T, do^T hi + lo 128, partials and sums 32: 224 KB
//   dQ:      q and do raw 64 KB, 2 stages of 2 slices of k and v pairs and
//            k^T hi + lo 96, partials and sums 32: 192 KB
// scripts/profile_flash_phases.py times their phases too; PERF.md has the
// numbers.

constexpr int kWideFwdTile = 32, kWideBwdTile = 16;
constexpr int kWideCW = 2 * kCW;  // channels a block
constexpr int kWideBars = 32;     // mbarriers: landed[2], met[2]
constexpr size_t kFwdWideSmem =
    (2 * kRows * kCW + 20 * kWideFwdTile * kCW + 4 * kRows * kWideFwdTile) * sizeof(float) +
    kAlign + kWideBars;
constexpr size_t kDkvWideSmem =
    (4 * kRows * kCW + 32 * kWideBwdTile * kCW + 8 * kRows * kWideBwdTile) * sizeof(float) +
    kAlign + kWideBars;
constexpr size_t kDqWideSmem =
    (4 * kRows * kCW + 24 * kWideBwdTile * kCW + 8 * kRows * kWideBwdTile) * sizeof(float) +
    kAlign + kWideBars;
// setmaxnreg in dK / dV: 2 x 216 + 72 = 3 x 168 (its consumers hold dK, dV
// and a score tile's hi . [raw | lo] product at once, and spilled at 208;
// the forward and dQ keep 208 and 88: dQ spilled at 216 and 72).
constexpr int kWideConsumerRegs = 216, kWideProducerRegs = 72;
// Named barriers: full[stage] (the producer and both consumers, 384
// threads), empty[stage] and the consumers' (kBarConsumers) as above.
__device__ __forceinline__ int bar_wide_full(int s) { return 1 + s; }

// The mbarriers, in the last kWideBars bytes of the block's shared memory
// (see `landed`): landed[2] (the producer's TMA copies), met[2] (a cluster's
// partials, by tile parity).
__device__ __forceinline__ uint64_t* wide_bars(unsigned char* smem, size_t bytes) {
  return reinterpret_cast<uint64_t*>(smem + bytes - kWideBars);
}

// A pair tile: a raw tile [ROWS][64] and its lo part, interleaved by
// 32-channel chunk (chunk c's ROWS raw rows, then its ROWS lo rows, each
// swizzled as a raw tile), so that one wgmma of 2 x ROWS columns reads both
// as B. Float offset of (row r, channel c) of the raw part; the lo part's
// is ROWS x 32 further.
template <int ROWS>
__device__ __forceinline__ int pair_at(int r, int c) {
  return (c >> 5) * 2 * ROWS * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The lo part of a pair tile from its raw part (split_lo, chunk by chunk).
template <int ROWS>
__device__ __forceinline__ void split_lo_pair(float* pair) {
  constexpr int kChunk = ROWS * 32 / 4;  // float4s of one chunk's rows
#pragma unroll
  for (int k = 0; k < ROWS * kCW / 4 / kThreads; ++k) {
    const int i = (threadIdx.x & (kThreads - 1)) + k * kThreads;
    float4* x = reinterpret_cast<float4*>(pair) + (i / kChunk) * 2 * kChunk + i % kChunk;
    float4 y = *x;
    y.x = hopper::tf32_lo(y.x);
    y.y = hopper::tf32_lo(y.y);
    y.z = hopper::tf32_lo(y.z);
    y.w = hopper::tf32_lo(y.w);
    x[kChunk] = y;
  }
}

// Float offset of (row r, channel c) in a transposed tile [kCW][16] in the
// 64-byte swizzle: row c holds 16 positions (r at its position as in
// trans_at), 16-byte group j of the row at j ^ (c / 2) % 4.
__device__ __forceinline__ int trans16_at(int r, int c) {
  const int p = (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
  return c * 16 + ((((p >> 2) ^ (c >> 1)) & 3) << 2) + (p & 3);
}

// The wide kernels read a tile's mask bytes (key columns c0 + 8j + 2t (+ 1),
// 0 past M) and lse / di (query columns n0 + 8j + 2t (+ 1), +inf and 0 past
// N) a tile ahead, raw, and test or scale them where they are used: the
// loads then land during the tile before instead of stalling its start.
template <int T>
__device__ __forceinline__ void column_mask(uint8_t (&mk)[T / 8][2],
                                            const uint8_t* __restrict__ mask, int b, int M, int c0,
                                            int t) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) {
      const int c = c0 + 8 * j + 2 * t + v0;
      mk[j][v0] = c >= M ? 0 : mask == nullptr ? 1 : mask[static_cast<size_t>(b) * M + c];
    }
}

template <int T>
__device__ __forceinline__ void column_raw(float (&lse_c)[T / 8][2], float (&di_c)[T / 8][2],
                                           const float* __restrict__ lse,
                                           const float* __restrict__ di, int b, int n0, int N,
                                           int H, int h, int t) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) {
      const int n = n0 + 8 * j + 2 * t + v0;
      const size_t at = (static_cast<size_t>(b) * N + n) * H + h;
      lse_c[j][v0] = n < N ? lse[at] : CUDART_INF_F;
      di_c[j][v0] = n < N ? di[at] : 0.f;
    }
}

// split_trans for the raw part of a pair tile of 16 rows, into trans16_at tiles: thread i
// takes rows 8a + e + 4v and 8a + e + 4v + 2 (consecutive positions) by
// channels 4c4 .. + 3 (a, e, v bits 0, 1, 2 of i; c4 the rest).
__device__ __forceinline__ void split_trans16(float* hi, float* lo, const float* raw) {
  const int i = threadIdx.x & (kThreads - 1);
  const int r = 8 * (i & 1) + ((i >> 1) & 1) + 4 * ((i >> 2) & 1), c = (i >> 3) << 2;
  const float4 x0 = *reinterpret_cast<const float4*>(raw + pair_at<16>(r, c));
  const float4 x1 = *reinterpret_cast<const float4*>(raw + pair_at<16>(r + 2, c));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 y = j == 0   ? make_float2(x0.x, x1.x)
                     : j == 1 ? make_float2(x0.y, x1.y)
                     : j == 2 ? make_float2(x0.z, x1.z)
                              : make_float2(x0.w, x1.w);
    const int at = trans16_at(r, c + j);
    *reinterpret_cast<float2*>(hi + at) = y;
    *reinterpret_cast<float2*>(lo + at) = make_float2(hopper::tf32_lo(y.x), hopper::tf32_lo(y.y));
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_tf32: N is 16, 32 or 64");
  if constexpr (N == 64) {
    hopper::wgmma_m64n64k8_tf32(d, a, desc);
  } else if constexpr (N == 32) {
    hopper::wgmma_m64n32k8_tf32(d, a, desc);
  } else {
    hopper::wgmma_m64n16k8_tf32(d, a, desc);
  }
}

// d[64 x N] = A . B over one 64-channel slice in 3xTF32: A the block's raw
// [64][64] tile of the slice (fragments read and split as in mma3_raw; hi
// and lo are scratch), B a pair tile of N rows. A k-step takes two wgmmas:
// hi . [B raw | B lo] into e (2N columns: a wgmma costs nearly the same
// at N and 2N for N <= 32), lo . B raw into d; then d = (hi.lo + lo.hi) +
// hi.hi in fp32. Returns with the wgmmas complete.
template <int N>
__device__ __forceinline__ void slice_scores(float (&d)[N / 2], uint32_t (&hi)[8][4],
                                             uint32_t (&lo)[8][4], const float* a_raw,
                                             const float* b_pair, int w, int g, int t) {
  const uint32_t bp = hopper::smem_u32(b_pair);
  const int r0 = 16 * w + g;
  float e[N];
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  hopper::fence_regs(d);
  hopper::fence_regs(e);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float x[4] = {a_raw[raw_at<kRows>(r0, 8 * s + t)],
                        a_raw[raw_at<kRows>(r0 + 8, 8 * s + t)],
                        a_raw[raw_at<kRows>(r0, 8 * s + t + 4)],
                        a_raw[raw_at<kRows>(r0 + 8, 8 * s + t + 4)]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[s][i] = __float_as_uint(x[i]);
      lo[s][i] = __float_as_uint(hopper::tf32_lo(x[i]));
    }
  }
  hopper::wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint64_t desc = hopper::desc_b128(bp + (s >> 2) * 2 * N * 128 + (s & 3) * 32);
    wgmma_tf32<2 * N>(e, hi[s], desc);
    wgmma_tf32<N>(d, lo[s], desc);
  }
  hopper::wg_commit();
  hopper::wg_wait<0>();
  hopper::fence_regs(d);
  hopper::fence_regs(e);
  hopper::fence_regs(hi);
  hopper::fence_regs(lo);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[4 * j + i] = (e[4 * (j + N / 8) + i] + d[4 * j + i]) + e[4 * j + i];
}

// d[64 x 64] += A . B in 3xTF32 over T positions: A in registers (P or dS,
// from acc_frags), B a transposed tile [64][T] and its lo tile (the 128-byte
// swizzle, or the 64-byte one for T = 16). Returns with the wgmmas complete.
template <int T>
__device__ __forceinline__ void slice_product(float (&d)[32], uint32_t (&hi)[T / 8][4],
                                              uint32_t (&lo)[T / 8][4], const float* b_hi,
                                              const float* b_lo) {
  const uint32_t bh = hopper::smem_u32(b_hi), bl = hopper::smem_u32(b_lo);
  hopper::fence_regs(d);
  hopper::wg_fence();
#pragma unroll
  for (int s = 0; s < T / 8; ++s) {
    const uint32_t off = (s >> 2) * kCW * 128 + (s & 3) * 32;
    const uint64_t dh = T == 16 ? hopper::desc_b64(bh + off) : hopper::desc_b128(bh + off);
    const uint64_t dl = T == 16 ? hopper::desc_b64(bl + off) : hopper::desc_b128(bl + off);
    hopper::wgmma_m64n64k8_tf32(d, hi[s], dh);
    hopper::wgmma_m64n64k8_tf32(d, hi[s], dl);
    hopper::wgmma_m64n64k8_tf32(d, lo[s], dh);
  }
  hopper::wg_commit();
  hopper::wg_wait<0>();
  hopper::fence_regs(d);
  hopper::fence_regs(hi);
  hopper::fence_regs(lo);
}

// The partial score tiles of tile `it`. Consumer wg puts its NP fragments
// (NV values each) in its part of `parts` (value 4k + e of thread lt at
// float4 k x 128 + lt), and once both consumers have, adds the other's: x =
// own + other, the same in both. The next tile writes the parts again only
// after both consumers have passed its full barrier, so one part a
// consumer does. With CL = 2 each consumer then pushes half of its pair
// sum (float4s k of its half) into the other block's `recv[it % 2]` by
// st.async, whose bytes complete on that block's met[it % 2] (thread 0
// of each block arms its own with the kPart x 16 bytes it awaits), and x +=
// this block's recv once they are in: (the block's pair) + (the other
// block's pair), the same sum in both blocks. A block writes recv[it % 2]
// again two tiles on, after the other block's pushes of the tile between
// have landed, so after its reads.
template <int CL, int NP, int NV>
__device__ __forceinline__ void sum_partials(float (&x)[NP][NV], float* parts, float* recv,
                                             uint64_t* met, int it, int wg, int rank) {
  constexpr int kPart = NP * NV / 4 * kThreads;  // float4s of one consumer's partials
  const int lt = threadIdx.x & (kThreads - 1);
  float4* mine = reinterpret_cast<float4*>(parts) + wg * kPart;
  const float4* other = reinterpret_cast<const float4*>(parts) + (wg ^ 1) * kPart;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < NV / 4; ++k)
      mine[(p * NV / 4 + k) * kThreads + lt] =
          make_float4(x[p][4 * k], x[p][4 * k + 1], x[p][4 * k + 2], x[p][4 * k + 3]);
  hopper::bar_sync(kBarConsumers, 2 * kThreads);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < NV / 4; ++k) {
      const float4 y = other[(p * NV / 4 + k) * kThreads + lt];
      x[p][4 * k] += y.x;
      x[p][4 * k + 1] += y.y;
      x[p][4 * k + 2] += y.z;
      x[p][4 * k + 3] += y.w;
    }
  if constexpr (CL == 2) {
    static_assert(NV % 8 == 0, "sum_partials: each consumer pushes half of a thread's float4s");
    const float4* in = reinterpret_cast<const float4*>(recv) + (it & 1) * kPart;
    const uint32_t out = hopper::cluster_addr(in, rank ^ 1);
    uint64_t* bar = met + (it & 1);
    const uint32_t peer_bar = hopper::cluster_addr(bar, rank ^ 1);
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, kPart * sizeof(float4));
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < NV / 4; ++k)
        if (k / (NV / 8) == wg)  // a constant index into x: a runtime one puts x on the stack
          hopper::st_async4(out + ((p * NV / 4 + k) * kThreads + lt) * sizeof(float4),
                            make_float4(x[p][4 * k], x[p][4 * k + 1], x[p][4 * k + 2],
                                        x[p][4 * k + 3]),
                            peer_bar);
    hopper::mbar_wait(bar, (it >> 1) & 1);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < NV / 4; ++k) {
        const float4 y = in[(p * NV / 4 + k) * kThreads + lt];
        x[p][4 * k] += y.x;
        x[p][4 * k + 1] += y.y;
        x[p][4 * k + 2] += y.z;
        x[p][4 * k + 3] += y.w;
      }
  }
}

// Thread 0 initialises the mbarriers; with CL > 1 the cluster's blocks meet
// so that no block arrives on another's before it is initialised.
template <int CL>
__device__ __forceinline__ void wide_start(uint64_t* bars) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    hopper::mbar_init(bars + 1, 1);
    hopper::mbar_init(bars + 2, 1);  // thread 0's expect_tx; the bytes from the other block
    hopper::mbar_init(bars + 3, 1);
    hopper::fence_mbar_init();
  }
  if constexpr (CL > 1) {
    hopper::cluster_sync();
  } else {
    __syncthreads();
  }
}

// With CL > 1 no block leaves while another may still read its partials.
template <int CL>
__device__ __forceinline__ void wide_end() {
  if constexpr (CL > 1) hopper::cluster_sync();
}

// Thread 0 of the producer: the TMA copies of tile `it` (T rows of batch b,
// head h) of each map, the block's two slices, into dst[map][slice]: raw
// tiles, or the raw parts of pair tiles where pair[map] (32-channel chunks
// 2 x T rows apart).
template <int T, int NM>
__device__ __forceinline__ void tma_wide(const CUtensorMap* const (&maps)[NM],
                                         float* const (&dst)[NM][2], const bool (&pair)[NM],
                                         int rank, int it, int h, int b, uint64_t* bar) {
  hopper::mbar_expect_tx(bar, NM * 2 * T * kCW * sizeof(float));
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int j = 0; j < kCW / 32; ++j)
        hopper::tma_load_4d(dst[i][sl] + j * (pair[i] ? 2 : 1) * T * 32, maps[i],
                            rank * kWideCW + sl * kCW + 32 * j, h, it * T, b, bar);
}

// The producer's loop, as `produce` with one full barrier for both consumers.
template <typename Load, typename Split>
__device__ __forceinline__ void produce_wide(int tiles, uint64_t* landed, Load load, Split split) {
  const bool lead = threadIdx.x == 2 * kThreads;
  if (lead) {
    if (tiles > 0) load(0);
    if (tiles > 1) load(1);
  }
  for (int it = 0; it < tiles; ++it) {
    const int s = it & 1;
    if (it >= 2) {
      hopper::bar_sync(bar_empty(s), kWsThreads);  // tile it - 2 is done
      if (lead) load(it);
    }
    hopper::mbar_wait(landed + s, (it >> 1) & 1);  // tile it's rows are in
    split(it);
    hopper::fence_proxy_async();
    hopper::bar_arrive(bar_wide_full(s), kWsThreads);
  }
}

// Forward: grid (CL x ceil(N / 64), H, B), clusters of CL blocks (the
// head's windows) on one 64-query tile of (b, h).
template <int CL>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wide(const float* __restrict__ q, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
               float* __restrict__ o, float* __restrict__ lse, int N, int M, int H, int D,
               float scale) {
  constexpr int T = kWideFwdTile, kTile = T * kCW, kSlice = 5 * kTile, kStage = 2 * kSlice;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);       // [2][64][64] raw: the rows, a slice a consumer
  float* stages = qs + 2 * kRows * kCW;  // per stage and slice: k pair [T][64] x 2, v raw,
                                         // v^T hi [64][T], v^T lo
  float* parts = stages + 2 * kStage;    // the score partials (sum_partials): 2 x [64 x T]
  float* recv = parts + 2 * kRows * T;   // the other block's pair sums (CL = 2): 2 x [64 x T]
  uint64_t* bars = wide_bars(smem_raw, kFwdWideSmem);
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const int rank = blockIdx.x % CL, n0 = blockIdx.x / CL * kRows;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (M + T - 1) / T;
  wide_start<CL>(bars);

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kProducerRegs>();
    const CUtensorMap* const ma = &tk;  // the parameters' own addresses (see flash_fwd_ws)
    const CUtensorMap* const mb = &tv;
    produce_wide(
        tiles, bars,
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2][2] = {{st, st + kSlice}, {st + 2 * kTile, st + kSlice + 2 * kTile}};
          const bool pair[2] = {true, false};
          tma_wide<T>(maps, dst, pair, rank, it, h, b, bars + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            float* x = st + sl * kSlice;
            split_lo_pair<T>(x);
            split_trans<T>(x + 3 * kTile, x + 4 * kTile, x + 2 * kTile);
          }
        });
  } else {  // a consumer: the 64 queries, slice os of the head
    hopper::regs_alloc<kConsumerRegs>();
    const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3, os = rank * 2 + wg;
    const int nq = min(kRows, N - n0);
    const float sl2 = scale * kLog2e;
    float* qw = qs + wg * kRows * kCW;
    load_raw<kRows>(qw, q + (static_cast<size_t>(b) * N + n0) * stride + h * D, stride, nq,
                    os * kCW, D, true, q);
    hopper::cp_async_wait_all();
    hopper::bar_sync(kBarConsumers, 2 * kThreads);

    float acc[32], m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t fh[8][4], fl[8][4];
    uint8_t mk[T / 8][2];
    column_mask<T>(mk, mask, b, M, 0, t);
    for (int it = 0; it < tiles; ++it) {
      const int s = it & 1;
      const float* st = stages + s * kStage + wg * kSlice;
      bool valid[T / 8][2];
#pragma unroll
      for (int j = 0; j < T / 8; ++j) valid[j][0] = mk[j][0] != 0, valid[j][1] = mk[j][1] != 0;
      column_mask<T>(mk, mask, b, M, (it + 1) * T, t);  // the next tile's
      float sc[1][T / 2];
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sc[0][i] = 0.f;
      hopper::bar_sync(bar_wide_full(s), kWsThreads);
      slice_scores<T>(sc[0], fh, fl, qw, st, w, g, t);
      sum_partials<CL>(sc, parts, recv, bars + 2, it, wg, rank);
      float alpha[2];
      online_softmax<T>(sc[0], valid, sl2, m_run, l_run, alpha);
      float part[32];  // the tile's P V: a fresh accumulator, added in fp32
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      uint32_t ph[T / 8][4], pl[T / 8][4];
      acc_frags<T / 8>(ph, pl, sc[0]);
      slice_product<T>(part, ph, pl, st + 3 * kTile, st + 4 * kTile);
      if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
    }
    finish_forward(o, lse, acc, m_run, l_run, b, n0, nq, N, H, D, h, os, stride, w, g, t);
  }
  wide_end<CL>();
}

// dK and dV: grid (CL x ceil(M / 64), H, B); the clusters' blocks own a
// 64-key tile of (b, h), looping over the query tiles.
template <int CL>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_wide(const __grid_constant__ CUtensorMap tq, const float* __restrict__ k,
                   const float* __restrict__ v, const uint8_t* __restrict__ mask,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
                   int N, int M, int H, int D, float scale) {
  constexpr int T = kWideBwdTile, kTile = T * kCW, kSlice = 8 * kTile, kStage = 2 * kSlice;
  extern __shared__ unsigned char smem_raw[];
  float* ks = align1024(smem_raw);       // [2][64][64] raw k, a slice a consumer
  float* vs = ks + 2 * kRows * kCW;      //                 v
  float* stages = vs + 2 * kRows * kCW;  // per stage and slice: q pair [T][64] x 2, do pair,
                                         // q^T hi [64][T], q^T lo, do^T hi, do^T lo
  float* parts = stages + 2 * kStage;    // s and dp partials (sum_partials): 2 x 2 x [64 x T]
  float* recv = parts + 4 * kRows * T;   // the other block's pair sums (CL = 2): 2 x 2 x [64 x T]
  uint64_t* bars = wide_bars(smem_raw, kDkvWideSmem);
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const int rank = blockIdx.x % CL, m0 = blockIdx.x / CL * kRows;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (N + T - 1) / T;
  wide_start<CL>(bars);

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kWideProducerRegs>();
    const CUtensorMap* const ma = &tq;
    const CUtensorMap* const mb = &tdo;
    produce_wide(
        tiles, bars,
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2][2] = {{st, st + kSlice}, {st + 2 * kTile, st + kSlice + 2 * kTile}};
          const bool pair[2] = {true, true};
          tma_wide<T>(maps, dst, pair, rank, it, h, b, bars + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            float* x = st + sl * kSlice;
            split_lo_pair<T>(x);
            split_lo_pair<T>(x + 2 * kTile);
            split_trans16(x + 4 * kTile, x + 5 * kTile, x);
            split_trans16(x + 6 * kTile, x + 7 * kTile, x + 2 * kTile);
          }
        });
  } else {  // a consumer: the 64 keys, slice os of the head
    hopper::regs_alloc<kWideConsumerRegs>();
    const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3, os = rank * 2 + wg;
    const int nk = min(kRows, M - m0);
    const size_t koff = (static_cast<size_t>(b) * M + m0) * stride + h * D;
    const float sl2 = scale * kLog2e;
    const bool kvalid[2] = {key_valid(mask, b, M, m0 + 16 * w + g),
                            key_valid(mask, b, M, m0 + 16 * w + g + 8)};
    float* kw = ks + wg * kRows * kCW;
    float* vw = vs + wg * kRows * kCW;
    load_raw<kRows>(kw, k + koff, stride, nk, os * kCW, D, true, k);
    load_raw<kRows>(vw, v + koff, stride, nk, os * kCW, D, true, v);
    hopper::cp_async_wait_all();
    hopper::bar_sync(kBarConsumers, 2 * kThreads);

    float acc_k[32], acc_v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
    uint32_t fh[8][4], fl[8][4];
    float lse_n[T / 8][2], di_n[T / 8][2];
    column_raw<T>(lse_n, di_n, lse, di, b, 0, N, H, h, t);
    for (int it = 0; it < tiles; ++it) {
      const int s = it & 1;
      const float* st = stages + s * kStage + wg * kSlice;
      float lse_c[T / 8][2], di_c[T / 8][2];  // as column_stats
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int v0 = 0; v0 < 2; ++v0) {
          lse_c[j][v0] = lse_n[j][v0] * kLog2e;
          di_c[j][v0] = di_n[j][v0];
        }
      column_raw<T>(lse_n, di_n, lse, di, b, (it + 1) * T, N, H, h, t);  // the next tile's
      float sd[2][T / 2];  // s^T, dp^T
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sd[0][i] = sd[1][i] = 0.f;
      hopper::bar_sync(bar_wide_full(s), kWsThreads);
      slice_scores<T>(sd[0], fh, fl, kw, st, w, g, t);
      slice_scores<T>(sd[1], fh, fl, vw, st + 2 * kTile, w, g, t);
      sum_partials<CL>(sd, parts, recv, bars + 2, it, wg, rank);
      dkv_weights<T>(sd[0], sd[1], kvalid, lse_c, di_c, sl2);
      // Each tile's products into a fresh accumulator, added in fp32.
      uint32_t ph[T / 8][4], pl[T / 8][4];
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      acc_frags<T / 8>(ph, pl, sd[0]);
      slice_product<T>(part, ph, pl, st + 6 * kTile, st + 7 * kTile);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc_v[i] += part[i];
        part[i] = 0.f;
      }
      acc_frags<T / 8>(ph, pl, sd[1]);
      slice_product<T>(part, ph, pl, st + 4 * kTile, st + 5 * kTile);
      if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[i] += part[i];
    }
    const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
    store_acc(dv + koff, acc_v, one, nk, stride, os * kCW, D, w, g, t);
    store_acc(dk + koff, acc_k, sc, nk, stride, os * kCW, D, w, g, t);
  }
  wide_end<CL>();
}

// dQ: grid (CL x ceil(N / 64), H, B); the clusters' blocks own a 64-query
// tile of (b, h), looping over the key tiles.
template <int CL>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_wide(const float* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const uint8_t* __restrict__ mask,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dq, int N, int M, int H,
                  int D, float scale) {
  constexpr int T = kWideBwdTile, kTile = T * kCW, kSlice = 6 * kTile, kStage = 2 * kSlice;
  extern __shared__ unsigned char smem_raw[];
  float* qs = align1024(smem_raw);        // [2][64][64] raw q, a slice a consumer
  float* dos = qs + 2 * kRows * kCW;      //                 do
  float* stages = dos + 2 * kRows * kCW;  // per stage and slice: k pair [T][64] x 2, v pair,
                                          // k^T hi [64][T], k^T lo
  float* parts = stages + 2 * kStage;    // s and dp partials (sum_partials): 2 x 2 x [64 x T]
  float* recv = parts + 4 * kRows * T;   // the other block's pair sums (CL = 2): 2 x 2 x [64 x T]
  uint64_t* bars = wide_bars(smem_raw, kDqWideSmem);
  const int tid = threadIdx.x, wg = tid >> 7, h = blockIdx.y, b = blockIdx.z;
  const int rank = blockIdx.x % CL, n0 = blockIdx.x / CL * kRows;
  const size_t stride = static_cast<size_t>(H) * D;
  const int tiles = (M + T - 1) / T;
  wide_start<CL>(bars);

  if (wg == 2) {  // the producer
    hopper::regs_dealloc<kProducerRegs>();
    const CUtensorMap* const ma = &tk;
    const CUtensorMap* const mb = &tv;
    produce_wide(
        tiles, bars,
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
          const CUtensorMap* const maps[2] = {ma, mb};
          float* const dst[2][2] = {{st, st + kSlice}, {st + 2 * kTile, st + kSlice + 2 * kTile}};
          const bool pair[2] = {true, true};
          tma_wide<T>(maps, dst, pair, rank, it, h, b, bars + (it & 1));
        },
        [=](int it) {
          float* st = stages + (it & 1) * kStage;
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            float* x = st + sl * kSlice;
            split_lo_pair<T>(x);
            split_lo_pair<T>(x + 2 * kTile);
            split_trans16(x + 4 * kTile, x + 5 * kTile, x);
          }
        });
  } else {  // a consumer: the 64 queries, slice os of the head
    hopper::regs_alloc<kConsumerRegs>();
    const int w = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3, os = rank * 2 + wg;
    const int nq = min(kRows, N - n0);
    const size_t qoff = (static_cast<size_t>(b) * N + n0) * stride + h * D;
    const float sl2 = scale * kLog2e;
    float lse_r[2], di_r[2];
    row_stats(lse_r, di_r, lse, di, b, n0, N, H, h, w, g);
    float* qw = qs + wg * kRows * kCW;
    float* dow = dos + wg * kRows * kCW;
    load_raw<kRows>(qw, q + qoff, stride, nq, os * kCW, D, true, q);
    load_raw<kRows>(dow, dout + qoff, stride, nq, os * kCW, D, true, dout);
    hopper::cp_async_wait_all();
    hopper::bar_sync(kBarConsumers, 2 * kThreads);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t fh[8][4], fl[8][4];
    uint8_t mk[T / 8][2];
    column_mask<T>(mk, mask, b, M, 0, t);
    for (int it = 0; it < tiles; ++it) {
      const int s = it & 1;
      const float* st = stages + s * kStage + wg * kSlice;
      bool valid[T / 8][2];
#pragma unroll
      for (int j = 0; j < T / 8; ++j) valid[j][0] = mk[j][0] != 0, valid[j][1] = mk[j][1] != 0;
      column_mask<T>(mk, mask, b, M, (it + 1) * T, t);  // the next tile's
      float sd[2][T / 2];  // s, dp
#pragma unroll
      for (int i = 0; i < T / 2; ++i) sd[0][i] = sd[1][i] = 0.f;
      hopper::bar_sync(bar_wide_full(s), kWsThreads);
      slice_scores<T>(sd[0], fh, fl, qw, st, w, g, t);
      slice_scores<T>(sd[1], fh, fl, dow, st + 2 * kTile, w, g, t);
      sum_partials<CL>(sd, parts, recv, bars + 2, it, wg, rank);
      dq_weights<T>(sd[0], sd[1], valid, lse_r, di_r, sl2);
      uint32_t dh[T / 8][4], dl[T / 8][4];
      float part[32];  // a fresh accumulator, added in fp32
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      acc_frags<T / 8>(dh, dl, sd[1]);
      slice_product<T>(part, dh, dl, st + 4 * kTile, st + 5 * kTile);
      if (it + 2 < tiles) hopper::bar_arrive(bar_empty(s), kWsThreads);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
    const float sc2[2] = {scale, scale};
    store_acc(dq + qoff, acc, sc2, nq, stride, os * kCW, D, w, g, t);
  }
  wide_end<CL>();
}

constexpr size_t kFwdSmem = (2 * kRows * kCW + 4 * kFwdTile * kCW) * sizeof(float) + kAlign;
constexpr size_t kDkvSmem = (2 * kRows * kCW + 8 * kBwdTile * kCW) * sizeof(float) + kAlign;
constexpr size_t kDqSmem = (2 * kRows * kCW + 6 * kBwdTile * kCW) * sizeof(float) + kAlign;

// cuTensorMapEncodeTiled, from the driver the runtime already loaded (no
// link against the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over x [B, rows, H, D] fp32 whose boxes are 32 channels x T rows of
// one head and batch, swizzled as raw tiles; zeros past rows and past D.
cudaError_t make_map(CUtensorMap* map, const float* x, int B, int rows, int H, int D, int T) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(H) * D * 4,
                                 static_cast<cuuint64_t>(rows) * H * D * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(T), 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Heads of up to 64 channels whose rows the TMA unit can copy (D % 4 == 0,
// 16-byte aligned tensors): the warp-specialised kernels.
bool warp_specialised(int N, int M, int D, std::initializer_list<const void*> tensors) {
  bool ok = D <= kCW && D % 4 == 0 && N > 0 && M > 0;
  for (const void* t : tensors) ok = ok && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  return ok;
}

// Heads above 64 channels that the wide warp-specialised kernels take, with
// rows the TMA unit can copy: 64 < D <= 128 (a block a 64-row tile) or D =
// 256 (a cluster of two). Returns the cluster size, or 0 for another route.
int wide_cluster(int N, int M, int D, std::initializer_list<const void*> tensors) {
  int cl = D > kCW && D <= kWideCW ? 1 : D == 2 * kWideCW ? 2 : 0;
  if (D % 4 != 0 || N <= 0 || M <= 0) cl = 0;
  for (const void* t : tensors) cl = reinterpret_cast<uintptr_t>(t) % 16 == 0 ? cl : 0;
  return cl;
}

// Launches a wide kernel: grid (cl x 64-row tiles, H, B), clusters of cl blocks.
template <auto Kernel>
cudaError_t launch_wide(size_t smem, int rows, int cl, int H, int B, cudaStream_t stream,
                        void** args) {
  const cudaError_t err = hopper::allow_smem<Kernel>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cl;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * ((rows + kRows - 1) / kRows), H, B);
  cfg.blockDim = dim3(kWsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(Kernel), args);
}

template <auto Kernel>
cudaError_t launch(size_t smem, int rows, int per, int threads, int H, int D, int B,
                   cudaStream_t stream, void** args) {
  const cudaError_t err = hopper::allow_smem<Kernel>(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + per - 1) / per, H * ((D + kCW - 1) / kCW), B);
  return cudaLaunchKernel(reinterpret_cast<const void*>(Kernel), grid, dim3(threads), args, smem,
                          stream);
}

// JAX's heads: D <= 128, or a multiple of 128; grid.y = H x D / 64 fits.
bool shape_ok(int B, int N, int M, int H, int D) {
  return B >= 0 && N >= 0 && M >= 0 && H > 0 && B <= 65535 && D > 0 &&
         (D <= 128 || D % 128 == 0) && static_cast<long long>(H) * ((D + kCW - 1) / kCW) <= 65535;
}

}  // namespace

// q [B, N, H, D], k and v [B, M, H, D], mask [B, M] (uint8) or null; writes
// o [B, N, H, D] and lse [B, N, H]. D <= 128 or a multiple of 128.
extern "C" int flash_attention_fwd_launch(const float* q, const float* k, const float* v,
                                          const uint8_t* mask, float* o, float* lse, int B, int N,
                                          int M, int H, int D, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  cudaError_t err;
  if (warp_specialised(N, M, D, {q, k, v})) {
    CUtensorMap tk, tv;
    if ((err = make_map(&tk, k, B, M, H, D, kFwdTile)) != cudaSuccess ||
        (err = make_map(&tv, v, B, M, H, D, kFwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&q, &tk, &tv, &mask, &o, &lse, &N, &M, &H, &D, &scale};
    err = launch<flash_fwd_ws>(kFwdWsSmem, N, kWsRows, kWsThreads, H, D, B, stream, args);
  } else if (const int cl = wide_cluster(N, M, D, {q, k, v})) {
    CUtensorMap tk, tv;
    if ((err = make_map(&tk, k, B, M, H, D, kWideFwdTile)) != cudaSuccess ||
        (err = make_map(&tv, v, B, M, H, D, kWideFwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&q, &tk, &tv, &mask, &o, &lse, &N, &M, &H, &D, &scale};
    err = cl == 1 ? launch_wide<flash_fwd_wide<1>>(kFwdWideSmem, N, 1, H, B, stream, args)
                  : launch_wide<flash_fwd_wide<2>>(kFwdWideSmem, N, 2, H, B, stream, args);
  } else {
    void* args[] = {&q, &k, &v, &mask, &o, &lse, &N, &M, &H, &D, &scale};
    err = launch<flash_fwd>(kFwdSmem, N, kRows, kThreads, H, D, B, stream, args);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dK / dV kernel: dk and dv [B, M, H, D] from the forward's inputs, its
// lse, dout [B, N, H, D] and di [B, N, H].
extern "C" int flash_attention_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                              const uint8_t* mask, const float* dout,
                                              const float* lse, const float* di, float* dk,
                                              float* dv, int B, int N, int M, int H, int D,
                                              float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  cudaError_t err;
  if (warp_specialised(N, M, D, {q, k, v, dout})) {
    CUtensorMap tq, tdo;
    if ((err = make_map(&tq, q, B, N, H, D, kBwdTile)) != cudaSuccess ||
        (err = make_map(&tdo, dout, B, N, H, D, kBwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&tq, &k, &v, &mask, &tdo, &lse, &di, &dk, &dv, &N, &M, &H, &D, &scale};
    err = launch<flash_bwd_dkv_ws>(kDkvWsSmem, M, kWsRows, kWsThreads, H, D, B, stream, args);
  } else if (const int cl = wide_cluster(N, M, D, {q, k, v, dout})) {
    CUtensorMap tq, tdo;
    if ((err = make_map(&tq, q, B, N, H, D, kWideBwdTile)) != cudaSuccess ||
        (err = make_map(&tdo, dout, B, N, H, D, kWideBwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&tq, &k, &v, &mask, &tdo, &lse, &di, &dk, &dv, &N, &M, &H, &D, &scale};
    err = cl == 1 ? launch_wide<flash_bwd_dkv_wide<1>>(kDkvWideSmem, M, 1, H, B, stream, args)
                  : launch_wide<flash_bwd_dkv_wide<2>>(kDkvWideSmem, M, 2, H, B, stream, args);
  } else {
    void* args[] = {&q, &k, &v, &mask, &dout, &lse, &di, &dk, &dv, &N, &M, &H, &D, &scale};
    err = launch<flash_bwd_dkv>(kDkvSmem, M, kRows, kThreads, H, D, B, stream, args);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The dQ kernel: dq [B, N, H, D].
extern "C" int flash_attention_bwd_dq_launch(const float* q, const float* k, const float* v,
                                             const uint8_t* mask, const float* dout,
                                             const float* lse, const float* di, float* dq, int B,
                                             int N, int M, int H, int D, float scale,
                                             cudaStream_t stream) {
  if (!shape_ok(B, N, M, H, D)) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  cudaError_t err;
  if (warp_specialised(N, M, D, {q, k, v, dout})) {
    CUtensorMap tk, tv;
    if ((err = make_map(&tk, k, B, M, H, D, kBwdTile)) != cudaSuccess ||
        (err = make_map(&tv, v, B, M, H, D, kBwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&q, &tk, &tv, &mask, &dout, &lse, &di, &dq, &N, &M, &H, &D, &scale};
    err = launch<flash_bwd_dq_ws>(kDqWsSmem, N, kWsRows, kWsThreads, H, D, B, stream, args);
  } else if (const int cl = wide_cluster(N, M, D, {q, k, v, dout})) {
    CUtensorMap tk, tv;
    if ((err = make_map(&tk, k, B, M, H, D, kWideBwdTile)) != cudaSuccess ||
        (err = make_map(&tv, v, B, M, H, D, kWideBwdTile)) != cudaSuccess)
      return err;
    void* args[] = {&q, &tk, &tv, &mask, &dout, &lse, &di, &dq, &N, &M, &H, &D, &scale};
    err = cl == 1 ? launch_wide<flash_bwd_dq_wide<1>>(kDqWideSmem, N, 1, H, B, stream, args)
                  : launch_wide<flash_bwd_dq_wide<2>>(kDqWideSmem, N, 2, H, B, stream, args);
  } else {
    void* args[] = {&q, &k, &v, &mask, &dout, &lse, &di, &dq, &N, &M, &H, &D, &scale};
    err = launch<flash_bwd_dq>(kDqSmem, N, kRows, kThreads, H, D, B, stream, args);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}
