// One GATsSPG matcher block [GATs, self, cross], as a sequence of kernels.
//
// Replaces onepose_tpu/ops/pallas/gats_block.py::fused_gats_block. For each
// example, with x2 [N2, C], x3 [N3, C], leaves [N3, L, C]:
//   x3 <- elu(GATs leaf attention)                         all fp32
//   x2 <- x2 + MLP([x2, selfattn(x2)]), x3 <- x3 + MLP([x3, selfattn(x3)])
//   x2, x3 <- x2 + MLP([x2, cross(x2 <- x3)]), x3 + MLP([x3, cross(x3 <- x2)])
// with masked multi-head linear attention (phi = elu + 1, masked keys
// zeroed) and an MLP dense -> instance norm over all N rows -> ReLU ->
// dense. Every product rounds both operands to T (bf16 in serving, fp32 in
// the parity runs) and sums in fp32; q, k, v, phi and the key sums s_k
// stay fp32; kv is rounded where it feeds the numerator; the normaliser
// goes through T too: z_h = sum_d T(phi_q * s_k), z = T(1 / (z_h + eps)).
// The reference's v / m then * m value conditioning cancels and is skipped.
//
// Bound on the H100: operations. At x2 [8, 1000, 256], x3 [8, 2000, 256],
// leaves [8, 2000, 8, 256] one block is about 66 GFLOP of products (the
// per-head [D, D] kv, not the TPU's masked [C, C] one), 0.067 ms at 989
// TFLOP/s of bf16; the fp32 leaves are 131 MB, 0.039 ms at 3.35 TB/s.
//
// Design: one example's activations (about 24 MB at the production shape)
// do not fit the 227 KB of shared memory that the TPU's 110 MB VMEM
// replaced, so the block runs as 37 launches on one stream, every product
// inside a kernel of this file (none goes to cuBLAS):
//   - the GATs leaf attention (gats_leaf.cuh: a warp per point, one pass),
//     reading bf16 leaves as they are on the bf16 path;
//   - 16 GEMMs over all B * N rows at once (the weights are shared): q, k
//     and v from one [3C]-wide GEMM per stream and attention, then merge,
//     MLP dense_0 and dense_1 per propagation. bf16: wgmma m64n256k16 on
//     64 x 256 tiles with the weights streamed into shared memory by TMA
//     bulk copies through an mbarrier ring, A's k-tiles streamed by
//     cp.async one tile ahead and read as register fragments
//     (gemm_wgmma_kernel);
//     fp32: SIMT FMAs on 128 x 64 tiles. The A loader rounds activations
//     to T, reads the MLP input [x | message] from two sources (no concat)
//     and can apply the instance norm and ReLU on the fly; the epilogue
//     adds the bias and the residual. In bf16 the attention output and the
//     message are stored in bf16: their only readers round them anyway;
//   - the per-head kv moments [H, D, D] and key sums s_k per 64-row chunk
//     (mma.sync m16n8k16 in bf16, SIMT in fp32), then a reduction over
//     the chunks in a fixed order: deterministic, no atomics;
//   - apply and normalise: num = T(phi_q) . T(kv) (mma.sync in bf16), z
//     from s_k, per 64 rows;
//   - the instance-norm statistics in two launches: partial (mean,
//     centred M2) per 128 rows and 32 columns of an example (2048 blocks
//     at the production shape, where one pass per example had 128), then
//     a fixed-order Chan combine per column.
// Bound on the H100 for the GEMM alone at [16000, 512] x [512, 512]: bytes
// (fp32 A in and out, 65.5 MB, 0.0197 ms at 3.35 TB/s). Launches per
// block: 1 GATs + 16 GEMMs + 4 x (kv_partial, kv_reduce, apply, colpart,
// colcombine) = 37.

#include "common.cuh"
#include "gats_leaf.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;        // head width (C = H * 64)
constexpr int CHUNK = 64;    // rows per kv-moment / apply block
constexpr float EPS_ATTN = 1e-6f;
constexpr float EPS_NORM = 1e-5f;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// The reference block's elu: exp(min(x, 0)) - 1 below zero.
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f; }

// ---------------------------------------------------------------- GEMM
// out[m, n] = sum_k T(A[m, k]) T(W[n, k]) + bias[n] (+ resid[m, n]).

struct AOperand {
  const void* a1;  // columns [0, k1), row stride lda1
  int lda1, k1;
  const void* a2;  // columns [k1, K), row stride lda2
  int lda2;
  const float* mean;  // optional: A <- relu((A - mean[e, k]) * rstd[e, k]), e = m / rows_per_ex
  const float* rstd;
  int rows_per_ex;
  int bf1, bf2;  // source 1 / 2 holds bf16 (T-rounded values), else fp32
};

AOperand plain_a(const void* a, int lda, int K, int bf = 0) {
  return AOperand{a, lda, K, nullptr, 0, nullptr, nullptr, 1, bf, bf};
}

// The fp32 GEMM (the parity runs): 128 x 64 x 32 tiles, 16 x 16 threads of
// 8 x 4 outputs as SIMT FMAs; the next k-tile is loaded into registers
// while the current one is multiplied. Sources are fp32.
constexpr int BM = 128, BN = 64, BK = 32, GEMM_THREADS = 256;

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_fp32_kernel(AOperand A, const float* __restrict__ W, const float* __restrict__ bias,
                 const float* __restrict__ resid, float* __restrict__ out, int ldo, int M, int N,
                 int K) {
  constexpr int A_VECS = BM * BK / 4 / GEMM_THREADS;  // float4 of A per thread
  constexpr int W_VECS = BN * BK / 4 / GEMM_THREADS;  // float4 of W per thread
  __shared__ __align__(16) float As[BM][BK + 8];
  __shared__ __align__(16) float Bs[BK][BN + 4];  // W transposed to [k][n]
  const int tid = threadIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float4 ra[A_VECS], rw[W_VECS];

  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / 4), k = k0 + 4 * (i % (BK / 4)), m = m0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const float* src =
            k < A.k1 ? static_cast<const float*>(A.a1) + static_cast<size_t>(m) * A.lda1 + k
                     : static_cast<const float*>(A.a2) + static_cast<size_t>(m) * A.lda2 + (k - A.k1);
        x = *reinterpret_cast<const float4*>(src);
        if (A.mean != nullptr) {
          const size_t s = static_cast<size_t>(m / A.rows_per_ex) * K + k;
          x.x = fmaxf((x.x - A.mean[s]) * A.rstd[s], 0.f);
          x.y = fmaxf((x.y - A.mean[s + 1]) * A.rstd[s + 1], 0.f);
          x.z = fmaxf((x.z - A.mean[s + 2]) * A.rstd[s + 2], 0.f);
          x.w = fmaxf((x.w - A.mean[s + 3]) * A.rstd[s + 3], 0.f);
        }
      }
      ra[v] = x;
    }
#pragma unroll
    for (int v = 0; v < W_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
      rw[v] = __ldg(reinterpret_cast<const float4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      *reinterpret_cast<float4*>(&As[i / (BK / 4)][4 * (i % (BK / 4))]) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < W_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
      Bs[c][r] = rw[v].x;
      Bs[c + 1][r] = rw[v].y;
      Bs[c + 2][r] = rw[v].z;
      Bs[c + 3][r] = rw[v].w;
    }
  };

  load(0);
  const int ty = tid >> 4, tx = tid & 15;  // rows ty * 8 .. + 7, columns tx * 4 .. + 3
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[ty * 8 + i][k];
        acc[i * 4 + 0] += a * b.x;
        acc[i * 4 + 1] += a * b.y;
        acc[i * 4 + 2] += a * b.z;
        acc[i * 4 + 3] += a * b.w;
      }
    }
    __syncthreads();
  }

  auto store2 = [&](int m, int n, float v0, float v1) {
    if (m >= M) return;
    v0 += bias[n];
    v1 += bias[n + 1];
    if (resid != nullptr) {
      v0 = resid[static_cast<size_t>(m) * N + n] + v0;
      v1 = resid[static_cast<size_t>(m) * N + n + 1] + v1;
    }
    *reinterpret_cast<float2*>(out + static_cast<size_t>(m) * ldo + n) = make_float2(v0, v1);
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i, n = n0 + tx * 4;
    store2(m, n, acc[i * 4], acc[i * 4 + 1]);
    store2(m, n + 2, acc[i * 4 + 2], acc[i * 4 + 3]);
  }
}

// The bf16 GEMM on wgmma: 64 x 256 output tiles, one warpgroup per block
// (m64n256k16, 128 fp32 accumulators per thread), two blocks per SM, so
// that one block's prologue and epilogue overlap the other's products
// (probes on the card found this faster than 128-row tiles of two
// warpgroups, than persistent blocks, and than deeper rings at one block
// per SM). W comes packed in swizzled [K / 64][N][64] chunks (hopper.cuh);
// each 64-deep k-tile of a block's 256 columns is one 32 KB TMA bulk copy
// into a ring of GSTAGES slots ("full" / "empty" mbarriers; thread 0
// refills a slot once the four warps released it). A's k-tiles (fp32, or
// bf16 where the source holds bf16) stream into a second ring with
// cp.async, so that the next tile's loads are in flight while the current
// one multiplies: the GEMM is bound by device memory. Each thread then
// reads its register fragments from the tile, applies the instance norm
// and ReLU where asked, and rounds them to bf16. The epilogue adds the
// bias and the residual and stores fp32, or bf16 where only a GEMM that
// rounds its A reads the result.
constexpr int GBM = 64, GBN = 256, GBK = 64, GSTAGES = 2, ASTAGES = 2, GTHREADS = 128;
constexpr int GSLOT = GBN * GBK * 2;                 // 32 KB of W
constexpr int APITCH = GBK + 8;                      // A tile row pitch, in elements
constexpr int ASLOT = GBM * APITCH * 4;              // 18 KB of A (fp32 or bf16 rows)
constexpr int GEMM_SMEM = GSTAGES * GSLOT + ASTAGES * ASLOT + 64 + 1024;

template <bool OUT_BF16>
__global__ void __launch_bounds__(GTHREADS, 2)
gemm_wgmma_kernel(AOperand A, const bf16* __restrict__ Wp, const float* __restrict__ bias,
                  const float* __restrict__ resid, void* __restrict__ out, int ldo, int M, int N,
                  int K) {
  constexpr int NT = GTHREADS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* aring = ring + GSTAGES * GSLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(aring + ASTAGES * ASLOT);
  uint64_t* empty = full + GSTAGES;
  const int tid = threadIdx.x, wl = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN, KT = K / GBK;
  auto issue = [&](int kt) {
    const int s = kt % GSTAGES;
    hopper::mbar_expect_tx(full + s, GSLOT);
    hopper::bulk_load(ring + s * GSLOT, Wp + (static_cast<size_t>(kt) * N + n0) * GBK, GSLOT,
                      full + s);
  };
  // A's k-tile kt into slot kt % ASTAGES: rows of 64 fp32 (16 copies of
  // 16 bytes) or 64 bf16 (8 copies); rows past M are zero. One commit
  // group per k-tile, empty past the last.
  auto load_a = [&](int kt) {
    if (kt < KT) {
      const int k0 = kt * GBK;
      const bool first = k0 < A.k1;
      const int bf = first ? A.bf1 : A.bf2, lda = first ? A.lda1 : A.lda2;
      const int kk = first ? k0 : k0 - A.k1;
      const unsigned char* base = static_cast<const unsigned char*>(first ? A.a1 : A.a2);
      unsigned char* dst = aring + (kt % ASTAGES) * ASLOT;
      const int shift = bf ? 3 : 4, esz = bf ? 2 : 4;  // 8 or 16 copies per row
      for (int i = tid; i < (GBM << shift); i += NT) {
        const int r = i >> shift, c = i & ((1 << shift) - 1), m = m0 + r;
        const bool ok = m < M;
        hopper::cp_async16(dst + (r * APITCH * esz) + c * 16,
                           base + ((static_cast<size_t>(ok ? m : 0) * lda + kk) * esz) + c * 16,
                           ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, NT / 32);
    }
    hopper::fence_mbar_init();
    for (int kt = 0; kt < GSTAGES && kt < KT; ++kt) issue(kt);
  }
  for (int kt = 0; kt < ASTAGES - 1; ++kt) load_a(kt);

  const int rl[2] = {wl * 16 + g, wl * 16 + g + 8};  // rows in the tile
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ASTAGES - 2) : "memory");
    __syncthreads();  // k-tile kt is in; every thread is done with kt - 1
    load_a(kt + ASTAGES - 1);
    const int k0 = kt * GBK;
    // The fragments of A's k-tile, rounded to bf16.
    const bool bf = k0 < A.k1 ? A.bf1 : A.bf2;
    const unsigned char* tile = aring + (kt % ASTAGES) * ASLOT;
    uint32_t a[4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (bf) {
        const bf16* r = reinterpret_cast<const bf16*>(tile) + rl[h] * APITCH + 2 * t;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          a[ks][h] = ld_bf16x2(r + ks * 16);
          a[ks][2 + h] = ld_bf16x2(r + ks * 16 + 8);
        }
        continue;
      }
      const float* r = reinterpret_cast<const float*>(tile) + rl[h] * APITCH + 2 * t;
      const float* mu = nullptr;
      const float* rs = nullptr;
      if (A.mean != nullptr) {
        const size_t e = static_cast<size_t>(min(m0 + rl[h], M - 1) / A.rows_per_ex) * K;
        mu = A.mean + e + k0 + 2 * t;
        rs = A.rstd + e + k0 + 2 * t;
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float2 lo = *reinterpret_cast<const float2*>(r + ks * 16);
        const float2 hi = *reinterpret_cast<const float2*>(r + ks * 16 + 8);
        float v[4] = {lo.x, lo.y, hi.x, hi.y};
        if (mu != nullptr) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = ks * 16 + (i & 1) + 8 * (i >> 1);
            v[i] = fmaxf((v[i] - __ldg(mu + c)) * __ldg(rs + c), 0.f);
          }
        }
        a[ks][h] = pack_bf16x2(v[0], v[1]);
        a[ks][2 + h] = pack_bf16x2(v[2], v[3]);
      }
    }
    const int s = kt % GSTAGES;
    hopper::mbar_wait(full + s, (kt / GSTAGES) & 1);
    const uint32_t slot = hopper::smem_u32(ring + s * GSLOT);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_m64n256k16(acc, a[ks], hopper::desc_b128(slot + ks * 32));
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(empty + s);
    if (tid == 0 && kt + GSTAGES < KT) {
      hopper::mbar_wait(empty + s, (kt / GSTAGES) & 1);
      issue(kt + GSTAGES);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + rl[h];
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      float v0 = acc[4 * j + 2 * h] + bias[n], v1 = acc[4 * j + 2 * h + 1] + bias[n + 1];
      if (resid != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(resid + static_cast<size_t>(m) * N + n);
        v0 = r.x + v0;
        v1 = r.y + v1;
      }
      if (OUT_BF16)
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + static_cast<size_t>(m) * ldo + n) =
            pack_bf16x2(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + static_cast<size_t>(m) * ldo + n) =
            make_float2(v0, v1);
    }
  }
}

// ------------------------------------------------------- linear attention
// Partial per-head moments of one 64-row chunk of one example's keys:
// kvpart[b, h, chunk] = sum_rows T(phi_k) T(v)^T ([D, D]) and
// skpart[b, chunk, h * D + d] = sum_rows phi_k (fp32). In bf16 the product
// runs on mma.sync m16n8k16 (phi_k^T and v^T staged as bf16 [64][64 + 8]:
// 8 warps of 16 x 32 outputs), in fp32 as SIMT FMAs.
template <bool BF16>
__global__ void __launch_bounds__(256)
kv_partial_kernel(const float* __restrict__ k, const float* __restrict__ v, int ld,
                  const float* __restrict__ mask, int Nk, int C, int chunks,
                  float* __restrict__ kvpart, float* __restrict__ skpart) {
  constexpr int P = D + 8;
  __shared__ __align__(16) unsigned char buf[BF16 ? 2 * D * P * 2 : 2 * CHUNK * D * 4];
  __shared__ float skp[16][D];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  bf16* pkT = reinterpret_cast<bf16*>(buf);  // [d][row], bf16
  bf16* vT = pkT + D * P;                     // [e][row]
  float* pkr = reinterpret_cast<float*>(buf);  // fp32: [row][d]
  float* vr = pkr + CHUNK * D;                 // [row][e]
  // Thread: channels d0 .. d0 + 3 (float4 loads) of rows tid / 16 + 16 i.
  const int d0 = (tid & 15) * 4;
  float sk[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = tid >> 4; r < CHUNK; r += 16) {
    const int row = c * CHUNK + r;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    float m = 0.f;
    if (row < Nk) {
      const size_t g = static_cast<size_t>(b) * Nk + row;
      kk = *reinterpret_cast<const float4*>(k + g * ld + h * D + d0);
      vv = *reinterpret_cast<const float4*>(v + g * ld + h * D + d0);
      m = mask[g];
    }
    const float phi[4] = {(elu(kk.x) + 1.f) * m, (elu(kk.y) + 1.f) * m, (elu(kk.z) + 1.f) * m,
                          (elu(kk.w) + 1.f) * m};
    const float val[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sk[j] += phi[j];
      if constexpr (BF16) {
        pkT[(d0 + j) * P + r] = __float2bfloat16_rn(phi[j]);
        vT[(d0 + j) * P + r] = __float2bfloat16_rn(val[j]);
      }
    }
    if constexpr (!BF16) {
      *reinterpret_cast<float4*>(pkr + r * D + d0) = make_float4(phi[0], phi[1], phi[2], phi[3]);
      *reinterpret_cast<float4*>(vr + r * D + d0) = vv;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) skp[tid >> 4][d0 + j] = sk[j];
  __syncthreads();
  float* dst = kvpart + ((static_cast<size_t>(b) * H + h) * chunks + c) * D * D;
  if constexpr (BF16) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp >> 1, wn = warp & 1;
    const int arow = lane & 15, acol = (lane >> 4) * 8;
    const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < CHUNK; ks += 16) {
      uint32_t a[4], bb[2][4];
      ldmatrix_x4(a, pkT + (wm * 16 + arow) * P + ks + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4(bb[np], vT + (wn * 32 + np * 16 + brow) * P + ks + bcol);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16_16816(acc[nt], a, bb[nt >> 1][(nt & 1) * 2], bb[nt >> 1][(nt & 1) * 2 + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = wm * 16 + g, e = wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst + d * D + e) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(dst + (d + 8) * D + e) = make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
    const int d0 = (tid >> 4) * 4, e0 = (tid & 15) * 4;
    float acc[4][4] = {};
    for (int r = 0; r < CHUNK; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += pkr[r * D + d0 + i] * vr[r * D + e0 + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (d0 + i) * D + e0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (tid < D) {
    float tot = 0.f;
    for (int i = 0; i < 16; ++i) tot += skp[i][tid];
    skpart[(static_cast<size_t>(b) * chunks + c) * C + h * D + tid] = tot;
  }
}

// kv[b, h] and sk[b, h * D ..] as the sums of the chunks' partials, in
// chunk order: a block per 256 entries of one [D, D] moment.
__global__ void __launch_bounds__(256)
kv_reduce_kernel(const float* __restrict__ kvpart, const float* __restrict__ skpart, int C,
                 int chunks, float* __restrict__ kv, float* __restrict__ sk) {
  const int bh = blockIdx.x, H = C / D, b = bh / H, h = bh % H;
  const int i = blockIdx.y * 256 + threadIdx.x;
  const float* src = kvpart + static_cast<size_t>(bh) * chunks * D * D;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += src[static_cast<size_t>(c) * D * D + i];
  kv[static_cast<size_t>(bh) * D * D + i] = s;
  if (blockIdx.y == 0 && threadIdx.x < D) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += skpart[(static_cast<size_t>(b) * chunks + c) * C + h * D + threadIdx.x];
    sk[static_cast<size_t>(b) * C + h * D + threadIdx.x] = s;
  }
}

// att[row, h * D + e] = (sum_d T(phi_q[d]) T(kv[d, e])) * T(1 / (z_h + eps)),
// z_h = sum_d T(phi_q[d] * sk[d]), for 64 query rows of one example and
// head. In bf16 the product runs on mma.sync (T(phi_q) and T(kv)^T staged
// as bf16 [64][64 + 8]) and att is stored in bf16: only the merge GEMM
// reads it, and that rounds it to bf16 anyway. In fp32, SIMT FMAs.
template <bool BF16>
__global__ void __launch_bounds__(256)
apply_kernel(const float* __restrict__ q, int ld, const float* __restrict__ kv,
             const float* __restrict__ sk, int Nq, int C, void* __restrict__ att) {
  constexpr int P = D + 8;
  __shared__ __align__(16) float pq[CHUNK][D];
  __shared__ __align__(16) unsigned char buf[BF16 ? 2 * D * P * 2 : D * D * 4];
  __shared__ float zl[CHUNK];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  const float* kvh = kv + (static_cast<size_t>(b) * H + h) * D * D;
  const float* skh = sk + static_cast<size_t>(b) * C + h * D;
  bf16* pqb = reinterpret_cast<bf16*>(buf);  // [row][d]
  bf16* kvT = pqb + CHUNK * P;               // [e][d]
  float* kvs = reinterpret_cast<float*>(buf);  // fp32: [d][e]
  for (int i = tid; i < D * D; i += 256) {
    if constexpr (BF16)
      kvT[(i % D) * P + i / D] = __float2bfloat16_rn(kvh[i]);
    else
      kvs[i] = kvh[i];
  }
  for (int i = tid; i < CHUNK * D / 4; i += 256) {  // float4 of q per step
    const int r = i / (D / 4), d = 4 * (i % (D / 4)), row = c * CHUNK + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < Nq) {
      x = *reinterpret_cast<const float4*>(q + (static_cast<size_t>(b) * Nq + row) * ld + h * D + d);
      x = make_float4(elu(x.x) + 1.f, elu(x.y) + 1.f, elu(x.z) + 1.f, elu(x.w) + 1.f);
    }
    *reinterpret_cast<float4*>(&pq[r][d]) = x;
    if constexpr (BF16)
      *reinterpret_cast<uint2*>(pqb + r * P + d) = make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
  }
  __syncthreads();
  {  // z: four threads per row, 16 channels each, then a shuffle sum
    const int r = tid >> 2, part = tid & 3;
    float z = 0.f;
#pragma unroll
    for (int d = part * 16; d < part * 16 + 16; ++d) z += rnd<BF16>(pq[r][d] * skh[d]);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    if (part == 0) zl[r] = rnd<BF16>(1.f / (z + EPS_ATTN));
  }
  __syncthreads();
  if constexpr (BF16) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp >> 1, wn = warp & 1;
    const int arow = lane & 15, acol = (lane >> 4) * 8;
    const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < D; ks += 16) {
      uint32_t a[4], bb[2][4];
      ldmatrix_x4(a, pqb + (wm * 16 + arow) * P + ks + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4(bb[np], kvT + (wn * 32 + np * 16 + brow) * P + ks + bcol);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16_16816(acc[nt], a, bb[nt >> 1][(nt & 1) * 2], bb[nt >> 1][(nt & 1) * 2 + 1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 16 + g + 8 * hh, row = c * CHUNK + r;
      if (row >= Nq) continue;
      const float z = zl[r];
      bf16* dst = static_cast<bf16*>(att) + (static_cast<size_t>(b) * Nq + row) * C + h * D;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(dst + wn * 32 + nt * 8 + 2 * t) =
            pack_bf16x2(acc[nt][2 * hh] * z, acc[nt][2 * hh + 1] * z);
    }
  } else {
    const int r0 = (tid >> 4) * 4, e0 = (tid & 15) * 4;
    float acc[4][4] = {};
    for (int d = 0; d < D; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(&kvs[d * D + e0]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = pq[r0 + i][d];
        acc[i][0] += a * kk.x;
        acc[i][1] += a * kk.y;
        acc[i][2] += a * kk.z;
        acc[i][3] += a * kk.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = c * CHUNK + r0 + i;
      if (row >= Nq) continue;
      const float z = zl[r0 + i];
      *reinterpret_cast<float4*>(static_cast<float*>(att) +
                                 (static_cast<size_t>(b) * Nq + row) * C + h * D + e0) =
          make_float4(acc[i][0] * z, acc[i][1] * z, acc[i][2] * z, acc[i][3] * z);
    }
  }
}

// ------------------------------------------------------- instance norm
// Statistics of each column of t [B * N, K] over the N rows of its
// example, in two launches: colpart, one block per 32 columns and SROWS
// rows of an example (mean, then the centred second moment, rows summed in
// a fixed order), and colcombine, one thread per column and example,
// which merges the parts in order with Chan's formula into mean and
// 1 / sqrt(var + eps). Deterministic, no atomics.
constexpr int SROWS = 128;

__global__ void __launch_bounds__(256)
colpart_kernel(const float* __restrict__ t, int N, int K, int parts, float* __restrict__ pmean,
               float* __restrict__ pm2) {
  __shared__ float red[8][32];
  __shared__ float mu_s[32];
  const int p = blockIdx.y, b = blockIdx.z, lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane, r0 = p * SROWS, n = min(SROWS, N - r0);
  const float* src = t + (static_cast<size_t>(b) * N + r0) * K + col;
  float s = 0.f;
  for (int r = rl; r < n; r += 8) s += src[static_cast<size_t>(r) * K];
  red[rl][lane] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float tot = 0.f;
    for (int i = 0; i < 8; ++i) tot += red[i][lane];
    mu_s[lane] = tot / n;
  }
  __syncthreads();
  const float mu = mu_s[lane];
  s = 0.f;
  for (int r = rl; r < n; r += 8) {
    const float dv = src[static_cast<size_t>(r) * K] - mu;
    s += dv * dv;
  }
  __syncthreads();
  red[rl][lane] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float tot = 0.f;
    for (int i = 0; i < 8; ++i) tot += red[i][lane];
    const size_t o = (static_cast<size_t>(b) * parts + p) * K + col;
    pmean[o] = mu;
    pm2[o] = tot;
  }
}

__global__ void __launch_bounds__(256)
colcombine_kernel(const float* __restrict__ pmean, const float* __restrict__ pm2, int N, int K,
                  int parts, float* __restrict__ mean, float* __restrict__ rstd) {
  const int b = blockIdx.y, col = blockIdx.x * 256 + threadIdx.x;
  if (col >= K) return;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int p = 0; p < parts; ++p) {
    const size_t o = (static_cast<size_t>(b) * parts + p) * K + col;
    const float np = static_cast<float>(min(SROWS, N - p * SROWS));
    const float tot = n + np, d = pmean[o] - mu;
    mu += d * (np / tot);
    m2 += pm2[o] + d * d * (n * np / tot);
    n = tot;
  }
  mean[static_cast<size_t>(b) * K + col] = mu;
  rstd[static_cast<size_t>(b) * K + col] = 1.f / sqrtf(m2 / N + EPS_NORM);
}

// ------------------------------------------------------- the sequence

// Pointer table order; the wrapper (ops/kernels/gats_block.py, PTRS) passes
// the same order.
enum Ptr {
  X2, X3, LEAVES, M2, M3, LEAFADD, WA,
  S_WQKV, S_BQKV, S_WM, S_BM, S_W0, S_B0, S_W1, S_B1,
  C_WQKV, C_BQKV, C_WM, C_BM, C_W0, C_B0, C_W1, C_B1,
  X2O, X3O,
  X3G, X2S, X3S, QKV2, QKV3, ATT, MSG, TBUF, KVPART, KV, SKPART, SK, PMEAN, PM2, MEAN, RSTD,
  NPTR
};

struct Run {
  void* const* p;
  int B, N2, N3, L, C, H;
  float alpha;
  cudaStream_t stream;
  int err;
  float* f(int i) const { return static_cast<float*>(p[i]); }
  void check() {
    const cudaError_t e = cudaGetLastError();
    if (err == 0 && e != cudaSuccess) err = e;
  }
};

// out [M, N] (row stride ldo) = T(A) T(W)^T + bias (+ resid). bf16: the
// wgmma kernel on W packed in swizzled chunks, N a multiple of GBN, output
// bf16 if out_bf16; fp32: the SIMT kernel on W [N][K].
template <typename T>
void gemm(Run& run, AOperand a, const void* w, const float* bias, const float* resid, void* out,
          int ldo, int M, int N, int K, bool out_bf16 = false) {
  if constexpr (sizeof(T) == 2) {
    const dim3 grid(N / GBN, (M + GBM - 1) / GBM);
    auto kernel = out_bf16 ? gemm_wgmma_kernel<true> : gemm_wgmma_kernel<false>;
    const cudaError_t e = out_bf16 ? hopper::allow_smem<gemm_wgmma_kernel<true>>(GEMM_SMEM)
                                   : hopper::allow_smem<gemm_wgmma_kernel<false>>(GEMM_SMEM);
    if (e != cudaSuccess && run.err == 0) run.err = e;
    kernel<<<grid, GTHREADS, GEMM_SMEM, run.stream>>>(a, static_cast<const bf16*>(w), bias,
                                                             resid, out, ldo, M, N, K);
  } else {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    gemm_fp32_kernel<<<grid, GEMM_THREADS, 0, run.stream>>>(
        a, static_cast<const float*>(w), bias, resid, static_cast<float*>(out), ldo, M, N, K);
  }
  run.check();
}

// x_out = resid + MLP([xq, attn(xq <- keys)]) for one stream. qkv_q holds
// the query stream's q at column 0 (row stride 3C); qkv_k the key stream's
// k at column C and v at column 2C; set = S_WQKV or C_WQKV. In bf16, att
// and msg are stored in bf16 (their only readers round them to bf16).
template <typename T>
void propagate(Run& run, const float* xq, int Nq, const float* qkv_q, const float* qkv_k,
               const float* mask_k, int Nk, int set, const float* resid, float* x_out) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int B = run.B, C = run.C, H = run.H, C3 = 3 * C;
  const int chunks = (Nk + CHUNK - 1) / CHUNK, parts = (Nq + SROWS - 1) / SROWS;
  kv_partial_kernel<BF16><<<dim3(chunks, H, B), 256, 0, run.stream>>>(
      qkv_k + C, qkv_k + 2 * C, C3, mask_k, Nk, C, chunks, run.f(KVPART), run.f(SKPART));
  run.check();
  kv_reduce_kernel<<<dim3(B * H, D * D / 256), 256, 0, run.stream>>>(run.f(KVPART), run.f(SKPART), C, chunks,
                                                  run.f(KV), run.f(SK));
  run.check();
  apply_kernel<BF16><<<dim3((Nq + CHUNK - 1) / CHUNK, H, B), 256, 0, run.stream>>>(
      qkv_q, C3, run.f(KV), run.f(SK), Nq, C, run.p[ATT]);
  run.check();
  const int M = B * Nq;
  const int wm = set + (S_WM - S_WQKV), w0 = set + (S_W0 - S_WQKV), w1 = set + (S_W1 - S_WQKV);
  gemm<T>(run, plain_a(run.p[ATT], C, C, BF16), run.p[wm], run.f(wm + 1), nullptr, run.p[MSG], C,
          M, C, C, BF16);
  gemm<T>(run, AOperand{xq, C, C, run.p[MSG], C, nullptr, nullptr, 1, 0, BF16}, run.p[w0],
          run.f(w0 + 1), nullptr, run.f(TBUF), 2 * C, M, 2 * C, 2 * C);
  colpart_kernel<<<dim3(2 * C / 32, parts, B), 256, 0, run.stream>>>(run.f(TBUF), Nq, 2 * C, parts,
                                                                   run.f(PMEAN), run.f(PM2));
  run.check();
  colcombine_kernel<<<dim3((2 * C + 255) / 256, B), 256, 0, run.stream>>>(
      run.f(PMEAN), run.f(PM2), Nq, 2 * C, parts, run.f(MEAN), run.f(RSTD));
  run.check();
  gemm<T>(run, AOperand{run.f(TBUF), 2 * C, 2 * C, nullptr, 0, run.f(MEAN), run.f(RSTD), Nq, 0, 0},
          run.p[w1], run.f(w1 + 1), resid, x_out, C, M, C, 2 * C);
}

template <typename T>
int block(Run& run, bool leaves_bf16) {
  const int B = run.B, N2 = run.N2, N3 = run.N3, C = run.C;
  const float* m2 = run.f(M2);
  const float* m3 = run.f(M3);
  if (leaves_bf16)
    gats_leaf::dispatch(static_cast<const bf16*>(run.p[LEAVES]), run.f(X3), run.f(LEAFADD),
                        run.f(WA), run.f(X3G), B * N3, run.L, C, run.alpha, run.stream);
  else
    gats_leaf::dispatch(run.f(LEAVES), run.f(X3), run.f(LEAFADD), run.f(WA), run.f(X3G), B * N3,
                        run.L, C, run.alpha, run.stream);
  run.check();
  // Self attention, shared weights, one stream after the other.
  gemm<T>(run, plain_a(run.f(X2), C, C), run.p[S_WQKV], run.f(S_BQKV), nullptr, run.f(QKV2), 3 * C,
          B * N2, 3 * C, C);
  propagate<T>(run, run.f(X2), N2, run.f(QKV2), run.f(QKV2), m2, N2, S_WQKV, run.f(X2), run.f(X2S));
  gemm<T>(run, plain_a(run.f(X3G), C, C), run.p[S_WQKV], run.f(S_BQKV), nullptr, run.f(QKV3),
          3 * C, B * N3, 3 * C, C);
  propagate<T>(run, run.f(X3G), N3, run.f(QKV3), run.f(QKV3), m3, N3, S_WQKV, run.f(X3G),
               run.f(X3S));
  // Cross attention: both messages read the pre-cross streams.
  gemm<T>(run, plain_a(run.f(X2S), C, C), run.p[C_WQKV], run.f(C_BQKV), nullptr, run.f(QKV2),
          3 * C, B * N2, 3 * C, C);
  gemm<T>(run, plain_a(run.f(X3S), C, C), run.p[C_WQKV], run.f(C_BQKV), nullptr, run.f(QKV3),
          3 * C, B * N3, 3 * C, C);
  propagate<T>(run, run.f(X2S), N2, run.f(QKV2), run.f(QKV3), m3, N3, C_WQKV, run.f(X2S),
               run.f(X2O));
  propagate<T>(run, run.f(X3S), N3, run.f(QKV3), run.f(QKV2), m2, N2, C_WQKV, run.f(X3S),
               run.f(X3O));
  return run.err;
}

}  // namespace

// Number of entries of the pointer table.
extern "C" int gats_block_num_ptrs() { return NPTR; }

// One fused block. ptrs: the table of device pointers in `Ptr` order (see
// the wrapper for shapes). bf16 != 0: weights in swizzled bf16 chunks
// [K / 64][N][64] (C a multiple of 256), att and msg bf16; else weights
// [N][K] fp32. Leaves bf16 if leaves_bf16 != 0, else fp32; everything else
// fp32. C = 64 * H <= 512; N2, N3 >= 1; L >= 0.
extern "C" int gats_block_launch(void* const* ptrs, int B, int N2, int N3, int L, int C, int H,
                                 float alpha, int bf16, int leaves_bf16, cudaStream_t stream) {
  if (C != D * H || C % BN || C > 512 || B <= 0 || N2 <= 0 || N3 <= 0 || L < 0 ||
      (bf16 && C % GBN))
    return cudaErrorInvalidValue;
  Run run{ptrs, B, N2, N3, L, C, H, alpha, stream, 0};
  return bf16 ? block<__nv_bfloat16>(run, leaves_bf16) : block<float>(run, leaves_bf16);
}

// The block's GEMM alone, out [M, N] = T(a [M, K]) T(w)^T + bias, for
// timing beside a library GEMM. bf16: w packed in swizzled chunks, N a
// multiple of 256, K of 64; fp32: w [N][K], N a multiple of 64, K of 32.
extern "C" int gats_block_gemm_launch(const float* a, const void* w, const float* bias, float* out,
                                      int M, int N, int K, int bf16, cudaStream_t stream) {
  if (M <= 0 || N % (bf16 ? GBN : BN) || K % (bf16 ? GBK : BK)) return cudaErrorInvalidValue;
  Run run{nullptr, 0, 0, 0, 0, 0, 0, 0.f, stream, 0};
  if (bf16)
    gemm<__nv_bfloat16>(run, plain_a(a, K, K), w, bias, nullptr, out, N, M, N, K);
  else
    gemm<float>(run, plain_a(a, K, K), w, bias, nullptr, out, N, M, N, K);
  return run.err;
}
