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
// replaced, so the block runs as 33 launches on one stream, every product
// inside a kernel of this file (none goes to cuBLAS):
//   - the GATs leaf attention (gats_leaf.cuh: a warp per point, one pass);
//   - a tiled GEMM (128 x 64 x 64 tiles in bf16, x 32 in fp32; 8 warps; the next k-tile loaded
//     into registers during the products) over all B * N rows at
//     once, since the weights are shared: bf16 operands on mma.sync
//     m16n8k16 with fp32 accumulators, or fp32 SIMT FMAs, the operand type
//     a template parameter. Its A loader rounds fp32 activations to T,
//     reads the MLP input [x | message] from two sources (no concat), and
//     can apply the instance norm and ReLU on the fly; its epilogue adds
//     the bias and the residual. q, k and v come from one GEMM ([3C] wide);
//   - the per-head kv moments [H, D, D] and key sums s_k, per 64-row chunk
//     (fp32 SIMT on T-rounded operands), then a reduction over the chunks
//     in a fixed order: deterministic, no atomics;
//   - apply and normalise: num = T(phi_q) . T(kv), z from s_k, per 64 rows;
//   - the instance-norm column statistics, one block per 32 columns of an
//     example, rows summed in a fixed order (mean, then the centred second
//     moment, as the reference).
// Later work: one persistent launch, wgmma / TMA tiles, bf16 leaves.

#include "common.cuh"
#include "gats_leaf.cuh"
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

constexpr int BM = 128, BN = 64, GEMM_THREADS = 256;

// k-tile depth: 64 for bf16, 32 for fp32 (the fp32 tiles must fit 48 KB).
template <typename T>
__host__ __device__ constexpr int gemm_bk() { return sizeof(T) == 2 ? 64 : 32; }

struct AOperand {
  const float* a1;  // columns [0, k1), row stride lda1
  int lda1, k1;
  const float* a2;  // columns [k1, K), row stride lda2
  int lda2;
  const float* mean;  // optional: A <- relu((A - mean[e, k]) * rstd[e, k]), e = m / rows_per_ex
  const float* rstd;
  int rows_per_ex;
};

// 8 warps: as 4 x 2 warps of 32 x 32 outputs (bf16 mma.sync, fragments by
// ldmatrix), or as 16 x 16 threads of 8 x 4 outputs (fp32 SIMT). The next
// k-tile is loaded into registers while the current one is multiplied.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(AOperand A, const T* __restrict__ W, const float* __restrict__ bias,
            const float* __restrict__ resid, float* __restrict__ out, int ldo, int M, int N,
            int K) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int BK = gemm_bk<T>();
  constexpr int EPV = 16 / sizeof(T);                        // W elements per 16-byte vector
  constexpr int A_VECS = BM * BK / 4 / GEMM_THREADS;         // float4 of A per thread
  constexpr int W_VECS = BN * BK / EPV / GEMM_THREADS;       // 16-byte vectors of W per thread
  // bf16: [row][k] tiles padded by 8 (conflict-free fragment loads);
  // fp32: A as [row][k], B transposed to [k][n].
  __shared__ __align__(16) T As[BM][BK + 8];
  __shared__ __align__(16) T Bs[BF16 ? BN : BK][BF16 ? BK + 8 : BN + 4];
  const int tid = threadIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float4 ra[A_VECS];
  uint4 rw[W_VECS];

  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / 4), k = k0 + 4 * (i % (BK / 4)), m = m0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const float* src = k < A.k1 ? A.a1 + static_cast<size_t>(m) * A.lda1 + k
                                    : A.a2 + static_cast<size_t>(m) * A.lda2 + (k - A.k1);
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
      const int r = i / (BK / EPV), c = EPV * (i % (BK / EPV));
      rw[v] = __ldg(reinterpret_cast<const uint4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c));
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / 4), k = 4 * (i % (BK / 4));
      if constexpr (BF16) {
        *reinterpret_cast<uint2*>(&As[r][k]) =
            make_uint2(pack_bf16x2(ra[v].x, ra[v].y), pack_bf16x2(ra[v].z, ra[v].w));
      } else {
        *reinterpret_cast<float4*>(&As[r][k]) = ra[v];
      }
    }
#pragma unroll
    for (int v = 0; v < W_VECS; ++v) {
      const int i = tid + v * GEMM_THREADS;
      const int r = i / (BK / EPV), c = EPV * (i % (BK / EPV));
      if constexpr (BF16) {
        *reinterpret_cast<uint4*>(&Bs[r][c]) = rw[v];
      } else {
        const float* f = reinterpret_cast<const float*>(&rw[v]);
#pragma unroll
        for (int j = 0; j < 4; ++j) Bs[c + j][r] = f[j];
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
    if constexpr (BF16) {
      const int warp = tid >> 5, lane = tid & 31;
      const int wm = warp >> 1, wn = warp & 1;
      // ldmatrix lane roles: A x4 = rows 0-7 / 8-15 at k, then at k + 8; B x4 =
      // n rows 0-7 at k and k + 8, then n rows 8-15 at k and k + 8.
      const int arow = lane & 15, acol = (lane >> 4) * 8;
      const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], &As[wm * 32 + mt * 16 + arow][ks + acol]);
#pragma unroll
        for (int np = 0; np < 2; ++np) ldmatrix_x4(b[np], &Bs[wn * 32 + np * 16 + brow][ks + bcol]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 = b[nt >> 1][(nt & 1) * 2], b1 = b[nt >> 1][(nt & 1) * 2 + 1];
          mma_bf16_16816(*reinterpret_cast<float(*)[4]>(&acc[(0 * 4 + nt) * 4]), a[0], b0, b1);
          mma_bf16_16816(*reinterpret_cast<float(*)[4]>(&acc[(1 * 4 + nt) * 4]), a[1], b0, b1);
        }
      }
    } else {
      const int ty = tid >> 4, tx = tid & 15;  // rows ty * 8 .. + 7, columns tx * 4 .. + 3
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
  if constexpr (BF16) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* d = &acc[(mt * 4 + nt) * 4];
        const int m = m0 + wm * 32 + mt * 16 + g, n = n0 + wn * 32 + nt * 8 + 2 * t;
        store2(m, n, d[0], d[1]);
        store2(m + 8, n, d[2], d[3]);
      }
  } else {
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i, n = n0 + tx * 4;
      store2(m, n, acc[i * 4], acc[i * 4 + 1]);
      store2(m, n + 2, acc[i * 4 + 2], acc[i * 4 + 3]);
    }
  }
}

// ------------------------------------------------------- linear attention
// Partial per-head moments of one 64-row chunk of one example's keys:
// kvpart[b, h, chunk] = sum_rows T(phi_k) T(v)^T ([D, D]) and
// skpart[b, chunk, h * D + d] = sum_rows phi_k (fp32).
template <bool BF16>
__global__ void __launch_bounds__(256)
kv_partial_kernel(const float* __restrict__ k, const float* __restrict__ v, int ld,
                  const float* __restrict__ mask, int Nk, int C, int chunks,
                  float* __restrict__ kvpart, float* __restrict__ skpart) {
  __shared__ float pk[CHUNK][D], pkr[CHUNK][D], vr[CHUNK][D];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  for (int i = tid; i < CHUNK * D; i += 256) {
    const int r = i / D, d = i % D, row = c * CHUNK + r;
    float phi = 0.f, vv = 0.f;
    if (row < Nk) {
      const size_t g = static_cast<size_t>(b) * Nk + row;
      phi = (elu(k[g * ld + h * D + d]) + 1.f) * mask[g];
      vv = v[g * ld + h * D + d];
    }
    pk[r][d] = phi;
    pkr[r][d] = rnd<BF16>(phi);
    vr[r][d] = rnd<BF16>(vv);
  }
  __syncthreads();
  const int d0 = (tid >> 4) * 4, e0 = (tid & 15) * 4;
  float acc[4][4] = {};
  for (int r = 0; r < CHUNK; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += pkr[r][d0 + i] * vr[r][e0 + j];
  }
  float* dst = kvpart + ((static_cast<size_t>(b) * H + h) * chunks + c) * D * D;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (d0 + i) * D + e0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (tid < D) {
    float s = 0.f;
    for (int r = 0; r < CHUNK; ++r) s += pk[r][tid];
    skpart[(static_cast<size_t>(b) * chunks + c) * C + h * D + tid] = s;
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
// z_h = sum_d T(phi_q[d] * sk[d]), for 64 query rows of one example and head.
template <bool BF16>
__global__ void __launch_bounds__(256)
apply_kernel(const float* __restrict__ q, int ld, const float* __restrict__ kv,
             const float* __restrict__ sk, int Nq, int C, float* __restrict__ att) {
  __shared__ float kvs[D][D], pq[CHUNK][D], zl[CHUNK];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y, tid = threadIdx.x;
  const float* kvh = kv + (static_cast<size_t>(b) * H + h) * D * D;
  const float* skh = sk + static_cast<size_t>(b) * C + h * D;
  for (int i = tid; i < D * D; i += 256) kvs[i / D][i % D] = rnd<BF16>(kvh[i]);
  for (int i = tid; i < CHUNK * D; i += 256) {
    const int r = i / D, d = i % D, row = c * CHUNK + r;
    pq[r][d] = row < Nq ? elu(q[(static_cast<size_t>(b) * Nq + row) * ld + h * D + d]) + 1.f : 0.f;
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
  const int r0 = (tid >> 4) * 4, e0 = (tid & 15) * 4;
  float acc[4][4] = {};
  for (int d = 0; d < D; ++d) {
    const float4 kk = *reinterpret_cast<const float4*>(&kvs[d][e0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = rnd<BF16>(pq[r0 + i][d]);
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
    *reinterpret_cast<float4*>(att + (static_cast<size_t>(b) * Nq + row) * C + h * D + e0) =
        make_float4(acc[i][0] * z, acc[i][1] * z, acc[i][2] * z, acc[i][3] * z);
  }
}

// ------------------------------------------------------- instance norm
// mean and 1 / sqrt(var + eps) of each column of t [B * N, K] over the N
// rows of its example: one block per 32 columns of one example.
__global__ void __launch_bounds__(256)
colstats_kernel(const float* __restrict__ t, int N, int K, float* __restrict__ mean,
                float* __restrict__ rstd) {
  __shared__ float red[8][32];
  __shared__ float mu_s[32];
  const int b = blockIdx.y, col = blockIdx.x * 32 + (threadIdx.x & 31), rl = threadIdx.x >> 5;
  const float* src = t + static_cast<size_t>(b) * N * K + col;
  float s = 0.f;
  for (int r = rl; r < N; r += 8) s += src[static_cast<size_t>(r) * K];
  red[rl][threadIdx.x & 31] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float tot = 0.f;
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    mu_s[threadIdx.x] = tot / N;
  }
  __syncthreads();
  const float mu = mu_s[threadIdx.x & 31];
  s = 0.f;
  for (int r = rl; r < N; r += 8) {
    const float dv = src[static_cast<size_t>(r) * K] - mu;
    s += dv * dv;
  }
  __syncthreads();
  red[rl][threadIdx.x & 31] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float tot = 0.f;
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    mean[static_cast<size_t>(b) * K + col] = mu;
    rstd[static_cast<size_t>(b) * K + col] = 1.f / sqrtf(tot / N + EPS_NORM);
  }
}

// ------------------------------------------------------- the sequence

// Pointer table order; the wrapper (ops/kernels/gats_block.py, PTRS) passes
// the same order.
enum Ptr {
  X2, X3, LEAVES, M2, M3, LEAFADD, WA,
  S_WQKV, S_BQKV, S_WM, S_BM, S_W0, S_B0, S_W1, S_B1,
  C_WQKV, C_BQKV, C_WM, C_BM, C_W0, C_B0, C_W1, C_B1,
  X2O, X3O,
  X3G, X2S, X3S, QKV2, QKV3, ATT, MSG, TBUF, KVPART, KV, SKPART, SK, MEAN, RSTD,
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

template <typename T>
void gemm(Run& run, AOperand a, const void* w, const float* bias, const float* resid, float* out,
          int ldo, int M, int N, int K) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<T><<<grid, GEMM_THREADS, 0, run.stream>>>(a, static_cast<const T*>(w), bias, resid,
                                                        out, ldo, M, N, K);
  run.check();
}

AOperand plain_a(const float* a, int lda, int K) {
  return AOperand{a, lda, K, nullptr, 0, nullptr, nullptr, 1};
}

// x_out = resid + MLP([xq, attn(xq <- keys)]) for one stream. qkv_q holds
// the query stream's q at column 0 (row stride 3C); qkv_k the key stream's
// k at column C and v at column 2C; set = S_WQKV or C_WQKV.
template <typename T>
void propagate(Run& run, const float* xq, int Nq, const float* qkv_q, const float* qkv_k,
               const float* mask_k, int Nk, int set, const float* resid, float* x_out) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int B = run.B, C = run.C, H = run.H, C3 = 3 * C;
  const int chunks = (Nk + CHUNK - 1) / CHUNK;
  kv_partial_kernel<BF16><<<dim3(chunks, H, B), 256, 0, run.stream>>>(
      qkv_k + C, qkv_k + 2 * C, C3, mask_k, Nk, C, chunks, run.f(KVPART), run.f(SKPART));
  run.check();
  kv_reduce_kernel<<<dim3(B * H, D * D / 256), 256, 0, run.stream>>>(run.f(KVPART), run.f(SKPART), C, chunks,
                                                  run.f(KV), run.f(SK));
  run.check();
  apply_kernel<BF16><<<dim3((Nq + CHUNK - 1) / CHUNK, H, B), 256, 0, run.stream>>>(
      qkv_q, C3, run.f(KV), run.f(SK), Nq, C, run.f(ATT));
  run.check();
  const int M = B * Nq;
  const int wm = set + (S_WM - S_WQKV), w0 = set + (S_W0 - S_WQKV), w1 = set + (S_W1 - S_WQKV);
  gemm<T>(run, plain_a(run.f(ATT), C, C), run.p[wm], run.f(wm + 1), nullptr, run.f(MSG), C, M, C,
          C);
  gemm<T>(run, AOperand{xq, C, C, run.f(MSG), C, nullptr, nullptr, 1}, run.p[w0], run.f(w0 + 1),
          nullptr, run.f(TBUF), 2 * C, M, 2 * C, 2 * C);
  colstats_kernel<<<dim3(2 * C / 32, B), 256, 0, run.stream>>>(run.f(TBUF), Nq, 2 * C,
                                                               run.f(MEAN), run.f(RSTD));
  run.check();
  gemm<T>(run, AOperand{run.f(TBUF), 2 * C, 2 * C, nullptr, 0, run.f(MEAN), run.f(RSTD), Nq},
          run.p[w1], run.f(w1 + 1), resid, x_out, C, M, C, 2 * C);
}

template <typename T>
int block(Run& run) {
  const int B = run.B, N2 = run.N2, N3 = run.N3, C = run.C;
  const float* m2 = run.f(M2);
  const float* m3 = run.f(M3);
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
// the wrapper for shapes); weights are [N][K] of T (bf16 if bf16 != 0,
// else fp32), everything else fp32. C = 64 * H; N2, N3 >= 1; L >= 0.
extern "C" int gats_block_launch(void* const* ptrs, int B, int N2, int N3, int L, int C, int H,
                                 float alpha, int bf16, cudaStream_t stream) {
  if (C != D * H || C % BN || C > 512 || B <= 0 || N2 <= 0 || N3 <= 0 || L < 0)
    return cudaErrorInvalidValue;
  Run run{ptrs, B, N2, N3, L, C, H, alpha, stream, 0};
  return bf16 ? block<__nv_bfloat16>(run) : block<float>(run);
}

// The block's GEMM alone, out [M, N] = T(a [M, K]) T(w [N, K])^T + bias, for
// timing beside a library GEMM. N a multiple of 64, K of 64 (bf16) or 32.
extern "C" int gats_block_gemm_launch(const float* a, const void* w, const float* bias, float* out,
                                      int M, int N, int K, int bf16, cudaStream_t stream) {
  if (M <= 0 || N % BN || K % (bf16 ? gemm_bk<__nv_bfloat16>() : gemm_bk<float>()))
    return cudaErrorInvalidValue;
  Run run{nullptr, 0, 0, 0, 0, 0, 0, 0.f, stream, 0};
  if (bf16)
    gemm<__nv_bfloat16>(run, plain_a(a, K, K), w, bias, nullptr, out, N, M, N, K);
  else
    gemm<float>(run, plain_a(a, K, K), w, bias, nullptr, out, N, M, N, K);
  return run.err;
}
