// K9: RANSAC-PnP over masked 2D-3D matches, batched over frames, as two
// kernels: `hypotheses` (launch A) and `score_refine` (launch B).
//
// Replaces no Pallas kernel. The JAX package compiles the whole of
// geometry/ransac.py::ransac_pnp into one XLA program; eager PyTorch has no
// counterpart of that, and the plain version (geometry/ransac.py::
// ransac_pnp_plain) runs as about 2400 kernels of a few microseconds each,
// launched one by one from the host, with two host syncs (two constants
// copied to the card in P3P's root finder). The host paced the serving call:
// RANSAC-PnP took two thirds of it while the card idled. This pair computes
// the same function stage by stage in fp32 in two launches and no sync.
//
// Bound on the H100: operations, about 0.71 GFLOP of fp32 at [64, 1000, 512]
// (portbench/counts.py::ransac_pnp), 0.0106 ms at 67 TFLOP/s. The work is so
// small that the kernels are latency-bound: long serial chains (40
// Durand-Kerner steps, 4 Newton steps, 5 Gauss-Newton steps with a 6 x 6
// solve) in a few thousand threads. The design spreads the independent work
// over as many threads as there are and keeps every chain in registers or
// shared memory.
//
// Launch A (stages 1 to 3), grid [ceil(4H / 256), B], 256 threads a block:
// one thread a candidate pose, the four roots of a sample in four adjacent
// lanes (64 samples a block; 512 blocks for [64, 1000, 512], where one
// block a frame would leave half the 132 SMs idle). Each block
//   1. builds the frame's valid-first order as a bit set (a ballot a warp,
//      32 matches a word) with the exclusive prefix of its popcounts (a block
//      scan), so the r-th valid match is a binary search and a bit select:
//      the valid indices in index order, as the plain version's stable
//      argsort of ~mask, without storing the order (2 words per 32 matches
//      of shared memory);
//   2. loads the first min(128, n_valid) valid matches into shared memory
//      (the preemptive subset, 2.5 KB), and takes each sample's indices from
//      the draws as `_sample_minimal_sets` does (with replacement, clamped to
//      n_valid - 1, index 0 for a frame with no valid match);
//   3. solves P3P as `p3p_solve` does: bearings, Grunert's quartic with
//      `polymul`'s sums in its order, 40 Durand-Kerner steps in complex
//      arithmetic on float pairs (c10's formulas: (ac - bd, ad + bc), and
//      Smith's division), the roots' differences read from the other three
//      lanes by shuffles, the two guards (|c4| < 1e-10, |denom| < 1e-12);
//      then is_real, 4 Newton steps with the adjugate 3 x 3 solve and its
//      1e-20 guard, the two triads, and ok (positive depths, finite pose,
//      a real root, three distinct matches);
//   4. counts each candidate's inliers on the subset, times ok
//      (`_preemptive_keep`), and writes the pose (R row-major, t) and its
//      (count, ok) to scratch.
// Launch B (stages 4 to 6), one block of 512 threads a frame:
//   1. keeps the best min(64, 4H) candidates by a stable descending rank of
//      the counts (integers in [0, 128]): a histogram gives the smallest
//      count T that is kept; the fewer than 64 above T are ranked pairwise
//      (count, then index), those equal to T are taken in index order by a
//      block scan until the keep is full. This is torch.sort(stable=True)
//      exactly, lowest index first among equal counts;
//   2. scores the kept poses on every match (a ballot a warp a pose), takes
//      the first maximum of count times ok, and writes its inlier mask
//      without ok (`_score_kept`: a failed P3P pose can be a frame's best);
//   3. refines as `_gn_refine` does: 5 Gauss-Newton steps on (angle-axis, t)
//      from the best pose, the residuals and the closed-form Jacobian of
//      `_residuals_and_jacobian` (Gallego-Yezzi with its 1e-8 branch), J^T J
//      + 1e-6 I and J^T r over the inliers as block sums (27 a step: a warp
//      sum, then one thread a sum over the warps), and an LU with partial
//      pivoting on one thread (a singular system gives non-finite steps and
//      no error, as `solve_ex` with check_errors=False);
//   4. writes pose, R, t, inliers, num_inliers and ok as `pnp.final` does,
//      t divided by the scale (the points are scaled on load).
// With epnp_refit, launch B runs twice: mode 1 stops after its step 2 and
// writes the best pose, the inlier mask and the count; the EPnP choice runs
// in PyTorch on the card; mode 2 starts at step 3 from the chosen pose.
//
// Rounding. The build passes -fmad=false for this file (ops/kernels/
// _build.py: EXTRA_FLAGS): every product and sum is rounded on its own, as
// the plain version's elementwise tensor ops round them, where contraction
// into FMAs would change sums that it rounds twice (the quartic's
// coefficients, the Durand-Kerner steps, the reprojections that decide
// inliers at the threshold). Sums over a small axis (norms, dot products,
// 3 x 3 products) run in index order. Division and sqrt are IEEE (no fast
// math); sin, cos and atan2 are CUDA's accurate versions. Sums over the
// matches (the Gauss-Newton normal equations) run in another order than
// the plain version's BLAS, so poses agree to rounding, not bit for bit.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadsA = 256;  // 64 samples x their 4 roots
constexpr int kThreadsB = 512;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kSub = 128;   // matches of the preemptive subset
constexpr int kKeep = 64;   // candidates kept for the second scoring
constexpr int kPose = 12;   // R row-major (9), then t (3)
constexpr int kRoots = 4;
constexpr int kDurandKerner = 40;
constexpr int kNewton = 4;
constexpr int kSums = 27;   // the upper triangle of J^T J (21) and J^T r (6)

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < CUDART_INF_F; }
// torch.clamp(min=lo) and torch.maximum: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || is_nan(a)) ? a : b;
}
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}
__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

struct cf {
  float r, i;
};
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
// c10::complex's division (numpy's, Smith's algorithm).
__device__ __forceinline__ cf cdiv(cf a, cf b) {
  const float c = b.r, d = b.i;
  const float ac = fabsf(c), ad = fabsf(d);
  if (ac >= ad) {
    if (ac == 0.0f && ad == 0.0f) return {a.r / ac, a.i / ad};
    const float rat = d / c;
    const float scl = 1.0f / (c + d * rat);
    return {(a.r + a.i * rat) * scl, (a.i - a.r * rat) * scl};
  }
  const float rat = c / d;
  const float scl = 1.0f / (d + c * rat);
  return {(a.r * rat + a.i) * scl, (a.i * rat - a.r) * scl};
}

// Exclusive prefix sum of one int a thread over a block of NT threads; the
// block's total in `total`. Every thread of the block calls it.
template <int NT>
__device__ int block_scan(int v, int* tmp, int& total) {
  constexpr int W = NT / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < W ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < W) tmp[lane] = t;
  }
  __syncthreads();
  total = tmp[W - 1];
  const int out = (w > 0 ? tmp[w - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

// Index of the r-th valid match (0-based, r < n_valid): the last word whose
// prefix is <= r holds it; then the (r - prefix)-th set bit of that word.
__device__ __forceinline__ int select_valid(const uint32_t* words, const uint32_t* pre, int nw,
                                            int r) {
  int lo = 0, hi = nw - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<int>(pre[mid]) <= r) lo = mid;
    else hi = mid - 1;
  }
  uint32_t bits = words[lo];
  for (int k = r - static_cast<int>(pre[lo]); k > 0; --k) bits &= bits - 1;
  return lo * 32 + __ffs(bits) - 1;
}

// `_reproj_err(...) < thr` of the scaled world point P at pixel (px, py)
// under pose (R row-major, t) and K [3][3] row-major; inf (not an inlier)
// at z <= 1e-6.
__device__ __forceinline__ bool is_inlier(const float* pose, const float* K, const float* P,
                                          float px, float py, float thr) {
  float pc[3], pix[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = ((P[0] * pose[3 * i] + P[1] * pose[3 * i + 1]) + P[2] * pose[3 * i + 2]) +
            pose[9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pix[i] = (pc[0] * K[3 * i] + pc[1] * K[3 * i + 1]) + pc[2] * K[3 * i + 2];
  const float z = pix[2];
  const float zc = clamp_min(fabsf(z), 1e-9f);
  const float du = pix[0] / zc - px, dv = pix[1] / zc - py;
  const float err = sqrtf(du * du + dv * dv);
  return z > 1e-6f && err < thr;
}

// Coefficients of p * q (lengths np and nq) in out[0 .. np + nq - 2], summed
// as `polymul` sums them: i outer, j inner, from zero.
template <int NP, int NQ, int NO>
__device__ __forceinline__ void polymul(const float* p, const float* q, float* out) {
#pragma unroll
  for (int k = 0; k < NO; ++k) out[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NQ; ++j) out[i + j] = out[i + j] + p[i] * q[j];
}

// `_solve3x3`: A^-1 b by the adjugate, det clamped to 1e-20.
__device__ __forceinline__ void solve3(const float A[3][3], const float* b, float* x) {
  const float c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
  const float c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
  const float c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
  float det = (A[0][0] * c00 + A[0][1] * c01) + A[0][2] * c02;
  if (fabsf(det) < 1e-20f) det = 1e-20f;
  const float c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2];
  const float c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0];
  const float c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1];
  const float c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1];
  const float c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2];
  const float c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0];
  x[0] = ((c00 * b[0] + c10 * b[1]) + c20 * b[2]) / det;
  x[1] = ((c01 * b[0] + c11 * b[1]) + c21 * b[2]) / det;
  x[2] = ((c02 * b[0] + c12 * b[1]) + c22 * b[2]) / det;
}

// `_triad`: the columns e1, e2, e3 of T (T[row][col]).
__device__ __forceinline__ void triad(const float* p1, const float* p2, const float* p3,
                                      float T[3][3]) {
  float e1[3], d13[3], n[3], e2[3], e3[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) e1[k] = p2[k] - p1[k];
  const float n1 = clamp_min(norm3(e1[0], e1[1], e1[2]), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = e1[k] / n1;
    d13[k] = p3[k] - p1[k];
  }
  cross3(e1, d13, n);
  const float nn = clamp_min(norm3(n[0], n[1], n[2]), 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) e3[k] = n[k] / nn;
  cross3(e3, e1, e2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T[k][0] = e1[k];
    T[k][1] = e2[k];
    T[k][2] = e3[k];
  }
}

// P3P (`p3p_solve`) of one sample for the root this lane owns: the four
// lanes of a sample run the Durand-Kerner steps together. P [3][3] scaled
// world points, v [3][3] unit bearings. Writes the pose and returns ok
// (without the sample's distinctness).
__device__ bool p3p_root(const float P[3][3], const float v[3][3], int root, float* pose) {
  const float a = norm3(P[1][0] - P[2][0], P[1][1] - P[2][1], P[1][2] - P[2][2]);
  const float b = clamp_min(norm3(P[0][0] - P[2][0], P[0][1] - P[2][1], P[0][2] - P[2][2]), 1e-9f);
  const float c = norm3(P[0][0] - P[1][0], P[0][1] - P[1][1], P[0][2] - P[1][2]);
  const float cos_a = dot3(v[1], v[2]);
  const float cos_b = dot3(v[0], v[2]);
  const float cos_g = dot3(v[0], v[1]);
  const float a2b = (a * a) / (b * b);
  const float c2b = (c * c) / (b * b);
  const float acb = a2b - c2b;
  const float Nc[3] = {1.0f + acb, (-2.0f * acb) * cos_b, acb - 1.0f};
  const float Dc[2] = {2.0f * cos_g, -2.0f * cos_a};
  const float Qc[3] = {1.0f - c2b, (2.0f * c2b) * cos_b, -c2b};
  float nn[5], dd[3], ddq[5], nd[4], poly[5];
  polymul<3, 3, 5>(Nc, Nc, nn);
  polymul<2, 2, 3>(Dc, Dc, dd);
  polymul<3, 3, 5>(dd, Qc, ddq);
  polymul<3, 2, 4>(Nc, Dc, nd);
  const float g2 = 2.0f * cos_g;
#pragma unroll
  for (int i = 0; i < 5; ++i) poly[i] = (nn[i] + ddq[i]) - g2 * (i < 4 ? nd[i] : 0.0f);

  // `_solve_quartic`: monic coefficients, the seeds (0.4 + 0.9i)^k times the bound.
  float c4 = poly[4];
  if (fabsf(c4) < 1e-10f) c4 = 1e-10f;
  const float b3 = poly[3] / c4, b2 = poly[2] / c4, b1 = poly[1] / c4, b0 = poly[0] / c4;
  const float bound =
      1.0f + max_nan(max_nan(fabsf(b3), fabsf(b2)), max_nan(fabsf(b1), fabsf(b0)));
  // complex64((0.4 + 0.9j) ** k), k = 0 .. 3
  const float seed_r[4] = {1.0f, 0x1.99999ap-2f, -0x1.4cccccp-1f, -0x1.d0e56p-1f};
  const float seed_i[4] = {0.0f, 0x1.ccccccp-1f, 0x1.70a3d8p-1f, -0x1.3020c4p-2f};
  cf x = cmul(cf{seed_r[root], seed_i[root]}, cf{bound, 0.0f});
  for (int it = 0; it < kDurandKerner; ++it) {
    cf den{1.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kRoots; ++k) {
      const cf xk{__shfl_sync(kFull, x.r, k, kRoots), __shfl_sync(kFull, x.i, k, kRoots)};
      const cf d{(x.r - xk.r) + (k == root ? 1.0f : 0.0f), (x.i - xk.i) + 0.0f};
      den = k == 0 ? d : cmul(den, d);
    }
    if (hypotf(den.r, den.i) < 1e-12f) den = cf{1e-12f, 0.0f};
    cf px = cmul(cadd(x, cf{b3, 0.0f}), x);
    px = cmul(cadd(px, cf{b2, 0.0f}), x);
    px = cmul(cadd(px, cf{b1, 0.0f}), x);
    px = cadd(px, cf{b0, 0.0f});
    x = csub(x, cdiv(px, den));
  }
  const bool is_real = fabsf(x.i) < 1e-3f * (1.0f + fabsf(x.r));
  const float vr = x.r;

  // Distances from the root, then the Newton polish.
  float du = 2.0f * (cos_g - vr * cos_a);
  if (fabsf(du) < 1e-9f) du = 1e-9f;
  const float u = (((((-1.0f + acb) * vr) * vr - ((2.0f * acb) * cos_b) * vr) + 1.0f) + acb) / du;
  const float s1 = sqrtf((b * b) / clamp_min((vr * vr - (2.0f * vr) * cos_b) + 1.0f, 1e-12f));
  float s[3] = {s1, u * s1, vr * s1};
  for (int it = 0; it < kNewton; ++it) {
    const float F[3] = {
        -(((s[0] * s[0] + s[1] * s[1]) - ((2.0f * s[0]) * s[1]) * cos_g) - c * c),
        -(((s[0] * s[0] + s[2] * s[2]) - ((2.0f * s[0]) * s[2]) * cos_b) - b * b),
        -(((s[1] * s[1] + s[2] * s[2]) - ((2.0f * s[1]) * s[2]) * cos_a) - a * a)};
    float A[3][3] = {
        {2.0f * (s[0] - s[1] * cos_g), 2.0f * (s[1] - s[0] * cos_g), 0.0f},
        {2.0f * (s[0] - s[2] * cos_b), 0.0f, 2.0f * (s[2] - s[0] * cos_b)},
        {0.0f, 2.0f * (s[1] - s[2] * cos_a), 2.0f * (s[2] - s[1] * cos_a)}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = A[i][j] + (i == j ? 1e-9f : 0.0f);
    float ds[3];
    solve3(A, F, ds);
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = s[k] + ds[k];
  }

  // Rigid alignment of the world triad to the camera triad.
  float C[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int d = 0; d < 3; ++d) C[k][d] = s[k] * v[k][d];
  float Tw[3][3], Tc[3][3];
  triad(P[0], P[1], P[2], Tw);
  triad(C[0], C[1], C[2], Tc);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      pose[3 * i + j] = (Tc[i][0] * Tw[j][0] + Tc[i][1] * Tw[j][1]) + Tc[i][2] * Tw[j][2];
      finite = finite && is_finite(pose[3 * i + j]);
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pose[9 + i] = C[0][i] - ((pose[3 * i] * P[0][0] + pose[3 * i + 1] * P[0][1]) +
                             pose[3 * i + 2] * P[0][2]);
    finite = finite && is_finite(pose[9 + i]);
  }
  return s[0] > 0.0f && s[1] > 0.0f && s[2] > 0.0f && finite && is_real;
}

// `angle_axis_to_rotmat` (row-major R); first order below 1e-8 rad.
__device__ void angle_axis_to_rotmat(const float* aa, float* R) {
  const float theta = norm3(aa[0], aa[1], aa[2]);
  if (theta < 1e-8f) {
    const float Rs[9] = {1.0f, -aa[2], aa[1], aa[2], 1.0f, -aa[0], -aa[1], aa[0], 1.0f};
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = Rs[i];
    return;
  }
  const float x = aa[0] / theta, y = aa[1] / theta, z = aa[2] / theta;
  const float c = cosf(theta), s = sinf(theta);
  const float C = 1.0f - c;
  R[0] = c + (x * x) * C;
  R[1] = (x * y) * C - z * s;
  R[2] = (x * z) * C + y * s;
  R[3] = (y * x) * C + z * s;
  R[4] = c + (y * y) * C;
  R[5] = (y * z) * C - x * s;
  R[6] = (z * x) * C - y * s;
  R[7] = (z * y) * C + x * s;
  R[8] = c + (z * z) * C;
}

// `rotmat_to_angle_axis` through `rotmat_to_qvec` (Shepperd, first largest
// pivot, w >= 0).
__device__ void rotmat_to_angle_axis(const float* m, float* aa) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5],
              m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = (m00 + m11) + m22;
  float qw[4] = {1.0f + tr, ((1.0f + m00) - m11) - m22, ((1.0f + m11) - m00) - m22,
                 ((1.0f + m22) - m00) - m11};
#pragma unroll
  for (int k = 0; k < 4; ++k) qw[k] = sqrtf(clamp_min(qw[k], 1e-12f)) / 2.0f;
  int pick = 0;  // argmax: the first maximum, a NaN counting as the largest
  for (int k = 1; k < 4 && !is_nan(qw[pick]); ++k)
    if (is_nan(qw[k]) || qw[k] > qw[pick]) pick = k;
  const float w0 = qw[0], x1 = qw[1], y2 = qw[2], z3 = qw[3];
  float q[4];
  if (pick == 0) {
    q[0] = w0; q[1] = (m21 - m12) / (4.0f * w0); q[2] = (m02 - m20) / (4.0f * w0);
    q[3] = (m10 - m01) / (4.0f * w0);
  } else if (pick == 1) {
    q[0] = (m21 - m12) / (4.0f * x1); q[1] = x1; q[2] = (m01 + m10) / (4.0f * x1);
    q[3] = (m02 + m20) / (4.0f * x1);
  } else if (pick == 2) {
    q[0] = (m02 - m20) / (4.0f * y2); q[1] = (m01 + m10) / (4.0f * y2); q[2] = y2;
    q[3] = (m12 + m21) / (4.0f * y2);
  } else {
    q[0] = (m10 - m01) / (4.0f * z3); q[1] = (m02 + m20) / (4.0f * z3);
    q[2] = (m12 + m21) / (4.0f * z3); q[3] = z3;
  }
  const float qn = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / qn;
  if (q[0] < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
  }
  const float w = q[0] < -1.0f ? -1.0f : (q[0] > 1.0f ? 1.0f : q[0]);
  const float vn = norm3(q[1], q[2], q[3]);
  const float theta = 2.0f * atan2f(vn, w);
  const float scale = vn < 1e-12f ? 2.0f : theta / clamp_min(vn, 1e-12f);
#pragma unroll
  for (int k = 0; k < 3; ++k) aa[k] = q[k + 1] * scale;
}

// `_rotmat_derivatives`: dR/daa_i [i][row][col] at aa, with R.
__device__ void rotmat_derivatives(const float* aa, const float* R, float dR[3][3][3]) {
  const float theta2 = (aa[0] * aa[0] + aa[1] * aa[1]) + aa[2] * aa[2];
  const bool small = sqrtf(theta2) < 1e-8f;
  const float S[3][3] = {{0.0f, -aa[2], aa[1]}, {aa[2], 0.0f, -aa[0]}, {-aa[1], aa[0], 0.0f}};
  for (int i = 0; i < 3; ++i) {
    if (small) {  // [e_i]x
      const float e[3] = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f};
      const float Se[3][3] = {{0.0f, -e[2], e[1]}, {e[2], 0.0f, -e[0]}, {-e[1], e[0], 0.0f}};
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) dR[i][r][c] = Se[r][c];
      continue;
    }
    float col[3], cr[3];  // column i of I - R, and aa x it
    for (int r = 0; r < 3; ++r) col[r] = (r == i ? 1.0f : 0.0f) - R[3 * r + i];
    cross3(aa, col, cr);
    const float Sc[3][3] = {{0.0f, -cr[2], cr[1]}, {cr[2], 0.0f, -cr[0]}, {-cr[1], cr[0], 0.0f}};
    float A[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) A[r][c] = aa[i] * S[r][c] + Sc[r][c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        dR[i][r][c] = ((A[r][0] * R[c] + A[r][1] * R[3 + c]) + A[r][2] * R[6 + c]) / theta2;
  }
}

// One match's residuals r [2] and Jacobian rows J [2][6] at x = (aa, t), as
// `_residuals_and_jacobian` with weight 1 (a match of weight 0 adds zeros).
__device__ __forceinline__ void residual_jacobian(const float* R, const float dR[3][3][3],
                                                  const float* t, const float* K, const float* P,
                                                  float px, float py, float r[2], float J[2][6]) {
  float pc[3], pix[3], M[3][6], dpix[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = ((P[0] * R[3 * i] + P[1] * R[3 * i + 1]) + P[2] * R[3 * i + 2]) + t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pix[i] = (pc[0] * K[3 * i] + pc[1] * K[3 * i + 1]) + pc[2] * K[3 * i + 2];
  const float z = pix[2];
  const float zc = clamp_min(fabsf(z), 1e-9f);
  r[0] = pix[0] / zc - px;
  r[1] = pix[1] / zc - py;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      M[k][i] = (dR[i][k][0] * P[0] + dR[i][k][1] * P[1]) + dR[i][k][2] * P[2];
#pragma unroll
    for (int q = 0; q < 3; ++q) M[k][3 + q] = k == q ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int c = 0; c < 6; ++c)
      dpix[rr][c] = (K[3 * rr] * M[0][c] + K[3 * rr + 1] * M[1][c]) + K[3 * rr + 2] * M[2][c];
  const float sg = fabsf(z) > 1e-9f ? (z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f)) : 0.0f;
  const float zz = zc * zc;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float dz = sg * dpix[2][c];
    J[0][c] = (dpix[0][c] * zc - pix[0] * dz) / zz;
    J[1][c] = (dpix[1][c] * zc - pix[1] * dz) / zz;
  }
}

// x = A^-1 b for a 6 x 6 system: LU with partial pivoting (the first largest
// pivot), a zero pivot left in place, so a singular A gives non-finite x.
__device__ void lu_solve6(float A[6][6], float* b, float* x) {
  for (int j = 0; j < 6; ++j) {
    int p = j;
    float big = fabsf(A[j][j]);
    for (int i = j + 1; i < 6; ++i)
      if (fabsf(A[i][j]) > big) {
        big = fabsf(A[i][j]);
        p = i;
      }
    if (p != j) {
      for (int k = 0; k < 6; ++k) {
        const float tmp = A[j][k];
        A[j][k] = A[p][k];
        A[p][k] = tmp;
      }
      const float tb = b[j];
      b[j] = b[p];
      b[p] = tb;
    }
    const float piv = A[j][j];
    if (piv == 0.0f) continue;
    for (int i = j + 1; i < 6; ++i) {
      const float l = A[i][j] / piv;
      A[i][j] = l;
      for (int k = j + 1; k < 6; ++k) A[i][k] = A[i][k] - l * A[j][k];
      b[i] = b[i] - l * b[j];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
    for (int k = i + 1; k < 6; ++k) s = s - A[i][k] * x[k];
    x[i] = s / A[i][i];
  }
}

// Launch A: stages 1 to 3. poses [B, 4H, 12], counts [B, 4H, 2] (count, ok).
__global__ void __launch_bounds__(kThreadsA)
hypotheses(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
           const float* __restrict__ Kmat, const uint8_t* __restrict__ mask,
           const float* __restrict__ draws, int N, int H, float thr, float scale,
           float* __restrict__ poses, int* __restrict__ counts) {
  extern __shared__ uint32_t bitset[];  // words [nw], their exclusive prefix [nw]
  __shared__ float sub2[kSub][2];
  __shared__ float sub3[kSub][3];
  __shared__ int scan_tmp[32];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int nw = (N + 31) >> 5;
  uint32_t* words = bitset;
  uint32_t* pre = bitset + nw;
  const uint8_t* m = mask + static_cast<size_t>(b) * N;
  const float* p2 = pts2d + static_cast<size_t>(b) * N * 2;
  const float* p3 = pts3d + static_cast<size_t>(b) * N * 3;

  for (int w = tid >> 5; w < nw; w += kThreadsA / 32) {
    const int j = (w << 5) + lane;
    const uint32_t bits = __ballot_sync(kFull, j < N && m[j] != 0);
    if (lane == 0) words[w] = bits;
  }
  __syncthreads();
  int n_valid = 0;
  for (int base = 0; base < nw; base += kThreadsA) {
    const int w = base + tid;
    int total;
    const int ex = block_scan<kThreadsA>(w < nw ? __popc(words[w]) : 0, scan_tmp, total);
    if (w < nw) pre[w] = n_valid + ex;
    n_valid += total;
  }
  __syncthreads();

  const int n_sub = min(min(kSub, N), n_valid);
  for (int j = tid; j < n_sub; j += kThreadsA) {
    const int i = select_valid(words, pre, nw, j);
    sub2[j][0] = p2[2 * i];
    sub2[j][1] = p2[2 * i + 1];
#pragma unroll
    for (int d = 0; d < 3; ++d) sub3[j][d] = p3[3 * i + d] * scale;
  }
  __syncthreads();

  // One candidate a thread: sample h, root `root`. Lanes past the last
  // sample repeat it (the shuffles need every lane) and write nothing.
  const int cand = blockIdx.x * kThreadsA + tid;
  const int h = min(cand / kRoots, H - 1);
  const int root = tid & (kRoots - 1);
  float K[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) K[i] = Kmat[static_cast<size_t>(b) * 9 + i];
  const float nf = static_cast<float>(max(n_valid, 1));
  int idx[3];
  float P[3][3], v[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = draws[(static_cast<size_t>(b) * H + h) * 3 + k];
    const int r = max(min(static_cast<int>(d * nf), max(n_valid - 1, 0)), 0);
    idx[k] = n_valid > 0 ? select_valid(words, pre, nw, r) : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) P[k][c] = p3[3 * idx[k] + c] * scale;
    const float x = (p2[2 * idx[k]] - K[2]) / K[0];
    const float y = (p2[2 * idx[k] + 1] - K[5]) / K[4];
    const float n = sqrtf((x * x + y * y) + 1.0f);
    v[k][0] = x / n;
    v[k][1] = y / n;
    v[k][2] = 1.0f / n;
  }
  const bool distinct = idx[0] != idx[1] && idx[0] != idx[2] && idx[1] != idx[2];
  float pose[kPose];
  const bool ok = p3p_root(P, v, root, pose) && distinct;

  int count = 0;
  for (int j = 0; j < n_sub; ++j) count += is_inlier(pose, K, sub3[j], sub2[j][0], sub2[j][1], thr);
  if (cand / kRoots < H) {
    const size_t at = static_cast<size_t>(b) * kRoots * H + cand;
#pragma unroll
    for (int i = 0; i < kPose; ++i) poses[at * kPose + i] = pose[i];
    counts[2 * at] = ok ? count : 0;
    counts[2 * at + 1] = ok;
  }
}

// Launch B: stages 4 to 6, one block a frame. mode 0 all of them; mode 1
// the second scoring only (writes start [B, 12], inl [B, N], n_in [B]);
// mode 2 the refine and the final stage from start, inl and n_in.
__global__ void __launch_bounds__(kThreadsB)
score_refine(const float* __restrict__ poses, const int* __restrict__ counts,
             const float* __restrict__ pts2d, const float* __restrict__ pts3d,
             const float* __restrict__ Kmat, const uint8_t* __restrict__ mask, int N, int H,
             float thr, float scale, int iters, int mode, float* start, uint8_t* inl,
             int* n_in, float* __restrict__ pose_out, float* __restrict__ R_out,
             float* __restrict__ t_out, uint8_t* __restrict__ inliers_out,
             long long* __restrict__ num_out, uint8_t* __restrict__ ok_out) {
  __shared__ int hist[kSub + 1];
  __shared__ int keep[kKeep];
  __shared__ int big_idx[kKeep], big_cnt[kKeep];
  __shared__ float kpose[kKeep][kPose];
  __shared__ int kok[kKeep], kcnt[kKeep];
  __shared__ int scan_tmp[32];
  __shared__ int s_T, s_m, s_nbig, s_count, s_final;
  __shared__ float K[9];
  __shared__ float s_pose[kPose];
  __shared__ float sx[6], sdR[3][3][3];
  __shared__ float red[kWarpsB][kSums];
  __shared__ float sHg[kSums];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H4 = kRoots * H, n_keep = min(kKeep, H4);
  const uint8_t* m = mask + static_cast<size_t>(b) * N;
  const float* p2 = pts2d + static_cast<size_t>(b) * N * 2;
  const float* p3 = pts3d + static_cast<size_t>(b) * N * 3;
  uint8_t* fl = inl + static_cast<size_t>(b) * N;
  if (tid < 9) K[tid] = Kmat[static_cast<size_t>(b) * 9 + tid];

  if (mode != 2) {
    // Stage 4a: the stable top n_keep of the preemptive counts.
    const int* cb = counts + static_cast<size_t>(b) * H4 * 2;
    for (int i = tid; i <= kSub; i += kThreadsB) hist[i] = 0;
    if (tid == 0) s_nbig = 0;
    __syncthreads();
    for (int c = tid; c < H4; c += kThreadsB) atomicAdd(&hist[cb[2 * c]], 1);
    __syncthreads();
    if (tid == 0) {
      int cum = 0, v = kSub;
      for (; v > 0; --v) {
        if (cum + hist[v] >= n_keep) break;
        cum += hist[v];
      }
      s_T = v;
      s_m = cum;
    }
    __syncthreads();
    const int T = s_T, above = s_m;
    for (int c = tid; c < H4; c += kThreadsB) {
      const int v = cb[2 * c];
      if (v > T) {
        const int k = atomicAdd(&s_nbig, 1);
        big_idx[k] = c;
        big_cnt[k] = v;
      }
    }
    __syncthreads();
    if (tid < above) {
      const int v = big_cnt[tid], c = big_idx[tid];
      int rank = 0;
      for (int j = 0; j < above; ++j)
        rank += big_cnt[j] > v || (big_cnt[j] == v && big_idx[j] < c);
      keep[rank] = c;
    }
    const int need = n_keep - above;
    for (int base = 0, taken = 0; base < H4 && taken < need; base += kThreadsB) {
      const int c = base + tid;
      const int f = c < H4 && cb[2 * c] == T;
      int total;
      const int pos = block_scan<kThreadsB>(f, scan_tmp, total);
      if (f && taken + pos < need) keep[above + taken + pos] = c;
      taken += total;
    }
    __syncthreads();
    for (int e = tid; e < n_keep * kPose; e += kThreadsB) {
      const int k = e / kPose;
      kpose[k][e % kPose] = poses[(static_cast<size_t>(b) * H4 + keep[k]) * kPose + e % kPose];
    }
    if (tid < n_keep) {
      kok[tid] = cb[2 * keep[tid] + 1];
      kcnt[tid] = 0;
    }
    __syncthreads();

    // Stage 4b: the kept poses on every match; the first best.
    for (int j0 = 0; j0 < N; j0 += kThreadsB) {
      const int j = j0 + tid;
      const bool valid = j < N && m[j] != 0;
      float P[3] = {0.0f, 0.0f, 0.0f}, px = 0.0f, py = 0.0f;
      if (j < N) {
#pragma unroll
        for (int d = 0; d < 3; ++d) P[d] = p3[3 * j + d] * scale;
        px = p2[2 * j];
        py = p2[2 * j + 1];
      }
      for (int k = 0; k < n_keep; ++k) {
        const unsigned bal =
            __ballot_sync(kFull, valid && is_inlier(kpose[k], K, P, px, py, thr));
        if (lane == 0 && bal) atomicAdd(&kcnt[k], __popc(bal));
      }
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0, top = kcnt[0] * kok[0];
      for (int k = 1; k < n_keep; ++k)
        if (kcnt[k] * kok[k] > top) {
          best = k;
          top = kcnt[k] * kok[k];
        }
      s_count = top;
      for (int i = 0; i < kPose; ++i) s_pose[i] = kpose[best][i];
    }
    __syncthreads();
    for (int j = tid; j < N; j += kThreadsB) {
      float P[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) P[d] = p3[3 * j + d] * scale;
      fl[j] = m[j] != 0 && is_inlier(s_pose, K, P, p2[2 * j], p2[2 * j + 1], thr);
    }
    if (mode == 1) {
      if (tid < kPose) start[static_cast<size_t>(b) * kPose + tid] = s_pose[tid];
      if (tid == 0) n_in[b] = s_count;
      return;
    }
  } else {
    if (tid < kPose) s_pose[tid] = start[static_cast<size_t>(b) * kPose + tid];
    if (tid == 0) s_count = n_in[b];
  }
  __syncthreads();

  // Stage 5: Gauss-Newton on (angle-axis, t) over the inliers.
  if (tid == 0) {
    rotmat_to_angle_axis(s_pose, sx);
    for (int i = 0; i < 3; ++i) sx[3 + i] = s_pose[9 + i];
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (tid == 0) {
      angle_axis_to_rotmat(sx, s_pose);
      rotmat_derivatives(sx, s_pose, sdR);
    }
    __syncthreads();
    float acc[kSums];
#pragma unroll
    for (int e = 0; e < kSums; ++e) acc[e] = 0.0f;
    for (int j = tid; j < N; j += kThreadsB) {
      if (!fl[j]) continue;
      float P[3], r[2], J[2][6];
#pragma unroll
      for (int d = 0; d < 3; ++d) P[d] = p3[3 * j + d] * scale;
      residual_jacobian(s_pose, sdR, sx + 3, K, P, p2[2 * j], p2[2 * j + 1], r, J);
      int e = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = a; c < 6; ++c, ++e) {
          acc[e] = acc[e] + J[0][a] * J[0][c];
          acc[e] = acc[e] + J[1][a] * J[1][c];
        }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        acc[21 + a] = acc[21 + a] + J[0][a] * r[0];
        acc[21 + a] = acc[21 + a] + J[1][a] * r[1];
      }
    }
#pragma unroll
    for (int e = 0; e < kSums; ++e) {
      const float s = warp_sum(acc[e]);
      if (lane == 0) red[warp][e] = s;
    }
    __syncthreads();
    if (tid < kSums) {
      float s = 0.0f;
      for (int w = 0; w < kWarpsB; ++w) s = s + red[w][tid];
      sHg[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      float A[6][6], rhs[6], dx[6];
      int e = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++e) A[a][c] = A[c][a] = sHg[e];
      for (int a = 0; a < 6; ++a) {
        A[a][a] = A[a][a] + 1e-6f;
        rhs[a] = -sHg[21 + a];
      }
      lu_solve6(A, rhs, dx);
      for (int a = 0; a < 6; ++a) sx[a] = sx[a] + dx[a];
    }
    __syncthreads();
  }

  // Stage 6: the final inliers and the pose.
  if (tid == 0) {
    angle_axis_to_rotmat(sx, s_pose);
    for (int i = 0; i < 3; ++i) s_pose[9 + i] = sx[3 + i];
    s_final = 0;
  }
  __syncthreads();
  const bool ok = s_count >= 4;
  for (int j0 = 0; j0 < N; j0 += kThreadsB) {
    const int j = j0 + tid;
    bool in = false;
    if (j < N && m[j] != 0) {
      float P[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) P[d] = p3[3 * j + d] * scale;
      in = is_inlier(s_pose, K, P, p2[2 * j], p2[2 * j + 1], thr);
    }
    const unsigned bal = __ballot_sync(kFull, in);
    if (lane == 0 && bal) atomicAdd(&s_final, __popc(bal));
    if (j < N) inliers_out[static_cast<size_t>(b) * N + j] = in && ok;
  }
  __syncthreads();
  if (tid == 0) {
    float* pose = pose_out + static_cast<size_t>(b) * 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const float r = ok ? s_pose[3 * i + j] : (i == j ? 1.0f : 0.0f);
        R_out[static_cast<size_t>(b) * 9 + 3 * i + j] = r;
        pose[4 * i + j] = r;
      }
      const float tv = ok ? s_pose[9 + i] / scale : 0.0f;
      t_out[static_cast<size_t>(b) * 3 + i] = tv;
      pose[4 * i + 3] = tv;
      pose[12 + i] = 0.0f;
    }
    pose[15] = 1.0f;
    num_out[b] = ok ? s_final : 0;
    ok_out[b] = ok;
  }
}

}  // namespace

extern "C" int ransac_pnp_hypotheses_launch(const float* pts2d, const float* pts3d,
                                            const float* K, const unsigned char* mask,
                                            const float* draws, int B, int N, int H, float thr,
                                            float scale, float* poses, int* counts,
                                            void* stream) {
  const size_t smem = 2 * static_cast<size_t>((N + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hypotheses, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((kRoots * H + kThreadsA - 1) / kThreadsA, B);
  hypotheses<<<grid, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      pts2d, pts3d, K, mask, draws, N, H, thr, scale, poses, counts);
  return cudaGetLastError();
}

extern "C" int ransac_pnp_refine_launch(const float* poses, const int* counts, const float* pts2d,
                                        const float* pts3d, const float* K,
                                        const unsigned char* mask, int B, int N, int H, float thr,
                                        float scale, int iters, int mode, float* start,
                                        unsigned char* inl, int* n_in, float* pose, float* R,
                                        float* t, unsigned char* inliers, long long* num_inliers,
                                        unsigned char* ok, void* stream) {
  score_refine<<<B, kThreadsB, 0, static_cast<cudaStream_t>(stream)>>>(
      poses, counts, pts2d, pts3d, K, mask, N, H, thr, scale, iters, mode, start, inl, n_in,
      pose, R, t, inliers, num_inliers, ok);
  return cudaGetLastError();
}
