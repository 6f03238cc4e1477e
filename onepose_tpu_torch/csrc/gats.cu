// GATs leaf attention for the shipped GATs configuration, fp32.
//
// Replaces onepose_tpu/ops/pallas/gats.py::_gats_pallas_raw. Per 3D point
// with descriptor d3 and L leaf descriptors:
//   e3      = d3 . wa_self,            wa_self = W @ a_self
//   l_self  = LeakyReLU(2 e3)
//   l_leaf  = LeakyReLU(leaf . wa_leaf + e3) + mask_add,  wa_leaf = W @ a_leaf
//   out     = ELU(softmax(l_self, l_leaf) . [d3; leaves])   (RAW descriptors)
// The wrapper forms wa = [wa_leaf; wa_self] with one tiny matvec, the same
// reassociation as the XLA path, so no C x C product runs in the kernel.
//
// Bound on the H100: bytes. Leaves are read once (131 MB at 8 x 2000 x 8 x
// 256), plus d3 and the output (16 MB each): about 49 us at 3.35 TB/s.
// Design: one warp per point streams its 1 + L rows of C floats once with
// 16-byte loads (lane k holds channels 4k .. 4k+3 of each 128-channel
// chunk), reduces each row's logit with warp shuffles, and keeps an online
// softmax (running max, denominator and weighted sum) in registers, so no
// row is read twice and nothing but the output is written.

#include "gats_leaf.cuh"

// leaves [P, L, C], d3 [P, C], mask_add [P, L] or null, wa [2, C], out [P, C];
// P = B * N3. C must be a multiple of 4 and at most 512.
extern "C" int gats_launch(const float* leaves, const float* d3, const float* mask_add,
                           const float* wa, float* out, int P, int L, int C, float alpha,
                           cudaStream_t stream) {
  if (C % 4 != 0 || C > 512 || C <= 0) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  gats_leaf::dispatch(leaves, d3, mask_add, wa, out, P, L, C, alpha, stream);
  return cudaGetLastError();
}
