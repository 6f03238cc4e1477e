// Native graph cores for the SfM host path of the port.
//
// Copy of onepose_tpu/native/union_find.cpp (the port keeps its own). The
// reference delegates its graph work (track building inside COLMAP's
// point_triangulator, C++) to native code; this covers the two union-find
// hot spots:
//   - track building over (image, keypoint) match edges
//     (onepose_tpu_torch/sfm/tracks.py)
//   - proximity point merging (onepose_tpu_torch/sfm/filtering.py)
//
// Pure C ABI, loaded via ctypes (onepose_tpu_torch/native/__init__.py).
// Semantics match the Python fallbacks there exactly: union-to-minimum-root,
// path halving, final full flatten.

#include <cstdint>
#include <vector>

extern "C" {

// Union-find over n nodes with m edges (ea[i] -- eb[i]).
// parent must be a caller-allocated array of n int64; on return it holds
// the root label of every node (roots are the minimum member index).
void uf_connected_components(int64_t n, const int64_t* ea,
                             const int64_t* eb, int64_t m,
                             int64_t* parent) {
  for (int64_t i = 0; i < n; ++i) parent[i] = i;

  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };

  for (int64_t i = 0; i < m; ++i) {
    int64_t ra = find(ea[i]);
    int64_t rb = find(eb[i]);
    if (ra == rb) continue;
    if (ra < rb)
      parent[rb] = ra;
    else
      parent[ra] = rb;
  }
  for (int64_t i = 0; i < n; ++i) parent[i] = find(i);
}

// Proximity clustering: union points whose squared distance is below
// thr2, using a caller-precomputed sorted cell assignment. Points are
// given as [n, 3] doubles; cell ids (int64) must place points so that any
// pair within threshold shares equal or adjacent cells. `cell_order` is
// the argsort of cell ids; `cell_starts`/`cell_ids` describe unique-cell
// runs. To keep the ABI simple we instead take candidate pairs generated
// by the caller and just union-find them; the heavy O(n_pairs) distance
// filtering happens here.
void uf_merge_close(int64_t n, const double* xyz, const int64_t* cand_a,
                    const int64_t* cand_b, int64_t n_cand, double thr2,
                    int64_t* parent) {
  for (int64_t i = 0; i < n; ++i) parent[i] = i;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t i = 0; i < n_cand; ++i) {
    int64_t a = cand_a[i], b = cand_b[i];
    double dx = xyz[3 * a] - xyz[3 * b];
    double dy = xyz[3 * a + 1] - xyz[3 * b + 1];
    double dz = xyz[3 * a + 2] - xyz[3 * b + 2];
    if (dx * dx + dy * dy + dz * dz >= thr2) continue;
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    if (ra < rb)
      parent[rb] = ra;
    else
      parent[ra] = rb;
  }
  for (int64_t i = 0; i < n; ++i) parent[i] = find(i);
}

}  // extern "C"
