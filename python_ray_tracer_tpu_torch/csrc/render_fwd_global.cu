// The render kernel's and the worklist kernel's large-scene instantiations in
// their global form (render_fwd_kernel.cuh with TABLES and G: the sphere table
// and the bounce tree read where they lie in device memory; for scenes whose
// tables do not fit a block's shared memory), in
// the pinned arithmetic of render_fwd.cu, whose staged kernels they match bit
// for bit, and their entry points. A file of its own, so that nvcc compiles it
// beside render_fwd.cu.

#include "render_fwd_kernel.cuh"

extern "C" {

// rt_render_fwd (render_fwd.cu) with large_scene, in the global form: the
// same arguments. Returns cudaGetLastError() after the launch (0 on success).
int rt_render_fwd_global(const float* params, const float* sph, int ns, const float* pln,
                         int npl, const float* lts, int nl, float* out, int W, int H, int Wg,
                         int depth, int mode, int compat, int cheap_shadow,
                         const int* vis_idx, const int* vis_cnt, int vis_k,
                         const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                         const int* perm, const float* box, int n_leaves,
                         const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                         void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  if (W <= 0 || H <= 0 || Wg < W || depth < 0 || ns < 0 || npl < 0 || nl < 0 ||
      (W + TILE - 1) / TILE > 65535 || !tables_ok(ta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth, ta,
              static_cast<cudaStream_t>(stream), Wg};
  return static_cast<int>(dispatch<true, true>(mode, compat != 0, cheap_shadow != 0, j));
}

// rt_render_list (render_fwd.cu) with large_scene, in the global form: the
// same arguments. Returns cudaGetLastError() after the launch (0 on success).
int rt_render_list_global(const float* params, const float* sph, int ns, const float* pln,
                          int npl, const float* lts, int nl, const int* idx,
                          const int* flagged, int K, float* out, int W, int H, int depth,
                          int compat, int cheap_shadow,
                          const int* vis_idx, const int* vis_cnt, int vis_k,
                          const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                          const int* perm, const float* box, int n_leaves,
                          const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                          void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  if (W <= 0 || H <= 0 || depth < 0 || ns < 0 || npl < 0 || nl < 0 || K < 1 || !idx ||
      !flagged || !out || !tables_ok(ta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth, ta,
              static_cast<cudaStream_t>(stream), W};
  return static_cast<int>(
      dispatch_list<true, true>(compat != 0, cheap_shadow != 0, j, idx, flagged, K));
}

}  // extern "C"
