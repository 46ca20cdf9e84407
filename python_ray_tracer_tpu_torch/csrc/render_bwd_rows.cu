// The backward kernel for large scenes in its third form (render_bwd_kernel.cuh
// with G and R: the sphere table read where it lies and each warp's row of
// object and light slots in a device-memory scratch buffer, for the scenes
// whose rows do not fit a block even in the global form; render_bwd_cuda.plan),
// in the pinned arithmetic of render_bwd.cu, whose kernels it matches bit for
// bit at the same launch shape; per-warp rows at depths 0-3 and the general
// depth. A file of its own, with its own entry point, so that nvcc compiles it
// beside render_bwd.cu and a library built without it still loads.

#include "render_bwd_kernel.cuh"

extern "C" {

// The one-launch AA step of this file's kernels (render_bwd_one_rows.cu).
int rt_render_bwd_one_rows(const BwdJob* job, int compat, int cheap_shadow);

// rt_render_bwd (render_bwd.cu) for a large scene in the third form: the
// same arguments (large_scene, per-warp rows, the global form, the tables;
// the tree is read where it lies), and scratch, n_rows x nt / 32 x (7 ns + 9
// npl + 3 nl) floats of device memory that the launch zeroes and fills with
// the warps' rows. Returns cudaGetLastError() after the launch.
int rt_render_bwd_rows(const float* params, const float* sph, int ns, const float* pln,
                       int npl, const float* lts, int nl, const float* img,
                       const float* target, float* partial, int n_rows, int n_grads,
                       int W, int H, int Wg, int depth, int mode, int compat,
                       int cheap_shadow, int nt, float* scratch,
                       const int* vis_idx, const int* vis_cnt, int vis_k,
                       const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                       const int* perm, const float* box, int n_leaves,
                       const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                       float* rec, void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  const BwdJob job{params, sph, ns, pln, npl, lts, nl, img, target, partial,
                   n_rows, W, H, depth, mode, n_grads, nt,
                   static_cast<cudaStream_t>(stream), Wg, scratch, ta, 0, rec};
  if (!bwd_job_ok(job) || scratch == nullptr || !tables_ok(ta) ||
      job_smem<true, true, true>(job, false) > static_cast<size_t>(227 * 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == FUSED_AA1) return rt_render_bwd_one_rows(&job, compat, cheap_shadow);
  return static_cast<int>(
      dispatch_depth<false, true, true, true>(compat != 0, cheap_shadow != 0, job));
}

}  // extern "C"
