// The backward kernel for large scenes in its global form (render_bwd_kernel.cuh
// with G: the sphere table read where it lies in device memory, for the
// scenes whose table and rows do not fit a block at the most threads the
// global form fits; render_bwd_cuda.plan), in the pinned arithmetic of
// render_bwd.cu, whose staged kernels it matches bit for bit; per-warp rows
// at depths 0-3 and the general depth. A file of its own, so that nvcc
// compiles it beside render_bwd.cu.

#include "render_bwd_kernel.cuh"

extern "C" {

// The one-launch AA step of this file's kernels (render_bwd_one_global.cu).
int rt_render_bwd_one_global(const BwdJob* job, int compat, int cheap_shadow);

// rt_render_bwd (render_bwd.cu) with staged 0; called from there with checked
// arguments.
int rt_render_bwd_global(const BwdJob* job, int compat, int cheap_shadow) {
  if (job->mode == FUSED_AA1) return rt_render_bwd_one_global(job, compat, cheap_shadow);
  return static_cast<int>(
      dispatch_depth<false, true, false, true>(compat != 0, cheap_shadow != 0, *job));
}

}  // extern "C"
