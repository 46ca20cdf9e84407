// The backward kernel for scenes the render kernel draws without tables
// (render_bwd_kernel.cuh in rt_common.cuh's contracted arithmetic, as
// render_fwd_small.cu): the slot columns at depths 0-3 and the general depth,
// and per-warp rows at the general depth for a scene whose columns do not fit
// a block.

#define RT_PIN 0
#include "render_bwd_kernel.cuh"

extern "C" {

// The one-launch AA step of these kernels (render_bwd_one_small.cu).
int rt_render_bwd_one_small(const BwdJob* job, int compat, int cheap_shadow, int cols);

// rt_render_bwd (render_bwd.cu) for such a scene; called from there with
// checked arguments.
int rt_render_bwd_small(const BwdJob* job, int compat, int cheap_shadow, int cols) {
  if (job->mode == FUSED_AA1) return rt_render_bwd_one_small(job, compat, cheap_shadow, cols);
  if (cols) return static_cast<int>(dispatch_depth<true>(compat != 0, cheap_shadow != 0, *job));
  return static_cast<int>(
      dispatch_cc<false, -1, false, false, false, false>(compat != 0, cheap_shadow != 0, *job));
}

}  // extern "C"
