// The backward kernel for scenes the render kernel draws without tables
// (render_bwd_kernel.cuh in rt_common.cuh's contracted arithmetic, as
// render_fwd_small.cu): the slot columns at depths 0-3 and the general depth,
// and per-warp rows at the general depth for a scene whose columns do not fit
// a block.

#define RT_PIN 0
#include "render_bwd_kernel.cuh"

extern "C" {

// rt_render_bwd (render_bwd.cu) for such a scene; called from there with
// checked arguments.
int rt_render_bwd_small(const BwdJob* job, int compat, int cheap_shadow, int cols) {
  if (cols) return static_cast<int>(dispatch_depth<true>(compat != 0, cheap_shadow != 0, *job));
  return static_cast<int>(dispatch_arith<false, -1>(compat != 0, cheap_shadow != 0, *job));
}

}  // extern "C"
