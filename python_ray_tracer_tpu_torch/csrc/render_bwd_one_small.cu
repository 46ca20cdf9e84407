// The one-launch fused AA step (FUSED_AA1) of render_bwd_small.cu's kernels:
// render_bwd_kernel.cuh's ONE instantiations in rt_common.cuh's contracted
// arithmetic, the slot columns at depths 0-3 and the general depth, per-warp
// rows at the general depth. A file of its own, so that nvcc compiles it
// beside render_bwd_small.cu.

#define RT_PIN 0
#include "render_bwd_kernel.cuh"

extern "C" {

// rt_render_bwd_small (render_bwd_small.cu) for a FUSED_AA1 job; called from
// there with checked arguments.
int rt_render_bwd_one_small(const BwdJob* job, int compat, int cheap_shadow, int cols) {
  if (cols) {
    return static_cast<int>(dispatch_depth<true, false, false, false, true>(
        compat != 0, cheap_shadow != 0, *job));
  }
  return static_cast<int>(
      dispatch_cc<false, -1, false, false, false, true>(compat != 0, cheap_shadow != 0, *job));
}

}  // extern "C"
