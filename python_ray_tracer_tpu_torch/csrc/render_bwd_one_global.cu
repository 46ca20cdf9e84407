// The one-launch fused AA step (FUSED_AA1) of render_bwd_global.cu's kernels, the global
// form: render_bwd_kernel.cuh's ONE instantiations in the pinned arithmetic, per-warp
// rows at depths 0-3 and the general depth. A file of its own, so that nvcc compiles it
// beside render_bwd_global.cu.

#include "render_bwd_kernel.cuh"

extern "C" {

// The FUSED_AA1 jobs of render_bwd_global.cu; called from there with checked
// arguments.
int rt_render_bwd_one_global(const BwdJob* job, int compat, int cheap_shadow) {
  return static_cast<int>(dispatch_depth<false, true, false, true, true>(
      compat != 0, cheap_shadow != 0, *job));
}

}  // extern "C"
