// The backward kernel for scenes the render kernel draws without tables
// (render_bwd_kernel.cuh in rt_common.cuh's contracted arithmetic, as
// render_fwd_small.cu).

#define RT_PIN 0
#include "render_bwd_kernel.cuh"

extern "C" {

// rt_render_bwd (render_bwd.cu) for such a scene; called from there with
// checked arguments.
int rt_render_bwd_small(const float* params, const float* sph, int ns, const float* pln,
                        int npl, const float* lts, int nl, const float* img,
                        const float* target, float* partial, int n_grads, int W, int H,
                        int depth, int mode, int compat, int cheap_shadow, void* stream) {
  return static_cast<int>(dispatch(params, sph, ns, pln, npl, lts, nl, img, target, partial,
                                   n_grads, W, H, depth, mode, compat != 0,
                                   cheap_shadow != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
