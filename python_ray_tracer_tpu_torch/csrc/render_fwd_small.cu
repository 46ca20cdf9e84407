// The render kernel's and the worklist kernel's small-scene instantiations
// (render_fwd_kernel.cuh without TABLES): every ray sweeps every sphere,
// nothing has to equal another sweep bit for bit, so this file takes
// rt_common.cuh's contracted arithmetic, the compiler's own choice of FMAs.
// Measured on the H100 (700 W), demo scene 1000x1000 AA / 1080p no AA / 1080p
// AA: 0.510 / 0.230 / 1.000 ms, against 0.515 / 0.233 / 1.013 ms in the
// pinned arithmetic.

#define RT_PIN 0
#include "render_fwd_kernel.cuh"

extern "C" {

// rt_render_fwd (render_fwd.cu) for a scene without large-scene tables; called
// from there with checked arguments.
int rt_render_fwd_small(const float* params, const float* sph, int ns, const float* pln,
                        int npl, const float* lts, int nl, float* out, int W, int H,
                        int Wg, int depth, int mode, int compat, int cheap_shadow,
                        void* stream) {
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth,
              {nullptr, nullptr, 0, nullptr, nullptr, 0, nullptr, nullptr, 0},
              static_cast<cudaStream_t>(stream), Wg};
  return static_cast<int>(dispatch<false>(mode, compat != 0, cheap_shadow != 0, j));
}

// rt_render_list (render_fwd.cu) for a scene without large-scene tables;
// called from there with checked arguments.
int rt_render_list_small(const float* params, const float* sph, int ns, const float* pln,
                         int npl, const float* lts, int nl, const int* idx,
                         const int* flagged, int K, float* out, int W, int H, int depth,
                         int compat, int cheap_shadow, void* stream) {
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth,
              {nullptr, nullptr, 0, nullptr, nullptr, 0, nullptr, nullptr, 0},
              static_cast<cudaStream_t>(stream), W};
  return static_cast<int>(dispatch_list<false>(compat != 0, cheap_shadow != 0, j, idx,
                                               flagged, K));
}

}  // extern "C"
