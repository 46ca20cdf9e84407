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

// rt_render_bwd (render_bwd.cu) for a large scene in the third form: the same
// arguments (large_scene, per-warp rows, the global form), and scratch, n_rows
// x nt / 32 x (7 ns + 9 npl + 3 nl) floats of device memory that the launch
// zeroes and fills with the warps' rows. Returns cudaGetLastError() after the
// launch.
int rt_render_bwd_rows(const float* params, const float* sph, int ns, const float* pln,
                       int npl, const float* lts, int nl, const float* img,
                       const float* target, float* partial, int n_rows, int n_grads,
                       int W, int H, int Wg, int depth, int mode, int compat,
                       int cheap_shadow, int nt, float* scratch, void* stream) {
  const bool fused = mode == FUSED_NOAA || mode == FUSED_AA;
  const bool aa = mode == COT_AA || mode == FUSED_AA;
  const long long n_tiles =
      static_cast<long long>((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE);
  if (W <= 0 || H <= 0 || Wg < W || depth < 0 || depth > MAX_DEPTH || ns < 0 || npl < 0 ||
      nl < 0 || mode < COT_NOAA || mode > FUSED_AA ||
      n_grads != 7 * ns + 9 * npl + 3 * nl + 18 + (fused ? 1 : 0) ||
      n_rows < 1 || n_rows > n_tiles || !(nt == 32 || nt == 64 || nt == 128) ||
      scratch == nullptr ||
      sizeof(float) * bwd_smem_words(ns, npl, nl, n_grads, aa, nt, false, false, false) >
          static_cast<size_t>(227 * 1024) ||
      (mode != FUSED_NOAA && img == nullptr) || (fused && target == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdJob job{params, sph, ns, pln, npl, lts, nl, img, target, partial,
                   n_rows, W, H, depth, mode, n_grads, nt,
                   static_cast<cudaStream_t>(stream), Wg, scratch};
  return static_cast<int>(
      dispatch_depth<false, true, true>(compat != 0, cheap_shadow != 0, job));
}

}  // extern "C"
