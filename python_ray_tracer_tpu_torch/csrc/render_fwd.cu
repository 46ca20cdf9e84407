// The render kernel's and the worklist kernel's large-scene instantiations
// (render_fwd_kernel.cuh with TABLES, in rt_common.cuh's pinned arithmetic;
// the staged form, render_fwd_global.cu the global one) and the entry points
// of both halves.

#include "render_fwd_kernel.cuh"

extern "C" {

// The small-scene instantiations (render_fwd_small.cu); arguments checked here.
int rt_render_fwd_small(const float* params, const float* sph, int ns, const float* pln,
                        int npl, const float* lts, int nl, float* out, int W, int H,
                        int Wg, int depth, int mode, int compat, int cheap_shadow,
                        void* stream);

// Render a W x H image into out (W, H, 3) float32 on `stream`: columns
// [params[P_X0], params[P_X0] + W) of a frame Wg columns wide (Wg == W and
// P_X0 0 for a whole frame; render_fwd_kernel.cuh's head). params holds
// N_PARAMS floats; sph/pln/lts are the (7,ns)/(9,npl)/(3,nl) SoA tables, all
// device pointers. mode: 0 no AA, 1 per-sample AA, 2 shared-sample AA.
// large_scene selects this file's instantiations, which read the large-scene
// tables (rt_common.cuh TableArgs; tiles of 16x16 pixels, x tiles outermost); each
// table is optional there: a null vis_idx, sh_idx or perm switches it off,
// and with all three null that kernel too sweeps every sphere for every ray
// (the render that the culled ones must equal bit for bit: same machine code,
// other sweeps). sh_idx / sh_cnt / sh_k / sh_levels: the occluder lists of the
// first sh_levels trace levels (>= 1), row (tile * sh_levels + level) * nl +
// light. perm / box / n_leaves: the bounce tree (rt_common.cuh
// Tables, LEAF spheres a leaf and FAN leaves a parent); lc_idx / lc_cnt /
// lc_hdr: the light cells of the bounce shadow rays (rt_light_cells,
// light_cells.cu; nl * LC_ROWS rows of LC_K slots). Without large_scene the
// tables must be null.
// Returns cudaGetLastError() after the launch (0 on success).
int rt_render_fwd(const float* params, const float* sph, int ns, const float* pln,
                  int npl, const float* lts, int nl, float* out, int W, int H, int Wg,
                  int depth, int mode, int compat, int cheap_shadow, int large_scene,
                  const int* vis_idx, const int* vis_cnt, int vis_k,
                  const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                  const int* perm, const float* box, int n_leaves,
                  const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                  void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  if (W <= 0 || H <= 0 || Wg < W || depth < 0 || ns < 0 || npl < 0 || nl < 0 ||
      (W + TILE - 1) / TILE > 65535 || !tables_ok(ta) ||
      (!large_scene && (vis_idx || sh_idx || perm || lc_idx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!large_scene) {
    return rt_render_fwd_small(params, sph, ns, pln, npl, lts, nl, out, W, H, Wg, depth,
                               mode, compat, cheap_shadow, stream);
  }
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth, ta,
              static_cast<cudaStream_t>(stream), Wg};
  return static_cast<int>(dispatch<true>(mode, compat != 0, cheap_shadow != 0, j));
}

// The small-scene worklist instantiations (render_fwd_small.cu); arguments
// checked here.
int rt_render_list_small(const float* params, const float* sph, int ns, const float* pln,
                         int npl, const float* lts, int nl, const int* idx,
                         const int* flagged, int K, float* out, int W, int H, int depth,
                         int compat, int cheap_shadow, void* stream);

// Adaptive AA's worklist pass on `stream`: for each of the first
// min(*flagged, K) slots of idx (int32, flat pixel indices x * H + y), trace
// that pixel's 9 AA samples and write their average, in the stored layout of
// mode 1 (per-sample AA), into out (W, H, 3) float32, which holds the tent
// image; every other pixel of out is left as it is. flagged is a device
// pointer to one int32. params and the SoA tables as for rt_render_fwd.
// large_scene selects this file's instantiation (the pinned arithmetic of the
// large-scene render), else render_fwd_small.cu's; the large-scene tables as
// for rt_render_fwd, the lists built for the AA lattice (each listed pixel
// reads its tile's rows; the bounce tree and the light cells are the
// frame's), and none without large_scene.
// Returns cudaGetLastError() after the launch (0 on success).
int rt_render_list(const float* params, const float* sph, int ns, const float* pln,
                   int npl, const float* lts, int nl, const int* idx, const int* flagged,
                   int K, float* out, int W, int H, int depth, int compat,
                   int cheap_shadow, int large_scene,
                   const int* vis_idx, const int* vis_cnt, int vis_k,
                   const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                   const int* perm, const float* box, int n_leaves,
                   const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                   void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  if (W <= 0 || H <= 0 || depth < 0 || ns < 0 || npl < 0 || nl < 0 || K < 1 ||
      !idx || !flagged || !out || !tables_ok(ta) ||
      (!large_scene && (vis_idx || sh_idx || perm || lc_idx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!large_scene) {
    return rt_render_list_small(params, sph, ns, pln, npl, lts, nl, idx, flagged, K, out,
                                W, H, depth, compat, cheap_shadow, stream);
  }
  const Job j{params, sph, ns, pln, npl, lts, nl, out, W, H, depth, ta,
              static_cast<cudaStream_t>(stream), W};
  return static_cast<int>(dispatch_list<true>(compat != 0, cheap_shadow != 0, j, idx,
                                              flagged, K));
}

// The bounce tree's shape this library was built for (rt_common.cuh LEAF,
// FAN).
void rt_tree_shape(int* leaf, int* fan) {
  *leaf = LEAF;
  *fan = FAN;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
