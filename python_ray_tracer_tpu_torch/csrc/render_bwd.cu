// The backward kernel for large scenes (render_bwd_kernel.cuh in rt_common.cuh's
// pinned arithmetic, the render kernel's for such scenes; per-warp rows, at
// depths 0-3 and the general depth; the staged form, render_bwd_global.cu the
// global one), the entry point of every part, and the second-stage reduction
// that every backward kernel of the library shares.

#include "render_bwd_kernel.cuh"

namespace {

constexpr int RED_THREADS = 256;             // reduce_rows block size

// Second stage: out[k] = sum over rows of partial[k * n_rows + row], each
// slot by one block in a fixed order (strided per thread, then a tree).
__global__ void __launch_bounds__(RED_THREADS)
reduce_rows_kernel(const float* __restrict__ partial, int n_rows, float* __restrict__ out) {
  __shared__ float buf[RED_THREADS];
  const float* col = partial + static_cast<size_t>(blockIdx.x) * n_rows;
  float v = 0.0f;
  for (int r = threadIdx.x; r < n_rows; r += RED_THREADS) v += col[r];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int h = RED_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

}  // namespace

extern "C" {

// The small-scene kernels (render_bwd_small.cu) and the global form of this
// file's (render_bwd_global.cu); arguments checked here.
int rt_render_bwd_small(const BwdJob* job, int compat, int cheap_shadow, int cols);
int rt_render_bwd_global(const BwdJob* job, int compat, int cheap_shadow);
// The one-launch AA step of this file's kernels (render_bwd_one.cu).
int rt_render_bwd_one(const BwdJob* job, int compat, int cheap_shadow);

// Launch the backward kernel on `stream`: n_rows blocks of nt threads (32, 64
// or 128) walk the image's 16x16 tiles (block b takes tiles b, b + n_rows,
// ...; 1 <= n_rows <= the tile count) and write per-block partial sums into
// partial (n_grads x n_rows); rt_reduce_rows then sums them. cols: the slot
// columns (small scenes only), else per-warp rows (render_bwd_kernel.cuh's
// head). mode: render_bwd_kernel.cuh's enum (FUSED_AA1, 4: the fused AA step
// in one launch). img: the (W, H, 3) cotangent (COT_* modes) or the rendered
// image (FUSED_AA); target: the (W, H, 3) target (FUSED_* modes); unused
// pointers may be null. n_grads = 7 ns + 9 npl + 3 nl + 18, + 1 in the fused
// modes. large_scene: the scene is one the render kernel draws with its
// large-scene instantiations (rt_render_fwd), so this file's pinned kernels
// recompute it, through the render's large-scene tables (rt_render_fwd's
// arguments, the lists built for the AA lattice in the AA modes; each may be
// null: that cull off; none without large_scene); else render_bwd_small.cu's
// kernels do. staged: the block copies the sphere table into shared memory;
// 0 takes the global form (large scenes, rows only; render_bwd_kernel.cuh's
// head). tree_smem: the staged form copies the bounce tree into shared memory
// too (else reads it where it lies). rec: FUSED_AA1's records, n_rows x
// rec_words(depth) floats of device memory (else may be null). W x H: the
// slice [params[P_X0], params[P_X0] + W) of a frame Wg columns wide (Wg == W
// for a whole frame), img and target the slice's; the loss's denominator is
// 3 Wg H. Returns cudaGetLastError() after the launch.
int rt_render_bwd(const float* params, const float* sph, int ns, const float* pln,
                  int npl, const float* lts, int nl, const float* img,
                  const float* target, float* partial, int n_rows, int n_grads,
                  int W, int H, int Wg, int depth, int mode, int compat, int cheap_shadow,
                  int large_scene, int nt, int cols, int staged,
                  const int* vis_idx, const int* vis_cnt, int vis_k,
                  const int* sh_idx, const int* sh_cnt, int sh_k, int sh_levels,
                  const int* perm, const float* box, int n_leaves,
                  const int* lc_idx, const int* lc_cnt, const float* lc_hdr,
                  int tree_smem, float* rec, void* stream) {
  const TableArgs ta{vis_idx, vis_cnt, vis_k, sh_idx, sh_cnt, sh_k, perm, box, n_leaves,
                     lc_idx, lc_cnt, lc_hdr, sh_levels};
  const BwdJob job{params, sph, ns, pln, npl, lts, nl, img, target, partial,
                   n_rows, W, H, depth, mode, n_grads, nt,
                   static_cast<cudaStream_t>(stream), Wg, nullptr, ta, tree_smem, rec};
  const bool tables = vis_idx || sh_idx || perm || lc_idx;
  if (!bwd_job_ok(job) || (cols && large_scene) || (!staged && (cols || !large_scene)) ||
      !tables_ok(ta) || (tables && !large_scene) || (tree_smem && (!staged || !perm)) ||
      (large_scene ? (staged ? job_smem<false, false, true>(job, false)
                             : job_smem<true, false, true>(job, false))
                   : job_smem<false, false, false>(job, cols != 0)) >
          static_cast<size_t>(227 * 1024)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!large_scene) return rt_render_bwd_small(&job, compat, cheap_shadow, cols);
  if (!staged) return rt_render_bwd_global(&job, compat, cheap_shadow);
  if (mode == FUSED_AA1) return rt_render_bwd_one(&job, compat, cheap_shadow);
  return static_cast<int>(
      dispatch_depth<false, false, false, true>(compat != 0, cheap_shadow != 0, job));
}

// out[k] = sum_r partial[k * n_rows + r] for k < n_cols, in a fixed order.
int rt_reduce_rows(const float* partial, int n_rows, int n_cols, float* out,
                   void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  reduce_rows_kernel<<<n_cols, RED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
