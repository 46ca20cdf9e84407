// The shadow lists of the render kernel, built on the card once a
// large-scene frame: for each (tile, level, light) row, the spheres that can
// block a shadow ray from a point of the box around the tile's hit points at
// that trace level (a row of hit_extents.cu) toward that light or beyond it,
// from the largest apparent size from the light down, k slots a row, count -1
// where more than k are kept. The rules are ops/cuda/cull_tables.py
// shadow_visibility_lists' (the JAX package's _shadow_visibility_lists,
// render_pallas.py:1113, plain jnp outside any kernel there): a capsule
// around the segment box centre -> light, widened by the box's half-diagonal,
// and a cone past the light, each widened by the sphere's radius and a slack
// of 2e-6 of the scene's scale; a row whose light lies within two
// half-diagonals of the box keeps every sphere, and a row of a tile without
// hits keeps none. No TPU kernel computes these lists; this kernel serves the
// render kernel's listed shadow sweeps (TPU kernels 1, 2 and 7): level 0's by
// default, the first L levels' with the render's shadow_list_levels = L. Its
// `tiles` are hit-extent rows: with L levels a tile's rows are tile * L +
// level (levels fastest), so row (tile * L + level) * nl + light of the
// output is that level's list, the layout of the JAX package's lists over
// hit-extent rows of L levels.
//
// What bounds it: FP32 work, one ~34-operation capsule-and-cone test a (row,
// sphere) pair until the row is decided (8160 tiles x 3 lights x 1000 spheres
// at 1080p, fewer for sky rows and overflowed rows), then the rows written
// once. The design:
//   * one warp a (tile, light) row; its lanes take the light's spheres 32 at a
//     time in the light's order (`order`, the stable argsort of -r / |c - L|
//     that the wrapper computes with the plain function's tensor ops) and a
//     ballot with a population count appends the kept ones in that order (no
//     atomics, no sort: the rows are deterministic). A row stops at its
//     (k + 1)-th kept sphere: its count is then -1 and its slots the first k;
//   * a block serves one light (blockIdx.y): it stages the light's spheres in
//     the light's order in shared memory once (center, radius, |c - L|^2 and
//     the original index), so a test reads 5 broadcast-free consecutive words
//     a lane; its warps stride over the tiles;
//   * the row's terms (box centre and half-diagonal, the direction to the
//     light, the cone's slope) once a row, the slack once a block (the
//     hit-extent kernel's scale and the lights' largest coordinate: no host
//     sync);
//   * every operation is the plain function's, in its order, pinned
//     (rt_common.cuh fm / fa / fs, __fsqrt_rn, __fdiv_rn, dot products summed
//     left to right as ops/intersect.py _dot does), so the rows equal
//     cull_tables.shadow_visibility_lists' integer for integer on the same
//     hit-extent rows; slots past a row's count hold 0, as there;
//   * past the 9,685 spheres whose staged words fit a block's 227 KB (the
//     chunked form, CHUNKED, shadow_lists_cuda.chunk_spheres), a block takes
//     its tiles a warp's worth at a time and sweeps the light's order in
//     chunks of `chunk`: it stages a chunk, each warp whose row is still open
//     appends that chunk's kept spheres, and the block stops once every row
//     is decided (__syncthreads_or). The same floats in the same order, so
//     the same rows.

#include <cuda_runtime.h>

#include <algorithm>

#include "rt_common.cuh"

namespace {

using namespace rt;

constexpr int SL_WARPS = 8;        // warps a block
constexpr int NT = SL_WARPS * 32;
constexpr int ROW = 8;             // floats a hit-extent row
constexpr float EXTENT_CLEAN = 1e9f;

__device__ __forceinline__ float dot3p(float ax, float ay, float az, float bx, float by,
                                       float bz) {
  return fa(fa(fm(ax, bx), fm(ay, by)), fm(az, bz));
}

// The staged words of positions [p0, p1) of light l's order (index p - p0).
struct Staged {
  float *cx, *cy, *cz, *r, *vv;
  int* j;

  __device__ __forceinline__ Staged(float* smem, int cap)
      : cx(smem), cy(smem + cap), cz(smem + 2 * cap), r(smem + 3 * cap), vv(smem + 4 * cap),
        j(reinterpret_cast<int*>(smem + 5 * cap)) {}

  __device__ __forceinline__ void stage(const int* __restrict__ ord,
                                        const float* __restrict__ cen,
                                        const float* __restrict__ rad, float lx, float ly,
                                        float lz, int p0, int p1, int tid) const {
    for (int p = p0 + tid; p < p1; p += NT) {
      const int jj = ord[p];
      const float x = cen[3 * jj], y = cen[3 * jj + 1], z = cen[3 * jj + 2];
      const float vx = fs(x, lx), vy = fs(y, ly), vz = fs(z, lz);
      const int i = p - p0;
      cx[i] = x;
      cy[i] = y;
      cz[i] = z;
      r[i] = rad[jj];
      vv[i] = dot3p(vx, vy, vz, vx, vy, vz);
      j[i] = jj;
    }
  }
};

// A (tile, light) row's terms, in cull_tables.shadow_visibility_lists'
// operations: the box centre b and half-diagonal, the segment s = L - b, and
// the cone's axis u, slope and 1 / cos.
struct RowTerms {
  float bx, by, bz, hdiag, sx, sy, sz, ss, ux, uy, uz, slope, rmink;
  bool all;   // the cone is ill-defined: the row keeps every sphere, in order
};

__device__ __forceinline__ RowTerms row_terms(const float* e, float lx, float ly, float lz) {
  RowTerms t;
  t.bx = fm(0.5f, fa(e[0], e[3])); t.by = fm(0.5f, fa(e[1], e[4]));
  t.bz = fm(0.5f, fa(e[2], e[5]));
  const float ex = fm(0.5f, fs(e[3], e[0])), ey = fm(0.5f, fs(e[4], e[1])),
              ez = fm(0.5f, fs(e[5], e[2]));
  t.hdiag = __fsqrt_rn(dot3p(ex, ey, ez, ex, ey, ez));
  t.sx = fs(lx, t.bx); t.sy = fs(ly, t.by); t.sz = fs(lz, t.bz);
  t.ss = fmaxf(dot3p(t.sx, t.sy, t.sz, t.sx, t.sy, t.sz), 1e-12f);
  const float dlb = __fsqrt_rn(t.ss);
  t.all = !(dlb > fm(2.0f, t.hdiag));
  t.ux = __fdiv_rn(t.sx, dlb); t.uy = __fdiv_rn(t.sy, dlb); t.uz = __fdiv_rn(t.sz, dlb);
  t.slope = __fdiv_rn(t.hdiag, fmaxf(fs(dlb, t.hdiag), 1e-6f));
  t.rmink = __fsqrt_rn(fa(1.0f, fm(t.slope, t.slope)));
  return t;
}

// One warp's sweep of staged positions [p0, p1) (at index p - p0) for row t:
// the kept spheres appended to slots from n on; false once the row overflows
// (n > k), where it stops.
__device__ __forceinline__ bool sweep_row(const RowTerms& t, const Staged& st, float lx,
                                          float ly, float lz, float slack, float extent,
                                          int p0, int p1, int k, int* slots, int& n,
                                          int lane) {
  for (int base = p0; base < p1; base += 32) {
    const int p = base + lane;
    bool keep = false;
    const int i = p - p0;
    if (p < p1) {
      const float cx = st.cx[i], cy = st.cy[i], cz = st.cz[i], r = st.r[i];
      // the capsule around the segment box centre -> light
      const float wx = fs(cx, t.bx), wy = fs(cy, t.by), wz = fs(cz, t.bz);
      const float ws = dot3p(wx, wy, wz, t.sx, t.sy, t.sz);
      const float tt = fminf(fmaxf(__fdiv_rn(ws, t.ss), 0.0f), 1.0f);
      const float d2 = fa(fs(dot3p(wx, wy, wz, wx, wy, wz), fm(fm(2.0f, tt), ws)),
                          fm(fm(tt, tt), t.ss));
      const float reach = fa(fa(r, t.hdiag), slack);
      // the cone past the light
      const float vx = fs(cx, lx), vy = fs(cy, ly), vz = fs(cz, lz);
      const float proj = dot3p(vx, vy, vz, t.ux, t.uy, t.uz);
      const float lat2 = fmaxf(fs(st.vv[i], fm(proj, proj)), 0.0f);
      const float allow = fa(fm(proj, t.slope), fm(fa(r, slack), t.rmink));
      keep = d2 <= fm(reach, reach) ||
             (proj > -r && proj < fa(extent, r) && lat2 <= fm(allow, allow) &&
              allow > 0.0f);
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    const int pos = n + __popc(bal & ((1u << lane) - 1u));
    if (keep && pos < k) slots[pos] = st.j[i];
    n += __popc(bal);
    if (n > k) return false;   // warp-uniform: the row overflows
  }
  return true;
}

// CHUNKED: `chunk` positions of the light's order staged at a time (chunk >
// 0); else all ns at once.
template <bool CHUNKED>
__global__ void __launch_bounds__(NT)
shadow_lists_kernel(const float* __restrict__ ext, const float* __restrict__ scale,
                    const float* __restrict__ lts, int nl, const float* __restrict__ cen,
                    const float* __restrict__ rad, int ns, const int* __restrict__ order,
                    int n_tiles, int k, int compat, int* __restrict__ idx,
                    int* __restrict__ cnt, int chunk) {
  extern __shared__ float smem[];   // cx, cy, cz, r, |c - L|^2, index: ns (chunk) each
  const Staged st(smem, CHUNKED ? chunk : ns);
  const int l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float lx = lts[3 * l], ly = lts[3 * l + 1], lz = lts[3 * l + 2];
  const int* ord = order + static_cast<size_t>(l) * ns;
  if (!CHUNKED) st.stage(ord, cen, rad, lx, ly, lz, 0, ns, tid);
  // the scale: the boxes' (hit_extents.cu) and the lights' largest |coordinate|
  float lmax = 0.0f;
  for (int i = lane; i < 3 * nl; i += 32) lmax = fmaxf(lmax, fabsf(lts[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, o));
  const float slack = fmaxf(fm(2e-6f, fmaxf(scale[0], lmax)), 1e-3f);
  const float extent = compat ? FAR : EXTENT_CLEAN;
  __syncthreads();

  if (!CHUNKED) {
    for (int tile = blockIdx.x * SL_WARPS + warp; tile < n_tiles;
         tile += gridDim.x * SL_WARPS) {
      const size_t row = static_cast<size_t>(tile) * nl + l;
      int* slots = idx + row * k;
      const float* e = ext + static_cast<size_t>(tile) * ROW;
      int n = 0;
      if (e[6] > 0.5f) {
        const RowTerms t = row_terms(e, lx, ly, lz);
        if (t.all) {
          n = ns;
          for (int p = lane; p < min(ns, k); p += 32) slots[p] = st.j[p];
        } else {
          sweep_row(t, st, lx, ly, lz, slack, extent, 0, ns, k, slots, n, lane);
        }
      }
      for (int i = min(n, k) + lane; i < k; i += 32) slots[i] = 0;
      if (lane == 0) cnt[row] = n > k ? -1 : n;
    }
    return;
  }
  // the block's tiles, a warp's worth at a time (the loop's bound is the
  // block's, so every warp meets the barriers), the chunks inside
  for (int tile0 = blockIdx.x * SL_WARPS; tile0 < n_tiles; tile0 += gridDim.x * SL_WARPS) {
    const int tile = tile0 + warp;
    const size_t row = static_cast<size_t>(tile) * nl + l;
    int* slots = idx + row * k;
    int n = 0;
    RowTerms t{};
    bool open = false;   // the row still sweeps
    if (tile < n_tiles) {
      const float* e = ext + static_cast<size_t>(tile) * ROW;
      if (e[6] > 0.5f) {
        t = row_terms(e, lx, ly, lz);
        if (t.all) {
          n = ns;
          for (int p = lane; p < min(ns, k); p += 32) slots[p] = ord[p];
        } else {
          open = true;
        }
      }
    }
    for (int p0 = 0; __syncthreads_or(open) && p0 < ns; p0 += chunk) {
      const int p1 = min(p0 + chunk, ns);
      st.stage(ord, cen, rad, lx, ly, lz, p0, p1, tid);
      __syncthreads();
      if (open) open = sweep_row(t, st, lx, ly, lz, slack, extent, p0, p1, k, slots, n, lane);
    }
    if (tile < n_tiles) {
      for (int i = min(n, k) + lane; i < k; i += 32) slots[i] = 0;
      if (lane == 0) cnt[row] = n > k ? -1 : n;
    }
  }
}

}  // namespace

extern "C" {

// Build the shadow lists of a frame on `stream` (device pointers): ext
// (n_tiles, 8) hit-extent rows (rt_hit_extents; with L levels n_tiles is the
// tiles times L, row tile * L + level), scale (1) their scale, lts (nl, 3)
// the lights, cen (ns, 3) and rad (ns) the spheres, order (nl, ns) int32 each
// light's spheres from the largest apparent size down; idx (n_tiles * nl * k)
// and cnt (n_tiles * nl) int32 receive the rows, row tile * nl + light (for L
// levels: (tile * L + level) * nl + light), k = min(K, ns) slots a row (count
// -1: overflowed). compat: the cone reaches FAR past the light, else 1e9.
// chunk: 0 stages the whole order at once; > 0, the chunked form, that many
// positions at a time (shadow_lists_cuda.chunk_spheres). Returns
// cudaGetLastError() after the launch (0 on success).
int rt_shadow_lists(const float* ext, const float* scale, const float* lts, int nl,
                    const float* cen, const float* rad, int ns, const int* order,
                    int n_tiles, int k, int compat, int* idx, int* cnt, int chunk,
                    void* stream) {
  if (ns < 1 || nl < 1 || nl > 65535 || n_tiles < 1 || k < 1 || k > ns || chunk < 0 ||
      !ext || !scale || !lts || !cen || !rad || !order || !idx || !cnt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 6 * static_cast<size_t>(chunk > 0 ? chunk : ns);
  const auto kernel = chunk > 0 ? shadow_lists_kernel<true> : shadow_lists_kernel<false>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
          cudaSuccess) {
    return static_cast<int>(e);
  }
  // as many blocks as the card holds at once, shared out over the lights
  const int per_light = std::max(1, std::min((n_tiles + SL_WARPS - 1) / SL_WARPS,
                                             sms * std::max(per_sm, 1) / nl));
  kernel<<<dim3(per_light, nl), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      ext, scale, lts, nl, cen, rad, ns, order, n_tiles, k, compat, idx, cnt, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
