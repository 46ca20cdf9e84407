// Hit-extent kernel for Hopper (sm_90a): pass 1 of the two-pass shadow
// pipeline. For every render tile (a 16x16 block of render_fwd_kernel.cuh) and trace
// level it writes the box around the biased hit points that the render kernel
// will start that level's shadow rays from, and how many there are:
// out[(tile * n_levels + level) * 8 ..] = min xyz, max xyz, count, 0. The host
// turns the boxes into per-(tile, light) occluder lists
// (ops/cuda/cull_tables.py shadow_visibility_lists) that the render kernel's
// level-0 shadow rays then sweep instead of the whole scene.
//
// Replaces the TPU kernel _make_hit_extent_kernel
// (python_ray_tracer_tpu/ops/pallas/render_pallas.py:990, run by
// _hit_extents_pallas :1076).
//
// What bounds it on this card: FP32 operations. It reads the scene (28 KB at
// 1000 spheres) and the tile's primary list and writes 32 bytes a (tile,
// level); each sample position costs one ray generation and one closest-hit
// sweep over the tile's cone-visible spheres, and past level 0 (where the
// render kernel lists no bounce) one closest hit through the bounce tree, the
// render kernel's own bounce sweep (rt_common.cuh closest_hit_tree): at 1000
// spheres the tree's box tests and the ~45 sphere tests of a bounce ray bound
// those levels, where the full sweep took 1000.
//
// What the design does about it, and what it must keep:
//   * one block per render tile with render_fwd_kernel.cuh's blockIdx -> tile mapping,
//     because the lists are indexed by the render kernel's tile id;
//   * each thread walks the tile's sample positions exactly as the render
//     kernel does: the 256 centers without AA, the 1089 positions of the four
//     shared grids (centers, both half-axis grids, corners) with AA, which is
//     also the lattice the per-sample AA mode samples;
//   * the hit points come from rt_common.cuh's raygen, primary_geometry (with
//     the same primary list, and the same bounce tree past level 0),
//     reflect_dir and bounce_ray, the functions the render kernel calls. They
//     are written in rounded-once operations (rt_common.cuh fm / fa / fs /
//     ff), so this file's copies give the render kernel's bits: the boxes
//     contain its shadow-ray origins exactly, which the lists' coverage proof
//     needs. chip_smoke.py and the card tests check it by comparing renders
//     with the lists on and off bit for bit;
//   * only positions an output pixel consumes may widen a box: alive at this
//     level and every level before it, and inside [0, W-1] x [0, H-1] (the
//     -0.5 column and the ragged edge are evaluated by the render kernel and
//     thrown away);
//   * min, max and an integer count are order-free, so warp shuffles and one
//     shared-memory stage give the same bits on every run: no atomics. A tile
//     without hits keeps the sentinels +-1e30 and count 0;
//   * blocks are independent and each writes its own rows (the TPU grid is
//     sequential and writes disjoint SMEM slots; nothing carries over);
//   * a launch of level 0 alone (the render path's) runs an instantiation
//     without the bounce levels (BOUNCES false), so the tree traversal's code
//     and registers stay out of it.

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

constexpr int TILE = 16;                    // render_fwd_kernel.cuh's tile
constexpr int NT = TILE * TILE;
constexpr int N_C = TILE * TILE;
constexpr int N_U = (TILE + 1) * TILE;
constexpr int N_V = TILE * (TILE + 1);
constexpr int N_UV = (TILE + 1) * (TILE + 1);
constexpr int N_SHARED = N_C + N_U + N_V + N_UV;
constexpr int MAX_LEVELS = 4;               // hit_extents_cuda.MAX_LEVELS
constexpr int ROW = 8;                      // floats a (tile, level) row

template <bool COMPAT, bool AA, bool BOUNCES>
__global__ void __launch_bounds__(NT)
hit_extents_kernel(const float* __restrict__ params, const float* __restrict__ sph,
                   int ns, const float* __restrict__ pln, int npl,
                   float* __restrict__ out, int W, int H, int n_levels, TableArgs ta) {
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + 7 * ns;
  float* s_tab = s_pln + 9 * npl;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < N_PARAMS; i += NT) s_p[i] = params[i];
  for (int i = tid; i < 7 * ns; i += NT) s_sph[i] = sph[i];
  for (int i = tid; i < 9 * npl; i += NT) s_pln[i] = pln[i];
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const Tables tb = stage_tables(ta, 0, tile, s_tab, tid, NT);
  // the reduction's stage: 7 values a (warp, level)
  float* s_red = s_tab + table_words(ta, 0);
  __syncthreads();
  const SceneView s{s_p, s_sph, ns, s_pln, npl, nullptr, 0};

  const float fx0 = static_cast<float>(blockIdx.y * TILE);
  const float fy0 = static_cast<float>(blockIdx.x * TILE);
  const float x_max = static_cast<float>(W - 1), y_max = static_cast<float>(H - 1);

  constexpr int LEVELS = BOUNCES ? MAX_LEVELS : 1;
  float mn[LEVELS][3], mx[LEVELS][3];
  int cnt[LEVELS];
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    mn[l][0] = mn[l][1] = mn[l][2] = BIG;
    mx[l][0] = mx[l][1] = mx[l][2] = -BIG;
    cnt[l] = 0;
  }

  const int n_pos = AA ? N_SHARED : N_C;
  for (int q = tid; q < n_pos; q += NT) {
    // render_fwd_kernel.cuh's sample grids: C at (x, y), U at (x - 0.5, y), V at
    // (x, y - 0.5), UV at (x - 0.5, y - 0.5), indices from the tile corner
    int kx, ky;
    float du = 0.0f, dv = 0.0f;
    if (q < N_C) {
      kx = q / TILE; ky = q % TILE;
    } else if (q < N_C + N_U) {
      kx = (q - N_C) / TILE; ky = (q - N_C) % TILE; du = -0.5f;
    } else if (q < N_C + N_U + N_V) {
      kx = (q - N_C - N_U) / (TILE + 1); ky = (q - N_C - N_U) % (TILE + 1); dv = -0.5f;
    } else {
      kx = (q - N_C - N_U - N_V) / (TILE + 1); ky = (q - N_C - N_U - N_V) % (TILE + 1);
      du = -0.5f; dv = -0.5f;
    }
    const float px = (fx0 + du) + static_cast<float>(kx);
    const float py = (fy0 + dv) + static_cast<float>(ky);
    bool used = px >= 0.0f && px <= x_max && py >= 0.0f && py <= y_max;
    Ray ray = raygen(s.p, px, py);
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      if (l >= n_levels) break;
      const Surface f = primary_geometry<COMPAT, true>(s, ray, tb, l == 0);
      // a chain dead at this level reaches no later one either, in the image
      // or out of it
      if (!f.alive) break;
      if (used) {
        mn[l][0] = fminf(mn[l][0], f.px); mx[l][0] = fmaxf(mx[l][0], f.px);
        mn[l][1] = fminf(mn[l][1], f.py); mx[l][1] = fmaxf(mx[l][1], f.py);
        mn[l][2] = fminf(mn[l][2], f.pz); mx[l][2] = fmaxf(mx[l][2], f.pz);
        cnt[l] += 1;
      }
      if (l + 1 < n_levels) {
        float rx, ry, rz;
        reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, rx, ry, rz);
        ray = bounce_ray(f, rx, ry, rz);
      }
    }
  }

  // warp shuffles, then one shared-memory stage; every thread gets here
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    if (l >= n_levels) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a = mn[l][c], b = mx[l][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = fminf(a, __shfl_xor_sync(FULL, a, o));
        b = fmaxf(b, __shfl_xor_sync(FULL, b, o));
      }
      if (lane == 0) {
        s_red[(warp * MAX_LEVELS + l) * 7 + c] = a;
        s_red[(warp * MAX_LEVELS + l) * 7 + 3 + c] = b;
      }
    }
    int n = cnt[l];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
    if (lane == 0) s_red[(warp * MAX_LEVELS + l) * 7 + 6] = static_cast<float>(n);
  }
  __syncthreads();
  if (tid < n_levels) {
    const int l = tid;
    float r[7] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0f};
    for (int w = 0; w < NT / 32; ++w) {
      const float* v = s_red + (w * MAX_LEVELS + l) * 7;
      for (int c = 0; c < 3; ++c) {
        r[c] = fminf(r[c], v[c]);
        r[3 + c] = fmaxf(r[3 + c], v[3 + c]);
      }
      r[6] += v[6];   // at most 1089 ones: exact in float32
    }
    float* o = out + (static_cast<size_t>(tile) * n_levels + l) * ROW;
    for (int c = 0; c < 7; ++c) o[c] = r[c];
    o[7] = 0.0f;
  }
}

template <bool COMPAT, bool AA, bool BOUNCES>
cudaError_t launch_levels(const float* params, const float* sph, int ns, const float* pln,
                          int npl, float* out, int W, int H, int n_levels,
                          const TableArgs& ta, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (N_PARAMS + 7 * ns + 9 * npl + table_words(ta, 0) +
                                       (NT / 32) * MAX_LEVELS * 7);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hit_extents_kernel<COMPAT, AA, BOUNCES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 block(TILE, TILE);
  const dim3 grid((H + TILE - 1) / TILE, (W + TILE - 1) / TILE);
  hit_extents_kernel<COMPAT, AA, BOUNCES><<<grid, block, smem, stream>>>(
      params, sph, ns, pln, npl, out, W, H, n_levels, ta);
  return cudaGetLastError();
}

template <bool COMPAT, bool AA>
cudaError_t launch(const float* params, const float* sph, int ns, const float* pln,
                   int npl, float* out, int W, int H, int n_levels,
                   const TableArgs& ta, cudaStream_t stream) {
  return n_levels > 1
             ? launch_levels<COMPAT, AA, true>(params, sph, ns, pln, npl, out, W, H, n_levels,
                                               ta, stream)
             : launch_levels<COMPAT, AA, false>(params, sph, ns, pln, npl, out, W, H,
                                                n_levels, ta, stream);
}

}  // namespace

extern "C" {

// Hit extents of a W x H render into out (n_tiles * n_levels, 8) float32 on
// `stream`, tiles of 16x16 pixels numbered x tiles outermost. params, sph and
// pln as for rt_render_fwd. aliasing: walk the 3x3 AA lattice (the four shared
// grids) instead of the pixel centers. vis_idx / vis_cnt / vis_k: the primary
// cone-cull lists the render will use (null: none); perm / box / n_leaves:
// the bounce tree it will use past level 0 (rt_common.cuh Tables;
// null: none; not staged when n_levels is 1, where no ray reads it). Returns
// cudaGetLastError() after the launch (0 on success).
int rt_hit_extents(const float* params, const float* sph, int ns, const float* pln,
                   int npl, float* out, int W, int H, int n_levels, int aliasing,
                   int compat, const int* vis_idx, const int* vis_cnt, int vis_k,
                   const int* perm, const float* box, int n_leaves,
                   void* stream) {
  const bool bounces = n_levels > 1;
  const TableArgs ta{vis_idx, vis_cnt, vis_k, nullptr, nullptr, 0,
                     bounces ? perm : nullptr, box, n_leaves};
  if (W <= 0 || H <= 0 || ns < 0 || npl < 0 || n_levels < 1 || n_levels > MAX_LEVELS ||
      (W + TILE - 1) / TILE > 65535 || !tables_ok(ta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (compat) {
    e = aliasing ? launch<true, true>(params, sph, ns, pln, npl, out, W, H, n_levels, ta, st)
                 : launch<true, false>(params, sph, ns, pln, npl, out, W, H, n_levels, ta, st);
  } else {
    e = aliasing ? launch<false, true>(params, sph, ns, pln, npl, out, W, H, n_levels, ta, st)
                 : launch<false, false>(params, sph, ns, pln, npl, out, W, H, n_levels, ta, st);
  }
  return static_cast<int>(e);
}

}  // extern "C"
