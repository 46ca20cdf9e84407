// Hit-extent kernel for Hopper (sm_90a): pass 1 of the two-pass shadow
// pipeline. For every render tile (a 16x16 block of render_fwd_kernel.cuh) and trace
// level it writes the box around the biased hit points that the render kernel
// will start that level's shadow rays from, and how many there are:
// out[(tile * n_levels + level) * 8 ..] = min xyz, max xyz, count, 0. With
// `scale` it also writes the largest coordinate magnitude of the rows that
// have hits (the list scale of ops/cuda/cull_tables.py extent_scale). The
// list kernel (shadow_lists.cu) turns the boxes into per-(tile, light)
// occluder lists that the render kernel's level-0 shadow rays then sweep
// instead of the whole scene.
//
// Replaces the TPU kernel _make_hit_extent_kernel
// (python_ray_tracer_tpu/ops/pallas/render_pallas.py:990, run by
// _hit_extents_pallas :1076).
//
// What bounds it on this card: FP32 operations. Each sample position costs one
// ray generation and one closest-hit sweep over the tile's cone-visible
// spheres (~5 a tile at 1000 spheres, 1080p), and past level 0 (where the
// render kernel lists no bounce) one closest hit through the bounce tree, the
// render kernel's own bounce sweep (rt_common.cuh closest_hit_tree). It reads
// the listed spheres and writes 32 bytes a (tile, level).
//
// What the design does about it, and what it must keep:
//   * a small group of warps a tile, so that each lane takes about 8 sample
//     positions: one warp without AA (8 of the 256 pixel centers a lane),
//     four with AA (8-9 of the 1089 positions of the AA lattice). A warp
//     reduces its lanes with shuffles alone; four warps then merge their
//     rows through shared memory behind a named barrier of the group. With
//     AA, one warp a tile (34-35 positions a lane) was slower, and one block
//     a tile (4-5 a lane) slower in both modes (chip_smoke.py [extent-sweep],
//     which builds the other group sizes with -DRT_HX_TILE_WARPS /
//     -DRT_HX_AA_TILE_WARPS; see PERF.md). A block holds 8 warps, the grid
//     one tile a group; no __syncthreads a tile;
//   * the level-0 launch (the render path's) stages no scene: the group
//     gathers its tile's listed spheres (the list's count, at most vis_k) into
//     its own slice of shared memory, in the list's ascending order, and
//     sweeps that copy. A row that overflowed (count -1), or a launch without
//     lists, sweeps the whole scene where it lies in device memory, so the
//     scene's size no longer sets the launch's shared memory. The two sweeps
//     are separate inlined calls, so each one's loads know their memory. The
//     launch with bounce levels (n_levels > 1: the render's
//     shadow_list_levels, whose lists cover the bounce levels' shadow rays
//     too) stages the scene and the bounce tree once a block, for the tree
//     walks;
//     past the size where they fit a block (G, the global form: the render
//     kernel's rule, render_cuda.scene_form) it reads the sphere table where
//     it lies, through the read-only cache, and past a further size the tree
//     too, with the same floats and so the same rows;
//   * the hit points come from rt_common.cuh's raygen, primary_geometry,
//     reflect_dir and bounce_ray, the functions the render kernel calls,
//     written in rounded-once operations (rt_common.cuh fm / fa / fs / ff), so
//     this file's copies give the render kernel's bits: the boxes contain its
//     shadow-ray origins exactly, which the lists' coverage proof needs.
//     primary_geometry without tables over the gathered copy is the listed
//     sweep: the same spheres' floats in the same ascending order under the
//     strict `<`, so the same winner, t and center (its object id is the slot
//     in the copy, which surface() does not read). chip_smoke.py and the card
//     tests compare renders with the lists on and off bit for bit;
//   * any number of levels (the JAX package's kernel takes any): a pass keeps
//     the boxes of MAX_LEVELS levels in registers, and past those the chains
//     are traced again from their start for each further pass, to the same
//     hit points (levels beyond 4 need a depth of 4 or more, where the render
//     itself traces every chain that deep);
//   * only positions an output pixel consumes may widen a box: alive at this
//     level and every level before it, and inside [0, Wg-1] x [0, H-1] in the
//     frame's pixels (the -0.5 column and the ragged edge are evaluated by the
//     render kernel and thrown away). A slice of a ray-parallel render
//     (P_X0, Wg: render_fwd_kernel.cuh's head) walks its own tiles at the
//     frame's positions and keeps the frame's bounds, as the TPU kernel does:
//     a position past the slice's last column widens a box at most, and a
//     wider box only lists more spheres;
//   * min, max and an integer count are order-free, so the shuffles and the
//     merge give the same bits on every run and for every group size; the
//     scale is a max of non-negative floats, one atomicMax on their bits a
//     warp, the same bits on every run too. A tile without hits keeps the
//     sentinels +-1e30 and count 0 and does not feed the scale.

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

constexpr int TILE = 16;                    // render_fwd_kernel.cuh's tile
constexpr int N_C = TILE * TILE;
constexpr int N_U = (TILE + 1) * TILE;
constexpr int N_V = TILE * (TILE + 1);
constexpr int N_UV = (TILE + 1) * (TILE + 1);
constexpr int N_SHARED = N_C + N_U + N_V + N_UV;
constexpr int MAX_LEVELS = 4;               // levels a pass (hit_extents_cuda.MAX_LEVELS)
constexpr int ROW = 8;                      // floats a (tile, level) row
constexpr int HX_WARPS = 8;                 // warps a block
constexpr int NT = HX_WARPS * 32;

// Warps a tile without and with AA (divisors of HX_WARPS).
#ifndef RT_HX_TILE_WARPS
#define RT_HX_TILE_WARPS 1
#endif
#ifndef RT_HX_AA_TILE_WARPS
#define RT_HX_AA_TILE_WARPS 4
#endif
template <bool AA>
__host__ __device__ constexpr int tile_warps() {
  return AA ? RT_HX_AA_TILE_WARPS : RT_HX_TILE_WARPS;
}
static_assert(HX_WARPS % RT_HX_TILE_WARPS == 0 && HX_WARPS % RT_HX_AA_TILE_WARPS == 0,
              "the warps a tile must divide the warps a block");

// The sample position q of a tile whose corner pixel is (fx0, fy0):
// render_fwd_kernel.cuh's grids, C at (x, y), U at (x - 0.5, y), V at
// (x, y - 0.5), UV at (x - 0.5, y - 0.5), indices from the tile corner.
__device__ __forceinline__ void position(int q, float fx0, float fy0, float& px, float& py) {
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
  px = (fx0 + du) + static_cast<float>(kx);
  py = (fy0 + dv) + static_cast<float>(ky);
}

// Shared memory of a block, in floats: the parameters, the planes, each
// group's gathered slice (7 rows of vis_k spheres), with more than one warp a
// tile the merge rows (8 floats a (warp, level)) and, with bounce levels, the
// scene and the bounce tree.
__host__ __device__ inline int slice_words(const TableArgs& ta) {
  return ta.vis_idx ? 7 * ta.vis_k : 0;
}
template <int TW>
__host__ __device__ constexpr int merge_words() {
  return TW > 1 ? HX_WARPS * MAX_LEVELS * 8 : 0;
}

// The tile group's barrier: the warp's own for one warp a tile, else named
// barrier 1 + group over the group's TW warps.
template <int TW>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (TW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(TW * 32) : "memory");
  }
}

// The hit point of a chain's ray at trace level l: level 0 sweeps s0, a
// bounce level `full` through the tables (closest_hit_at's dispatch: the
// bounce tree where there is one).
template <bool COMPAT>
__device__ __forceinline__ Surface level_geometry(const SceneView& s0, const SceneView& full,
                                                  const Tables& tb, const Ray& ray, int l) {
  return l == 0 ? primary_geometry<COMPAT, false>(s0, ray, tb, 0)
                : primary_geometry<COMPAT, true>(full, ray, tb, l);
}

// One lane's share of a tile's sample positions (gl, gl + 32 TW, ..., gl the
// lane's place in the tile's group of TW warps): the chains that start there
// widen the lane's per-level boxes of levels [l0, l0 + LEVELS) (box k for
// level l0 + k) with their hit points. s0 is what the level-0 closest hit
// sweeps (the tile's gathered list, or the whole scene), `full` what the
// bounce levels sweep.
template <bool COMPAT, bool AA, int TW, int LEVELS>
__device__ __forceinline__ void trace_positions(const SceneView& s0, const SceneView& full,
                                                const Tables& tb, int gl, float fx0,
                                                float fy0, int Wg, int H, int n_levels,
                                                int l0, float (&mn)[LEVELS][3],
                                                float (&mx)[LEVELS][3], int (&cnt)[LEVELS]) {
  const float x_max = static_cast<float>(Wg - 1), y_max = static_cast<float>(H - 1);
  const int n_pos = AA ? N_SHARED : N_C;
  for (int q = gl; q < n_pos; q += TW * 32) {
    float px, py;
    position(q, fx0, fy0, px, py);
    const bool used = px >= 0.0f && px <= x_max && py >= 0.0f && py <= y_max;
    Ray ray = raygen(s0.p, px, py);
    // the levels before this pass's first: traced again, not kept
    bool alive = true;
    for (int l = 0; l < l0; ++l) {
      const Surface f = level_geometry<COMPAT>(s0, full, tb, ray, l);
      if (!f.alive) {
        alive = false;
        break;
      }
      float rx, ry, rz;
      reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, rx, ry, rz);
      ray = bounce_ray(f, rx, ry, rz);
    }
    if (!alive) continue;
#pragma unroll
    for (int k = 0; k < LEVELS; ++k) {
      const int l = l0 + k;
      if (l >= n_levels) break;
      const Surface f = level_geometry<COMPAT>(s0, full, tb, ray, l);
      // a chain dead at this level reaches no later one either, in the image
      // or out of it
      if (!f.alive) break;
      if (used) {
        mn[k][0] = fminf(mn[k][0], f.px); mx[k][0] = fmaxf(mx[k][0], f.px);
        mn[k][1] = fminf(mn[k][1], f.py); mx[k][1] = fmaxf(mx[k][1], f.py);
        mn[k][2] = fminf(mn[k][2], f.pz); mx[k][2] = fmaxf(mx[k][2], f.pz);
        cnt[k] += 1;
      }
      if (l + 1 < n_levels) {
        float rx, ry, rz;
        reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, rx, ry, rz);
        ray = bounce_ray(f, rx, ry, rz);
      }
    }
  }
}

template <bool COMPAT, bool AA, bool BOUNCES, bool G>
__global__ void __launch_bounds__(NT)
hit_extents_kernel(const float* __restrict__ params, const float* __restrict__ sph,
                   int ns, const float* __restrict__ pln, int npl,
                   float* __restrict__ out, float* __restrict__ scale, int W, int H,
                   int Wg, int n_levels, TableArgs ta) {
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_pln = s_p + N_PARAMS;
  float* s_slices = s_pln + 9 * npl;
  constexpr int TW = tile_warps<AA>(), GROUPS = HX_WARPS / TW;
  float* s_merge = s_slices + GROUPS * slice_words(ta);
  float* s_sph = s_merge + merge_words<TW>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / TW, gw = warp % TW, gl = gw * 32 + lane;
  for (int i = tid; i < N_PARAMS; i += NT) s_p[i] = params[i];
  for (int i = tid; i < 9 * npl; i += NT) s_pln[i] = pln[i];
  Tables tb = no_tables();
  if (BOUNCES) {
    if (!G) {
      for (int i = tid; i < 7 * ns; i += NT) s_sph[i] = sph[i];
    }
    stage_tree<G>(ta, s_sph + (G ? 0 : 7 * ns), tid, NT, tb);
  }
  __syncthreads();   // the only block-wide barrier: the tiles below are the groups' own
  // the whole scene: staged with bounce levels (G: where it lies, read through
  // the read-only cache), else where it lies
  const SceneView full{s_p, BOUNCES && !G ? s_sph : sph, ns, s_pln, npl, nullptr, 0, G};
  float* slice = s_slices + group * slice_words(ta);
  float* merge = s_merge + group * TW * MAX_LEVELS * 8;

  const int n_ty = (H + TILE - 1) / TILE;
  const int n_tiles = ((W + TILE - 1) / TILE) * n_ty;
  constexpr int LEVELS = BOUNCES ? MAX_LEVELS : 1;
  float top = 0.0f;   // the largest coordinate magnitude of this warp's rows with hits

  for (int tile = blockIdx.x * GROUPS + group; tile < n_tiles; tile += gridDim.x * GROUPS) {
    // the tile's cone-visible spheres, gathered in the list's ascending order
    const int n_vis = ta.vis_idx ? ta.vis_cnt[tile] : -1;
    if (n_vis >= 0) {
      const int* src = ta.vis_idx + static_cast<size_t>(tile) * ta.vis_k;
      for (int i = gl; i < n_vis; i += TW * 32) {
        const int j = src[i];
#pragma unroll
        for (int r = 0; r < 7; ++r) slice[r * n_vis + i] = sph_at(full, r * ns + j);
      }
    }
    group_sync<TW>(group);

    // the tile's corner pixel: tile = tx * n_ty + ty (render_fwd_kernel.cuh's
    // blockIdx.y * gridDim.x + blockIdx.x, blockIdx.y along x)
    const float fx0 = static_cast<float>((tile / n_ty) * TILE) + s_p[P_X0];
    const float fy0 = static_cast<float>((tile % n_ty) * TILE);
    // LEVELS levels a pass (one pass up to MAX_LEVELS levels; past that the
    // chains are traced again for each further pass, the same hit points)
    for (int l0 = 0; l0 < (BOUNCES ? n_levels : 1); l0 += LEVELS) {
      float mn[LEVELS][3], mx[LEVELS][3];
      int cnt[LEVELS];
#pragma unroll
      for (int l = 0; l < LEVELS; ++l) {
        mn[l][0] = mn[l][1] = mn[l][2] = BIG;
        mx[l][0] = mx[l][1] = mx[l][2] = -BIG;
        cnt[l] = 0;
      }
      // two calls, so that each sweep's loads know their memory (the gathered
      // slice in shared memory, or the whole scene)
      if (n_vis >= 0) {
        const SceneView listed{s_p, slice, n_vis, s_pln, npl, nullptr, 0};
        trace_positions<COMPAT, AA, TW, LEVELS>(listed, full, tb, gl, fx0, fy0, Wg, H,
                                                n_levels, l0, mn, mx, cnt);
      } else {
        trace_positions<COMPAT, AA, TW, LEVELS>(full, full, tb, gl, fx0, fy0, Wg, H,
                                                n_levels, l0, mn, mx, cnt);
      }
      const int n_pass = min(LEVELS, n_levels - l0);

      // the warp's share: every lane ends with its min, max and count; one
      // warp a tile writes the rows, else the group's first warp merges its
      // warps'
#pragma unroll
      for (int l = 0; l < LEVELS; ++l) {
        if (l >= n_pass) break;
        float v[7] = {mn[l][0], mn[l][1], mn[l][2], mx[l][0], mx[l][1], mx[l][2], 0.0f};
        int n = cnt[l];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[c] = fminf(v[c], __shfl_xor_sync(FULL, v[c], o));
            v[3 + c] = fmaxf(v[3 + c], __shfl_xor_sync(FULL, v[3 + c], o));
          }
          n += __shfl_xor_sync(FULL, n, o);
        }
        v[6] = static_cast<float>(n);   // at most 1089: exact in float32
        if (TW > 1) {
          if (lane < 7) {
            float w = 0.0f;
#pragma unroll
            for (int c = 0; c < 7; ++c) w = lane == c ? v[c] : w;
            merge[(gw * MAX_LEVELS + l) * 8 + lane] = w;
          }
          continue;
        }
        if (n > 0) {
#pragma unroll
          for (int c = 0; c < 6; ++c) top = fmaxf(top, fabsf(v[c]));
        }
        float* o = out + (static_cast<size_t>(tile) * n_levels + l0 + l) * ROW;
        if (lane < ROW) {
          float w = 0.0f;
#pragma unroll
          for (int c = 0; c < 7; ++c) w = lane == c ? v[c] : w;
          o[lane] = w;
        }
      }
      if (TW > 1) {
        group_sync<TW>(group);
        // lane c of the first warp merges column c of each level (min, max,
        // and the counts, whole numbers below 2^24: exact sums)
        if (gw == 0 && lane < ROW) {
          for (int l = 0; l < n_pass; ++l) {
            float w = lane < 3 ? BIG : lane < 6 ? -BIG : 0.0f;
            float n = 0.0f;
            for (int k = 0; k < TW; ++k) {
              const float* m = merge + (k * MAX_LEVELS + l) * 8;
              const float x = lane < 7 ? m[lane] : 0.0f;
              w = lane < 3 ? fminf(w, x) : lane < 6 ? fmaxf(w, x) : w + x;
              n += m[6];
            }
            if (n > 0.0f && lane < 6) top = fmaxf(top, fabsf(w));
            out[(static_cast<size_t>(tile) * n_levels + l0 + l) * ROW + lane] = w;
          }
        }
      }
      // the merge rows (and, after the last pass, the slice) are read before
      // they are written again
      group_sync<TW>(group);
    }
  }
  // one atomic a warp; non-negative floats order as their bits do
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(FULL, top, o));
  if (scale && lane == 0 && top > 0.0f) {
    atomicMax(reinterpret_cast<int*>(scale), __float_as_int(top));
  }
}

template <bool COMPAT, bool AA, bool BOUNCES, bool G>
cudaError_t launch_levels(const float* params, const float* sph, int ns, const float* pln,
                          int npl, float* out, float* scale, int W, int H, int Wg,
                          int n_levels, const TableArgs& ta, cudaStream_t stream) {
  const auto kernel = hit_extents_kernel<COMPAT, AA, BOUNCES, G>;
  constexpr int TW = tile_warps<AA>(), GROUPS = HX_WARPS / TW;
  const size_t smem =
      sizeof(float) * (N_PARAMS + 9 * static_cast<size_t>(npl) +
                       GROUPS * static_cast<size_t>(slice_words(ta)) + merge_words<TW>() +
                       (BOUNCES && !G ? 7 * static_cast<size_t>(ns) + tree_words(ta) : 0));
  cudaError_t e;
  if (smem > static_cast<size_t>(227 * 1024)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // one tile a group: the hardware hands out the blocks as others finish
  const long n_tiles = static_cast<long>((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE);
  const long grid = (n_tiles + GROUPS - 1) / GROUPS;
  if (scale && (e = cudaMemsetAsync(scale, 0, sizeof(float), stream)) != cudaSuccess) {
    return e;
  }
  kernel<<<static_cast<unsigned>(grid), NT, smem, stream>>>(params, sph, ns, pln, npl, out,
                                                            scale, W, H, Wg, n_levels, ta);
  return cudaGetLastError();
}

// form: 0 staged, 1 global (the sphere table and the tree where they lie);
// only a launch with bounce levels stages either.
template <bool COMPAT, bool AA>
cudaError_t launch(const float* params, const float* sph, int ns, const float* pln,
                   int npl, float* out, float* scale, int W, int H, int Wg, int n_levels,
                   const TableArgs& ta, int form, cudaStream_t stream) {
  if (n_levels == 1) {
    return launch_levels<COMPAT, AA, false, false>(params, sph, ns, pln, npl, out, scale, W,
                                                   H, Wg, n_levels, ta, stream);
  }
  return form == 0
             ? launch_levels<COMPAT, AA, true, false>(params, sph, ns, pln, npl, out, scale,
                                                      W, H, Wg, n_levels, ta, stream)
             : launch_levels<COMPAT, AA, true, true>(params, sph, ns, pln, npl, out, scale, W,
                                                     H, Wg, n_levels, ta, stream);
}

}  // namespace

extern "C" {

// Hit extents of a W x H render into out (n_tiles * n_levels, 8) float32 on
// `stream`, tiles of 16x16 pixels numbered x tiles outermost: the slice
// [params[P_X0], params[P_X0] + W) of a frame Wg columns wide, as for
// rt_render_fwd (Wg == W for a whole frame). params, sph and
// pln as for rt_render_fwd. scale (1 float, or null): receives the largest
// |coordinate| of the rows with hits (0 if none). aliasing: walk the 3x3 AA
// lattice (the four shared grids) instead of the pixel centers. vis_idx /
// vis_cnt / vis_k: the primary cone-cull lists the render will use (null:
// none); perm / box / n_leaves: the bounce tree it will use past level 0
// (rt_common.cuh Tables; null: none; not staged when n_levels is 1, where no
// ray reads it). form: as for rt_render_fwd (render_cuda.scene_form; read only
// with n_levels > 1). Returns cudaGetLastError() after the launch (0 on
// success).
int rt_hit_extents(const float* params, const float* sph, int ns, const float* pln,
                   int npl, float* out, float* scale, int W, int H, int Wg, int n_levels,
                   int aliasing, int compat, const int* vis_idx, const int* vis_cnt,
                   int vis_k, const int* perm, const float* box, int n_leaves, int form,
                   void* stream) {
  const bool bounces = n_levels > 1;
  const TableArgs ta{vis_idx, vis_cnt, vis_k, nullptr, nullptr, 0,
                     bounces ? perm : nullptr, box, n_leaves};
  if (W <= 0 || H <= 0 || Wg < W || ns < 0 || npl < 0 || n_levels < 1 ||
      form < 0 || form > 1 ||
      static_cast<long>((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE) > (1L << 30) ||
      !tables_ok(ta)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (compat) {
    e = aliasing ? launch<true, true>(params, sph, ns, pln, npl, out, scale, W, H, Wg,
                                      n_levels, ta, form, st)
                 : launch<true, false>(params, sph, ns, pln, npl, out, scale, W, H, Wg,
                                       n_levels, ta, form, st);
  } else {
    e = aliasing ? launch<false, true>(params, sph, ns, pln, npl, out, scale, W, H, Wg,
                                       n_levels, ta, form, st)
                 : launch<false, false>(params, sph, ns, pln, npl, out, scale, W, H, Wg,
                                        n_levels, ta, form, st);
  }
  return static_cast<int>(e);
}

}  // extern "C"
