// Forward render kernel for Hopper (sm_90a): ray generation -> closest hit ->
// ambient + Lambert + shadow rays -> mirror bounces -> 3x3 AA with the
// reference's compat G/B swaps, in one launch, one thread per pixel.
//
// Replaces the TPU kernels of python_ray_tracer_tpu/ops/pallas/render_pallas.py:
//   AA_NONE        <- _make_kernel (:1487) at S=1 (no AA)
//   AA_PER_SAMPLE  <- _make_kernel (:1487) at S=9 (per-sample AA grid axis)
//   AA_SHARED      <- _make_kernel_aa_shared (:1386) (4 shared sample grids)
// and, in render_list_kernel below, the TPU kernel of adaptive AA's worklist
// (python_ray_tracer_tpu/ops/pallas/render_adaptive.py:97, _make_list_kernel).
//
// What bounds it on this card: FP32 ALU work and sqrt/division rate, not
// memory. The scene is 60 floats (demo) to 7000 (1000 spheres) and the output
// 12 bytes a pixel; without tables every ray sweeps every object (spheres,
// planes) once for its closest hit and once per light for its shadow test, at
// each of up to depth+1 trace levels. With the tables, what is left at 1000
// spheres is the bounce levels (rt_common.cuh's head): the tiles' lists make
// the primary and level-0 shadow sweeps short, and a bounce ray's sweeps go
// through the bounce tree.
//
// What the design does about it:
//   * the parameter vector and the scene's SoA tables are staged in shared
//     memory at block start, so object reads are broadcasts that cost no
//     global-memory traffic (the staged form; past the size where a block's
//     227 KB hold them, the global form below);
//   * loops over objects, lights and bounces run at run time (no unroll
//     limit); a ray that misses stops bouncing and a shadow ray stops at its
//     first occluder, both exact;
//   * AA_SHARED evaluates each distinct sample position once per block: the
//     reference's AA samples are midpoints between neighbouring pixels, so a
//     16x16 block needs its 256 centers, 17x16 + 16x17 edge midpoints and
//     17x17 corners (1089 chains) instead of 9 x 256 = 2304;
//   * no atomics: every output element is written by one thread, so the
//     output is deterministic;
//   * large scenes (the TABLES instantiations, render_fwd.cu; the host wrapper
//     decides) sweep less: a block is one tile of the host's tables, so its primary rays
//     sweep the tile's cone-visible spheres, its level-0 shadow rays the
//     tile's per-light occluder lists (built from the hit-extent kernel's
//     rows, hit_extents.cu), its bounce rays the bounce tree's boxes they
//     meet and their shadow rays their light cell's row (light_cells.cu; the
//     rows stay in device memory, read through the read-only path). The
//     block's lists and the tree are staged in shared memory beside the
//     scene; lists are uniform across the block, box tests and cell rows
//     are per thread. Every cull is exact: the image is bit-identical to the full
//     sweep's, exact t ties included (the tree takes the least (t, index)),
//     which the same instantiation renders with its tables off, and which
//     needs rt_common.cuh's pinned arithmetic. The small-scene
//     instantiations (render_fwd_small.cu) are the kernel without any of it,
//     in the compiler's own arithmetic.
// Occupancy tuning and gathered (cx, cy, cz, r) list rows are later work.
//
// The global form (G, large scenes only, render_fwd_global.cu): the sphere
// table is read where it lies in device memory, through the read-only cache
// (rt_common.cuh sph_at), and so is the bounce tree; the block stages the
// parameters, planes, lights and the tile's lists, whose rows have at most
// cull_tables.list_capacity (128) slots. The wrapper decides the form
// (render_cuda.scene_form): staged wherever the scene fits, so every frame the
// staged form draws is unchanged. At 1 plane and 3 lights the staged form
// takes 7753 spheres (5600 with the tree), the global form any scene. Both
// forms read the same floats in the same pinned arithmetic, so a frame is the
// same bits in either.
//
// Block shape: 16x16 threads; threadIdx.x walks the image's y axis, which is
// the contiguous axis of the (w, h, 3) output. The ragged edge is masked with
// `<` (the reference's `<=` bound reads out of bounds; see the README's
// divergence ledger, item 1).
//
// Slices (ray-parallel sharding): a launch renders columns [P_X0, P_X0 + W)
// of a frame Wg columns wide. Grid, tiles, output and the ragged-edge mask are
// the slice's own (local x); rays, the AA lattice's positions and the border
// ring's test are the frame's (global x = P_X0 + local x, exact in float32).
// Tile corners then sit at P_X0 + 16 k instead of 16 k, so a slice's tiles
// hold other pixels than the frame's: every per-pixel value is still the
// frame's own (the lattice positions are the same floats, each sample chain
// is a function of its position alone, and every cull is exact), so frames
// stitched from slices equal the whole frame bit for bit.
//
// Shadow lists at the bounce levels (the render's shadow_list_levels = L >
// 1): the tile's occluder rows of the first L trace levels are staged beside
// its primary list (L x nl rows, rt_common.cuh stage_lists) and a shadow ray
// of level b < L sweeps its level's row (light_occluded); a larger L moves
// the size where the wrapper switches to the global form (render_cuda.
// scene_form counts the rows).
//
// This header holds the kernels and their launches; each of the source files
// includes it once, after choosing rt_common.cuh's arithmetic, and
// instantiates its own part (TABLES false in render_fwd_small.cu, TABLES in
// render_fwd.cu, TABLES and G in render_fwd_global.cu, with entry points of
// its own, so that nvcc compiles it beside render_fwd.cu and a library built
// without it still loads), so the worklist pass runs the same arithmetic as
// the render it stands in for.
#pragma once

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

enum : int { AA_NONE = 0, AA_PER_SAMPLE = 1, AA_SHARED = 2 };

constexpr int TILE = 16;                                   // pixels a side
constexpr int N_C = TILE * TILE;                           // centers
constexpr int N_U = (TILE + 1) * TILE;                     // x-axis midpoints
constexpr int N_V = TILE * (TILE + 1);                     // y-axis midpoints
constexpr int N_UV = (TILE + 1) * (TILE + 1);              // corners
constexpr int N_SHARED = N_C + N_U + N_V + N_UV;           // 1089

__device__ __forceinline__ void store(float* out, int H, int x, int y,
                                      float c0, float c1, float c2) {
  float* o = out + (static_cast<size_t>(x) * H + y) * 3;
  o[0] = c0;
  o[1] = c1;
  o[2] = c2;
}

// Shared-memory words of the parameter vector and the scene's SoA tables
// (G, the global form: without the sphere table).
template <bool G = false>
__host__ __device__ __forceinline__ int scene_words(int ns, int npl, int nl) {
  return N_PARAMS + (G ? 0 : 7 * ns) + 9 * npl + 3 * nl;
}

// Stage the parameter vector and the scene's tables at smem (thread tid of
// nt) and return the view of them; the words past scene_words<G> are the
// caller's. G: the sphere table stays where it lies (read through sph_at).
// The caller synchronises.
template <bool G = false>
__device__ __forceinline__ SceneView stage_scene(const float* __restrict__ params,
                                                 const float* __restrict__ sph, int ns,
                                                 const float* __restrict__ pln, int npl,
                                                 const float* __restrict__ lts, int nl,
                                                 float* smem, int tid, int nt) {
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + (G ? 0 : 7 * ns);
  float* s_lts = s_pln + 9 * npl;
  for (int i = tid; i < N_PARAMS; i += nt) s_p[i] = params[i];
  if (!G) {
    for (int i = tid; i < 7 * ns; i += nt) s_sph[i] = sph[i];
  }
  for (int i = tid; i < 9 * npl; i += nt) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += nt) s_lts[i] = lts[i];
  return SceneView{s_p, G ? sph : s_sph, ns, s_pln, npl, s_lts, nl, G};
}

// AA_PER_SAMPLE's value of the pixel at (gx, gy), in the stored layout: the
// primary sample, and where aa (an interior pixel) its 8 neighbours added and
// the sum scaled by float32(1/9). Compat stores the primary sample (R, B, G),
// the store swap (common.py:61-63); the neighbours land unswapped, since the
// accumulation swap (kernels.py:59-60) composed with the store swap cancels
// for them. The render kernel and the worklist kernel both call this, so a
// worklist frame with every interior pixel listed is the per-sample frame.
template <bool COMPAT, bool CHEAP, bool TABLES>
__device__ __forceinline__ Rgb per_sample_aa(const SceneView& s, const Tables& tb, float gx,
                                             float gy, int depth, bool aa) {
  const Rgb c0 = sample_chain<COMPAT, CHEAP, TABLES>(s, tb, gx + s.p[P_OFFS],
                                                     gy + s.p[P_OFFS + 1], depth);
  Rgb o{c0.r, COMPAT ? c0.b : c0.g, COMPAT ? c0.g : c0.b};
  if (aa) {
    for (int k = 1; k < 9; ++k) {
      const Rgb c = sample_chain<COMPAT, CHEAP, TABLES>(
          s, tb, gx + s.p[P_OFFS + 2 * k], gy + s.p[P_OFFS + 2 * k + 1], depth);
      o.r += c.r;
      o.g += c.g;
      o.b += c.b;
    }
    const float inv9 = static_cast<float>(1.0 / 9.0);
    o.r *= inv9;
    o.g *= inv9;
    o.b *= inv9;
  }
  return o;
}

// Launch bounds. The TABLES instantiations (render_fwd.cu) ask for a minimum
// of resident blocks a multiprocessor, which caps their registers. Left to
// itself, since the light cells' lookup ptxas makes every aa_shared and
// aa_per_sample instantiation spill (aa_per_sample never did before) and one
// of aa_none's; 3 blocks (at most 85 registers) keep aa_none and aa_shared
// free of spills, 2 (at most 128) aa_per_sample. The worklist kernel spills
// in neither case and takes 2 as well. These bounds are chosen for no spill,
// not for speed: chip_smoke.py's [lightbuf-bounds] prints ptxas's rows and
// times each kernel against the same source with no minimum (PERF.md). The
// small-scene instantiations (render_fwd_small.cu) ask for a minimum of 0,
// which is no minimum: ptxas then reports the registers, spills and stack of
// a bound without a second argument (a minimum of 1 lets it give
// aa_per_sample 89-92 registers).

template <int MODE, bool COMPAT, bool CHEAP, bool TABLES, bool G = false>
__global__ void __launch_bounds__(TILE * TILE,
                                   TABLES ? (MODE == AA_PER_SAMPLE ? 2 : 3) : 0)
render_fwd_kernel(const float* __restrict__ params, const float* __restrict__ sph,
                  int ns, const float* __restrict__ pln, int npl,
                  const float* __restrict__ lts, int nl, float* __restrict__ out,
                  int W, int H, int Wg, int depth, TableArgs ta) {
  extern __shared__ float smem[];
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const SceneView s =
      stage_scene<G>(params, sph, ns, pln, npl, lts, nl, smem, tid, TILE * TILE);
  // The tile id of the host's tables: x tiles outermost, as cull_tables.py
  // numbers them.
  float* s_tab = smem + scene_words<G>(ns, npl, nl);
  Tables tb = no_tables();
  if (TABLES) {
    tb = stage_tables<G>(ta, nl, blockIdx.y * gridDim.x + blockIdx.x, s_tab, tid,
                         TILE * TILE);
  }
  __syncthreads();

  // local pixel (x, y) of the output; global x of the tile corner and pixel
  const int x0 = blockIdx.y * TILE, y0 = blockIdx.x * TILE;
  const int x = x0 + threadIdx.y, y = y0 + threadIdx.x;
  const float fx0 = static_cast<float>(x0) + s.p[P_X0];
  const float fy0 = static_cast<float>(y0);
  const float gx = fx0 + static_cast<float>(threadIdx.y);
  const float gy = fy0 + static_cast<float>(threadIdx.x);
  const bool interior = gx >= 1.0f && gx <= static_cast<float>(Wg - 2) &&
                        gy >= 1.0f && gy <= static_cast<float>(H - 2);

  if (MODE == AA_SHARED) {
    // Evaluate the block's 4 shared sample grids into shared memory:
    // C (16x16) at (x, y), U (17x16) at (x - 0.5, y), V (16x17) at
    // (x, y - 0.5), UV (17x17) at (x - 0.5, y - 0.5), indices from the tile
    // corner; channel c of sample q lives at samp[c * N_SHARED + q].
    float* samp = s_tab + (TABLES ? table_words<G>(ta, nl) : 0);
    for (int q = tid; q < N_SHARED; q += TILE * TILE) {
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
      const Rgb c = sample_chain<COMPAT, CHEAP, TABLES>(
          s, tb, (fx0 + du) + static_cast<float>(kx),
          (fy0 + dv) + static_cast<float>(ky), depth);
      samp[q] = c.r;
      samp[N_SHARED + q] = c.g;
      samp[2 * N_SHARED + q] = c.b;
    }
    __syncthreads();
    if (x >= W || y >= H) return;
    const int kx = threadIdx.y, ky = threadIdx.x;
    const int iC = kx * TILE + ky;
    const int iU = N_C + kx * TILE + ky;                        // U[kx][ky]
    const int iV = N_C + N_U + kx * (TILE + 1) + ky;            // V[kx][ky]
    const int iUV = N_C + N_U + N_V + kx * (TILE + 1) + ky;     // UV[kx][ky]
    const Rgb o = aa_combine<COMPAT>(samp, N_SHARED, TILE, iC, iU, iV, iUV, interior);
    store(out, H, x, y, o.r, o.g, o.b);
    return;
  }

  if (x >= W || y >= H) return;
  const Rgb o = per_sample_aa<COMPAT, CHEAP, TABLES>(s, tb, gx, gy, depth,
                                                     MODE == AA_PER_SAMPLE && interior);
  store(out, H, x, y, o.r, o.g, o.b);
}

// Adaptive AA's worklist pass (replaces the TPU kernel _make_list_kernel,
// python_ray_tracer_tpu/ops/pallas/render_adaptive.py:97): one thread per
// listed pixel traces its 9 AA samples and writes their average
// (per_sample_aa, the render kernel's AA_PER_SAMPLE code) straight into the
// tent image at (x, y), which the wrapper allocated for this launch and hands
// over. What bounds it: FP32 work, 9 sample chains a listed pixel. With the
// large-scene tables (TABLES, and the wrapper passes them) a chain reads the
// tables of its pixel's tile, (x / 16) * ceil(H / 16) + y / 16 as
// cull_tables.py numbers tiles: its primary and level-0 shadow sweeps take
// that tile's lists, read straight from device memory (the worklist runs in
// flat x * H + y order, so a warp's pixels lie in 1-3 tiles), and its bounce
// sweeps the bounce tree, staged in shared memory beside the scene. The lists
// must have been built for the AA lattice (aliasing), whose boxes hold every
// sample of a tile's pixels. The TPU kernel traced a (rows, 128) list of
// float sample coordinates into a (3, rows, 128) sample buffer that XLA then
// combined and scattered, because the TPU has no scatter worth the name; here
// each thread derives its pixel from the flat index x * H + y and writes its
// own 12 bytes, so no
// sample buffer, coordinate list or scatter exists. idx holds K slots; the
// first min(*flagged, K) are live (the count stays on the device: no host
// sync). A block whose first slot is past the count exits before staging the
// scene, so the empty tail of a static-budget grid costs almost nothing.
constexpr int LIST_BLOCK = 256;

template <bool COMPAT, bool CHEAP, bool TABLES, bool G = false>
__global__ void __launch_bounds__(LIST_BLOCK, TABLES ? 2 : 0)
render_list_kernel(const float* __restrict__ params, const float* __restrict__ sph, int ns,
                   const float* __restrict__ pln, int npl, const float* __restrict__ lts,
                   int nl, const int* __restrict__ idx, const int* __restrict__ flagged,
                   int K, float* __restrict__ out, int W, int H, int depth, TableArgs ta) {
  const int n = min(*flagged, K);
  const int first = blockIdx.x * LIST_BLOCK;
  if (first >= n) return;   // uniform across the block, before any barrier
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const SceneView s =
      stage_scene<G>(params, sph, ns, pln, npl, lts, nl, smem, tid, LIST_BLOCK);
  // With every table off (and without TABLES) every sweep takes its
  // full-sweep branch, the machine code of the render kernel with every cull
  // off. G: the global form, the tree read where it lies (as the render's).
  Tables tb = no_tables();
  if (TABLES) stage_tree<G>(ta, smem + scene_words<G>(ns, npl, nl), tid, LIST_BLOCK, tb);
  __syncthreads();
  const int slot = first + tid;
  if (slot >= n) return;
  const int p = idx[slot];
  if (p < 0 || p >= W * H) return;
  const int x = p / H, y = p % H;
  if (TABLES) tile_lists(ta, nl, (x / TILE) * ((H + TILE - 1) / TILE) + y / TILE, tb);
  const Rgb o = per_sample_aa<COMPAT, CHEAP, TABLES>(s, tb, static_cast<float>(x),
                                                     static_cast<float>(y), depth, true);
  store(out, H, x, y, o.r, o.g, o.b);
}

// The scene, the output and the launch settings, bundled for the dispatch.
struct Job {
  const float* params;
  const float* sph;
  int ns;
  const float* pln;
  int npl;
  const float* lts;
  int nl;
  float* out;
  int W, H, depth;
  TableArgs ta;
  cudaStream_t stream;
  int Wg;   // the frame's width; W is the slice's (rt_render_fwd)
};

// Shared memory above 48 KB needs the kernel's opt-in; past 227 KB no launch.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(227 * 1024)) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int MODE, bool COMPAT, bool CHEAP, bool TABLES, bool G>
cudaError_t launch(const Job& j) {
  const size_t smem =
      sizeof(float) * (scene_words<G>(j.ns, j.npl, j.nl) +
                       (TABLES ? table_words<G>(j.ta, j.nl) : 0) +
                       (MODE == AA_SHARED ? 3 * N_SHARED : 0));
  const auto kernel = render_fwd_kernel<MODE, COMPAT, CHEAP, TABLES, G>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 block(TILE, TILE);
  const dim3 grid((j.H + TILE - 1) / TILE, (j.W + TILE - 1) / TILE);
  kernel<<<grid, block, smem, j.stream>>>(j.params, j.sph, j.ns, j.pln, j.npl, j.lts, j.nl,
                                          j.out, j.W, j.H, j.Wg, j.depth, j.ta);
  return cudaGetLastError();
}

template <int MODE, bool TABLES, bool G>
cudaError_t dispatch_mode(bool compat, bool cheap, const Job& j) {
  if (compat) {
    return cheap ? launch<MODE, true, true, TABLES, G>(j)
                 : launch<MODE, true, false, TABLES, G>(j);
  }
  return cheap ? launch<MODE, false, true, TABLES, G>(j)
               : launch<MODE, false, false, TABLES, G>(j);
}

// mode: 0 no AA, 1 per-sample AA, 2 shared-sample AA; G: the global form.
template <bool TABLES, bool G = false>
cudaError_t dispatch(int mode, bool compat, bool cheap, const Job& j) {
  switch (mode) {
    case AA_NONE:
      return dispatch_mode<AA_NONE, TABLES, G>(compat, cheap, j);
    case AA_PER_SAMPLE:
      return dispatch_mode<AA_PER_SAMPLE, TABLES, G>(compat, cheap, j);
    case AA_SHARED:
      return dispatch_mode<AA_SHARED, TABLES, G>(compat, cheap, j);
    default:
      return cudaErrorInvalidValue;
  }
}

// The worklist pass over K slots of idx (j.out is the tent image).
template <bool COMPAT, bool CHEAP, bool TABLES, bool G>
cudaError_t launch_list(const Job& j, const int* idx, const int* flagged, int K) {
  const size_t smem = sizeof(float) * (scene_words<G>(j.ns, j.npl, j.nl) +
                                       (TABLES && !G ? tree_words(j.ta) : 0));
  const auto kernel = render_list_kernel<COMPAT, CHEAP, TABLES, G>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (K + LIST_BLOCK - 1) / LIST_BLOCK;
  kernel<<<blocks, LIST_BLOCK, smem, j.stream>>>(j.params, j.sph, j.ns, j.pln, j.npl, j.lts,
                                                 j.nl, idx, flagged, K, j.out, j.W, j.H,
                                                 j.depth, j.ta);
  return cudaGetLastError();
}

template <bool TABLES, bool G = false>
cudaError_t dispatch_list(bool compat, bool cheap, const Job& j, const int* idx,
                          const int* flagged, int K) {
  if (compat) {
    return cheap ? launch_list<true, true, TABLES, G>(j, idx, flagged, K)
                 : launch_list<true, false, TABLES, G>(j, idx, flagged, K);
  }
  return cheap ? launch_list<false, true, TABLES, G>(j, idx, flagged, K)
               : launch_list<false, false, TABLES, G>(j, idx, flagged, K);
}

}  // namespace
