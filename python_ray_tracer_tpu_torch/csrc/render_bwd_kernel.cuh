// Backward render kernel for Hopper (sm_90a): scene and camera gradients of
// the render, by hand-derived reverse-mode adjoints of the whole chain (ray
// generation -> closest hit -> normal -> ambient/Lambert/Phong with shadow
// rays -> mirror bounces -> AA), one thread per sample chain.
//
// Replaces the TPU kernel python_ray_tracer_tpu/ops/pallas/render_bwd.py
// _make_bwd_kernel (:736), with its helpers _norm_adj (:70), _fwd_trace_res
// (:144) and _bwd_trace (:464). Modes (C enum below):
//   COT_NOAA    cotangent image in, no AA              (render_bwd.py:1039-1044)
//   COT_AA      cotangent image in, the AA lattice     (:1066-1130, aa_share)
//   FUSED_NOAA  target in: the kernel renders the pixel, forms the MSE loss
//               partial and its cotangent, then reverse-sweeps  (:958-977)
//   FUSED_AA    target and the aa_shared render in: loss partial and
//               cotangent per pixel, then COT_AA's lattice chains
//   FUSED_AA1   target in: the AA step in one launch, in three phases a tile
//               (render_bwd.py:744-763): A traces the lattice chains through
//               the render's sample_chain, keeping their colors in shared
//               memory and each trace's (t, hit object, occlusion bits) in a
//               device-memory record buffer; B combines them in AA_SHARED's
//               order (aa_combine) into the pixels, the loss partial and the
//               cotangents; C rebuilds each chain from its records
//               (replay_chain: no closest-hit or shadow sweep) and
//               reverse-sweeps it as COT_AA does
// Every mode fills the camera slots (position, rotation, fov).
//
// Output: per-block partial sums of the flat gradient vector of
// render_bwd.grad_layout,
//   [spheres 7*ns (cx cy cz r ar ag ab), planes 9*npl (ox oy oz nx ny nz ar
//   ag ab), lights 3*nl, amb, lamb, refl, spec, shin, cam_pos 3, rot 9, fov]
// plus a trailing loss slot in the fused modes; rt_reduce_rows (render_bwd.cu)
// sums them in a fixed order.
//
// What bounded the first port of this kernel (0.16 ms a fit step at 1000x1000
// depth 2 without AA, 1.61 ms with, H100 at 700 W): reductions inside the
// reverse loop (per trace 3 nl light slots and each hit object's 7 or 9 slots
// warp-summed one object at a time, per chain 19 camera, material and loss
// slots: ~29 warp sums a trace, ~106 a chain on the fit scene, each 5 shuffles
// and a shared-memory add, all of them even where every lane's value was 0),
// the residuals in local memory (an array indexed at run time), one block per
// 128 pixels, and 9 chains a pixel with AA. What bounds this one: the chain's
// FP32 arithmetic (closest-hit and shadow sweeps, sqrt and division).
//
// What the design does about it:
//   * the forward chain is recomputed per thread through rt_common.cuh's
//     raygen / closest_hit / occluded / surface / reflect_dir, the functions
//     the render kernel uses, in the arithmetic the render kernel uses for the
//     same scene (below); per trace only (origin, direction, t, hit index,
//     shadow bitmask) is kept, and the reverse sweep rebuilds the rest;
//   * the residuals stay in registers: the kernel is instantiated for depths
//     0-3 (the main path's 2 among them), where each trace's record is read
//     and written through a chain of selects on the loop index; other depths
//     up to MAX_DEPTH take a general instantiation with a run-time indexed
//     array;
//   * no reduction inside the loops (COLS, the small scenes): every thread
//     adds each adjoint into its own column of shared memory, slot k of
//     thread t at k * nt + t (neighbouring lanes hit neighbouring banks; no
//     atomics), for every trace of every chain it takes. At the end each slot
//     is reduced once a block in a fixed order (each lane sums its column's
//     entries of the block's warps in warp order, then one warp sum), and a
//     warp-uniform __any_sync skips a slot that is 0 on every lane;
//   * where the columns do not fit a block (ROWS: the large scenes, 7 ns
//     sphere slots, and small scenes with very many slots) the object and
//     light slots keep per-warp rows, each adjoint warp-reduced as it is
//     produced (acc, acc_obj); the 18-19 camera, material and loss slots are
//     lane-private columns in both forms, added to once a chain;
//   * a block walks several 16x16 tiles (tile b, b + gridDim.x, ...): the
//     grid is sized to the card by the wrapper's planner, and each block
//     writes one partial column;
//   * the AA modes trace the forward's lattice: a tile's 1089 distinct sample
//     positions (the C, U, V and UV grids of render_fwd_kernel.cuh's
//     AA_SHARED) instead of 9 chains a pixel. A lattice chain's cotangent is
//     the sum of the weights of the in-tile pixels whose 3x3 stencil holds it
//     (float32(1/9) each for an interior pixel; a border pixel takes its
//     primary sample alone, weight 1; the compat channel swap on the centre
//     sample only), exactly the adjoint of the forward's combine. A position
//     on a tile edge is traced by both tiles, each with its own share;
//   * exact skips: a chain whose cotangent is 0 runs no reverse sweep (every
//     adjoint is linear in it; in ROWS it still joins the collectives) and, in
//     the cotangent modes, no forward chain either; in COLS a trace that does
//     not contribute (a miss, past the chain's end) is not swept at all;
//   * the reverse sweep takes each light's terms once a trace, for the shade
//     and its adjoints alike (the first port took them twice);
//   * determinism without float atomics: every column and row has one writer,
//     each block writes its partial column in a fixed order, and a second
//     kernel (reduce_rows) sums each slot's column in a fixed tree order. Two
//     runs give the same bits;
//   * the per-pixel cotangent and target are read only for in-bounds pixels.
// The launch plan (threads a block, the grid, COLS or ROWS) comes from the
// wrapper's planner (render_bwd_cuda.plan), one rule: 128 threads a block and
// the slot columns where the scene is a small one and they fit (else 64, then
// 32 threads), else per-warp rows (128, 64, 32 threads); BLOCKS_PER_SM blocks
// (4; fewer where their shared memory does not fit an SM) on each SM, at most
// one a tile. Shared memory a block:
//   4 B x (41 + 7 ns + 9 npl + 3 nl              the scene (7 ns: staged form)
//          + TABLES: a tile's lists (+ the tree)  bwd_table_words
//          + 3 x 1089 in FUSED_AA1               the lattice's colors
//          + 6 x 256 with AA                     a tile's pixel cotangents
//          + COLS: n_grads x nt                  every slot's columns
//            ROWS: nwarps x (n_grads - 18 - fused) + (18 + fused) x nt)
// The staged form (G false) copies the sphere table into shared memory at
// block start. The global form (G, large scenes only, render_bwd_global.cu)
// reads the view's sphere table where it lies in device memory, through the
// read-only cache (rt_common.cuh sph_at), and the block keeps only the
// parameters, planes, lights, cotangents and its gradient rows; that reaches
// 8208 spheres (7989 with AA) at 1 plane and 3 lights, past the 7753 the
// render kernel takes, where the staged form stops at 4104 (3994). The
// planner takes the most threads a block that either form fits, staged where
// both do (render_bwd_cuda.plan: on the card the global form is slower at the
// same threads and faster at twice the staged form's). At 1 plane and 3
// lights without AA that is 128 threads staged up to 1587 spheres, then
// global up to 1983, 64 staged up to 2704, then global up to 4057, 32 staged
// up to 4101, then global. Both forms read the same floats in the same
// order, so their gradients are the same bits.
// Past 8203 spheres (7984 with AA) even the global form's rows do not fit a
// block: the third form (R, render_bwd_rows.cu; the planner takes it only
// where neither of the others fits) keeps each warp's row of object and light
// slots in a device-memory scratch buffer (blocks x warps x (7 ns + 9 npl +
// 3 nl) floats) that the wrapper allocates and the kernel zeroes. Each warp
// still owns its row (lane 0 adds each warp sum to it, as in shared memory)
// and the block still sums its rows in warp order into its partial column,
// so at the same launch shape the gradients are the other forms' bits, with
// no atomics. The block keeps the parameters, planes, lights, cotangents and
// the 18-19 tail columns, which fit any scene.
//
// Slices (ray-parallel sharding): a launch reverse-sweeps columns [P_X0, P_X0
// + W) of a frame Wg columns wide, as render_fwd_kernel.cuh renders them:
// tiles, pixel bounds and pad pixels are the slice's (local x), the rays, the
// AA lattice's positions and the border ring's test the frame's (global x),
// and the fused modes' loss and cotangents have the frame's denominator
// 3 Wg H, so the slices' partial sums add up to the frame's.
//
// Large scenes (TABLES, the pinned sources): the kernel reads the render's
// large-scene tables (rt_common.cuh TableArgs; the render's 16x16 tiles, so
// the tables a frame's render builds serve its backward, AA lattice and
// slices included): each block stages a tile's primary list and its shadow
// lists (those of the render's listed trace levels, rt_common.cuh
// stage_lists) between two barriers as it walks its tiles, and the bounce tree once
// (tree_smem, the staged form; else it reads the tree where it lies, as the
// global and rows forms do); the light cells stay in device memory. The
// recomputed chains decide every hit and shadow through the render's own
// level dispatch (closest_hit_at, light_occluded), so with the same tables
// they are the render's, and with any of them on the gradients are the bits
// of the same launch with every table off.
//
// This header holds the kernel and its launch. Four source files include it
// once each, after choosing rt_common.cuh's arithmetic, as the render kernel's
// two halves do: render_bwd_small.cu (contracted; COLS at depths 0-3 and the
// general depth, ROWS at the general depth) for scenes the render kernel draws
// without tables, render_bwd.cu (pinned; ROWS at depths 0-3 and the general
// depth) for large scenes, so that the recomputed chain decides each hit as
// the forward did, render_bwd_global.cu (pinned; the global form of
// render_bwd.cu's kernels, compiled beside it) and render_bwd_rows.cu
// (pinned; the third form, with an entry point of its own). The one-launch AA
// step (FUSED_AA1) of each lives in a twin of its own, render_bwd_one_small.cu,
// render_bwd_one.cu, render_bwd_one_global.cu and render_bwd_one_rows.cu, which
// its entry point calls for that mode, so that nvcc compiles the eight files
// side by side. A scene small enough for the contracted kernels always fits
// the staged form.
#pragma once

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

enum : int { COT_NOAA = 0, COT_AA = 1, FUSED_NOAA = 2, FUSED_AA = 3, FUSED_AA1 = 4 };

// Resident blocks a multiprocessor the kernel asks ptxas to make room for (0:
// no minimum, ptxas's own register choice); chip_smoke.py's [bwd-bounds] times
// other minimums, built with -DRT_BWD_MIN_BLOCKS.
#ifndef RT_BWD_MIN_BLOCKS
#define RT_BWD_MIN_BLOCKS 0
#endif

// The one-launch AA step's minimum: 4 blocks of MAX_NT threads, at most 128
// registers. Left to itself ptxas gave its compat depth-2 instantiation 148
// (3 blocks an SM where the planner deals out 4), and the 100-sphere
// 1000x1000 step ran 6.2821 ms against 4.5247 with the step inside the other
// modes' 128-register instantiations (chip_smoke.py [fused-aa1], PERF.md).
constexpr int ONE_MIN_BLOCKS = 4;

constexpr int MAX_DEPTH = 8;                 // bounces a chain can keep residuals for
constexpr int MAX_NT = 128;                  // threads a block, at most
constexpr int TILE = 16;                     // pixels a tile side
constexpr int TILE_PX = TILE * TILE;
constexpr int N_C = TILE * TILE;             // the AA lattice's grids (render_fwd_kernel.cuh)
constexpr int N_U = (TILE + 1) * TILE;
constexpr int N_V = TILE * (TILE + 1);
constexpr int N_UV = (TILE + 1) * (TILE + 1);
constexpr int N_SHARED = N_C + N_U + N_V + N_UV;   // 1089
constexpr int COT_WORDS = 6 * TILE_PX;       // a tile's centre and neighbour cotangents
constexpr float DEN_EPS = 1e-6f;             // grazing-hit clamp, render_bwd.py:60

// What one trace keeps for the reverse sweep.
struct Res {
  float ox, oy, oz, dx, dy, dz, t;
  int obj;         // hit object, -1 on a miss
  unsigned occ;    // bit l: light l (< 32) occluded
};

// Records of a chain's traces: NR of them. D >= 0 (depths 0-3): kept in
// registers, read and written through selects on the index; D < 0: an array
// indexed at run time (MAX_DEPTH + 1 records).
template <int D>
struct Chain {
  static constexpr int NR = D < 0 ? MAX_DEPTH + 1 : D + 1;
  Res r[NR];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < NR; ++k) r[k] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0u};
  }
  __device__ __forceinline__ Res get(int i) const {
    if constexpr (D < 0) {
      return r[i];
    } else {
      Res o = r[0];
#pragma unroll
      for (int k = 1; k < NR; ++k) {
        if (i == k) o = r[k];
      }
      return o;
    }
  }
  __device__ __forceinline__ void put(int i, const Res& v) {
    if constexpr (D < 0) {
      r[i] = v;
    } else {
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        if (i == k) r[k] = v;
      }
    }
  }
};

// row[base + c] += v[c], summed over the lanes that share `base` (base < 0:
// nothing to add). Lanes hit different objects, so the warp reduces one
// object at a time, the lowest pending lane's first. Every lane must call it.
template <int N>
__device__ __forceinline__ void acc_obj(float* row, int base, const float (&v)[N],
                                        int lane) {
  unsigned pending = __ballot_sync(FULL, base >= 0);
  while (pending) {
    const int b = __shfl_sync(FULL, base, __ffs(pending) - 1);
    const bool mine = base == b;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float x = warp_sum(mine ? v[c] : 0.0f);
      if (lane == 0) row[b + c] += x;
    }
    pending &= ~__ballot_sync(FULL, mine);
  }
}

// Where a trace's object and light adjoints go. COLS: this lane's column
// (slot k at col[k * nt]), added to only where the trace contributes. ROWS:
// the warp's row, through warp sums that every lane joins.
template <bool COLS>
struct Sink {
  float* p;   // COLS: s_acc + tid; ROWS: the warp's row
  int nt, lane;

  __device__ __forceinline__ void add(int k, float v, bool act) const {
    if (COLS) {
      p[k * nt] += v;
    } else {
      acc(p, k, act ? v : 0.0f, lane);
    }
  }
  template <int N>
  __device__ __forceinline__ void add_obj(int base, const float (&v)[N]) const {
    if (COLS) {
      if (base >= 0) {
#pragma unroll
        for (int c = 0; c < N; ++c) p[(base + c) * nt] += v[c];
      }
    } else {
      acc_obj<N>(p, base, v, lane);
    }
  }
};

// Per-light shading terms of one trace.
struct LightTerm {
  float lx, ly, lz, lrn;
  float ldotn;
  bool m;                     // lit: not occluded and facing the light
  float p, s_safe, logs;      // Phong: p = sdot^shin (masked), clean mode only
};

// Light l's terms at surface f. `known`: the occlusion bit comes from
// occ_bits (the forward pass's test, stored); otherwise the shadow ray is
// tested and its bit set. Lights past the bitmask (l >= 32) are always
// re-tested: the same test (light_occluded, with the tables of the trace's
// level `level`, 0 for the primary trace) on the same ray gives the same
// answer.
template <bool COMPAT, bool CHEAP, bool TABLES>
__device__ __forceinline__ LightTerm light_term(const SceneView& s, int l,
                                                const Surface& f, float Rx,
                                                float Ry, float Rz, unsigned& occ_bits,
                                                bool known, const Tables& tb, int level) {
  LightTerm q;
  q.lrn = light_dir(s, l, f, q.lx, q.ly, q.lz);
  bool occ;
  if (known && l < 32) {
    occ = ((occ_bits >> l) & 1u) != 0u;
  } else {
    occ = light_occluded<COMPAT, CHEAP, TABLES>(s, f, q.lx, q.ly, q.lz, tb, l, level);
    if (!known && l < 32 && occ) occ_bits |= 1u << l;
  }
  q.ldotn = q.lx * f.nx + q.ly * f.ny + q.lz * f.nz;
  q.m = !occ && q.ldotn > 0.0f;
  q.p = 0.0f; q.s_safe = 1.0f; q.logs = 0.0f;
  if (!COMPAT) {
    const float sdot = q.lx * Rx + q.ly * Ry + q.lz * Rz;
    const bool smask = !occ && sdot > 0.0f;
    q.s_safe = smask ? sdot : 1.0f;
    q.logs = logf(q.s_safe);
    q.p = smask ? expf(s.p[P_SHIN] * q.logs) : 0.0f;
  }
  return q;
}

// Shaded color of one trace in the fused form (amb + lamb * sum) * albedo
// (+ white Phong), render_bwd.py:440-450; ULP-apart from the render kernel,
// which adds the lights' terms one at a time (render_bwd.py:1224-1227).
struct Shade {
  float lam_sum, spec_sum, shade, r, g, b;
};

template <bool COMPAT, bool CHEAP, bool TABLES>
__device__ __forceinline__ Shade shade_of(const SceneView& s, const Surface& f, float Rx,
                                          float Ry, float Rz, unsigned& occ_bits,
                                          bool known, const Tables& tb, int level) {
  Shade o{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int l = 0; l < s.nl; ++l) {
    const LightTerm q = light_term<COMPAT, CHEAP, TABLES>(s, l, f, Rx, Ry, Rz, occ_bits,
                                                          known, tb, level);
    o.lam_sum += q.m ? q.ldotn : 0.0f;
    o.spec_sum += q.p;
  }
  const float* P = s.p;
  o.shade = P[P_AMB] + P[P_LAMB] * o.lam_sum;
  const float spec = (!COMPAT && s.nl > 0) ? P[P_SPEC] * o.spec_sum : 0.0f;
  o.r = o.shade * f.ar + spec;
  o.g = o.shade * f.ag + spec;
  o.b = o.shade * f.ab + spec;
  return o;
}

// Forward chain of one sample: primary trace + up to `depth` bounces,
// keeping each trace's residuals; returns how many traces ran (the last one
// may be a miss) and the weighted color sum. Every sweep is the render's at
// the trace's level (closest_hit_at, light_occluded), tables included.
template <bool COMPAT, bool CHEAP, bool TABLES, int D>
__device__ __forceinline__ int fwd_chain(const SceneView& s, const Tables& tb, Ray ray,
                                         int depth, Chain<D>& ch, float& cr, float& cg,
                                         float& cb) {
  const float refl = s.p[P_REFL];
  const int last = D < 0 ? depth : D;
  float w = 1.0f;
  cr = cg = cb = 0.0f;
  int k = 0;
  for (int bounce = 0; bounce <= last; ++bounce) {
    const Hit h = closest_hit_at<COMPAT, TABLES>(s, ray, tb, bounce);
    ++k;
    const Surface f = surface<COMPAT>(ray, h);
    if (!f.alive) {
      ch.put(bounce, {ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, h.t, h.obj, 0u});
      break;
    }
    float Rx, Ry, Rz;
    reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, Rx, Ry, Rz);
    unsigned occ = 0u;
    const Shade sh = shade_of<COMPAT, CHEAP, TABLES>(s, f, Rx, Ry, Rz, occ, false, tb,
                                                     bounce);
    ch.put(bounce, {ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, h.t, h.obj, occ});
    cr = cr + w * sh.r;
    cg = cg + w * sh.g;
    cb = cb + w * sh.b;
    w = w * refl;
    ray = bounce_ray(f, Rx, Ry, Rz);
  }
  return k;
}

// What the one-launch fused AA step (FUSED_AA1) keeps of its lattice chains'
// traces, in the block's region of the record buffer: for trace level lvl of
// lattice position q, its t, hit object and occlusion bits at (3 lvl + 0, 1,
// 2) * N_SHARED + q (coalesced across a warp's positions).
struct Recorder {
  float* base;   // the block's region, plus q
  __device__ __forceinline__ void operator()(int lvl, const TraceOut& t) const {
    float* r = base + 3 * lvl * N_SHARED;
    r[0] = t.t;
    r[N_SHARED] = __int_as_float(t.obj);
    r[2 * N_SHARED] = __uint_as_float(t.occ);
  }
};

// The forward chain rebuilt from a Recorder's records (rec: the block's region
// plus q): each trace's ray from the one before it, elementwise (hit_of,
// surface, reflect_dir, bounce_ray: the render's own functions and
// arithmetic), with no closest-hit or shadow sweep. Returns how many traces
// ran, as fwd_chain.
template <bool COMPAT, int D>
__device__ __forceinline__ int replay_chain(const SceneView& s, Ray ray, int depth,
                                            Chain<D>& ch, const float* rec) {
  const int last = D < 0 ? depth : D;
  int k = 0;
  for (int bounce = 0; bounce <= last; ++bounce) {
    const float* r = rec + 3 * bounce * N_SHARED;
    const float t = r[0];
    const int obj = __float_as_int(r[N_SHARED]);
    ch.put(bounce, {ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, t, obj,
                    __float_as_uint(r[2 * N_SHARED])});
    ++k;
    const Surface f = surface<COMPAT>(ray, hit_of<COMPAT>(s, t, obj));
    if (!f.alive) break;
    float Rx, Ry, Rz;
    reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, Rx, Ry, Rz);
    ray = bounce_ray(f, Rx, Ry, Rz);
  }
  return k;
}

// Material adjoints kept in registers over a chain.
struct MatAcc {
  float amb, lamb, refl, spec, shin;
};

// Reverse sweep of one trace (render_bwd.py:464-700). g: the chain's
// cotangent in sample color space; w: the trace's weight refl^i; dw: d w /
// d refl = i refl^(i-1). ob/db: in, the cotangents of the next trace's
// origin and direction; out, this trace's. `act`: this lane's trace
// contributes (always, in COLS, whose caller sweeps only such traces; in ROWS
// every lane of the warp calls it and a lane that does not contribute adds
// zeros). tb, level: the tables and the trace's level, for the
// re-tested lights past the bitmask.
template <bool COMPAT, bool CHEAP, bool COLS, bool TABLES>
__device__ __forceinline__ void bwd_trace(const SceneView& s, const Slots& sl,
                                          const Sink<COLS>& out, const Res& rs, bool act,
                                          float g0, float g1, float g2, float w, float dw,
                                          float* ob, float* db, MatAcc& ma, const Tables& tb,
                                          int level) {
  const float* P = s.p;
  const float lamb = P[P_LAMB];
  const float dx = rs.dx, dy = rs.dy, dz = rs.dz;
  const Ray ray{rs.ox, rs.oy, rs.oz, dx, dy, dz};
  const Hit h = hit_of<COMPAT>(s, rs.t, rs.obj);
  const Surface f = surface<COMPAT>(ray, h);
  const float nx = f.nx, ny = f.ny, nz = f.nz;
  float Rx, Ry, Rz;
  const float rrn = reflect_dir(dx, dy, dz, nx, ny, nz, Rx, Ry, Rz);
  const float ddn = dx * nx + dy * ny + dz * nz;
  unsigned occ = rs.occ;
  const bool has_spec = !COMPAT && s.nl > 0;

  // rgb = shade * albedo (+ spec * spec_sum), shade = amb + lamb * lam_sum:
  // the lights' terms once, for the shade and its adjoints alike
  const float gr = w * g0, gg = w * g1, gb = w * g2;
  const float shade_bar = gr * f.ar + gg * f.ag + gb * f.ab;
  const float lam_sum_bar = shade_bar * lamb;
  const float gsum = gr + gg + gb;
  const float spec_sum_bar = has_spec ? P[P_SPEC] * gsum : 0.0f;
  float shin_bar = 0.0f, lam_sum = 0.0f, spec_sum = 0.0f;

  // next trace: o_next = Pb + BIAS * R, d_next = R
  float Rbx = BIAS * ob[0] + db[0], Rby = BIAS * ob[1] + db[1], Rbz = BIAS * ob[2] + db[2];
  float pbbx = ob[0], pbby = ob[1], pbbz = ob[2];   // cotangent of Pb
  float lnx = 0.0f, lny = 0.0f, lnz = 0.0f;
  for (int l = 0; l < s.nl; ++l) {
    const LightTerm q = light_term<COMPAT, CHEAP, TABLES>(s, l, f, Rx, Ry, Rz, occ, true,
                                                          tb, level);
    lam_sum += q.m ? q.ldotn : 0.0f;
    spec_sum += q.p;
    const float chi = q.m ? lam_sum_bar : 0.0f;
    float Lbx = chi * nx, Lby = chi * ny, Lbz = chi * nz;
    lnx += chi * q.lx;
    lny += chi * q.ly;
    lnz += chi * q.lz;
    if (has_spec) {
      const float sdot_bar = spec_sum_bar * P[P_SHIN] * q.p / q.s_safe;
      Lbx += sdot_bar * Rx; Lby += sdot_bar * Ry; Lbz += sdot_bar * Rz;
      Rbx += sdot_bar * q.lx; Rby += sdot_bar * q.ly; Rbz += sdot_bar * q.lz;
      shin_bar += spec_sum_bar * q.p * q.logs;
    }
    norm_adj(q.lx, q.ly, q.lz, q.lrn, Lbx, Lby, Lbz);
    out.add(sl.lts + 3 * l + 0, Lbx, act);
    out.add(sl.lts + 3 * l + 1, Lby, act);
    out.add(sl.lts + 3 * l + 2, Lbz, act);
    pbbx -= Lbx; pbby -= Lby; pbbz -= Lbz;
  }
  const float shade = P[P_AMB] + lamb * lam_sum;
  const float spec = has_spec ? P[P_SPEC] * spec_sum : 0.0f;
  const float abr = shade * gr, abg = shade * gg, abb = shade * gb;
  ma.amb += act ? shade_bar : 0.0f;
  ma.lamb += act ? shade_bar * lam_sum : 0.0f;
  ma.refl += act ? dw * (g0 * (shade * f.ar + spec) + g1 * (shade * f.ag + spec) +
                         g2 * (shade * f.ab + spec)) : 0.0f;
  if (has_spec) ma.spec += act ? gsum * spec_sum : 0.0f;
  if (has_spec) ma.shin += act ? shin_bar : 0.0f;

  // R = normalize(w), w = d - 2 (d.n) n
  norm_adj(Rx, Ry, Rz, rrn, Rbx, Rby, Rbz);
  const float ndotwb = nx * Rbx + ny * Rby + nz * Rbz;
  float dbx = Rbx - 2.0f * ndotwb * nx;
  float dby = Rby - 2.0f * ndotwb * ny;
  float dbz = Rbz - 2.0f * ndotwb * nz;
  float nbx = -2.0f * (ndotwb * dx + ddn * Rbx) + lnx;
  float nby = -2.0f * (ndotwb * dy + ddn * Rby) + lny;
  float nbz = -2.0f * (ndotwb * dz + ddn * Rbz) + lnz;
  // Pb = P + BIAS n
  float Pbarx = pbbx, Pbary = pbby, Pbarz = pbbz;
  nbx += BIAS * pbbx; nby += BIAS * pbby; nbz += BIAS * pbbz;

  const float t = f.alive ? rs.t : 0.0f;
  float sv[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int sbase = -1, pbase = -1;
  float obx, oby, obz;
  if (!h.plane) {
    // sphere n = normalize(P - c): P gets vb, the center -vb
    norm_adj(nx, ny, nz, f.srn, nbx, nby, nbz);
    Pbarx += nbx; Pbary += nby; Pbarz += nbz;
  }
  // P = o + t d
  obx = Pbarx; oby = Pbary; obz = Pbarz;
  const float tbar = Pbarx * dx + Pbary * dy + Pbarz * dz;
  dbx += t * Pbarx; dby += t * Pbary; dbz += t * Pbarz;
  if (act && !h.plane) {
    // t from f(t) = a t^2 + b t + c = 0: dt = -(t^2 da + t db + dc) / (2at + b)
    const int j = rs.obj, ns = s.ns;
    const float cx = sph_at(s, j), cy = sph_at(s, ns + j), cz = sph_at(s, 2 * ns + j);
    const float r = sph_at(s, 3 * ns + j);
    const float ox = rs.ox, oy = rs.oy, oz = rs.oz;
    const float a = dx * dx + dy * dy + dz * dz;
    const float od = ox * dx + oy * dy + oz * dz;
    const float b = 2.0f * (od - (cx * dx + cy * dy + cz * dz));
    const float den = 2.0f * a * t + b;
    const float inv_den = fabsf(den) > DEN_EPS ? 1.0f / den : 0.0f;
    const float abar = -tbar * t * t * inv_den;
    const float bbar = -tbar * t * inv_den;
    const float cbar = -tbar * inv_den;
    dbx += 2.0f * dx * abar; dby += 2.0f * dy * abar; dbz += 2.0f * dz * abar;
    obx += 2.0f * dx * bbar; oby += 2.0f * dy * bbar; obz += 2.0f * dz * bbar;
    dbx += 2.0f * (ox - cx) * bbar;
    dby += 2.0f * (oy - cy) * bbar;
    dbz += 2.0f * (oz - cz) * bbar;
    float ccx = -2.0f * dx * bbar, ccy = -2.0f * dy * bbar, ccz = -2.0f * dz * bbar;
    obx += 2.0f * (ox - cx) * cbar;
    oby += 2.0f * (oy - cy) * cbar;
    obz += 2.0f * (oz - cz) * cbar;
    ccx += -2.0f * (ox - cx) * cbar;
    ccy += -2.0f * (oy - cy) * cbar;
    ccz += -2.0f * (oz - cz) * cbar;
    sv[0] = ccx - nbx; sv[1] = ccy - nby; sv[2] = ccz - nbz;
    sv[3] = -2.0f * r * cbar;
    sv[4] = abr; sv[5] = abg; sv[6] = abb;
    sbase = 7 * j;
  } else if (act) {
    // t = n.(p0 - o) / n.d
    const int j = rs.obj - s.ns, np = s.npl;
    const float p0x = s.pln[j], p0y = s.pln[np + j], p0z = s.pln[2 * np + j];
    const float ox = rs.ox, oy = rs.oy, oz = rs.oz;
    const float den = dx * nx + dy * ny + dz * nz;
    const float inv_den = fabsf(den) > DEN_EPS ? 1.0f / den : 0.0f;
    const float num_bar = tbar * inv_den;
    const float den_bar = -tbar * t * inv_den;
    pv[0] = nx * num_bar; pv[1] = ny * num_bar; pv[2] = nz * num_bar;
    obx -= nx * num_bar; oby -= ny * num_bar; obz -= nz * num_bar;
    pv[3] = (p0x - ox) * num_bar + dx * den_bar + nbx;
    pv[4] = (p0y - oy) * num_bar + dy * den_bar + nby;
    pv[5] = (p0z - oz) * num_bar + dz * den_bar + nbz;
    dbx += nx * den_bar; dby += ny * den_bar; dbz += nz * den_bar;
    pv[6] = abr; pv[7] = abg; pv[8] = abb;
    pbase = sl.pln + 9 * j;
  }
  out.add_obj(sbase, sv);
  out.add_obj(pbase, pv);
  ob[0] = act ? obx : 0.0f; ob[1] = act ? oby : 0.0f; ob[2] = act ? obz : 0.0f;
  db[0] = act ? dbx : 0.0f; db[1] = act ? dby : 0.0f; db[2] = act ? dbz : 0.0f;
}

// One sample chain at fractional pixel (px, py): the forward chain (which
// FUSED_NOAA needs for its loss and cotangent), then the reverse sweep and
// the camera adjoint. `fwd`: the chain is traced; `cot` (sr, sg, sb): its
// cotangent in sample color space, or in FUSED_NOAA the pixel at `pix` forms
// it from the render and the target. tail: this lane's column of the 18-19
// material, camera and loss slots (slot k - sl.mat at tail[(k - sl.mat) * nt]).
// ONE (FUSED_AA1): the chain is replayed from its records `rec` (Recorder)
// instead of traced.
template <bool COMPAT, bool CHEAP, bool COLS, bool TABLES, int D, bool ONE>
__device__ __forceinline__ void sample(const SceneView& s, const Tables& tb, const Slots& sl,
                                       const Sink<COLS>& out, float* tail, int nt,
                                       float px, float py, int depth, bool fwd,
                                       bool fused_noaa, const float* __restrict__ target,
                                       size_t pix, float inv_denom, float two_inv, float sr,
                                       float sg, float sb, const float* rec) {
  const float* P = s.p;
  const RayGen rg = raygen_full(P, px, py);
  Chain<D> ch;
  ch.clear();
  int K = 1;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (fwd) {
    if constexpr (ONE) {
      K = replay_chain<COMPAT, D>(s, rg.ray, depth, ch, rec);
    } else {
      K = fwd_chain<COMPAT, CHEAP, TABLES, D>(s, tb, rg.ray, depth, ch, cr, cg, cb);
    }
  }
  if (fused_noaa && fwd) {
    // the stored pixel (compat stores (r, b, g)), its MSE partial and cotangent
    const float st0 = cr, st1 = COMPAT ? cb : cg, st2 = COMPAT ? cg : cb;
    const float d0 = st0 - target[pix], d1 = st1 - target[pix + 1],
                d2 = st2 - target[pix + 2];
    tail[(sl.loss - sl.mat) * nt] += (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
    const float g0 = two_inv * d0, g1 = two_inv * d1, g2 = two_inv * d2;
    sr = g0; sg = COMPAT ? g2 : g1; sb = COMPAT ? g1 : g2;
  }
  // Every adjoint is linear in the cotangent: none where it is 0.
  const bool on = fwd && (sr != 0.0f || sg != 0.0f || sb != 0.0f);

  const float refl = P[P_REFL];
  MatAcc ma{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ob[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  const int kmax = COLS ? (on ? K : 0) : __reduce_max_sync(FULL, on ? K : 0);
  for (int i = kmax - 1; i >= 0; --i) {
    float w = 1.0f, dw = 0.0f;       // refl^i and i refl^(i-1)
    for (int k = 0; k < i; ++k) {
      dw = dw * refl + w;
      w = w * refl;
    }
    const Res rs = ch.get(i);
    const bool act = on && i < K && rs.obj >= 0;
    if (COLS && !act) continue;
    bwd_trace<COMPAT, CHEAP, COLS, TABLES>(s, sl, out, rs, act, sr, sg, sb, w, dw, ob, db, ma,
                                           tb, i);
  }
  if (!on) return;

  // Camera: position takes the primary origin's cotangent; d = normalize(R p),
  // p = (focal, pcy, pcz); focal = cot(fov/2) with fov in degrees.
  const float focal = P[P_FOCAL];
  float ubx = db[0], uby = db[1], ubz = db[2];
  norm_adj(rg.ray.dx, rg.ray.dy, rg.ray.dz, rg.dn, ubx, uby, ubz);
  const float pvec[3] = {focal, rg.pcy, rg.pcz};
  const float ub[3] = {ubx, uby, ubz};
  float* cam = tail + (sl.cam - sl.mat) * nt;
#pragma unroll
  for (int c = 0; c < 3; ++c) cam[c * nt] += ob[c];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) cam[(3 + 3 * r + c) * nt] += ub[r] * pvec[c];
  const float focal_bar = P[P_ROT + 0] * ubx + P[P_ROT + 3] * uby + P[P_ROT + 6] * ubz;
  const float dfdf = -(1.0f + focal * focal) * static_cast<float>(3.14159265358979 / 360.0);
  cam[12 * nt] += focal_bar * dfdf;
  tail[0] += ma.amb;
  tail[nt] += ma.lamb;
  tail[2 * nt] += ma.refl;
  tail[3 * nt] += ma.spec;
  tail[4 * nt] += ma.shin;
}

// Shared-memory words of one block (render_bwd_cuda.smem_bytes / 4); the
// global form (staged false) leaves the sphere table out, the third form
// (rows false) the rows too. tab: the tables' words (bwd_table_words); one:
// the one-launch fused AA step's lattice colors.
inline size_t bwd_smem_words(int ns, int npl, int nl, int n_grads, bool aa, int nt,
                             bool cols, bool staged = true, bool rows = true, int tab = 0,
                             bool one = false) {
  const size_t mat = 7 * static_cast<size_t>(ns) + 9 * static_cast<size_t>(npl) +
                     3 * static_cast<size_t>(nl);
  const size_t tail = static_cast<size_t>(n_grads) - mat;
  return N_PARAMS + mat - (staged ? 0 : 7 * static_cast<size_t>(ns)) +
         static_cast<size_t>(tab) + (one ? 3 * N_SHARED : 0) + (aa ? COT_WORDS : 0) +
         (cols ? static_cast<size_t>(n_grads) * nt
               : (rows ? static_cast<size_t>(nt / 32) * mat : 0) + tail * nt);
}

// Words of the tables a block keeps in shared memory: one tile's lists and,
// with tree_smem (the staged form only), the bounce tree.
__host__ __device__ inline int bwd_table_words(const TableArgs& a, int nl, bool tree_smem) {
  return list_words(a, nl) + (tree_smem ? tree_words(a) : 0);
}

// Floats of a block's region of the one-launch step's records: 3 for each
// trace level of each lattice position.
__host__ __device__ inline size_t rec_words(int depth) {
  return 3 * static_cast<size_t>(depth + 1) * N_SHARED;
}

// Lattice position q < N_SHARED (render_fwd_kernel.cuh's AA_SHARED order):
// its grid cell (kx, ky) from the tile's corner and its half offsets.
__device__ __forceinline__ void lattice_cell(int q, int& kx, int& ky, float& du, float& dv) {
  du = 0.0f; dv = 0.0f;
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
}

// G: the global form (the sphere table where it lies); R (with G, rows only):
// the third form, the warps' rows in `scratch` (gridDim.x x nwarps x the
// object and light slots) instead of shared memory. TABLES (the pinned
// sources): the render's large-scene tables `ta` (any of them null: that cull
// off; tree_smem: the staged form copies the bounce tree into shared memory,
// else reads it where it lies). ONE: the instantiation of FUSED_AA1 (a
// compile-time choice, so that the other modes' code is what it was without
// it), with rec: gridDim.x regions of rec_words(depth) floats for the
// lattice chains' records.
template <bool COMPAT, bool CHEAP, bool COLS, int D, bool G, bool R = false,
          bool TABLES = false, bool ONE = false>
__global__ void __launch_bounds__(MAX_NT, ONE ? ONE_MIN_BLOCKS : RT_BWD_MIN_BLOCKS)
render_bwd_kernel(const float* __restrict__ params, const float* __restrict__ sph,
                  int ns, const float* __restrict__ pln, int npl,
                  const float* __restrict__ lts, int nl, const float* __restrict__ img,
                  const float* __restrict__ target, float* __restrict__ partial,
                  int W, int H, int Wg, int depth, int mode, float* __restrict__ scratch,
                  TableArgs ta, int tree_smem, float* __restrict__ rec) {
  static_assert(!R || (G && !COLS), "device-memory rows: the global form's rows only");
  static_assert(!TABLES || !COLS, "the tables: the large scenes' per-warp rows only");
  constexpr bool one = ONE;   // mode == FUSED_AA1
  const bool fused = mode == FUSED_NOAA || mode == FUSED_AA || one;
  const bool aa = mode == COT_AA || mode == FUSED_AA || one;
  const Slots sl(ns, npl, nl, fused);
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, nwarps = nt >> 5;
  const int n_tail = sl.n - sl.mat;
  const bool tree_in = TABLES && !G && tree_smem;   // the tree staged
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;                 // the staged form's sphere table
  float* s_pln = s_sph + (G ? 0 : 7 * ns);
  float* s_lts = s_pln + 9 * npl;
  float* s_tab = s_lts + 3 * nl;                 // TABLES: the tree (tree_in), a tile's lists
  float* s_samp = s_tab + (TABLES ? bwd_table_words(ta, nl, tree_in) : 0);
  float* s_cot = s_samp + (one ? 3 * N_SHARED : 0);   // AA: centre, then neighbour cotangents
  float* s_acc = s_cot + (aa ? COT_WORDS : 0);
  // COLS: every slot's columns; ROWS: the warps' rows of the object and light
  // slots (R: in scratch), then the tail slots' columns.
  const int acc_words = COLS ? sl.n * nt : (R ? 0 : nwarps * sl.mat) + n_tail * nt;
  float* rows = R ? scratch + static_cast<size_t>(blockIdx.x) * nwarps * sl.mat : s_acc;
  if (R) {
    for (int i = tid; i < nwarps * sl.mat; i += nt) rows[i] = 0.0f;
  }
  for (int i = tid; i < N_PARAMS; i += nt) s_p[i] = params[i];
  if (!G) {
    for (int i = tid; i < 7 * ns; i += nt) s_sph[i] = sph[i];
  }
  for (int i = tid; i < 9 * npl; i += nt) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += nt) s_lts[i] = lts[i];
  for (int i = tid; i < acc_words; i += nt) s_acc[i] = 0.0f;
  Tables tb = no_tables();
  int* s_lists = reinterpret_cast<int*>(s_tab + (tree_in ? tree_words(ta) : 0));
  if constexpr (TABLES) {
    if (tree_in) {
      stage_tree<false>(ta, s_tab, tid, nt, tb);
    } else {
      stage_tree<true>(ta, s_tab, tid, nt, tb);
    }
  }
  __syncthreads();
  const SceneView s{s_p, G ? sph : s_sph, ns, s_pln, npl, s_lts, nl, G};
  const Sink<COLS> out{COLS ? s_acc + tid : rows + (tid >> 5) * sl.mat, nt, lane};
  float* tail = COLS ? s_acc + sl.mat * nt + tid : s_acc + (R ? 0 : nwarps * sl.mat) + tid;
  float* blk_rec = one ? rec + static_cast<size_t>(blockIdx.x) * rec_words(depth) : nullptr;

  // the frame's denominator; x0g: the slice's first column in the frame
  const float inv_denom = static_cast<float>(1.0 / (3.0 * Wg * static_cast<double>(H)));
  const float two_inv = static_cast<float>(2.0 / (3.0 * Wg * static_cast<double>(H)));
  const float inv9 = static_cast<float>(1.0 / 9.0);
  const int x0g = static_cast<int>(s_p[P_X0]);
  const int n_ty = (H + TILE - 1) / TILE;
  const int n_tiles = ((W + TILE - 1) / TILE) * n_ty;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if constexpr (TABLES) {
      // the tile's lists, once every thread is done with the last tile's
      __syncthreads();
      stage_lists(ta, nl, tile, s_lists, tid, nt, tb);
      __syncthreads();
    }
    // local tile corner (x0, y0), x tiles outermost; fx0: its global x
    const int x0 = tile / n_ty * TILE, y0 = tile % n_ty * TILE;
    const float fx0 = static_cast<float>(x0) + s_p[P_X0], fy0 = static_cast<float>(y0);
    if constexpr (ONE) {
      // Phase A: the tile's lattice chains through the render's sample_chain
      // (its sweeps, tables and shading), each chain's color into s_samp and
      // its traces' records into the block's region. Thread tid takes
      // positions tid, tid + nt, ..., as in phase C, so each thread reads back
      // only the records it wrote.
      for (int q = tid; q < N_SHARED; q += nt) {
        int kx, ky;
        float du, dv;
        lattice_cell(q, kx, ky, du, dv);
        const Rgb c = sample_chain<COMPAT, CHEAP, TABLES>(
            s, tb, (fx0 + du) + static_cast<float>(kx), (fy0 + dv) + static_cast<float>(ky),
            depth, Recorder{blk_rec + q});
        s_samp[q] = c.r;
        s_samp[N_SHARED + q] = c.g;
        s_samp[2 * N_SHARED + q] = c.b;
      }
      __syncthreads();
    }
    if (aa) {
      // The tile's pixel cotangents (and, fused, the loss): the centre
      // sample's share (weight 1/9 inside the border ring, 1 on it; compat's
      // store swap) and each neighbour sample's (1/9, inside the ring only).
      // Fused, the pixel is the render's (FUSED_AA: the aa_shared launch's
      // image; FUSED_AA1, phase B: its combine of phase A's colors).
      for (int p = tid; p < TILE_PX; p += nt) {
        const int kx = p / TILE, ky = p % TILE;
        const int x = x0 + kx, y = y0 + ky;
        float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
        bool interior = false;
        if (x < W && y < H) {
          const size_t pix = (static_cast<size_t>(x) * H + y) * 3;
          interior = x0g + x >= 1 && x0g + x <= Wg - 2 && y >= 1 && y <= H - 2;
          if (fused) {
            Rgb c;
            if constexpr (ONE) {
              c = aa_combine<COMPAT>(s_samp, N_SHARED, TILE, p, N_C + p,
                                     N_C + N_U + kx * (TILE + 1) + ky,
                                     N_C + N_U + N_V + kx * (TILE + 1) + ky, interior);
            } else {
              c = {img[pix], img[pix + 1], img[pix + 2]};
            }
            const float d0 = c.r - target[pix], d1 = c.g - target[pix + 1],
                        d2 = c.b - target[pix + 2];
            tail[(sl.loss - sl.mat) * nt] += (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
            g0 = two_inv * d0; g1 = two_inv * d1; g2 = two_inv * d2;
          } else {
            g0 = img[pix]; g1 = img[pix + 1]; g2 = img[pix + 2];
          }
        }
        const float wc = interior ? inv9 : 1.0f;
        s_cot[p] = wc * g0;
        s_cot[TILE_PX + p] = wc * (COMPAT ? g2 : g1);
        s_cot[2 * TILE_PX + p] = wc * (COMPAT ? g1 : g2);
        s_cot[3 * TILE_PX + p] = interior ? inv9 * g0 : 0.0f;
        s_cot[4 * TILE_PX + p] = interior ? inv9 * g1 : 0.0f;
        s_cot[5 * TILE_PX + p] = interior ? inv9 * g2 : 0.0f;
      }
      __syncthreads();
    }
    const int items = aa ? N_SHARED : TILE_PX;
    for (int base = 0; base < items; base += nt) {   // warp-uniform
      const int q = base + tid;
      float px, py, sr = 0.0f, sg = 0.0f, sb = 0.0f;
      bool fwd = false;
      size_t pix = 0;
      if (aa) {
        // Lattice position q (render_fwd_kernel.cuh's AA_SHARED order) and the
        // sum of its in-tile pixels' shares.
        int kx = 0, ky = 0;
        float du = 0.0f, dv = 0.0f;
        if (q < N_SHARED) lattice_cell(q, kx, ky, du, dv);
        const auto share = [&](int p) {   // pixel p's neighbour share
          sr += s_cot[3 * TILE_PX + p];
          sg += s_cot[4 * TILE_PX + p];
          sb += s_cot[5 * TILE_PX + p];
        };
        if (q < N_C) {
          const int p = kx * TILE + ky;
          sr = s_cot[p]; sg = s_cot[TILE_PX + p]; sb = s_cot[2 * TILE_PX + p];
        } else if (q < N_C + N_U) {
          if (kx < TILE) share(kx * TILE + ky);
          if (kx >= 1) share((kx - 1) * TILE + ky);
        } else if (q < N_C + N_U + N_V) {
          if (ky < TILE) share(kx * TILE + ky);
          if (ky >= 1) share(kx * TILE + ky - 1);
        } else if (q < N_SHARED) {
          if (kx < TILE && ky < TILE) share(kx * TILE + ky);
          if (kx >= 1 && ky >= 1) share((kx - 1) * TILE + ky - 1);
          if (kx < TILE && ky >= 1) share(kx * TILE + ky - 1);
          if (kx >= 1 && ky < TILE) share((kx - 1) * TILE + ky);
        }
        px = (fx0 + du) + static_cast<float>(kx);
        py = (fy0 + dv) + static_cast<float>(ky);
        fwd = q < N_SHARED && (sr != 0.0f || sg != 0.0f || sb != 0.0f);
      } else {
        const int x = x0 + q / TILE, y = y0 + q % TILE;
        fwd = x < W && y < H;
        px = (static_cast<float>(x) + s_p[P_X0]) + s_p[P_OFFS];
        py = static_cast<float>(y) + s_p[P_OFFS + 1];
        if (fwd) {
          pix = (static_cast<size_t>(x) * H + y) * 3;
          if (!fused) {   // the stored pixel's cotangent, into sample color space
            const float g0 = img[pix], g1 = img[pix + 1], g2 = img[pix + 2];
            sr = g0; sg = COMPAT ? g2 : g1; sb = COMPAT ? g1 : g2;
            fwd = sr != 0.0f || sg != 0.0f || sb != 0.0f;   // no loss to form
          }
        }
      }
      // Phase C of FUSED_AA1: the chain replayed from its records.
      sample<COMPAT, CHEAP, COLS, TABLES, D, ONE>(s, tb, sl, out, tail, nt, px, py, depth,
                                                  fwd, !aa && fused, target, pix, inv_denom,
                                                  two_inv, sr, sg, sb, blk_rec + (ONE ? q : 0));
    }
    if (aa) __syncthreads();   // the next tile rewrites the colors and cotangents
  }

  // The block's partial column: each slot reduced once, in a fixed order.
  __syncthreads();
  const size_t n_blk = gridDim.x;
  const int warp = tid >> 5;
  float* col0 = s_acc + (COLS || R ? 0 : nwarps * sl.mat);
  const int k0 = COLS ? 0 : sl.mat;
  if (!COLS) {   // the rows, summed in warp order
    for (int k = tid; k < sl.mat; k += nt) {
      float v = 0.0f;
      for (int wp = 0; wp < nwarps; ++wp) v += rows[wp * sl.mat + k];
      partial[static_cast<size_t>(k) * n_blk + blockIdx.x] = v;
    }
  }
  for (int k = k0 + warp; k < sl.n; k += nwarps) {
    const float* c = col0 + (k - k0) * nt;
    float v = 0.0f;
    for (int wp = 0; wp < nwarps; ++wp) v += c[wp * 32 + lane];
    if (__any_sync(FULL, v != 0.0f)) v = warp_sum(v);
    if (lane == 0) partial[static_cast<size_t>(k) * n_blk + blockIdx.x] = v;
  }
}

// The launch's arguments, bundled for the dispatch.
struct BwdJob {
  const float* params;
  const float* sph;
  int ns;
  const float* pln;
  int npl;
  const float* lts;
  int nl;
  const float* img;
  const float* target;
  float* partial;
  int n_rows, W, H, depth, mode, n_grads, nt;
  cudaStream_t stream;
  int Wg;   // the frame's width; W is the slice's
  float* scratch;   // the third form's rows (n_rows x nt / 32 x the object and light slots)
  TableArgs ta;     // the large-scene tables (TABLES; all null: every cull off)
  int tree_smem;    // the staged form copies the bounce tree into shared memory
  float* rec;       // FUSED_AA1: n_rows x rec_words(depth) floats
};

// What every entry point checks of a job: sizes, depth, mode, the gradient's
// length, the grid, the threads, and the inputs its mode reads.
inline bool bwd_job_ok(const BwdJob& j) {
  const bool fused = j.mode == FUSED_NOAA || j.mode == FUSED_AA || j.mode == FUSED_AA1;
  const long long n_tiles =
      static_cast<long long>((j.W + TILE - 1) / TILE) * ((j.H + TILE - 1) / TILE);
  return j.W > 0 && j.H > 0 && j.Wg >= j.W && j.depth >= 0 && j.depth <= MAX_DEPTH &&
         j.ns >= 0 && j.npl >= 0 && j.nl >= 0 && j.mode >= COT_NOAA && j.mode <= FUSED_AA1 &&
         j.n_grads == 7 * j.ns + 9 * j.npl + 3 * j.nl + 18 + (fused ? 1 : 0) &&
         j.n_rows >= 1 && j.n_rows <= n_tiles && (j.nt == 32 || j.nt == 64 || j.nt == 128) &&
         (j.mode == FUSED_NOAA || j.mode == FUSED_AA1 || j.img != nullptr) &&
         (!fused || j.target != nullptr) && (j.mode != FUSED_AA1 || j.rec != nullptr);
}

// Shared memory of a job's block, in the form (G, R) and tables it runs with.
template <bool G, bool R, bool TABLES>
size_t job_smem(const BwdJob& j, bool cols) {
  const bool aa = j.mode == COT_AA || j.mode == FUSED_AA || j.mode == FUSED_AA1;
  const int tab = TABLES ? bwd_table_words(j.ta, j.nl, !G && j.tree_smem) : 0;
  return sizeof(float) * bwd_smem_words(j.ns, j.npl, j.nl, j.n_grads, aa, j.nt, cols, !G, !R,
                                        tab, j.mode == FUSED_AA1);
}

template <bool COMPAT, bool CHEAP, bool COLS, int D, bool G, bool R, bool TABLES, bool ONE>
cudaError_t launch_job(const BwdJob& j) {
  const size_t smem = job_smem<G, R, TABLES>(j, COLS);
  const auto kernel = render_bwd_kernel<COMPAT, CHEAP, COLS, D, G, R, TABLES, ONE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<j.n_rows, j.nt, smem, j.stream>>>(
      j.params, j.sph, j.ns, j.pln, j.npl, j.lts, j.nl, j.img, j.target, j.partial, j.W, j.H,
      j.Wg, j.depth, j.mode, j.scratch, j.ta, j.tree_smem, j.rec);
  return cudaGetLastError();
}

// The instantiation for (compat, cheap) at depth D; G: the global form, R:
// its rows in device memory; TABLES: the large-scene tables read; ONE: the
// one-launch AA step.
template <bool COLS, int D, bool G, bool R, bool TABLES, bool ONE>
cudaError_t dispatch_cc(bool compat, bool cheap, const BwdJob& j) {
  if (compat) {
    return cheap ? launch_job<true, true, COLS, D, G, R, TABLES, ONE>(j)
                 : launch_job<true, false, COLS, D, G, R, TABLES, ONE>(j);
  }
  return cheap ? launch_job<false, true, COLS, D, G, R, TABLES, ONE>(j)
               : launch_job<false, false, COLS, D, G, R, TABLES, ONE>(j);
}

// Depths 0-3 take their own instantiation, the others the general one. ONE:
// the one-launch AA step's instantiations, which only the render_bwd_one*.cu
// files make (each source's entry point hands FUSED_AA1 jobs to its one-launch
// twin's), so that nvcc compiles them beside the other modes'.
template <bool COLS, bool G = false, bool R = false, bool TABLES = false, bool ONE = false>
cudaError_t dispatch_depth(bool compat, bool cheap, const BwdJob& j) {
  switch (j.depth) {
    case 0: return dispatch_cc<COLS, 0, G, R, TABLES, ONE>(compat, cheap, j);
    case 1: return dispatch_cc<COLS, 1, G, R, TABLES, ONE>(compat, cheap, j);
    case 2: return dispatch_cc<COLS, 2, G, R, TABLES, ONE>(compat, cheap, j);
    case 3: return dispatch_cc<COLS, 3, G, R, TABLES, ONE>(compat, cheap, j);
    default: return dispatch_cc<COLS, -1, G, R, TABLES, ONE>(compat, cheap, j);
  }
}

}  // namespace
