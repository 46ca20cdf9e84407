// Shared device math for the port's render kernels: ray generation, closest
// hit, shadow occlusion, shading and the mirror-bounce chain.
//
// Each function mirrors a helper of the TPU forward kernel
// (python_ray_tracer_tpu/ops/pallas/render_pallas.py) term for term, so the
// two agree up to float rounding:
//   raygen            <- _raygen            (:1294)
//   closest_hit       <- _closest_hit       (:403), plus the winner's index
//   closest_hit_listed  <- _culled_sphere_fold (:128) inside _closest_hit
//   closest_hit_tree  <- _grouped_sphere_fold (:338) inside _closest_hit
//   hit_of            <- the hit-attribute fold of render_bwd._fwd_trace_res
//   sphere_occ_cheap  <- _sphere_occ_cheap  (:501)
//   occluded          <- _any_hit_multi     (:571), one light at a time
//   occluded_listed   <- _any_hit_listed    (:757), _culled_sphere_fold_ee (:168)
//   occluded_tree     <- _any_hit_multi_grouped (:645), one light at a time
//   occluded_cells    <- no JAX counterpart: a bounce shadow ray over its
//                        light cell's row (the light cells, light_cells.cu)
//   surface           <- _primary_geometry  (:952), for a given hit
//   primary_geometry  <- _primary_geometry  (:952)
//   reflect_dir       <- _reflect_dir       (:979)
//   light_dir, bounce_ray <- the shadow and mirror rays of _trace (:1195)
//   trace             <- _trace             (:1195)
//   sample_chain      <- _sample_chain      (:1310)
// The backward kernel (render_bwd_kernel.cuh) includes this header and
// recomputes its forward chain through these same functions. The soft kernels include it
// through soft_common.cuh. The adjoint helpers at the end (norm_adj and the
// warp reductions) are shared by both backward kernels, the per-block partial
// column of per-warp rows by the soft backward.
//
// Semantics kept from the reference (compat mode): hits count only for
// 0 < t < 999 (t starts at FAR and the winner test is a strict `<`, so the far
// clip costs nothing); spheres are scanned before planes, lower index first;
// the plane parallel threshold is 1e-3 (1e-8 in clean mode); shadow rays have
// no maximum distance; shadow and mirror origins are biased by 2e-4.
//
// Large scenes (the TABLES instantiations): a primary ray sweeps its tile's
// cone-visible list (~1.2 spheres at 1000 spheres) and a level-0 shadow ray
// its tile's occluder list (~1.7), so what bounds them is the bounce levels,
// where rays go anywhere: a bounce origin sits inside many large bounding
// volumes, so 16-sphere groups under balls (R ~ 2) left ~390 of 1000 sphere
// tests a bounce closest hit. The bounce tree (tight boxes over 4-8
// consecutive Morton spheres under one level of parent boxes) takes ~100
// sqrt-free slab tests and ~45 sphere tests there, and its slab test widens
// every box by what the sphere tests' rounding can reach, so no culled sweep
// ever differs from the full one (see the tree's section below). A bounce
// shadow ray has no maximum distance and a lit one met every box on its line
// (~100-120 slab and ~24 sphere tests); it now sweeps its light cell's row
// instead (~11 spheres, ~4 tests before the first occluder; the light cells'
// section below), with the same kind of margin.
//
// Normalisations use 1/sqrtf (IEEE sqrt and division without fast math), not
// the approximate rsqrtf, so rays match the CPU references to the last bits
// as far as the chosen FMAs allow.
//
// Two arithmetics, chosen per source file with RT_PIN before the include.
//
// RT_PIN 1 (the default; render_fwd.cu's large-scene kernels, hit_extents.cu
// and render_bwd.cu, the backward kernel of large scenes): every function that decides a hit or moves a ray (ray
// generation, the sphere and plane tests of both sweeps, the surface point and
// normal, the mirror and light directions) is written in the operations fm /
// fa / fs / ff / pm below, so that no product is ever fused with the sum that
// consumes it except where the source says ff. Left to itself the compiler
// contracts a*b + c differently from one inlined copy to the next (measured
// on the H100: the listed and the full closest-hit sweep of one kernel
// disagreed in the last bits at a third of the pixels). With the operations
// pinned, a sphere's t, a hit point and a shadow decision are the same bits in
// every sweep and in every pinned source file: the culled render equals the
// full sweep, the hit-extent kernel's points are the render kernel's, and the
// backward kernel recomputes the render kernel's own decisions.
//
// A mul and an add are fused only when neither carries a rounding modifier,
// so one of the two pinned is enough, and which one is a matter of speed.
// Everywhere but in the per-sphere tests the sums are pinned (fa / fs / ff)
// and the products plain (fm); in hit_sphere, sphere_occludes and
// sphere_occ_cheap the products are pinned (pm, ff) and the sums plain
// (+, -). Measured on the H100 (700 W), demo scene 1000x1000 AA / 1080p no AA
// / 1080p AA and 1000 spheres 1080p no AA with every table off: compiler's
// choice 0.510 / 0.230 / 1.000 / 19.85 ms, everything pinned 0.532 / 0.235 /
// 1.047 / 19.85 ms, this mix 0.515 / 0.233 / 1.013 / 19.55 ms. The rule to
// keep: never a plain product into a plain sum.
//
// RT_PIN 0 (render_fwd_small.cu and render_bwd_small.cu, for scenes too small
// for tables, and the soft kernels): the same operations are plain * + -, and
// the compiler contracts them as it likes. Those kernels sweep every sphere
// for every ray, so nothing of theirs has to equal another sweep bit for bit,
// and they keep the compiler's faster code. The two arithmetics live in two
// inline namespaces, so a library that links both kinds of source file holds
// no function under one name with two bodies.
#pragma once

#include <cuda_runtime.h>

#ifndef RT_PIN
#define RT_PIN 1
#endif

namespace rt {
#if RT_PIN
inline namespace pinned {
#else
inline namespace contracted {
#endif

constexpr float FAR = 999.0f;   // reference init distance, trace.py:17
constexpr float BIG = 1e30f;    // "no hit" distance in clean mode
constexpr float BIAS = 2e-4f;   // shadow/mirror acne offset, trace.py:82

// Parameter vector layout (render_cuda.py P_*; render_pallas.py _P_*). P_X0
// is the global x index of a ray-parallel slice's first column (0 for a whole
// frame): every kernel adds it to the pixel's x where it generates a ray, so a
// slice [P_X0, P_X0 + W) of a wider frame traces the whole frame's rays. The
// offset and the pixel indices are whole numbers below 2^24, so the sums are
// exact and a slice's rays are the whole frame's, bit for bit.
enum : int {
  P_ORIGIN = 0, P_ROT = 3, P_FOCAL = 12, P_Y0 = 13, P_DY = 14, P_Z0 = 15,
  P_DZ = 16, P_AMB = 17, P_LAMB = 18, P_REFL = 19, P_SPEC = 20, P_SHIN = 21,
  P_X0 = 22, P_OFFS = 23, N_PARAMS = 41
};

// The scene as the kernels read it: the parameter vector and the SoA tables
// sph (7 x ns: center xyz, radius, albedo rgb), pln (9 x npl: origin xyz,
// unit normal xyz, albedo rgb) and lts (3 x nl), row-major. `ldg`: sph lies
// in device memory and is read through the read-only data cache (the global
// form of the render, hit-extent and backward kernels, for scenes whose
// sphere table does not fit a block's shared memory beside what else the
// block keeps there); every other view reads sph where it points, staged or
// not. A kernel fixes `ldg` at compile time, so the test folds away.
struct SceneView {
  const float* p;
  const float* sph;
  int ns;
  const float* pln;
  int npl;
  const float* lts;
  int nl;
  bool ldg = false;
};

// Word i of the sphere table (the same float from either memory).
__device__ __forceinline__ float sph_at(const SceneView& s, int i) {
  return s.ldg ? __ldg(s.sph + i) : s.sph[i];
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Rgb {
  float r, g, b;
};

// Shading result of one trace: color, biased next origin, unit mirror
// direction, whether the ray hit anything, and what it hit.
struct TraceOut {
  float r, g, b;
  Ray next;
  bool alive;
  float t;        // the hit's distance (the far clip on a miss)
  int obj;        // the hit object, -1 on a miss
  unsigned occ;   // bit l: light l (< 32) occluded
};

#if RT_PIN
// fm: a product for pinned sums only (fa, fs, ff, or no sum at all). fa, fs,
// ff, pm: one IEEE operation each, round to nearest even, never fused or split.
__device__ __forceinline__ float fm(float a, float b) { return a * b; }
__device__ __forceinline__ float pm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float ff(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// a . b = fma(az, bz, fma(ay, by, ax bx)).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ff(az, bz, ff(ay, by, fm(ax, bx)));
}
#else
__device__ __forceinline__ float fm(float a, float b) { return a * b; }
__device__ __forceinline__ float pm(float a, float b) { return a * b; }
__device__ __forceinline__ float fa(float a, float b) { return a + b; }
__device__ __forceinline__ float fs(float a, float b) { return a - b; }
__device__ __forceinline__ float ff(float a, float b, float c) { return a * b + c; }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}
#endif

__device__ __forceinline__ float rnorm(float x, float y, float z) {
  return 1.0f / sqrtf(dot3(x, y, z, x, y, z));
}

// A primary ray with what its adjoint needs: the camera-space grid point
// (focal, pcy, pcz) and the reciprocal norm of R @ p.
struct RayGen {
  Ray ray;
  float pcy, pcz, dn;
};

// Analytic primary ray through fractional pixel (px, py).
__device__ __forceinline__ RayGen raygen_full(const float* P, float px, float py) {
  const float pcx = P[P_FOCAL];
  const float pcy = ff(px, P[P_DY], P[P_Y0]);
  const float pcz = ff(py, P[P_DZ], P[P_Z0]);
  const float dx = dot3(P[P_ROT + 0], P[P_ROT + 1], P[P_ROT + 2], pcx, pcy, pcz);
  const float dy = dot3(P[P_ROT + 3], P[P_ROT + 4], P[P_ROT + 5], pcx, pcy, pcz);
  const float dz = dot3(P[P_ROT + 6], P[P_ROT + 7], P[P_ROT + 8], pcx, pcy, pcz);
  const float dn = rnorm(dx, dy, dz);
  return {{P[P_ORIGIN + 0], P[P_ORIGIN + 1], P[P_ORIGIN + 2],
           fm(dx, dn), fm(dy, dn), fm(dz, dn)}, pcy, pcz, dn};
}

__device__ __forceinline__ Ray raygen(const float* P, float px, float py) {
  return raygen_full(P, px, py).ray;
}

struct Hit {
  float t;
  float ar, ag, ab;   // albedo of the hit object
  float qx, qy, qz;   // sphere center, or plane normal
  bool plane;
  int obj;            // index into [spheres ++ planes]; -1 for no hit
};

// The record of a ray that has hit nothing yet: t at the far clip.
template <bool COMPAT>
__device__ __forceinline__ Hit no_hit() {
  return {COMPAT ? FAR : BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, -1};
}

// The Hit record of object `obj` at distance t (obj < 0: no hit).
template <bool COMPAT>
__device__ __forceinline__ Hit hit_of(const SceneView& s, float t, int obj) {
  if (obj < 0) return no_hit<COMPAT>();
  if (obj < s.ns) {
    const int ns = s.ns;
    return {t, sph_at(s, 4 * ns + obj), sph_at(s, 5 * ns + obj), sph_at(s, 6 * ns + obj),
            sph_at(s, obj), sph_at(s, ns + obj), sph_at(s, 2 * ns + obj), false, obj};
  }
  const int j = obj - s.ns, np = s.npl;
  return {t, s.pln[6 * np + j], s.pln[7 * np + j], s.pln[8 * np + j],
          s.pln[3 * np + j], s.pln[4 * np + j], s.pln[5 * np + j], true, obj};
}

// The terms of a closest-hit sweep that do not depend on the object:
// b_j = 2(o.d - c_j.d), c_j = o.o - 2 o.c_j + |c_j|^2 - r_j^2.
struct HitSweep {
  float ox, oy, oz, dx, dy, dz;
  float a, inv2a, od, oo;
};

__device__ __forceinline__ HitSweep hit_sweep(const Ray& ray) {
  HitSweep w;
  w.ox = ray.ox; w.oy = ray.oy; w.oz = ray.oz;
  w.dx = ray.dx; w.dy = ray.dy; w.dz = ray.dz;
  w.a = dot3(w.dx, w.dy, w.dz, w.dx, w.dy, w.dz);
  w.inv2a = 1.0f / fm(2.0f, w.a);
  w.od = dot3(w.ox, w.oy, w.oz, w.dx, w.dy, w.dz);
  w.oo = dot3(w.ox, w.oy, w.oz, w.ox, w.oy, w.oz);
  return w;
}

// Sphere j against the running winner h: strict `<`, or with TIE the least
// (t, index), which is the same winner for a sweep in ascending index order
// and for the tree's Morton order alike. Every closest-hit sweep (full,
// listed, tree) goes through this one body, so a sphere's t does not depend on
// which sweep reached it.
template <bool TIE = false>
__device__ __forceinline__ void hit_sphere(const SceneView& s, const HitSweep& w,
                                           int j, Hit& h) {
  const int ns = s.ns;
  const float cx = sph_at(s, j), cy = sph_at(s, ns + j), cz = sph_at(s, 2 * ns + j);
  const float r = sph_at(s, 3 * ns + j);
  const float cd = dot3(cx, cy, cz, w.dx, w.dy, w.dz);
  const float oc = dot3(cx, cy, cz, w.ox, w.oy, w.oz);
  // pinned products, plain sums (see the head of this file)
  const float b = pm(2.0f, w.od - cd);
  const float c = ff(-2.0f, oc, w.oo) + ff(-r, r, dot3(cx, cy, cz, cx, cy, cz));
  const float disc = ff(b, b, -pm(pm(4.0f, w.a), c));
  const bool has = disc >= 0.0f;
  const float sq = sqrtf(has ? disc : 0.0f);
  const float num_near = -b - sq;
  const float num_far = -b + sq;
  // nearest positive root; the far root is >= the near root always
  const float tj = pm(num_near > 0.0f ? num_near : num_far, w.inv2a);
  if (has && num_far > 0.0f && (tj < h.t || (TIE && tj == h.t && j < h.obj))) {
    h = {tj, sph_at(s, 4 * ns + j), sph_at(s, 5 * ns + j), sph_at(s, 6 * ns + j),
         cx, cy, cz, false, j};
  }
}

// The planes against the running winner, after the spheres.
template <bool COMPAT>
__device__ __forceinline__ void hit_planes(const SceneView& s, const HitSweep& w,
                                           Hit& h) {
  const float eps = COMPAT ? 1e-3f : 1e-8f;
  const int np = s.npl;
  for (int j = 0; j < np; ++j) {
    const float nx = s.pln[3 * np + j], ny = s.pln[4 * np + j], nz = s.pln[5 * np + j];
    const float den = dot3(w.dx, w.dy, w.dz, nx, ny, nz);
    const float den_safe = fabsf(den) > 1e-30f ? den : 1.0f;
    const float num = dot3(fs(s.pln[j], w.ox), fs(s.pln[np + j], w.oy),
                           fs(s.pln[2 * np + j], w.oz), nx, ny, nz);
    const float tj = num / den_safe;
    if (fabsf(den) >= eps && tj > 0.0f && tj < h.t) {
      h = {tj, s.pln[6 * np + j], s.pln[7 * np + j], s.pln[8 * np + j],
           nx, ny, nz, true, s.ns + j};
    }
  }
}

// Closest hit over spheres, then planes, with the strict `<` winner test.
template <bool COMPAT>
__device__ __forceinline__ Hit closest_hit(const SceneView& s, const Ray& ray) {
  Hit h = no_hit<COMPAT>();
  const HitSweep w = hit_sweep(ray);
  const int ns = s.ns;
  for (int j = 0; j < ns; ++j) hit_sphere(s, w, j, h);
  hit_planes<COMPAT>(s, w, h);
  return h;
}

// --- large-scene tables -------------------------------------------------------
//
// What a block reads of the tables that ops/cuda/cull_tables.py builds. The
// lists are per render tile (one 16x16 block), so every thread of a block
// sweeps the same list and a listed sweep does not diverge. The bounce tree is
// per scene; its box tests are per thread, on the thread's own ray (see
// closest_hit_tree).
//
// The bounce tree (cull_tables.bounce_tree): the spheres in Morton order, cut
// into leaves of LEAF consecutive spheres (pad slots of the last leaf repeat
// its last real member), each leaf with an axis-aligned box around its member
// balls, and one level of parents, each over FAN consecutive leaves (the last
// parent may have fewer), each with the box around its leaves' boxes. It is
// implicit: leaf l holds perm[l * LEAF .. (l + 1) * LEAF), parent p leaves
// [p * FAN, min((p + 1) * FAN, n_leaves)). box holds `reach` (the largest |c|
// + r of any sphere, rounded up; the slab test's slack scales with it), then
// the parents' boxes, then the leaves', 6 floats each (lo xyz, hi xyz).
//
// LEAF and FAN are compile-time constants (cull_tables.LEAF / FAN mirror
// them), so the member loop unrolls. 4 and 8 were the fastest of LEAF in {4,
// 8} x FAN in {8, 16} at 1000 spheres (chip_smoke.py [tree-sweep], which
// builds the other three with -DRT_LEAF / -DRT_FAN; see PERF.md).
#ifndef RT_LEAF
#define RT_LEAF 4
#endif
#ifndef RT_FAN
#define RT_FAN 8
#endif
constexpr int LEAF = RT_LEAF;
constexpr int FAN = RT_FAN;

// The light cells' shape (light_cells.cu builds them; occluded_cells below
// reads them): LC_R x LC_R cells on each of the 3 axial faces of a light's
// cube map, LC_K slots a row. Compile-time constants (light_cells_cuda.R / K
// mirror them; the loader checks rt_light_cells_shape); -DRT_LC_R / -DRT_LC_K
// build other shapes for chip_smoke.py's sweep only. LC_R must be a power of
// two (the cell index's product is then exact).
#ifndef RT_LC_R
#define RT_LC_R 64
#endif
#ifndef RT_LC_K
#define RT_LC_K 32
#endif
constexpr int LC_R = RT_LC_R;
constexpr int LC_K = RT_LC_K;
static_assert(LC_R >= 2 && LC_R <= 1024 && (LC_R & (LC_R - 1)) == 0, "LC_R: a power of two");
static_assert(LC_K >= 1, "LC_K: at least one slot");

// Rows of one light's cells: 3 faces of LC_R x LC_R.
constexpr int LC_ROWS = 3 * LC_R * LC_R;

struct Tables {
  const int* vis;     // this tile's cone-visible spheres, ascending index
  int vis_n;          // how many; < 0: no list, sweep all ns spheres
  const int* sh;      // this tile's sh_levels * nl occluder lists, sh_k slots each,
                      // row level * nl + light
  const int* sh_n;    // their counts (< 0: sweep all); nullptr: no lists
  int sh_k;
  const int* perm;    // the bounce tree's sweep order, n_leaves * LEAF indices
  const float* box;   // reach, parent boxes, leaf boxes
  int n_leaves;       // 0: no tree
  const int* lc_idx;  // the light cells (device memory): LC_K slots a row
  const int* lc_cnt;  // their counts (< 0: overflowed); nullptr: no cells
  const float* lc_hdr;  // reach, s_max
  int sh_levels;      // the trace levels with occluder lists (0: no lists)
};

// The tables as a kernel receives them (device pointers; a null pointer
// switches that table off): the flat per-tile primary lists `vis_idx
// (n_tiles * vis_k)` with counts `vis_cnt (n_tiles)`, the per-(tile, level,
// light) occluder lists of the first sh_levels trace levels `sh_idx (n_tiles
// * sh_levels * nl * sh_k)` with counts `sh_cnt (n_tiles * sh_levels * nl)`,
// row (tile * sh_levels + level) * nl + light (the JAX package's
// _shadow_visibility_lists over hit-extent rows of sh_levels levels), the
// bounce tree `perm (n_leaves * LEAF)`, `box (tree_box_words)`, and the
// per-light direction-cell occluder lists of the bounce shadow rays
// `lc_idx (nl * LC_ROWS * LC_K)`, `lc_cnt (nl * LC_ROWS)`, `lc_hdr (2)` (see
// occluded_cells). A count of -1 marks a row that overflowed its slots: that
// row sweeps all spheres (the tree, for a bounce ray where there is one).
struct TableArgs {
  const int* vis_idx;
  const int* vis_cnt;
  int vis_k;
  const int* sh_idx;
  const int* sh_cnt;
  int sh_k;
  const int* perm;
  const float* box;
  int n_leaves;
  const int* lc_idx;
  const int* lc_cnt;
  const float* lc_hdr;
  int sh_levels = 1;
};

// Each table that is on is whole: a list's counts beside its indices and at
// least one slot and one level a row; a tree with leaves; the light cells with
// their header.
inline bool tables_ok(const TableArgs& a) {
  return (!a.vis_idx || (a.vis_cnt && a.vis_k >= 1)) &&
         (!a.sh_idx || (a.sh_cnt && a.sh_k >= 1 && a.sh_levels >= 1)) &&
         (!a.perm || (a.box && a.n_leaves >= 1)) &&
         (!a.lc_idx || (a.lc_cnt && a.lc_hdr));
}

__host__ __device__ inline int tree_parents(int n_leaves) {
  return (n_leaves + FAN - 1) / FAN;
}

// Floats of a tree's box table: reach, then 6 a parent and 6 a leaf.
__host__ __device__ inline int tree_box_words(int n_leaves) {
  return 1 + 6 * (tree_parents(n_leaves) + n_leaves);
}

// 4-byte words of shared memory a block needs for the bounce tree.
__host__ __device__ inline int tree_words(const TableArgs& a) {
  return a.perm ? tree_box_words(a.n_leaves) + a.n_leaves * LEAF : 0;
}

// 4-byte words of shared memory a block needs for one tile's lists: the
// primary list and sh_levels * nl occluder rows with their counts.
__host__ __device__ inline int list_words(const TableArgs& a, int nl) {
  return (a.vis_idx ? a.vis_k : 0) + (a.sh_idx ? a.sh_levels * nl * (a.sh_k + 1) : 0);
}

// 4-byte words of shared memory a block needs for its copy of the tables
// (G, the global form: the tree's left out, as it is read where it lies).
template <bool G = false>
__host__ __device__ inline int table_words(const TableArgs& a, int nl) {
  return (G ? 0 : tree_words(a)) + list_words(a, nl);
}

// Copy the bounce tree into shared memory at `base` (tree_words words) and
// point tb at it and at the light cells, which stay in device memory. Every
// thread of the block calls it; a __syncthreads() must follow before the tree
// is read. G (the global form): tb points at the tree where it lies in
// device memory, and nothing is staged; the same floats and indices either way.
template <bool G = false>
__device__ __forceinline__ void stage_tree(const TableArgs& a, float* base, int tid, int nt,
                                           Tables& tb) {
  if (a.lc_idx) {
    tb.lc_idx = a.lc_idx; tb.lc_cnt = a.lc_cnt; tb.lc_hdr = a.lc_hdr;
  }
  if (!a.perm) return;
  if (G) {
    tb.box = a.box; tb.perm = a.perm; tb.n_leaves = a.n_leaves;
    return;
  }
  const int nb = tree_box_words(a.n_leaves);
  int* perm = reinterpret_cast<int*>(base + nb);
  for (int i = tid; i < nb; i += nt) base[i] = a.box[i];
  for (int i = tid; i < a.n_leaves * LEAF; i += nt) perm[i] = a.perm[i];
  tb.box = base; tb.perm = perm; tb.n_leaves = a.n_leaves;
}

// The record of a tile with no tables.
__host__ __device__ inline Tables no_tables() {
  return Tables{nullptr, -1, nullptr, nullptr, 0, nullptr, nullptr, 0,
                nullptr, nullptr, nullptr, 0};
}

// Copy tile `tile`'s lists into shared memory at `w` (list_words words) and
// point tb at them. Every thread of the block calls it; a __syncthreads()
// must follow before they are read.
__device__ __forceinline__ void stage_lists(const TableArgs& a, int nl, int tile, int* w,
                                            int tid, int nt, Tables& tb) {
  if (a.vis_idx) {
    const int n = a.vis_cnt[tile];
    const int* src = a.vis_idx + static_cast<size_t>(tile) * a.vis_k;
    for (int i = tid; i < n; i += nt) w[i] = src[i];
    tb.vis = w; tb.vis_n = n;
    w += a.vis_k;
  }
  if (a.sh_idx) {
    const int rows = a.sh_levels * nl;   // level * nl + light
    int* cnt = w + rows * a.sh_k;
    for (int l = 0; l < rows; ++l) {
      const size_t row = static_cast<size_t>(tile) * rows + l;
      const int n = a.sh_cnt[row];
      const int* src = a.sh_idx + row * a.sh_k;
      for (int i = tid; i < n; i += nt) w[l * a.sh_k + i] = src[i];
      if (tid == 0) cnt[l] = n;
    }
    tb.sh = w; tb.sh_n = cnt; tb.sh_k = a.sh_k; tb.sh_levels = a.sh_levels;
  }
}

// Copy tile `tile`'s lists and the bounce tree into shared memory at `base`
// (table_words<G> words; G: the tree read where it lies) and return the
// block's view of them. Every thread of the block calls it; a __syncthreads()
// must follow before the view is read.
template <bool G = false>
__device__ __forceinline__ Tables stage_tables(const TableArgs& a, int nl, int tile,
                                               float* base, int tid, int nt) {
  Tables tb = no_tables();
  stage_tree<G>(a, base, tid, nt, tb);
  stage_lists(a, nl, tile, reinterpret_cast<int*>(base + (G ? 0 : tree_words(a))), tid, nt,
              tb);
  return tb;
}

// Tile `tile`'s lists read where they lie in device memory (the worklist
// kernel: the threads of a block belong to different tiles).
__device__ __forceinline__ void tile_lists(const TableArgs& a, int nl, int tile, Tables& tb) {
  if (a.vis_idx) {
    tb.vis = a.vis_idx + static_cast<size_t>(tile) * a.vis_k;
    tb.vis_n = a.vis_cnt[tile];
  }
  if (a.sh_idx) {
    const size_t rows = static_cast<size_t>(a.sh_levels) * nl;
    tb.sh = a.sh_idx + static_cast<size_t>(tile) * rows * a.sh_k;
    tb.sh_n = a.sh_cnt + static_cast<size_t>(tile) * rows;
    tb.sh_k = a.sh_k;
    tb.sh_levels = a.sh_levels;
  }
}

// Primary closest hit over the tile's cone-visible list (the JAX package's
// _culled_sphere_fold). The list keeps ascending sphere index, so the strict
// `<` winner and its tie class are those of the full sweep; n < 0 is the
// overflow sentinel and sweeps all spheres.
template <bool COMPAT>
__device__ __forceinline__ Hit closest_hit_listed(const SceneView& s, const Ray& ray,
                                                  const int* list, int n) {
  if (n < 0) return closest_hit<COMPAT>(s, ray);
  Hit h = no_hit<COMPAT>();
  const HitSweep w = hit_sweep(ray);
  for (int i = 0; i < n; ++i) hit_sphere(s, w, list[i], h);
  hit_planes<COMPAT>(s, w, h);
  return h;
}

// --- the bounce tree's slab test ----------------------------------------------
//
// A box is skipped only where no member sphere can be reported by the sphere
// tests above (hit_sphere, sphere_occludes in both forms) as they compute it
// in float32, for any ray, bounce origins far out on the ground plane
// included. Let u = 2^-24 and S = |o| + reach >= |o| + |c| + r for every
// member (the ray's `s` below; |d| = 1 within a few u). The tests form b =
// 2(o.d - c.d) and c = o.o - 2 o.c + c.c - r^2 from hoisted dot products, so
// their rounding grows with |o|^2 + |c|^2, not with |o - c|^2. Counting each
// operation once (a dot3: 3 roundings of its terms' magnitude; the sums; 4ac;
// the discriminant's fma): |b - B| <= 8uS, |c - C| <= 5uS^2, and the computed
// discriminant lies within 76uS^2 of the exact D = 4a(r^2 - rho^2), rho the
// distance from the center to the ray's line. So a reported hit (disc >= 0)
// has rho^2 <= r^2 + 19uS^2 (1 + 4u): the line passes within r + sqrt(19u) S of
// the center. The sqrt-free shadow test accepts a point o + tc d (tc in [0,
// FAR] in compat, >= 0 in clean) whose exact squared distance from the center
// exceeds r^2 by at most 22uS^2 (cterm's 5uS^2, tc (2g - a tc)'s 17uS^2, with
// tc <= S). Both margins are below delta = 1.5e-3 S (sqrt(22u) = 1.15e-3; the
// rest covers the rounding of delta, of S and of the planes lo - o - delta,
// at most u(S + delta) each): every point of a member that a test can report
// lies in the member's box grown by delta on every side. The boxes' own
// inflation (r 1.001 + 1e-3, rounded outward) only adds to that.
//
// Along the ray: the computed roots are (-b -+ sq) / 2a with |b - B| / 2a <=
// 4uS and sq <= sqrt(D + E)(1 + u), E = 76uS^2, whose exact counterpart is
// the chord of a ball of radius sqrt(r^2 + E / 4a) inside the grown box; 1/2a
// and the product add 2u|t|. So the reported t (the near root, or the far one
// where the near one is <= 0, never less than the near one) is >= T0 - 5uS -
// 3u|T0|, T0 the grown box's exact entry, and num_far > 0 implies that the
// exact exit T1 > -5uS. The slab t's, fma(lo, 1/d, (-o - delta) / d) and the
// like, are (lo + (-o - delta)(1 + e1)) (1/d)(1 + e2)(1 + e3), |e| <= u: the
// first factor moves the plane by at most u(|o| + delta), which delta covers,
// and the rest keeps them within 3u|T| of their exact values. So with w =
// 2^-20 = 16u, t0' = t0 - (|t0| + S) w <=
// T0 - 5uS - 3u|T0| and t1' = t1 + (|t1| + S) w >= T1 + 5uS, and a box may hold
// a reported hit only if t0' <= t1', t1' >= 0 and t0' <= the running winner's
// t (a closest hit: a member's t is >= t0'), or t0' <= FAR (a compat shadow
// ray). The operations are pinned (fa / fm / ff) like the rest of the file.
//
// 1/d is clamped to +-2^64, so no slab product can overflow (for |o| + reach
// < 2^60) and no infinity or NaN ever reaches the slab t's: with a clamp at
// FLT_MAX, d = 0 made (-o - delta) / d infinite wherever |o -+ delta| > 1, so
// both planes of that axis summed to one infinity and every box was dropped
// (a ground bounce keeps a primary ray's exact 0, a shadow ray gets one where
// P_x == light_x). Where |d| >= 2^-64 the argument above holds as it stands.
// Where |d| < 2^-64 (0 and subnormals included) the slope is 2^64 (a power of
// two, so the products are exact), which shrinks that axis's interval from
// (plane - o) / d to (plane - o) 2^64 but cuts off nothing: a reported point
// lies within S (1 + 2e-3) of o along the ray, so on this axis within S 2^-64
// of o's coordinate, and inside the member's box grown by the margins above
// (< 1.2e-3 S); so o lies inside the slab grown by delta with at least 2e-4 S
// to spare, and the clamped interval reaches 2e-4 S 2^64 >> S on both sides
// of t = 0. Where o is not inside it so, no member can report a hit at all.
struct BoxRay {
  float lx, ly, lz;   // (-o - delta) / d: lo / d + this is the lower plane's t
  float hx, hy, hz;   // (-o + delta) / d
  float ix, iy, iz;   // 1/d, clamped to +-2^64
  float s;            // |o| + reach
};

__device__ __forceinline__ float slab_inv(float d) {
  constexpr float CLAMP = 18446744073709551616.0f;   // 2^64
  return fminf(fmaxf(1.0f / d, -CLAMP), CLAMP);
}

__device__ __forceinline__ BoxRay box_ray(float ox, float oy, float oz, float dx, float dy,
                                          float dz, float reach) {
  BoxRay q;
  q.s = fa(sqrtf(dot3(ox, oy, oz, ox, oy, oz)), reach);
  const float delta = fm(1.5e-3f, q.s);
  q.ix = slab_inv(dx); q.iy = slab_inv(dy); q.iz = slab_inv(dz);
  q.lx = fm(fs(-ox, delta), q.ix); q.ly = fm(fs(-oy, delta), q.iy);
  q.lz = fm(fs(-oz, delta), q.iz);
  q.hx = fm(fa(-ox, delta), q.ix); q.hy = fm(fa(-oy, delta), q.iy);
  q.hz = fm(fa(-oz, delta), q.iz);
  return q;
}

struct Span {
  float t0, t1;   // widened entry and exit of the grown box
};

__device__ __forceinline__ Span box_span(const BoxRay& q, const float* b) {
  constexpr float W = 9.5367431640625e-7f;   // 2^-20
  const float ax = ff(b[0], q.ix, q.lx), bx = ff(b[3], q.ix, q.hx);
  const float ay = ff(b[1], q.iy, q.ly), by = ff(b[4], q.iy, q.hy);
  const float az = ff(b[2], q.iz, q.lz), bz = ff(b[5], q.iz, q.hz);
  const float t0 = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float t1 = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return {ff(-W, fa(fabsf(t0), q.s), t0), ff(W, fa(fabsf(t1), q.s), t1)};
}

// May a member of the box beat the running winner at t_max (closest hit), or
// block a shadow ray (t_max = FAR in compat, BIG in clean)?
__device__ __forceinline__ bool visit(const Span& sp, float t_max) {
  return sp.t0 <= sp.t1 && sp.t1 >= 0.0f && sp.t0 <= t_max;
}

// Bounce closest hit over the tree (the JAX package's _grouped_sphere_fold
// answers the same query with Morton groups of 16 under a ball each): parents
// in Morton order, then a parent's leaves, then a leaf's members through
// hit_sphere. A node is skipped if the ray misses its box or enters it after
// the running winner (visit). The winner is the least (t, sphere index)
// (hit_sphere<true>), which the full sweep's strict `<` in ascending order
// also finds, so no visit order can move a tie: the result is the full
// sweep's, bits and index. Pad slots repeat a real member, whose second visit
// changes nothing. The TPU kernel tests a whole tile's rays and sweeps a group
// if any lane needs it; here each thread decides for its own ray, which is the
// same test on fewer rays: lanes of a warp that skip a node wait for those
// that take it, and no warp vote is needed (in AA_SHARED's last pass of the
// sample loop only part of a warp is active, where a full-mask vote would be
// undefined).
template <bool COMPAT>
__device__ __forceinline__ Hit closest_hit_tree(const SceneView& s, const Ray& ray,
                                                const Tables& tb) {
  Hit h = no_hit<COMPAT>();
  const HitSweep w = hit_sweep(ray);
  const BoxRay q = box_ray(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, tb.box[0]);
  const int n_par = tree_parents(tb.n_leaves);
  const float* pbox = tb.box + 1;
  const float* lbox = pbox + 6 * n_par;
  for (int p = 0; p < n_par; ++p) {
    if (!visit(box_span(q, pbox + 6 * p), h.t)) continue;
    const int l1 = min((p + 1) * FAN, tb.n_leaves);
    for (int l = p * FAN; l < l1; ++l) {
      if (!visit(box_span(q, lbox + 6 * l), h.t)) continue;
#pragma unroll
      for (int k = 0; k < LEAF; ++k) hit_sphere<true>(s, w, tb.perm[l * LEAF + k], h);
    }
  }
  hit_planes<COMPAT>(s, w, h);
  return h;
}

// Sqrt-free sphere occlusion: the segment o + t d, 0 <= t <= FAR (unbounded
// in clean mode), meets the ball iff the squared distance at the clamped
// closest-approach parameter tc = clamp(g/a) is <= r^2, i.e.
// cterm <= tc (2g - a tc), with g = d.(c-o) and cterm = |o-c|^2 - r^2. Exact
// against the root form unless a radius is >= FAR/2 (the host guard
// shadow_cheap_ok selects the root form then).
template <bool COMPAT>
__device__ __forceinline__ bool sphere_occ_cheap(float cterm, float g, float a,
                                                 float inv_a) {
  float tc = pm(g, inv_a);
  tc = COMPAT ? fminf(fmaxf(tc, 0.0f), FAR) : fmaxf(tc, 0.0f);
  return cterm <= pm(tc, ff(-a, tc, pm(2.0f, g)));
}

// The terms of a shadow sweep that do not depend on the object.
struct ShadowSweep {
  float ox, oy, oz, dx, dy, dz;
  float oo, a, inv2a, inv_a, od;
};

__device__ __forceinline__ ShadowSweep shadow_sweep(float ox, float oy, float oz,
                                                    float dx, float dy, float dz) {
  ShadowSweep w;
  w.ox = ox; w.oy = oy; w.oz = oz; w.dx = dx; w.dy = dy; w.dz = dz;
  w.oo = dot3(ox, oy, oz, ox, oy, oz);
  w.a = dot3(dx, dy, dz, dx, dy, dz);
  w.inv2a = 1.0f / fm(2.0f, w.a);
  w.inv_a = fa(w.inv2a, w.inv2a);
  w.od = dot3(ox, oy, oz, dx, dy, dz);
  return w;
}

// Does any plane block the shadow ray at 0 < t (< FAR in compat)?
template <bool COMPAT>
__device__ __forceinline__ bool planes_occlude(const SceneView& s, const ShadowSweep& w) {
  const float eps = COMPAT ? 1e-3f : 1e-8f;
  const int np = s.npl;
  for (int j = 0; j < np; ++j) {
    const float nx = s.pln[3 * np + j], ny = s.pln[4 * np + j], nz = s.pln[5 * np + j];
    const float pnum = dot3(fs(s.pln[j], w.ox), fs(s.pln[np + j], w.oy),
                            fs(s.pln[2 * np + j], w.oz), nx, ny, nz);
    const float den = dot3(w.dx, w.dy, w.dz, nx, ny, nz);
    const float den_safe = fabsf(den) > 1e-30f ? den : 1.0f;
    const float tj = pnum / den_safe;
    if (fabsf(den) >= eps && tj > 0.0f && (!COMPAT || tj < FAR)) return true;
  }
  return false;
}

// Does sphere j block the shadow ray? One body for every shadow sweep (full,
// listed, tree).
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool sphere_occludes(const SceneView& s, const ShadowSweep& w,
                                                int j) {
  const int ns = s.ns;
  const float cx = sph_at(s, j), cy = sph_at(s, ns + j), cz = sph_at(s, 2 * ns + j);
  const float r = sph_at(s, 3 * ns + j);
  const float oc = dot3(cx, cy, cz, w.ox, w.oy, w.oz);
  // pinned products, plain sums (see the head of this file)
  const float cterm = ff(-2.0f, oc, w.oo) + ff(-r, r, dot3(cx, cy, cz, cx, cy, cz));
  const float cd = dot3(cx, cy, cz, w.dx, w.dy, w.dz);
  if (CHEAP) return sphere_occ_cheap<COMPAT>(cterm, cd - w.od, w.a, w.inv_a);
  const float b = pm(2.0f, w.od - cd);
  const float disc = ff(b, b, -pm(pm(4.0f, w.a), cterm));
  const bool has = disc >= 0.0f;
  const float sq = sqrtf(has ? disc : 0.0f);
  const float num_near = -b - sq;
  const float num_far = -b + sq;
  const float tj = pm(num_near > 0.0f ? num_near : num_far, w.inv2a);
  return has && num_far > 0.0f && (!COMPAT || tj < FAR);
}

// Is the shadow ray from o along unit d blocked by any object at any
// 0 < t (< FAR in compat)? Planes first, then spheres; the first occluder
// ends the sweep (occlusion is an OR, so the order changes nothing).
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool occluded(const SceneView& s, float ox, float oy,
                                         float oz, float dx, float dy, float dz) {
  const ShadowSweep w = shadow_sweep(ox, oy, oz, dx, dy, dz);
  if (planes_occlude<COMPAT>(s, w)) return true;
  const int ns = s.ns;
  for (int j = 0; j < ns; ++j) {
    if (sphere_occludes<COMPAT, CHEAP>(s, w, j)) return true;
  }
  return false;
}

// Level-0 shadow ray over the tile's occluder list for this light
// (_any_hit_listed): the list holds every sphere that can block a shadow ray
// from the tile's hit points toward the light or beyond it; n < 0 sweeps all.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool occluded_listed(const SceneView& s, float ox, float oy,
                                                float oz, float dx, float dy, float dz,
                                                const int* list, int n) {
  if (n < 0) return occluded<COMPAT, CHEAP>(s, ox, oy, oz, dx, dy, dz);
  const ShadowSweep w = shadow_sweep(ox, oy, oz, dx, dy, dz);
  if (planes_occlude<COMPAT>(s, w)) return true;
  for (int i = 0; i < n; ++i) {
    if (sphere_occludes<COMPAT, CHEAP>(s, w, list[i])) return true;
  }
  return false;
}

// Bounce shadow ray over the tree (_any_hit_multi_grouped): a box is
// skipped if the ray misses it or, in compat, enters it beyond FAR (a member's
// occluding t is >= the box's widened entry). Per thread, as in
// closest_hit_tree; the first occluder ends the sweep.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool occluded_tree(const SceneView& s, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              const Tables& tb) {
  const ShadowSweep w = shadow_sweep(ox, oy, oz, dx, dy, dz);
  if (planes_occlude<COMPAT>(s, w)) return true;
  const BoxRay q = box_ray(ox, oy, oz, dx, dy, dz, tb.box[0]);
  const float t_max = COMPAT ? FAR : BIG;
  const int n_par = tree_parents(tb.n_leaves);
  const float* pbox = tb.box + 1;
  const float* lbox = pbox + 6 * n_par;
  for (int p = 0; p < n_par; ++p) {
    if (!visit(box_span(q, pbox + 6 * p), t_max)) continue;
    const int l1 = min((p + 1) * FAN, tb.n_leaves);
    for (int l = p * FAN; l < l1; ++l) {
      if (!visit(box_span(q, lbox + 6 * l), t_max)) continue;
#pragma unroll
      for (int k = 0; k < LEAF; ++k) {
        if (sphere_occludes<COMPAT, CHEAP>(s, w, tb.perm[l * LEAF + k])) return true;
      }
    }
  }
  return false;
}

// --- the light cells: per-light direction-cell occluder lists -----------------
//
// Every shadow ray toward light l lies, up to rounding, on a line through l, so
// a sphere can block it only if it comes near that line, on either side of l
// (an occluder beyond the light shadows too: shadow rays have no maximum
// distance). Each light gets an axial cube map of directions: face k in {x, y,
// z} takes the directions whose largest |component| is the k-th, with face
// coordinates the other two components over the k-th, in [-1, 1], so d and -d
// share a cell; each face is cut into LC_R x LC_R cells, and a cell's row
// lists, in ascending index, every sphere that a shadow ray filed under that
// cell can report (the light buffer of Haines and Greenberg, 1986).
// light_cells.cu builds the rows once a frame on the card; a bounce-level
// shadow ray sweeps its row (occluded_cells) instead of the tree or every
// sphere. Level 0 keeps its tile lists.
//
// Exactness. Let u = 2^-24, reach >= max(|c| + r, |l|) over every sphere and
// light (rounded up), S = |o| + reach for a shadow ray from o, and S_max =
// LC_SCALE reach, fixed when the rows are built. A ray with S > S_max (in
// float32: not S <= s_max; far ground bounces) takes the sweep it took
// before the cells. For S <= S_max:
//  (1) a sphere that sphere_occludes reports (root or cheap form) has its
//      center within r + sqrt(22u) S < r + 1.15e-3 S of the ray's line (the
//      derivation at the bounce tree's slab test above);
//  (2) light_dir's float32 direction d of l - o is off the exact one by ~9u
//      at most (a rounding of each difference, three in the dot product, the
//      square root, the division, the product), so the ray's line passes
//      within 9u |l - o| <= 9u S of l, and within that of the line through l
//      along d everywhere (where l - o is so short that its squares are
//      subnormal, it passes within |l - o| < 1e-18 of l);
//  (3) so a reported sphere's center lies within r + m of the line through l
//      along d, with m = LC_MARGIN S_max >= (1.15e-3 + 9u) S_max (1.5e-3, the
//      slab test's delta, leaves ~3.5e-4 S_max unused). LC_SCALE = 4 lets
//      origins out to 3 reach use the rows (at 2, 6-7% of the bounce shadow
//      rays of a 100-sphere 1080p frame fell back to the full sweep, at 4
//      2%; the rows grow ~10%, PERF.md);
//  (4) the kernel files d under the face of its largest |d_k| (exact compares,
//      ties to the lower axis, so |d_i / d_k| <= 1 exactly), takes a = d_i /
//      d_k in one IEEE division (within u of the exact ratio) and the index
//      floor((a + 1) LC_R / 2) (the sum rounds once, within u; the product by
//      a power of two is exact; a = 1 goes to the last cell): the exact
//      ratios of d lie within 2^-22 of the computed cell's square, and the
//      build grows every square by LC_GROW = 2^-20 on each side;
//  (5) the build keeps sphere j in a cell's row if a line through l with a
//      direction in the grown cell can pass within rho = r + m of its center:
//      with w = c - l, where rho >= |w| (the grown ball holds the light) in
//      every row of that light; else where the angle between the lines of w
//      and of the cell's central direction c^ is at most alpha + beta, alpha
//      = asin(rho / |w|) and beta the largest angle from c^ to a corner of the
//      grown cell (the cone around c^ through the four corners holds the
//      whole square: its section by the face's plane is an ellipse, which is
//      convex). In cosines, with no asin or acos: |c^ . w| >= cb sqrt(|w|^2 -
//      rho^2) - sb rho, cb = cos(beta), sb = sin(beta) (the right side is |w|
//      cos(alpha + beta), <= 0 where alpha + beta >= 90 degrees);
//  (6) in float32 each side of that test is within 200u (|w| + rho) <= 400u
//      S_max of its exact value (|w| <= |c| + |l| <= 2 reach <= S_max and rho
//      <= S_max; the "holds the light" branch takes every rho^2 >= (1 -
//      2^-10) |w|^2, which keeps sqrt(|w|^2 - rho^2) >= |w| / 32 clear of
//      the cancellation), so the left side gets tau = LC_TAU S_max = 2^-14
//      S_max = 1024u S_max added, and no sphere that the exact test keeps is
//      dropped.
// A direction that is not finite or whose largest |component| is below 0.5
// (light_dir at the light itself) is filed under no cell and takes the old
// sweep too. The build's test is written in products, sums, differences and
// square roots, each one pinned IEEE operation, so light_cells.cu and the
// plain version (light_cells_cuda.light_cells_plain) produce the same rows,
// integer for integer. With LC_MARGIN at 0 the plain lookup misses occluders
// that the full sweep reports (tests/test_torch_light_cells.py).
constexpr float LC_SCALE = 4.0f;                          // S_max / reach
constexpr float LC_MARGIN = 1.5e-3f;                      // m / S_max
constexpr float LC_GROW = 9.5367431640625e-7f;            // 2^-20, the cells' growth
constexpr float LC_TAU = 6.103515625e-5f;                 // 2^-14, the test's slack / S_max
constexpr float LC_HOLDS = 0.9990234375f;                 // 1 - 2^-10
constexpr float LC_REACH_UP = 1.00000095367431640625f;    // 1 + 2^-20

// The row of a light's cells that direction d is filed under, (face * LC_R +
// iu) * LC_R + iv, or -1 (not finite, or not near unit length).
__device__ __forceinline__ int light_cell(float dx, float dy, float dz) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  if (!(__fadd_rn(__fadd_rn(ax, ay), az) <= 2.0f)) return -1;
  int face;
  float m, p, q;
  if (ax >= ay && ax >= az) {
    face = 0; m = dx; p = dy; q = dz;
  } else if (ay >= az) {
    face = 1; m = dy; p = dx; q = dz;
  } else {
    face = 2; m = dz; p = dx; q = dy;
  }
  if (!(fabsf(m) >= 0.5f)) return -1;
  constexpr float HALF_R = 0.5f * LC_R;
  const int iu = min(static_cast<int>(__fmul_rn(__fadd_rn(__fdiv_rn(p, m), 1.0f), HALF_R)),
                     LC_R - 1);
  const int iv = min(static_cast<int>(__fmul_rn(__fadd_rn(__fdiv_rn(q, m), 1.0f), HALF_R)),
                     LC_R - 1);
  return (face * LC_R + iu) * LC_R + iv;
}

// Bounce shadow ray toward light l over the light cells: the row of its
// direction's cell (planes first, then the row's spheres, the first occluder
// ending the sweep), where S <= s_max, the direction has a cell and the row
// did not overflow; else the sweep of before, the tree where the scene has
// one, every sphere where not.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool occluded_cells(const SceneView& s, float ox, float oy,
                                               float oz, float dx, float dy, float dz,
                                               const Tables& tb, int l) {
  const int cell = light_cell(dx, dy, dz);
  const float S = __fadd_rn(
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)), __fmul_rn(oz, oz))),
      __ldg(tb.lc_hdr));
  if (cell >= 0 && S <= __ldg(tb.lc_hdr + 1)) {
    const size_t row = static_cast<size_t>(l) * LC_ROWS + cell;
    const int n = __ldg(tb.lc_cnt + row);
    if (n >= 0) {
      return occluded_listed<COMPAT, CHEAP>(s, ox, oy, oz, dx, dy, dz,
                                            tb.lc_idx + row * LC_K, n);
    }
  }
  if (tb.n_leaves > 0) return occluded_tree<COMPAT, CHEAP>(s, ox, oy, oz, dx, dy, dz, tb);
  return occluded<COMPAT, CHEAP>(s, ox, oy, oz, dx, dy, dz);
}

// Unit mirror direction d - 2(d.n)n (reference common.py:114-120). Returns
// the reciprocal norm of d - 2(d.n)n, which the backward kernel's adjoint of
// the normalisation needs.
__device__ __forceinline__ float reflect_dir(float dx, float dy, float dz,
                                             float nx, float ny, float nz,
                                             float& rx, float& ry, float& rz) {
  const float k = fm(-2.0f, dot3(dx, dy, dz, nx, ny, nz));
  rx = ff(k, nx, dx);
  ry = ff(k, ny, dy);
  rz = ff(k, nz, dz);
  const float rn = rnorm(rx, ry, rz);
  rx = fm(rx, rn);
  ry = fm(ry, rn);
  rz = fm(rz, rn);
  return rn;
}

struct Surface {
  bool alive;
  float px, py, pz;   // hit point, biased along the normal
  float nx, ny, nz;   // unit normal
  float ar, ag, ab;   // albedo
  float ux, uy, uz;   // hit point before the bias (o + t d)
  float srn;          // 1/|P - center| on a sphere, 1 on a plane
};

// A hit -> normal-biased hit point, unit normal and albedo.
template <bool COMPAT>
__device__ __forceinline__ Surface surface(const Ray& ray, const Hit& h) {
  Surface f;
  f.alive = h.t < (COMPAT ? FAR : BIG * 0.5f);
  const float ts = f.alive ? h.t : 0.0f;
  const float px = ff(ts, ray.dx, ray.ox), py = ff(ts, ray.dy, ray.oy),
              pz = ff(ts, ray.dz, ray.oz);
  if (h.plane) {
    f.nx = h.qx; f.ny = h.qy; f.nz = h.qz;
    f.srn = 1.0f;
  } else {
    const float sx = fs(px, h.qx), sy = fs(py, h.qy), sz = fs(pz, h.qz);
    const float sn = rnorm(sx, sy, sz);
    f.nx = fm(sx, sn); f.ny = fm(sy, sn); f.nz = fm(sz, sn);
    f.srn = sn;
  }
  f.ux = px; f.uy = py; f.uz = pz;
  f.px = ff(BIAS, f.nx, px);
  f.py = ff(BIAS, f.ny, py);
  f.pz = ff(BIAS, f.nz, pz);
  f.ar = h.ar; f.ag = h.ag; f.ab = h.ab;
  return f;
}

// Unit direction from the biased hit point to light l (the shadow ray), and
// its reciprocal norm.
__device__ __forceinline__ float light_dir(const SceneView& s, int l, const Surface& f,
                                           float& lx, float& ly, float& lz) {
  const int nl = s.nl;
  lx = fs(s.lts[l], f.px);
  ly = fs(s.lts[nl + l], f.py);
  lz = fs(s.lts[2 * nl + l], f.pz);
  const float ln = rnorm(lx, ly, lz);
  lx = fm(lx, ln); ly = fm(ly, ln); lz = fm(lz, ln);
  return ln;
}

// The mirror ray leaving surface f along unit (rx, ry, rz), its origin biased
// along the ray.
__device__ __forceinline__ Ray bounce_ray(const Surface& f, float rx, float ry, float rz) {
  return {ff(BIAS, rx, f.px), ff(BIAS, ry, f.py), ff(BIAS, rz, f.pz), rx, ry, rz};
}

// Closest hit of a ray at its trace level (0: the primary ray). With TABLES,
// the primary ray sweeps the tile's cone-visible list and a bounce ray the
// bounce tree (where the scene has one); without, and for a table that is
// off, every ray sweeps every sphere. The render, hit-extent and backward
// kernels all decide their hits here, so with the same tables they decide the
// same ones.
template <bool COMPAT, bool TABLES>
__device__ __forceinline__ Hit closest_hit_at(const SceneView& s, const Ray& ray,
                                              const Tables& tb, int level) {
  if (!TABLES) return closest_hit<COMPAT>(s, ray);
  if (level == 0) return closest_hit_listed<COMPAT>(s, ray, tb.vis, tb.vis_n);
  if (tb.n_leaves > 0) return closest_hit_tree<COMPAT>(s, ray, tb);
  return closest_hit<COMPAT>(s, ray);
}

// Closest hit -> normal-biased hit point, unit normal and albedo
// (closest_hit_at's sweeps). The hit-extent kernel (hit_extents.cu) calls
// this same function, so its hit points are the render kernel's level-0
// shadow-ray origins.
template <bool COMPAT, bool TABLES>
__device__ __forceinline__ Surface primary_geometry(const SceneView& s, const Ray& ray,
                                                    const Tables& tb, int level) {
  return surface<COMPAT>(ray, closest_hit_at<COMPAT, TABLES>(s, ray, tb, level));
}

// Is the shadow ray from surface f toward light l (unit direction l), at trace
// level `level`, blocked? With TABLES (the JAX package's dispatch order,
// _trace: lists, then groups, then every sphere, with the light cells and the
// tree standing in for the groups): a shadow ray of a level below
// tb.sh_levels sweeps the tile's occluder list for that level and light; a
// bounce shadow ray above them its light cell's row (occluded_cells), or the
// bounce tree where the cells are off; else, and without TABLES, every
// sphere. The render and the backward kernels both ask here.
template <bool COMPAT, bool CHEAP, bool TABLES>
__device__ __forceinline__ bool light_occluded(const SceneView& s, const Surface& f,
                                               float lx, float ly, float lz,
                                               const Tables& tb, int l, int level) {
  if (TABLES && level < tb.sh_levels) {
    const int row = level * s.nl + l;
    return occluded_listed<COMPAT, CHEAP>(s, f.px, f.py, f.pz, lx, ly, lz,
                                          tb.sh + row * tb.sh_k, tb.sh_n[row]);
  }
  if (TABLES && level > 0 && tb.lc_cnt != nullptr) {
    return occluded_cells<COMPAT, CHEAP>(s, f.px, f.py, f.pz, lx, ly, lz, tb, l);
  }
  if (TABLES && level > 0 && tb.n_leaves > 0) {
    return occluded_tree<COMPAT, CHEAP>(s, f.px, f.py, f.pz, lx, ly, lz, tb);
  }
  return occluded<COMPAT, CHEAP>(s, f.px, f.py, f.pz, lx, ly, lz);
}

// One shading evaluation at trace level `level` (reference trace,
// trace.py:45-112): ambient + Lambert over unoccluded lights (+ Phong in clean
// mode), and the next mirror ray. A miss returns black with alive = false and
// no next ray. The sweeps are closest_hit_at's and light_occluded's. Besides
// the color, the record the backward kernel replays: the hit's t and object,
// and bit l of occ for each occluded light l < 32 (the render drops them).
template <bool COMPAT, bool CHEAP, bool TABLES>
__device__ __forceinline__ TraceOut trace(const SceneView& s, const Ray& ray,
                                          const Tables& tb, int level) {
  TraceOut o;
  const Hit h = closest_hit_at<COMPAT, TABLES>(s, ray, tb, level);
  const Surface f = surface<COMPAT>(ray, h);
  o.t = h.t;
  o.obj = h.obj;
  o.occ = 0u;
  o.alive = f.alive;
  if (!f.alive) {
    o.r = o.g = o.b = 0.0f;
    return o;
  }
  const float* P = s.p;
  const float amb = P[P_AMB], lamb = P[P_LAMB];
  float r = amb * f.ar, g = amb * f.ag, b = amb * f.ab;
  float rx, ry, rz;
  reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, rx, ry, rz);
  float spec_sum = 0.0f;
  const int nl = s.nl;
  for (int l = 0; l < nl; ++l) {
    float lx, ly, lz;
    light_dir(s, l, f, lx, ly, lz);
    const bool occ = light_occluded<COMPAT, CHEAP, TABLES>(s, f, lx, ly, lz, tb, l, level);
    if (occ && l < 32) o.occ |= 1u << l;
    float lam = lamb * (lx * f.nx + ly * f.ny + lz * f.nz);
    lam = (!occ && lam > 0.0f) ? lam : 0.0f;
    r = r + lam * f.ar;
    g = g + lam * f.ag;
    b = b + lam * f.ab;
    if (!COMPAT) {
      // Phong highlight; pow as a masked exp(shin * log(s)).
      const float sdot = lx * rx + ly * ry + lz * rz;
      const bool smask = !occ && sdot > 0.0f;
      const float s_safe = smask ? sdot : 1.0f;
      spec_sum += smask ? expf(P[P_SHIN] * logf(s_safe)) : 0.0f;
    }
  }
  if (!COMPAT && nl > 0) {
    const float phong = P[P_SPEC] * spec_sum;
    r += phong; g += phong; b += phong;
  }
  o.r = r; o.g = g; o.b = b;
  o.next = bounce_ray(f, rx, ry, rz);
  return o;
}

// A sample chain's recorder that keeps nothing (the render's).
struct NoRecord {
  __device__ __forceinline__ void operator()(int, const TraceOut&) const {}
};

// Primary trace + up to `depth` mirror bounces; bounce i adds
// reflection^(i+1) * rgb_i. A ray that misses stops: its weight is 0 from
// then on, so stopping is exact. rec(level, trace) sees each trace as it is
// made (the one-launch fused AA backward keeps their records).
template <bool COMPAT, bool CHEAP, bool TABLES, typename Rec = NoRecord>
__device__ __forceinline__ Rgb sample_chain(const SceneView& s, const Tables& tb,
                                            float px, float py, int depth,
                                            const Rec& rec = Rec()) {
  TraceOut t = trace<COMPAT, CHEAP, TABLES>(s, raygen(s.p, px, py), tb, 0);
  rec(0, t);
  float r = t.r, g = t.g, b = t.b;
  const float refl = s.p[P_REFL];
  float w = 1.0f;
  for (int bounce = 0; bounce < depth && t.alive; ++bounce) {
    w = w * refl;
    t = trace<COMPAT, CHEAP, TABLES>(s, t.next, tb, bounce + 1);
    rec(bounce + 1, t);
    r = r + w * t.r;
    g = g + w * t.g;
    b = b + w * t.b;
  }
  return {r, g, b};
}

// The shared-sample AA combine of one pixel (render_fwd_kernel.cuh's
// AA_SHARED; the one-launch fused AA backward forms its loss with it): the
// lattice colors samp (channel c of position q at samp[c * stride + q]), the
// pixel's centre iC and the first of its U, V and UV neighbours (iU, iV, iUV;
// grids `tile` and `tile + 1` wide), in the stored layout: the centre sample
// alone on the border ring, else its 8 neighbours added and the sum scaled by
// float32(1/9); compat stores the centre (R, B, G) and the neighbours
// unswapped (the accumulation swap composed with the store swap).
template <bool COMPAT>
__device__ __forceinline__ Rgb aa_combine(const float* samp, int stride, int tile, int iC,
                                          int iU, int iV, int iUV, bool interior) {
  const float inv9 = static_cast<float>(1.0 / 9.0);
  float n[3];
  for (int c = 0; c < 3; ++c) {
    const float* sc = samp + c * stride;
    n[c] = sc[iU] + sc[iU + tile] + sc[iV] + sc[iV + 1] + sc[iUV] +
           sc[iUV + tile + 1] + sc[iUV + 1] + sc[iUV + tile + 2];
  }
  const float pr = samp[iC], pg = samp[stride + iC], pb = samp[2 * stride + iC];
  if (COMPAT) {
    return {interior ? (pr + n[0]) * inv9 : pr, interior ? (pb + n[1]) * inv9 : pb,
            interior ? (pg + n[2]) * inv9 : pg};
  }
  return {interior ? (pr + n[0]) * inv9 : pr, interior ? (pg + n[1]) * inv9 : pg,
          interior ? (pb + n[2]) * inv9 : pb};
}

// --- adjoint helpers shared by the backward kernels ------------------------------

constexpr unsigned FULL = 0xffffffffu;

// Slot offsets of the flat gradient vector, grad_layout(ns, npl, nl):
// [spheres 7 ns (cx cy cz r ar ag ab), planes 9 npl (ox oy oz nx ny nz ar ag
// ab), lights 3 nl, amb, lamb, refl, spec, shin, cam_pos 3, rot 9, fov] and a
// trailing loss slot in the fused modes.
struct Slots {
  int pln, lts, mat, cam, loss, n;
  __device__ Slots(int ns, int npl, int nl, bool fused) {
    pln = 7 * ns;
    lts = pln + 9 * npl;
    mat = lts + 3 * nl;          // amb, lamb, refl, spec, shin
    cam = mat + 5;               // pos 3, rot 9, fov
    loss = cam + 13;
    n = loss + (fused ? 1 : 0);
  }
};

// Adjoint of u = v * rn, rn = 1/|v| (render_bwd.py:70): vbar = rn (ubar -
// u (u . ubar)), written into b.
__device__ __forceinline__ void norm_adj(float ux, float uy, float uz, float rn,
                                         float& bx, float& by, float& bz) {
  const float dot = ux * bx + uy * by + uz * bz;
  bx = rn * (bx - ux * dot);
  by = rn * (by - uy * dot);
  bz = rn * (bz - uz * dot);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// row[slot] += the warp's sum of v. Every lane of the warp must call it.
__device__ __forceinline__ void acc(float* row, int slot, float v, int lane) {
  v = warp_sum(v);
  if (lane == 0) row[slot] += v;
}

// The block's partial sums: its `nwarps` accumulator rows of `n` slots
// (s_acc[w * n + k]) summed in warp order into column `block` of partial
// (partial[k * n_blocks + block]). Call after a __syncthreads().
__device__ __forceinline__ void write_block_partial(const float* s_acc, int nwarps, int n,
                                                    float* partial, int tid, int nt) {
  const size_t n_blocks = static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z;
  const size_t block = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                           gridDim.x + blockIdx.x;
  for (int k = tid; k < n; k += nt) {
    float v = 0.0f;
    for (int wp = 0; wp < nwarps; ++wp) v += s_acc[wp * n + k];
    partial[static_cast<size_t>(k) * n_blocks + block] = v;
  }
}

}  // inline namespace pinned / contracted
}  // namespace rt
