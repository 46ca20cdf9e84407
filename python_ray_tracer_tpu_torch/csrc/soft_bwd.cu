// Soft-visibility backward kernel for Hopper (sm_90a): scene and camera
// gradients of the soft render by hand-derived reverse-mode adjoints, one
// thread per pixel.
//
// Replaces the TPU kernel python_ray_tracer_tpu/ops/pallas/soft_bwd.py
// _make_soft_bwd_kernel (:77, pallas_call at :619) in both of its forms:
//   COT    an image cotangent (W, H, 3) in        (soft_scene_grads_pallas, :634)
//   FUSED  a target in: the kernel renders the pixel, forms the MSE loss
//          partial and its cotangent, then reverse-sweeps (soft_loss_and_grads_pallas,
//          :646): a whole soft training step in one launch.
// Both fill the camera slots. Output: per-block partial sums of the flat
// gradient vector of render_bwd.grad_layout (the refl, spec and shin slots stay
// 0: the soft scope has no mirror bounce and no Phong) plus a trailing loss
// slot in FUSED; rt_reduce_rows (render_bwd.cu) sums them in a fixed order.
//
// The adjoints use the sigmoid-cancelling identities of soft_bwd.py:16-28. With
// x_j a sphere's sigmoid pre-activation:
//   transmission vis = prod_j (1 - a_j):               dL/dx_j = -visbar vis a_j
//   weight w_i = a_i prod_{j != i} (1 - a_j c_ji):     own      dL/dx_i += wbar w_i (1 - a_i)
//                                                      occluder dL/dx_j -= wbar w_i a_j
// No division by (1 - a): a saturated a == 1.0f gives exact zeros, never a NaN.
// A sphere's primary cover is adjoined once a pixel: its own term and every
// object behind it are one pre-activation cotangent, wbar_j w_j (1 - a_j) -
// a_j sum_{i behind j} wbar_i w_i (the cover's adjoint is linear in it). The
// plane's t adjoint masks den by |den| > 1e-8 and leaves num unmasked, as
// ops/soft.py's autograd does.
//
// What bounded the first port of this kernel (3.007 ms on the demo scene at
// 1000x1000, 195.4 ms at 100 spheres 512x512, 45x and 2796x its bound, H100 at
// 700 W): per (object i, occluder j, light l) four warp reductions (5 shuffles
// and a shared-memory add each: 504 a pixel-warp on the demo scene, ~121,000 at
// 100 spheres), the forward recomputed for every object (its weight from K
// fresh covers: O(K^2) covers a pixel), and dead terms computed and reduced.
// What bounds this one: FP32 issue, most of it in the shadow sweeps' covers (a
// cover a lit (object, light, sphere) triple in the forward, a cover and, where
// its alpha is not 0, an adjoint in the backward), whose IEEE sqrt, exp and
// reciprocal are multi-instruction sequences without fast math (an estimate
// from the operation counts; the issue slots are not measured).
//
// What the design does about it:
//   * forward values once a pixel: every object's primary cover is taken once
//     and the live ones (alpha > 0, ascending index) go into a lane-private
//     table in shared memory (index and lit-light bits, a, t, weight, lam_sum,
//     tbar, one transmission per light; a's field holds wbar once the forward
//     is done). The weights are formed from the table's (a, t) alone, each lit
//     (object, light) transmission is swept once, and FUSED's loss and
//     cotangent come from those same values. A pixel with more than `cap` live
//     objects takes them in chunks of `cap`; a chunk that does not hold every
//     live object forms its weights from one sweep of fresh covers and FUSED
//     re-sweeps its transmissions in the backward. A plan that cannot store
//     one transmission per light (store_vis 0, very many lights) re-sweeps
//     them too. 1 / (tau r), 1 / r and the squared distance past which alpha
//     is exactly 0 are staged per sphere, so a cover takes one multiply where
//     the forward kernel divides, and a far sphere is dropped before its sqrt;
//   * exact skips, each of a term that is exactly 0: an object with weight 0
//     (a == 0, or an occluder in front with a == 1.0f, which the table's weights
//     give exactly), a light with a Lambert term <= 0 (vis_fac and relubar are
//     then unused), a shadow occluder with alpha 0 (t_ca <= 0, b^2 > dead2, or a
//     sigmoid that underflows: its adjoint is all zeros), a transmission that reached 0, and a
//     pixel whose color cotangent is 0 (pad pixels included);
//   * no reduction in the inner loops: the (center, radius, albedo) cotangents
//     of a window of `cj` spheres accumulate in a lane-private slab of shared
//     memory (slot-major, so neighbouring lanes hit neighbouring banks; no
//     atomics), and each slot is warp-reduced once a window, in a fixed order,
//     into the warp's row, as are each light's, plane's, material's and camera
//     slot once a chunk. A warp-uniform __any_sync skips a slot that is 0 on
//     every lane (an add of zeros changes at most a zero's sign). The block then
//     sums its warp rows in warp order into its partial column, and
//     rt_reduce_rows sums each column in a fixed tree: two runs give the same
//     bits;
//   * loops that hold a warp collective (chunks, windows, lights, planes, slots)
//     run warp-uniformly; everything inside them is per lane.
// The plan (threads a block, cap, cj, store_vis) comes from the wrapper's
// planner (soft_bwd_cuda.plan), which fits the block's shared memory:
//   4 B x (41 + 10 ns + 9 npl + 3 nl                the scene and 3 floats a sphere
//          + (nt / 32) n_grads                      one row a warp
//          + nt ((6 + nl store_vis) cap + 7 cj))    the lane-private table and slab
// The planner takes the most threads a block, then stored transmissions, then
// cap and cj as large as fit (cap up to 32, cj up to 16, the larger halved
// first). The arithmetic on the H100: the kernel has 96 registers and 64 B of
// local memory a thread (stack frame and spills; chip_smoke.py phase 12 prints
// what cudaFuncGetAttributes reports), so registers allow 5 blocks of 128
// threads an SM. The demo scene's plan (128 threads, cap 7, cj 6) takes
// 55,500 B of shared memory, 4 blocks (16 warps) an SM; 100 spheres
// (128, 32, 16) take 220,828 B, 1 block (4 warps). In phase 12's plan sweep
// the demo's plan is the fastest; at 100 spheres the fastest, (64, 8, 8) with
// 10 warps an SM, is 17% faster than the planner's, and a chunk of 1 object
// is 2.4-2.7x slower (PERF.md §6).
//
// Block: nt threads (32, 64 or 128), 16 along the image's y axis and nt/16
// along x; a one-dimensional grid of ceil(H/16) * ceil(W/(nt/16)) blocks.
//
// Past 3388 spheres (1 plane, 3 lights) the scene's 10 words a sphere do not
// fit a block beside its rows, and the planner takes the global form (G):
// the sphere table is read where it lies in device memory, through the
// read-only cache (Scene<G>), and 1 / (tau r), 1 / r and dead2 are computed
// where they are needed, in the staging loop's operations; that takes scenes
// up to 8228 spheres. The forms agree to float32 rounding, not bit for bit:
// nvcc contracts their instantiations differently, and compiling the file
// without contraction, which gave bits, cost the main-path soft step 2.8%
// (PERF.md §6). On the card the global form is 14-17% slower on the scenes
// both take (chip_smoke.py phase 22 [repair-form]), so the planner stages
// while the scene fits.
//
// Past 8228 spheres the rows no longer fit a block either, and the planner
// takes the third form (R, only where neither of the others fits): each
// warp's row lies in a device-memory scratch buffer (blocks x warps x n_grads
// floats) that the wrapper allocates and the kernel zeroes. Its grid is the
// card's size (soft_bwd_cuda.n_blocks), not one block a pixel group: block b
// walks groups b, b + gridDim.x, ..., so the scratch and the partials are
// bounded by the card, whatever the frame. Each warp still owns its row (lane
// 0 adds each warp sum to it), and the block still sums its rows in warp
// order into its partial column: no atomics, two runs give the same bits. The
// block keeps the parameters, planes, lights and the lane-private table and
// slab.
//
// Slices (ray-parallel sharding): a launch's pixels are columns [P_X0, P_X0 +
// W) of a frame Wg wide; FUSED's loss and cotangent take the frame's
// denominator 3 Wg H, so the slices' partials sum to the frame's.

#include <cuda_runtime.h>

#include "soft_common.cuh"

namespace {

using namespace rt;

constexpr int BX = 16;         // threads along y
constexpr int MAX_NT = 128;
constexpr int GI_BITS = 21;    // T_KEY: object index in the low bits (2^21 objects) ...
constexpr int LIT_BITS = 9;    // ... the Lambert sign of lights 0..8 above (bit 30 clear)

// Lane-private table fields (slot-major: field f of entry e at (f cap + e) nt).
enum : int {
  T_KEY = 0,   // object index | lit-light mask << GI_BITS (int bits)
  T_A,         // primary alpha; after the forward, wbar w_i = (amb + lam_sum) gA w_i
  T_T,         // blend depth
  T_W,         // compositing weight
  T_LS,        // lam_sum = sum_l relu(lamb L.N) vis_l
  T_TBAR,      // cotangent of the blend depth
  T_VIS,       // nl transmissions (store_vis; -1 for a light the forward found unlit)
  N_TFIXED = T_VIS
};
constexpr int T_WBAR = T_A;

// Per sphere of radius r: 1 / (tau r), 1 / r and dead2 = (r (1 + 90 tau))^2:
// a ray whose squared closest-approach distance exceeds dead2 has x < -89.9,
// so expf(-x) overflows and alpha is exactly 0 (which makes dead2's last bit
// immaterial: alpha is 0 on both sides of it).
__device__ __forceinline__ float inv_tau_r(float r, float tau) { return 1.0f / (tau * r); }
__device__ __forceinline__ float dead_r2(float r, float tau) {
  const float rd = r * (1.0f + 90.0f * tau);
  return rd * rd;
}

// The scene as the backward reads it: the SoA tables and, staged (G false),
// each sphere's three values above in shared memory (rcp); the global form
// (G) reads the sphere table where it lies, through the read-only cache, and
// computes the three values from the radius where it needs them, in the
// staging loop's operations.
template <bool G>
struct Scene {
  SceneView v;
  const float* rcp;   // 1 / (tau r) x ns, 1 / r x ns, dead2 x ns (staged form)
  float tau;

  __device__ __forceinline__ float sph(int i) const {
    if constexpr (G) {
      return __ldg(v.sph + i);
    } else {
      return v.sph[i];
    }
  }
  __device__ __forceinline__ float r(int j) const { return sph(3 * v.ns + j); }
  __device__ __forceinline__ float inv_tr(int j) const {
    if constexpr (G) {
      return inv_tau_r(r(j), tau);
    } else {
      return rcp[j];
    }
  }
  __device__ __forceinline__ float inv_r(int j) const {
    if constexpr (G) {
      return 1.0f / r(j);
    } else {
      return rcp[v.ns + j];
    }
  }
  __device__ __forceinline__ float dead2(int j) const {
    if constexpr (G) {
      return dead_r2(r(j), tau);
    } else {
      return rcp[2 * v.ns + j];
    }
  }
};

// Sphere j's cover of a ray, with early exits: false (alpha exactly 0) when
// t_ca <= 0, when b^2 > dead2 (before the sqrt and the exp) or when the
// sigmoid underflows. soft_cover's arithmetic, but for the pre-activation
// -(b - r) * (1 / (tau r)).
template <bool NEED_T, bool G>
__device__ __forceinline__ bool live_cover(const Scene<G>& sc, int j, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           Cover& c) {
  const int ns = sc.v.ns;
  const float r = sc.r(j);
  c.Lx = sc.sph(j) - ox;
  c.Ly = sc.sph(ns + j) - oy;
  c.Lz = sc.sph(2 * ns + j) - oz;
  c.t_ca = c.Lx * dx + c.Ly * dy + c.Lz * dz;
  if (!(c.t_ca > 0.0f)) return false;
  const float vx = c.Lx - c.t_ca * dx, vy = c.Ly - c.t_ca * dy, vz = c.Lz - c.t_ca * dz;
  c.d2 = vx * vx + vy * vy + vz * vz;
  if (c.d2 > sc.dead2(j)) return false;
  c.b = sqrtf(c.d2 > 1e-12f ? c.d2 : 1e-12f);
  c.a = sigmoid(-(c.b - r) * sc.inv_tr(j));
  c.hc = 1.0f;
  c.t_raw = c.t = 0.0f;
  c.inside = false;
  if (NEED_T) {
    const float chord2 = r * r - c.d2;
    c.inside = chord2 > 1e-12f;
    c.hc = sqrtf(c.inside ? chord2 : 1.0f);
    c.t_raw = c.inside ? c.t_ca - c.hc : c.t_ca;
    c.t = fmaxf(c.t_raw, 1e-4f);
  }
  return c.a > 0.0f;
}

struct CoverAdj {
  float cx, cy, cz, r;   // center and radius cotangents
  float ox, oy, oz;      // ray-origin cotangent
  float dx, dy, dz;      // ray-direction cotangent
};

// Adjoint of sphere j's cover (soft_bwd.cover_adj, :179-206): xbar is the
// cotangent of the sigmoid's pre-activation x = -(b - r) / (tau r) (formed with
// the sigmoid-cancelling identities, so a saturated alpha gives exact zeros);
// tbar that of the clamped blend depth (WITH_T; the cover must carry t).
template <bool WITH_T, bool G>
__device__ __forceinline__ CoverAdj cover_adj(const Scene<G>& sc, int j, const Cover& c,
                                              float dx, float dy, float dz, float xbar,
                                              float tbar) {
  const float r = sc.r(j), inv_tr = sc.inv_tr(j);
  const float bbar = -xbar * inv_tr;
  float rbar = xbar * c.b * inv_tr * sc.inv_r(j);
  float d2bar = c.d2 > 1e-12f ? bbar * 0.5f / c.b : 0.0f;
  float t_cabar;
  if (WITH_T) {
    const float t_rbar = c.t_raw > 1e-4f ? tbar : 0.0f;
    const float hcbar = c.inside ? -t_rbar : 0.0f;
    const float c2bar = hcbar * 0.5f / c.hc;
    rbar += 2.0f * r * c2bar;
    d2bar -= c2bar;
    t_cabar = t_rbar - 2.0f * c.t_ca * d2bar;
  } else {
    t_cabar = -2.0f * c.t_ca * d2bar;
  }
  // The adjoint of d2 = |L|^2 - t_ca^2 (t_ca = L . d, L = center - origin).
  // That of |L - t_ca d|^2, the form the cover evaluates, gives the same L
  // cotangent for a unit d and a d cotangent that differs only along d, which
  // the adjoint of each ray direction's normalisation removes; this one costs
  // fewer operations a cover.
  const float Lbx = t_cabar * dx + 2.0f * d2bar * c.Lx;
  const float Lby = t_cabar * dy + 2.0f * d2bar * c.Ly;
  const float Lbz = t_cabar * dz + 2.0f * d2bar * c.Lz;
  return {Lbx, Lby, Lbz, rbar, -Lbx, -Lby, -Lbz,
          t_cabar * c.Lx, t_cabar * c.Ly, t_cabar * c.Lz};
}

// Shadow transmission prod_j (1 - alpha_j) from P toward L, dead occluders
// skipped (a factor 1 - 0), stopping once it is 0.
template <bool G>
__device__ __forceinline__ float transmission_live(const Scene<G>& sc, float px, float py,
                                                   float pz, const LightDir& L) {
  float vis = 1.0f;
  for (int j = 0; j < sc.v.ns && vis != 0.0f; ++j) {
    Cover c;
    if (live_cover<false>(sc, j, px, py, pz, L.x, L.y, L.z, c)) vis *= 1.0f - c.a;
  }
  return vis;
}

// Object gi's surface at blend depth t: its point, unit normal (with the
// normal's reciprocal norm) and albedo.
struct Surf {
  float px, py, pz, nx, ny, nz, nn, ar, ag, ab;
};

template <bool G>
__device__ __forceinline__ Surf surface_at(const Scene<G>& sc, const Ray& ray, int gi,
                                           float t) {
  const SceneView& s = sc.v;
  Surf o;
  o.px = ray.ox + t * ray.dx;
  o.py = ray.oy + t * ray.dy;
  o.pz = ray.oz + t * ray.dz;
  const int ns = s.ns;
  if (gi < ns) {
    const float vx = o.px - sc.sph(gi), vy = o.py - sc.sph(ns + gi),
                vz = o.pz - sc.sph(2 * ns + gi);
    const float vv = vx * vx + vy * vy + vz * vz;
    o.nn = 1.0f / sqrtf(vv > 0.0f ? vv : 1.0f);
    o.nx = vx * o.nn; o.ny = vy * o.nn; o.nz = vz * o.nn;
    o.ar = sc.sph(4 * ns + gi); o.ag = sc.sph(5 * ns + gi); o.ab = sc.sph(6 * ns + gi);
  } else {
    const int k = gi - ns, np = s.npl;
    o.nn = 1.0f;
    o.nx = s.pln[3 * np + k]; o.ny = s.pln[4 * np + k]; o.nz = s.pln[5 * np + k];
    o.ar = s.pln[6 * np + k]; o.ag = s.pln[7 * np + k]; o.ab = s.pln[8 * np + k];
  }
  return o;
}

// Cotangents of the primary ray's origin and direction, carried over objects.
struct RayBar {
  float ox, oy, oz, dx, dy, dz;
};

// One lane's pixel: its ray, color cotangent, table and slab (lane-private,
// slot-major with stride nt) and its running sums.
template <bool G>
struct Pix {
  const Scene<G>& sc;
  Ray ray;
  float tau;
  float* tab;   // this lane's column of the table
  float* slab;  // this lane's column of the slab
  int nt, cap;
  bool store_vis;
  float g0, g1, g2;
  RayBar rb;
  float amb_acc, lamb_acc;

  __device__ float& T(int f, int e) const { return tab[(f * cap + e) * nt]; }
  __device__ float& S(int k) const { return slab[k * nt]; }
  __device__ unsigned key(int e) const {
    return static_cast<unsigned>(__float_as_int(T(T_KEY, e)));
  }
  __device__ int gi(int e) const { return static_cast<int>(key(e) & ((1u << GI_BITS) - 1u)); }

  // Was light l's Lambert term positive in the forward? So that every stage
  // takes the forward's decision: the table's bit for lights below LIT_BITS,
  // past them the stored transmission (fill() stores -1 for an unlit light).
  // Only a plan without stored transmissions recomputes the sign past
  // LIT_BITS; its transmissions are recomputed too, so nothing stale is read.
  __device__ bool lit(int e, int l, float lam) const {
    if (l < LIT_BITS) return ((key(e) >> (GI_BITS + l)) & 1u) != 0u;
    return store_vis ? T(T_VIS + l, e) >= 0.0f : lam > 0.0f;
  }
  __device__ bool maybe_lit(int e, int l) const {
    return (l >= LIT_BITS && !store_vis) || lit(e, l, 0.0f);
  }

  __device__ float vis(int e, int l, const Surf& o, const LightDir& L) const {
    return store_vis ? T(T_VIS + l, e) : transmission_live(sc, o.px, o.py, o.pz, L);
  }

  // Scan objects from *k on: the next `cap` live ones (alpha > 0) go into the
  // table. *k stops at the first live object that did not fit, or at K.
  __device__ int build(int* k) const {
    const SceneView& s = sc.v;
    const int ns = s.ns, K = ns + s.npl;
    int n = 0;
    for (; *k < K; ++*k) {
      float a, t;
      if (*k < ns) {
        Cover c;
        if (!live_cover<true>(sc, *k, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, c))
          continue;
        a = c.a;
        t = c.t;
      } else {
        const PlaneCover p = plane_cover(s, *k - ns, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                         ray.dz);
        a = p.a;
        t = p.t;
      }
      if (!(a > 0.0f)) continue;
      if (n == cap) break;
      T(T_KEY, n) = __int_as_float(*k);
      T(T_A, n) = a;
      T(T_T, n) = t;
      ++n;
    }
    return n;
  }

  // Weights of a chunk that does not hold every live object: one sweep over
  // all objects' fresh covers, each live one a factor of every entry behind
  // it (objects ascending, as soft_weight multiplies).
  __device__ void chunk_weights(int n) const {
    const SceneView& s = sc.v;
    const int ns = s.ns, K = ns + s.npl;
    for (int e = 0; e < n; ++e) T(T_W, e) = T(T_A, e);
    for (int k = 0; k < K; ++k) {
      float a, t;
      if (k < ns) {
        Cover c;
        if (!live_cover<true>(sc, k, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, c))
          continue;
        a = c.a;
        t = c.t;
      } else {
        const PlaneCover p = plane_cover(s, k - ns, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                         ray.dz);
        a = p.a;
        t = p.t;
      }
      if (!(a > 0.0f)) continue;
      for (int e = 0; e < n; ++e) {
        if (closer(t, k, T(T_T, e), gi(e))) T(T_W, e) *= 1.0f - a;
      }
    }
  }

  // The forward of the table's n entries: weights (from the table when it
  // holds every live object, else from one sweep of fresh covers),
  // transmissions of lit lights, lam_sum; returns the chunk's color.
  __device__ Rgb fill(int n, bool complete) const {
    const SceneView& s = sc.v;
    const float amb = s.p[P_AMB], lamb = s.p[P_LAMB];
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (!complete) chunk_weights(n);
    for (int e = 0; e < n; ++e) {
      const int gi_e = gi(e);
      const float a = T(T_A, e), t = T(T_T, e);
      float w = a;
      if (complete) {
        for (int e2 = 0; e2 < n; ++e2) {
          if (closer(T(T_T, e2), gi(e2), t, gi_e)) w *= 1.0f - T(T_A, e2);
        }
      } else {
        w = T(T_W, e);
      }
      T(T_W, e) = w;
      float lam_sum = 0.0f;
      unsigned lit_bits = 0;
      if (w != 0.0f) {
        const Surf o = surface_at(sc, ray, gi_e, t);
        for (int l = 0; l < s.nl; ++l) {
          const LightDir L = light_dir(s, l, o.px, o.py, o.pz);
          const float lam = lamb * (L.x * o.nx + L.y * o.ny + L.z * o.nz);
          if (!(lam > 0.0f)) {
            if (store_vis) T(T_VIS + l, e) = -1.0f;
            continue;
          }
          const float vis = transmission_live(sc, o.px, o.py, o.pz, L);
          lam_sum += lam * vis;
          if (store_vis) T(T_VIS + l, e) = vis;
          if (l < LIT_BITS) lit_bits |= 1u << (GI_BITS + l);
        }
        r += w * (amb * o.ar + lam_sum * o.ar);
        g += w * (amb * o.ag + lam_sum * o.ag);
        b += w * (amb * o.ab + lam_sum * o.ab);
      }
      T(T_LS, e) = lam_sum;
      T(T_KEY, e) = __int_as_float(static_cast<int>(static_cast<unsigned>(gi_e) | lit_bits));
    }
    return {r, g, b};
  }

  // Per live object, once its color cotangent is known: wbar (into T_A) and
  // the ambient sum; the blend depth's cotangent starts at 0.
  __device__ void prepare(int n) {
    const SceneView& s = sc.v;
    const float amb = s.p[P_AMB];
    for (int e = 0; e < n; ++e) {
      const float w = T(T_W, e);
      T(T_TBAR, e) = 0.0f;
      T(T_WBAR, e) = 0.0f;
      if (w == 0.0f) continue;
      const int gi_e = gi(e), ns = s.ns;
      float ar, ag, ab;
      if (gi_e < ns) {
        ar = sc.sph(4 * ns + gi_e); ag = sc.sph(5 * ns + gi_e); ab = sc.sph(6 * ns + gi_e);
      } else {
        const float* alb = s.pln + 6 * s.npl + gi_e - ns;
        ar = alb[0]; ag = alb[s.npl]; ab = alb[2 * s.npl];
      }
      const float gA = g0 * ar + g1 * ag + g2 * ab;
      amb_acc += w * gA;
      T(T_WBAR, e) = (amb + T(T_LS, e)) * gA * w;
    }
  }

  // P = o + t d: the primary ray and the blend depth take P's cotangent.
  __device__ void point_adj(int e, float t, float bx, float by, float bz) {
    rb.ox += bx; rb.oy += by; rb.oz += bz;
    rb.dx += t * bx; rb.dy += t * by; rb.dz += t * bz;
    T(T_TBAR, e) += bx * ray.dx + by * ray.dy + bz * ray.dz;
  }

  // Entry e's Lambert terms: the lamb sum and the normal's cotangent nb.
  __device__ void lambert_adj(int e, const Surf& o, float sbar, float* nb) {
    const SceneView& s = sc.v;
    const float lamb = s.p[P_LAMB];
    for (int l = 0; l < s.nl; ++l) {
      if (!maybe_lit(e, l)) continue;
      const LightDir L = light_dir(s, l, o.px, o.py, o.pz);
      const float ldotn = L.x * o.nx + L.y * o.ny + L.z * o.nz;
      if (!lit(e, l, lamb * ldotn)) continue;
      const float relubar = sbar * vis(e, l, o, L);
      lamb_acc += relubar * ldotn;
      const float ldotnbar = relubar * lamb;
      nb[0] += ldotnbar * L.x;
      nb[1] += ldotnbar * L.y;
      nb[2] += ldotnbar * L.z;
    }
  }

  // Lights' and shadow occluders' adjoints of light l for the entries, with
  // the occluders of spheres [w0, w1) (slab slots 7 (j - w0) + 0..3); the
  // Lambert term's light cotangent rides in the first window. Adds the light
  // slot's cotangent to Lw.
  __device__ void shadow_stage(int n, int l, int w0, int w1, float* Lw) {
    const SceneView& s = sc.v;
    const float lamb = s.p[P_LAMB];
    for (int e = 0; e < n; ++e) {
      const float w = T(T_W, e);
      if (w == 0.0f || !maybe_lit(e, l)) continue;
      const float t = T(T_T, e);
      const Surf o = surface_at(sc, ray, gi(e), t);
      const LightDir L = light_dir(s, l, o.px, o.py, o.pz);
      const float lam = lamb * (L.x * o.nx + L.y * o.ny + L.z * o.nz);
      if (!lit(e, l, lam)) continue;
      const float v = vis(e, l, o, L);
      const float sbar = w * (g0 * o.ar + g1 * o.ag + g2 * o.ab);
      float Lb[3] = {0.0f, 0.0f, 0.0f}, Pb[3] = {0.0f, 0.0f, 0.0f};
      if (w0 == 0) {
        const float ldotnbar = (sbar * v) * lamb;
        Lb[0] = ldotnbar * o.nx; Lb[1] = ldotnbar * o.ny; Lb[2] = ldotnbar * o.nz;
      }
      const float vis_fac = -(sbar * lam) * v;
      if (vis_fac != 0.0f) {
        for (int j = w0; j < w1; ++j) {
          Cover c;
          if (!live_cover<false>(sc, j, o.px, o.py, o.pz, L.x, L.y, L.z, c)) continue;
          const CoverAdj d = cover_adj<false>(sc, j, c, L.x, L.y, L.z, vis_fac * c.a, 0.0f);
          float* q = slab + 7 * (j - w0) * nt;
          q[0] += d.cx; q[nt] += d.cy; q[2 * nt] += d.cz; q[3 * nt] += d.r;
          Pb[0] += d.ox; Pb[1] += d.oy; Pb[2] += d.oz;
          Lb[0] += d.dx; Lb[1] += d.dy; Lb[2] += d.dz;
        }
      }
      // L = (light - P) * rn
      norm_adj(L.x, L.y, L.z, L.rn, Lb[0], Lb[1], Lb[2]);
      Lw[0] += Lb[0]; Lw[1] += Lb[1]; Lw[2] += Lb[2];
      point_adj(e, t, Pb[0] - Lb[0], Pb[1] - Lb[1], Pb[2] - Lb[2]);
    }
  }

  // Sphere j into slab slots 7 (j - w0) + 0..6: for its entry `own` (or -1)
  // the Lambert and normal chains, the albedo; then its primary cover's
  // adjoint, own term, every entry behind it and its depth in one.
  __device__ void sphere_primary(int n, int j, int w0, int own) {
    const SceneView& s = sc.v;
    float* q = slab + 7 * (j - w0) * nt;
    float t = 0.0f;
    if (own >= 0) {
      t = T(T_T, own);
      const float w = T(T_W, own);
      if (w != 0.0f) {
        const Surf o = surface_at(sc, ray, j, t);
        float nb[3] = {0.0f, 0.0f, 0.0f};
        lambert_adj(own, o, w * (g0 * o.ar + g1 * o.ag + g2 * o.ab), nb);
        // N = (P - c) * nn: P takes vb, the center -vb
        norm_adj(o.nx, o.ny, o.nz, o.nn, nb[0], nb[1], nb[2]);
        point_adj(own, t, nb[0], nb[1], nb[2]);
        const float ws = w * (s.p[P_AMB] + T(T_LS, own));
        q[0] -= nb[0]; q[nt] -= nb[1]; q[2 * nt] -= nb[2];
        q[4 * nt] += ws * g0; q[5 * nt] += ws * g1; q[6 * nt] += ws * g2;
      }
    }
    Cover c;
    if (!live_cover<true>(sc, j, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, c)) {
      if (own < 0) return;
      // an entry whose recomputed cover rounds to dead: take the full cover
      c = soft_cover<true>(ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, sc.sph(j),
                           sc.sph(s.ns + j), sc.sph(2 * s.ns + j), sc.r(j), tau);
    }
    if (own < 0) t = c.t;
    // wbar_j w_j (1 - a_j) - a_j sum_{i behind j} wbar_i w_i
    float behind = 0.0f;
    for (int e = 0; e < n; ++e) {
      if (e != own && closer(t, j, T(T_T, e), gi(e))) behind += T(T_WBAR, e);
    }
    float xbar = -c.a * behind, tbar = 0.0f;
    if (own >= 0) {
      xbar = T(T_WBAR, own) * (1.0f - c.a) + xbar;
      tbar = T(T_TBAR, own);
    }
    if (xbar != 0.0f || tbar != 0.0f) {
      const CoverAdj d = cover_adj<true>(sc, j, c, ray.dx, ray.dy, ray.dz, xbar, tbar);
      q[0] += d.cx; q[nt] += d.cy; q[2 * nt] += d.cz; q[3 * nt] += d.r;
      rb.ox += d.ox; rb.oy += d.oy; rb.oz += d.oz;
      rb.dx += d.dx; rb.dy += d.dy; rb.dz += d.dz;
    }
  }

  // Plane entry e's nine slot cotangents (origin, normal, albedo) into v.
  __device__ void plane_adj(int e, float* v) {
    const SceneView& s = sc.v;
    const int k = gi(e) - s.ns, np = s.npl;
    const float w = T(T_W, e), t = T(T_T, e);
    const Surf o = surface_at(sc, ray, gi(e), t);
    float nb[3] = {0.0f, 0.0f, 0.0f};
    lambert_adj(e, o, w * (g0 * o.ar + g1 * o.ag + g2 * o.ab), nb);
    const float p0x = s.pln[k], p0y = s.pln[np + k], p0z = s.pln[2 * np + k];
    const PlaneCover pc = plane_cover(s, k, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz);
    // t = max(num / den_safe, 1e-4), num = n.(p0 - o), den = n.d; the plane's
    // alpha is an indicator and has no adjoint
    const float t_m = pc.t_pre > 1e-4f ? T(T_TBAR, e) : 0.0f;
    const float inv_den = 1.0f / pc.den_safe;
    const float numbar = t_m * inv_den;
    const float denbar = pc.den_ok ? -(t_m * pc.t_pre) * inv_den : 0.0f;
    const float ws = w * (s.p[P_AMB] + T(T_LS, e));
    v[0] = numbar * o.nx;
    v[1] = numbar * o.ny;
    v[2] = numbar * o.nz;
    v[3] = denbar * ray.dx + nb[0] + numbar * (p0x - ray.ox);
    v[4] = denbar * ray.dy + nb[1] + numbar * (p0y - ray.oy);
    v[5] = denbar * ray.dz + nb[2] + numbar * (p0z - ray.oz);
    v[6] = ws * g0; v[7] = ws * g1; v[8] = ws * g2;
    rb.ox -= numbar * o.nx; rb.oy -= numbar * o.ny; rb.oz -= numbar * o.nz;
    rb.dx += denbar * o.nx; rb.dy += denbar * o.ny; rb.dz += denbar * o.nz;
  }
};

// row[slot] += the warp's sum of v, skipped when v is 0 on every lane. Every
// lane of the warp must call it.
__device__ __forceinline__ void acc_live(float* row, int slot, float v, int lane) {
  if (__any_sync(FULL, v != 0.0f)) acc(row, slot, v, lane);
}

// Flush the slab's first `per` slots of each sphere in [w0, w1) into the row.
template <bool G>
__device__ __forceinline__ void flush(const Pix<G>& px, float* row, int lane, int w0, int w1,
                                      int per) {
  for (int j = w0; j < w1; ++j) {
    for (int c = 0; c < per; ++c) acc_live(row, 7 * j + c, px.S(7 * (j - w0) + c), lane);
  }
}

template <bool G>
__device__ __forceinline__ void zero_slab(const Pix<G>& px, int w0, int w1) {
  for (int k = 0; k < 7 * (w1 - w0); ++k) px.S(k) = 0.0f;
}

// G: the global form; R (with G): the third form, the warps' rows in scratch
// (gridDim.x x nwarps x n_grads floats) instead of shared memory, and a grid
// of the card's size walking the pixel groups.
template <bool G, bool R = false>
__global__ void __launch_bounds__(MAX_NT)
soft_bwd_kernel(const float* __restrict__ params, const float* __restrict__ sph, int ns,
                const float* __restrict__ pln, int npl, const float* __restrict__ lts,
                int nl, float tau, const float* __restrict__ img,
                float* __restrict__ partial, int W, int H, int Wg, int fused, int cap,
                int cj, int store_vis, float* __restrict__ scratch) {
  static_assert(!R || G, "device-memory rows: the global form's only");
  const int nt = blockDim.x, nwarps = nt / 32, by = nt / BX;
  const Slots sl(ns, npl, nl, fused != 0);
  const int nf = N_TFIXED + (store_vis ? nl : 0);
  extern __shared__ float smem[];
  // G (the global form): no sphere table and no per-sphere values staged
  const int staged_ns = G ? 0 : ns;
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + 7 * staged_ns;
  float* s_lts = s_pln + 9 * npl;
  float* s_rcp = s_lts + 3 * nl;               // 1 / (tau r), 1 / r, dead2
  float* s_acc = s_rcp + 3 * staged_ns;        // nwarps rows of sl.n slots (not R)
  float* s_tab = s_acc + (R ? 0 : nwarps * sl.n);   // nf x cap x nt
  float* acc_rows = R ? scratch + static_cast<size_t>(blockIdx.x) * nwarps * sl.n : s_acc;
  float* s_slab = s_tab + nf * cap * nt;       // 7 cj x nt
  const int tid = threadIdx.x;
  for (int i = tid; i < N_PARAMS; i += nt) s_p[i] = params[i];
  for (int i = tid; i < 7 * staged_ns; i += nt) s_sph[i] = sph[i];
  for (int i = tid; i < 9 * npl; i += nt) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += nt) s_lts[i] = lts[i];
  for (int i = tid; i < staged_ns; i += nt) {
    const float r = sph[3 * ns + i];
    s_rcp[i] = inv_tau_r(r, tau);
    s_rcp[ns + i] = 1.0f / r;
    s_rcp[2 * ns + i] = dead_r2(r, tau);
  }
  for (int i = tid; i < nwarps * sl.n; i += nt) acc_rows[i] = 0.0f;
  __syncthreads();
  const Scene<G> sc{{s_p, G ? sph : s_sph, ns, s_pln, npl, s_lts, nl, G}, s_rcp, tau};
  const int lane = tid & 31;
  float* row = acc_rows + (tid >> 5) * sl.n;

  const int nby = (H + BX - 1) / BX;
  // One pixel group (BX x by pixels) into the warps' rows.
  const auto group = [&](int grp) {
    const int x = grp / nby * by + tid / BX;
    const int y = grp % nby * BX + tid % BX;
    const bool inb = x < W && y < H;
    const size_t pix = inb ? (static_cast<size_t>(x) * H + y) * 3 : 0;
    const RayGen rg = raygen_full(s_p, static_cast<float>(x) + s_p[P_X0],
                                  static_cast<float>(y));
    Pix<G> px{sc, rg.ray, tau, s_tab + tid, s_slab + tid, nt, cap, store_vis != 0,
           0.0f, 0.0f, 0.0f, {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, 0.0f};
    const int K = ns + npl;

    // Cotangent of the pixel's color: the image in, or in FUSED the MSE's.
    float loss = 0.0f;
    int n_first = 0;
    bool table_valid = false;
    if (fused) {
      if (inb) {
        float cr = 0.0f, cg = 0.0f, cb = 0.0f;
        int k = 0;
        n_first = px.build(&k);
        table_valid = k == K;      // one chunk holds every live object
        for (bool first = true;; first = false) {
          const int n = first ? n_first : px.build(&k);
          const Rgb c = px.fill(n, first && table_valid);
          cr += c.r; cg += c.g; cb += c.b;
          if (k == K) break;
        }
        // the frame's denominator (a slice's launch: Wg the frame's width)
        const float inv_denom = static_cast<float>(1.0 / (3.0 * Wg * static_cast<double>(H)));
        const float two_inv = static_cast<float>(2.0 / (3.0 * Wg * static_cast<double>(H)));
        const float d0 = cr - img[pix], d1 = cg - img[pix + 1], d2 = cb - img[pix + 2];
        loss = (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
        px.g0 = two_inv * d0; px.g1 = two_inv * d1; px.g2 = two_inv * d2;
      }
    } else if (inb) {
      px.g0 = img[pix]; px.g1 = img[pix + 1]; px.g2 = img[pix + 2];
    }

    // Reverse sweep, a chunk of live objects at a time (one chunk where the
    // table holds them all). Every adjoint is linear in the color cotangent, so a
    // pixel whose cotangent is 0 has none.
    bool more = px.g0 != 0.0f || px.g1 != 0.0f || px.g2 != 0.0f;
    int kb = 0;
    const int nwin = ns > 0 ? (ns + cj - 1) / cj : 1;
    while (__any_sync(FULL, more)) {
      int n = 0;
      bool complete = false;
      if (more) {
        if (table_valid) {
          n = n_first;
          kb = K;
          complete = true;
        } else {
          const bool first = kb == 0;
          n = px.build(&kb);
          complete = first && kb == K;
          px.fill(n, complete);
        }
        more = kb < K;
        px.prepare(n);
      }
      // Shadows and lights, a window of spheres at a time.
      for (int win = 0; win < nwin; ++win) {
        const int w0 = win * cj, w1 = min(w0 + cj, ns);
        zero_slab(px, w0, w1);
        for (int l = 0; l < nl; ++l) {
          float Lw[3] = {0.0f, 0.0f, 0.0f};
          px.shadow_stage(n, l, w0, w1, Lw);
#pragma unroll
          for (int c = 0; c < 3; ++c) acc_live(row, sl.lts + 3 * l + c, Lw[c], lane);
        }
        if (nwin > 1) flush(px, row, lane, w0, w1, 4);
      }
      // Spheres: Lambert and normal chains, albedos, primary covers.
      for (int win = 0; win < nwin && ns > 0; ++win) {
        const int w0 = win * cj, w1 = min(w0 + cj, ns);
        if (nwin > 1) zero_slab(px, w0, w1);
        if (complete) {
          for (int e = 0; e < n; ++e) {
            const int j = px.gi(e);
            if (j >= w0 && j < w1) px.sphere_primary(n, j, w0, e);
          }
        } else if (n > 0) {
          int e = 0;
          while (e < n && px.gi(e) < w0) ++e;
          for (int j = w0; j < w1; ++j) {
            const int own = e < n && px.gi(e) == j ? e++ : -1;
            px.sphere_primary(n, j, w0, own);
          }
        }
        flush(px, row, lane, w0, w1, 7);
      }
      // Planes.
      int e = 0;
      while (e < n && px.gi(e) < ns) ++e;
      for (int k = 0; k < npl; ++k) {
        float v[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (e < n && px.gi(e) == ns + k) {
          if (px.T(T_W, e) != 0.0f) px.plane_adj(e, v);
          ++e;
        }
#pragma unroll
        for (int c = 0; c < 9; ++c) acc_live(row, sl.pln + 9 * k + c, v[c], lane);
      }
    }

    acc_live(row, sl.mat + 0, px.amb_acc, lane);
    acc_live(row, sl.mat + 1, px.lamb_acc, lane);
    // Camera: position takes the origin's cotangent; d = normalize(R p),
    // p = (focal, pcy, pcz); focal = cot(fov/2) with fov in degrees.
    const RayBar& rb = px.rb;
    const float focal = s_p[P_FOCAL];
    float ub[3] = {rb.dx, rb.dy, rb.dz};
    norm_adj(rg.ray.dx, rg.ray.dy, rg.ray.dz, rg.dn, ub[0], ub[1], ub[2]);
    const float ob[3] = {rb.ox, rb.oy, rb.oz};
    const float pvec[3] = {focal, rg.pcy, rg.pcz};
#pragma unroll
    for (int c = 0; c < 3; ++c) acc(row, sl.cam + c, ob[c], lane);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc(row, sl.cam + 3 + 3 * r + c, ub[r] * pvec[c], lane);
    const float focal_bar = s_p[P_ROT + 0] * ub[0] + s_p[P_ROT + 3] * ub[1] +
                            s_p[P_ROT + 6] * ub[2];
    const float dfdf = -(1.0f + focal * focal) * static_cast<float>(3.14159265358979 / 360.0);
    acc(row, sl.cam + 12, focal_bar * dfdf, lane);
    if (fused) acc(row, sl.loss, loss, lane);
  };
  if (R) {
    // a grid of the card's size: block b walks groups b, b + gridDim.x, ...
    const int n_groups = nby * ((W + by - 1) / by);
    for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) group(grp);
  } else {
    group(static_cast<int>(blockIdx.x));
  }

  __syncthreads();
  write_block_partial(acc_rows, nwarps, sl.n, partial, tid, nt);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one soft backward block under a plan; the
// wrapper's planner (soft_bwd_cuda.smem_bytes) computes the same. staged 0:
// the global form, without the 10 words a sphere; rows 0 (the third form):
// without the warps' rows too.
long long rt_soft_bwd_smem(int ns, int npl, int nl, int n_grads, int nt, int cap, int cj,
                           int store_vis, int staged, int rows) {
  const long long nf = N_TFIXED + (store_vis ? nl : 0);
  return 4LL * (N_PARAMS + (staged ? 10LL * ns : 0LL) + 9LL * npl + 3LL * nl +
                (rows ? (nt / 32) * 1LL * n_grads : 0LL) +
                static_cast<long long>(nt) * (nf * cap + 7LL * cj));
}

// Launch the soft backward kernel on `stream`: per-block partial sums into
// partial (n_grads x n_rows, n_rows = ceil(H/16) * ceil(W/(nt/16)), the pixel
// groups; with scratch, any 1 <= n_rows <= the groups); rt_reduce_rows
// then sums them. img: the (W, H, 3) cotangent, or with fused the target.
// n_grads = 7 ns + 9 npl + 3 nl + 18, + 1 with fused. The plan: nt threads a
// block (32, 64 or 128), cap live objects a chunk (>= 1), cj spheres a window
// (>= 1), store_vis (a transmission a light in the table), staged (the sphere
// table and its per-sphere values in shared memory; 0: the global form).
// scratch (the third form, with staged 0): n_rows x nt / 32 x n_grads floats
// of device memory that the launch zeroes and fills with the warps' rows; null
// keeps the rows in shared memory. Objects are indexed in GI_BITS bits. W x H:
// the slice [params[P_X0],
// params[P_X0] + W) of a frame Wg columns wide (Wg == W for a whole frame),
// img the slice's; FUSED's loss has the frame's denominator 3 Wg H. Returns
// cudaGetLastError() after the launch.
int rt_soft_bwd(const float* params, const float* sph, int ns, const float* pln, int npl,
                const float* lts, int nl, float tau, const float* img, float* partial,
                int n_rows, int n_grads, int W, int H, int Wg, int fused, int nt, int cap,
                int cj, int store_vis, int staged, float* scratch, void* stream) {
  const long long n_groups = (nt == 32 || nt == 64 || nt == 128) && H > 0 && W > 0
      ? static_cast<long long>((H + BX - 1) / BX) * ((W + nt / BX - 1) / (nt / BX)) : 0;
  if (W <= 0 || H <= 0 || Wg < W || ns < 0 || npl < 0 || nl < 0 || !(tau > 0.0f) ||
      img == nullptr || !(nt == 32 || nt == 64 || nt == 128) || cap < 1 || cj < 1 ||
      ns + npl >= (1 << GI_BITS) ||
      n_grads != 7 * ns + 9 * npl + 3 * nl + 18 + (fused ? 1 : 0) ||
      (scratch == nullptr && n_rows != n_groups) || n_rows < 1 || n_rows > n_groups ||
      (scratch != nullptr && staged)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = rt_soft_bwd_smem(ns, npl, nl, n_grads, nt, cap, cj, store_vis,
                                          staged, scratch == nullptr);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = staged ? soft_bwd_kernel<false>
                             : (scratch ? soft_bwd_kernel<true, true> : soft_bwd_kernel<true>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_rows, nt, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      params, sph, ns, pln, npl, lts, nl, tau, img, partial, W, H, Wg, fused, cap, cj,
      store_vis, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local memory a thread (stack frame and spills) of
// the soft backward kernel, as the loaded module reports them.
int rt_soft_bwd_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, soft_bwd_kernel<false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // extern "C"
