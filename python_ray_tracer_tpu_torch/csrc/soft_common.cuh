// Shared device math of the soft-visibility kernels (soft_fwd.cu, soft_bwd.cu):
// the soft sphere cover, the opaque plane cover, the light geometry and the
// compositing tie-break. Each kernel's own helpers (the forward's live-object
// table, the backward's adjoints) live in its source file.
//
// Each function mirrors the plain version (ops/soft.py) and the TPU kernels
// term for term, except one: the squared closest-approach distance b^2 is
// |v|^2 with v = L - t_ca d, not |L|^2 - t_ca^2. The two are equal for a unit
// d, but the second cancels for a sphere far along the ray and is off by
// t_ca^2 (|d|^2 - 1) for a float32-normalised d; at tau 0.02 a steep sigmoid
// turns that into ~1e-3 of color (the plain float32 version is that far off
// its float64 run at 1000x1000). |v|^2 has neither error.
//   soft_cover      <- soft_pallas._soft_cover (:55-69), soft_bwd.cover (:156-177)
//   plane_cover     <- soft_bwd.plane_cover (:213-222)
//   light_dir       <- soft_bwd.light_geom (:236-245)
//   closer          <- the stable argsort order (soft.py:173; soft_pallas.py:182-184)
//
// Normalisation guard: every normalisation (surface normal, light direction)
// takes 1/sqrtf(n2 > 0 ? n2 : 1), the guard of ops/soft.py's _norm, in the
// forward and the backward kernel alike (the TPU backward uses rsqrt with a
// `<= 1e-20` guard; the two agree wherever n2 > 1e-20). The sigmoid is
// 1/(1 + expf(-x)) in full-precision expf (no fast math): exp overflows to inf
// far outside a silhouette, which gives alpha = 0 exactly, never a NaN.
#pragma once

// The soft kernels read no large-scene table: the compiler's own contraction
// (rt_common.cuh).
#define RT_PIN 0
#include "rt_common.cuh"

namespace rt {

// One sphere's soft cover of a ray, with what its adjoint needs.
struct Cover {
  float Lx, Ly, Lz;   // center - ray origin
  float t_ca;         // closest-approach distance along the ray
  float d2;           // b^2 = |v|^2, v = L - t_ca d the closest-approach vector
  float b;            // sqrt(d2 > 1e-12 ? d2 : 1e-12)
  float a;            // coverage alpha (0 behind the ray origin)
  float hc;           // half chord sqrt(chord2 > 1e-12 ? chord2 : 1)
  float t_raw, t;     // blend depth before and after max(., 1e-4)
  bool inside;        // chord2 > 1e-12: the ray passes inside the sphere
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// alpha = sigmoid(-(b - r) / (tau r)), 0 where t_ca <= 0; with NEED_T also the
// blend depth t = max(inside ? t_ca - half chord : t_ca, 1e-4).
template <bool NEED_T>
__device__ __forceinline__ Cover soft_cover(float ox, float oy, float oz, float dx,
                                            float dy, float dz, float cx, float cy,
                                            float cz, float r, float tau) {
  Cover c;
  c.Lx = cx - ox;
  c.Ly = cy - oy;
  c.Lz = cz - oz;
  c.t_ca = c.Lx * dx + c.Ly * dy + c.Lz * dz;
  const float vx = c.Lx - c.t_ca * dx, vy = c.Ly - c.t_ca * dy, vz = c.Lz - c.t_ca * dz;
  c.d2 = vx * vx + vy * vy + vz * vz;
  c.b = sqrtf(c.d2 > 1e-12f ? c.d2 : 1e-12f);
  const float a = sigmoid(-(c.b - r) / (tau * r));
  c.a = c.t_ca > 0.0f ? a : 0.0f;
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
  return c;
}

// Opaque plane k: alpha 1 where the ray hits it (|n.d| > 1e-8 and t > 0),
// else 0; t = max(n.(p0 - o) / n.d, 1e-4).
struct PlaneCover {
  float a, t, t_pre, den_safe;
  bool den_ok;
};

__device__ __forceinline__ PlaneCover plane_cover(const SceneView& s, int k, float ox,
                                                  float oy, float oz, float dx, float dy,
                                                  float dz) {
  const int np = s.npl;
  const float nx = s.pln[3 * np + k], ny = s.pln[4 * np + k], nz = s.pln[5 * np + k];
  PlaneCover p;
  const float den = dx * nx + dy * ny + dz * nz;
  p.den_ok = fabsf(den) > 1e-8f;
  p.den_safe = p.den_ok ? den : 1.0f;
  const float num = (s.pln[k] - ox) * nx + (s.pln[np + k] - oy) * ny +
                    (s.pln[2 * np + k] - oz) * nz;
  p.t_pre = num / p.den_safe;
  p.a = (p.den_ok && p.t_pre > 0.0f) ? 1.0f : 0.0f;
  p.t = fmaxf(p.t_pre, 1e-4f);
  return p;
}

// Does occluder j (global index gj: spheres 0..ns-1, then planes ns+k) come
// before object i in the stable depth order? Ties go to the lower index;
// j == i is never closer.
__device__ __forceinline__ bool closer(float tj, int gj, float ti, int gi) {
  return tj < ti || (tj == ti && gj < gi);
}

// Unit direction from P to light l and its reciprocal norm.
struct LightDir {
  float x, y, z, rn;
};

__device__ __forceinline__ LightDir light_dir(const SceneView& s, int l, float px,
                                              float py, float pz) {
  const int nl = s.nl;
  const float wx = s.lts[l] - px, wy = s.lts[nl + l] - py, wz = s.lts[2 * nl + l] - pz;
  const float ww = wx * wx + wy * wy + wz * wz;
  const float rn = 1.0f / sqrtf(ww > 0.0f ? ww : 1.0f);
  return {wx * rn, wy * rn, wz * rn, rn};
}

}  // namespace rt
