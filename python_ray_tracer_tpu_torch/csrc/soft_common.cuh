// Shared device math of the soft-visibility kernels (soft_fwd.cu, soft_bwd.cu):
// the soft sphere cover, the opaque plane cover, the light geometry, the
// compositing tie-break and weight, shadow transmission, and the forward
// kernel's per-object evaluation. The backward's own helpers (the cover's
// adjoint among them) live in soft_bwd.cu.
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

// Sphere j's cover of `ray` (the scene in SoA order, as SceneView holds it).
template <bool NEED_T>
__device__ __forceinline__ Cover sphere_cover(const SceneView& s, int j, float ox,
                                              float oy, float oz, float dx, float dy,
                                              float dz, float tau) {
  const int ns = s.ns;
  return soft_cover<NEED_T>(ox, oy, oz, dx, dy, dz, s.sph[j], s.sph[ns + j],
                            s.sph[2 * ns + j], s.sph[3 * ns + j], tau);
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

// Shadow transmission prod_j (1 - alpha_j) over every sphere, spheres
// ascending, along the ray from P in unit direction L.
__device__ __forceinline__ float transmission(const SceneView& s, float px, float py,
                                              float pz, const LightDir& L, float tau) {
  float vis = 1.0f;
  for (int j = 0; j < s.ns; ++j) {
    vis *= 1.0f - sphere_cover<false>(s, j, px, py, pz, L.x, L.y, L.z, tau).a;
  }
  return vis;
}

// Compositing weight w_i = a_i prod_{j != i} (1 - a_j [j closer]), the
// order-free form of the sorted cumprod: spheres ascending, then planes.
__device__ __forceinline__ float soft_weight(const SceneView& s, const Ray& ray,
                                             float tau, int gi, float ai, float ti) {
  float w = ai;
  for (int j = 0; j < s.ns; ++j) {
    const Cover c = sphere_cover<true>(s, j, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                       ray.dz, tau);
    if (closer(c.t, j, ti, gi)) w *= 1.0f - c.a;
  }
  for (int k = 0; k < s.npl; ++k) {
    const PlaneCover p = plane_cover(s, k, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz);
    if (closer(p.t, s.ns + k, ti, gi)) w *= 1.0f - p.a;
  }
  return w;
}

// A composited object at this pixel: its surface point and unit normal, the
// normal's reciprocal norm (spheres; 1 on planes), albedo, compositing weight,
// and lam_sum = sum_l relu(lamb L.N) vis_l (color (amb + lam_sum) * albedo).
struct SoftObj {
  float a, t;
  float px, py, pz, nx, ny, nz, nn;
  float ar, ag, ab;
  float w, lam_sum;
};

// Object gi's surface and weight at blend depth t (after its cover).
__device__ __forceinline__ SoftObj soft_surface(const SceneView& s, const Ray& ray,
                                                float tau, int gi, float a, float t) {
  SoftObj o;
  o.a = a;
  o.t = t;
  o.px = ray.ox + t * ray.dx;
  o.py = ray.oy + t * ray.dy;
  o.pz = ray.oz + t * ray.dz;
  const int ns = s.ns;
  if (gi < ns) {
    const float vx = o.px - s.sph[gi], vy = o.py - s.sph[ns + gi],
                vz = o.pz - s.sph[2 * ns + gi];
    const float vv = vx * vx + vy * vy + vz * vz;
    o.nn = 1.0f / sqrtf(vv > 0.0f ? vv : 1.0f);
    o.nx = vx * o.nn; o.ny = vy * o.nn; o.nz = vz * o.nn;
    o.ar = s.sph[4 * ns + gi]; o.ag = s.sph[5 * ns + gi]; o.ab = s.sph[6 * ns + gi];
  } else {
    const int k = gi - ns, np = s.npl;
    o.nn = 1.0f;
    o.nx = s.pln[3 * np + k]; o.ny = s.pln[4 * np + k]; o.nz = s.pln[5 * np + k];
    o.ar = s.pln[6 * np + k]; o.ag = s.pln[7 * np + k]; o.ab = s.pln[8 * np + k];
  }
  o.w = soft_weight(s, ray, tau, gi, a, t);
  o.lam_sum = 0.0f;
  return o;
}

// Fill o.lam_sum = sum_l relu(lamb L.N) vis_l.
__device__ __forceinline__ void soft_shade(const SceneView& s, float tau, SoftObj& o) {
  const float lamb = s.p[P_LAMB];
  float lam_sum = 0.0f;
  for (int l = 0; l < s.nl; ++l) {
    const LightDir L = light_dir(s, l, o.px, o.py, o.pz);
    const float lam = lamb * (L.x * o.nx + L.y * o.ny + L.z * o.nz);
    const float vis = transmission(s, o.px, o.py, o.pz, L, tau);
    lam_sum += (lam > 0.0f ? lam : 0.0f) * vis;
  }
  o.lam_sum = lam_sum;
}

// Object gi's full forward evaluation: cover, surface, weight and lam_sum.
__device__ __forceinline__ SoftObj soft_object(const SceneView& s, const Ray& ray,
                                               float tau, int gi) {
  float a, t;
  if (gi < s.ns) {
    const Cover c = sphere_cover<true>(s, gi, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                       ray.dz, tau);
    a = c.a;
    t = c.t;
  } else {
    const PlaneCover p = plane_cover(s, gi - s.ns, ray.ox, ray.oy, ray.oz, ray.dx,
                                     ray.dy, ray.dz);
    a = p.a;
    t = p.t;
  }
  SoftObj o = soft_surface(s, ray, tau, gi, a, t);
  soft_shade(s, tau, o);
  return o;
}

// The soft-composited color of one primary ray: sum_i w_i (amb + lam_sum_i)
// albedo_i, written amb * albedo + lam_sum * albedo as ops/soft.py does.
__device__ __forceinline__ Rgb soft_pixel(const SceneView& s, const Ray& ray, float tau) {
  const float amb = s.p[P_AMB];
  float r = 0.0f, g = 0.0f, b = 0.0f;
  const int K = s.ns + s.npl;
  for (int gi = 0; gi < K; ++gi) {
    const SoftObj o = soft_object(s, ray, tau, gi);
    r += o.w * (amb * o.ar + o.lam_sum * o.ar);
    g += o.w * (amb * o.ag + o.lam_sum * o.ag);
    b += o.w * (amb * o.ab + o.lam_sum * o.ab);
  }
  return {r, g, b};
}

}  // namespace rt
