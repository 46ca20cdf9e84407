// Shared device math for the port's render kernels: ray generation, closest
// hit, shadow occlusion, shading and the mirror-bounce chain.
//
// Each function mirrors a helper of the TPU forward kernel
// (python_ray_tracer_tpu/ops/pallas/render_pallas.py) term for term, so the
// two agree up to float rounding:
//   raygen            <- _raygen            (:1294)
//   closest_hit       <- _closest_hit       (:403), plus the winner's index
//   hit_of            <- the hit-attribute fold of render_bwd._fwd_trace_res
//   sphere_occ_cheap  <- _sphere_occ_cheap  (:501)
//   occluded          <- _any_hit_multi     (:571), one light at a time
//   surface           <- _primary_geometry  (:952), for a given hit
//   primary_geometry  <- _primary_geometry  (:952)
//   reflect_dir       <- _reflect_dir       (:979)
//   trace             <- _trace             (:1195)
//   sample_chain      <- _sample_chain      (:1310)
// The backward kernel (render_bwd.cu) includes this header and recomputes its
// forward chain through these same functions, so its hit, shadow and bounce
// decisions are the render kernel's own. The soft kernels include it through
// soft_common.cuh. The adjoint helpers at the end (norm_adj, the warp
// reductions and the per-block partial column) are shared by both backward
// kernels.
//
// Semantics kept from the reference (compat mode): hits count only for
// 0 < t < 999 (t starts at FAR and the winner test is a strict `<`, so the far
// clip costs nothing); spheres are scanned before planes, lower index first;
// the plane parallel threshold is 1e-3 (1e-8 in clean mode); shadow rays have
// no maximum distance; shadow and mirror origins are biased by 2e-4.
//
// Normalisations use 1/sqrtf (IEEE sqrt and division without fast math), not
// the approximate rsqrtf, so rays match the CPU references to the last bits
// as far as FMA contraction allows.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr float FAR = 999.0f;   // reference init distance, trace.py:17
constexpr float BIG = 1e30f;    // "no hit" distance in clean mode
constexpr float BIAS = 2e-4f;   // shadow/mirror acne offset, trace.py:82

// Parameter vector layout (render_cuda.py P_*; render_pallas.py _P_*). P_X0,
// the x offset of a ray-parallel slice, is packed as 0: the port renders whole
// frames. The soft kernels add it to the pixel's x (as the TPU soft backward
// does), so a sharded caller needs no kernel change.
enum : int {
  P_ORIGIN = 0, P_ROT = 3, P_FOCAL = 12, P_Y0 = 13, P_DY = 14, P_Z0 = 15,
  P_DZ = 16, P_AMB = 17, P_LAMB = 18, P_REFL = 19, P_SPEC = 20, P_SHIN = 21,
  P_X0 = 22, P_OFFS = 23, N_PARAMS = 41
};

// The scene as the kernels read it: the parameter vector and the SoA tables
// sph (7 x ns: center xyz, radius, albedo rgb), pln (9 x npl: origin xyz,
// unit normal xyz, albedo rgb) and lts (3 x nl), row-major.
struct SceneView {
  const float* p;
  const float* sph;
  int ns;
  const float* pln;
  int npl;
  const float* lts;
  int nl;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Rgb {
  float r, g, b;
};

// Shading result of one trace: color, biased next origin, unit mirror
// direction, and whether the ray hit anything.
struct TraceOut {
  float r, g, b;
  Ray next;
  bool alive;
};

__device__ __forceinline__ float rnorm(float x, float y, float z) {
  return 1.0f / sqrtf(x * x + y * y + z * z);
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
  const float pcy = P[P_Y0] + px * P[P_DY];
  const float pcz = P[P_Z0] + py * P[P_DZ];
  const float dx = P[P_ROT + 0] * pcx + P[P_ROT + 1] * pcy + P[P_ROT + 2] * pcz;
  const float dy = P[P_ROT + 3] * pcx + P[P_ROT + 4] * pcy + P[P_ROT + 5] * pcz;
  const float dz = P[P_ROT + 6] * pcx + P[P_ROT + 7] * pcy + P[P_ROT + 8] * pcz;
  const float dn = rnorm(dx, dy, dz);
  return {{P[P_ORIGIN + 0], P[P_ORIGIN + 1], P[P_ORIGIN + 2],
           dx * dn, dy * dn, dz * dn}, pcy, pcz, dn};
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

// The Hit record of object `obj` at distance t (obj < 0: no hit).
template <bool COMPAT>
__device__ __forceinline__ Hit hit_of(const SceneView& s, float t, int obj) {
  if (obj < 0) return {COMPAT ? FAR : BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, -1};
  if (obj < s.ns) {
    const int ns = s.ns;
    return {t, s.sph[4 * ns + obj], s.sph[5 * ns + obj], s.sph[6 * ns + obj],
            s.sph[obj], s.sph[ns + obj], s.sph[2 * ns + obj], false, obj};
  }
  const int j = obj - s.ns, np = s.npl;
  return {t, s.pln[6 * np + j], s.pln[7 * np + j], s.pln[8 * np + j],
          s.pln[3 * np + j], s.pln[4 * np + j], s.pln[5 * np + j], true, obj};
}

// Closest hit over spheres, then planes, with the strict `<` winner test.
template <bool COMPAT>
__device__ __forceinline__ Hit closest_hit(const SceneView& s, const Ray& ray) {
  Hit h{COMPAT ? FAR : BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, false, -1};
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv2a = 1.0f / (2.0f * a);
  // Sweep-invariant terms: b_j = 2(o.d - c_j.d), c_j = o.o - 2 o.c_j + |c_j|^2 - r_j^2.
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  const int ns = s.ns;
  for (int j = 0; j < ns; ++j) {
    const float cx = s.sph[j], cy = s.sph[ns + j], cz = s.sph[2 * ns + j];
    const float r = s.sph[3 * ns + j];
    const float cd = cx * dx + cy * dy + cz * dz;
    const float oc = cx * ox + cy * oy + cz * oz;
    const float b = 2.0f * (od - cd);
    const float c = oo - 2.0f * oc + (cx * cx + cy * cy + cz * cz - r * r);
    const float disc = b * b - 4.0f * a * c;
    const bool has = disc >= 0.0f;
    const float sq = sqrtf(has ? disc : 0.0f);
    const float num_near = -b - sq;
    const float num_far = -b + sq;
    // nearest positive root; the far root is >= the near root always
    const float tj = (num_near > 0.0f ? num_near : num_far) * inv2a;
    if (has && num_far > 0.0f && tj < h.t) {
      h = {tj, s.sph[4 * ns + j], s.sph[5 * ns + j], s.sph[6 * ns + j],
           cx, cy, cz, false, j};
    }
  }
  const float eps = COMPAT ? 1e-3f : 1e-8f;
  const int np = s.npl;
  for (int j = 0; j < np; ++j) {
    const float nx = s.pln[3 * np + j], ny = s.pln[4 * np + j], nz = s.pln[5 * np + j];
    const float den = dx * nx + dy * ny + dz * nz;
    const float den_safe = fabsf(den) > 1e-30f ? den : 1.0f;
    const float num = (s.pln[j] - ox) * nx + (s.pln[np + j] - oy) * ny +
                      (s.pln[2 * np + j] - oz) * nz;
    const float tj = num / den_safe;
    if (fabsf(den) >= eps && tj > 0.0f && tj < h.t) {
      h = {tj, s.pln[6 * np + j], s.pln[7 * np + j], s.pln[8 * np + j],
           nx, ny, nz, true, ns + j};
    }
  }
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
  float tc = g * inv_a;
  tc = COMPAT ? fminf(fmaxf(tc, 0.0f), FAR) : fmaxf(tc, 0.0f);
  return cterm <= tc * (2.0f * g - a * tc);
}

// Is the shadow ray from o along unit d blocked by any object at any
// 0 < t (< FAR in compat)? Planes first, then spheres; the first occluder
// ends the sweep (occlusion is an OR, so the order changes nothing).
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ bool occluded(const SceneView& s, float ox, float oy,
                                         float oz, float dx, float dy, float dz) {
  const float eps = COMPAT ? 1e-3f : 1e-8f;
  const int np = s.npl;
  for (int j = 0; j < np; ++j) {
    const float nx = s.pln[3 * np + j], ny = s.pln[4 * np + j], nz = s.pln[5 * np + j];
    const float pnum = (s.pln[j] - ox) * nx + (s.pln[np + j] - oy) * ny +
                       (s.pln[2 * np + j] - oz) * nz;
    const float den = dx * nx + dy * ny + dz * nz;
    const float den_safe = fabsf(den) > 1e-30f ? den : 1.0f;
    const float tj = pnum / den_safe;
    if (fabsf(den) >= eps && tj > 0.0f && (!COMPAT || tj < FAR)) return true;
  }
  const float oo = ox * ox + oy * oy + oz * oz;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv2a = 1.0f / (2.0f * a);
  const float inv_a = inv2a + inv2a;
  const float od = ox * dx + oy * dy + oz * dz;
  const int ns = s.ns;
  for (int j = 0; j < ns; ++j) {
    const float cx = s.sph[j], cy = s.sph[ns + j], cz = s.sph[2 * ns + j];
    const float r = s.sph[3 * ns + j];
    const float oc = cx * ox + cy * oy + cz * oz;
    const float cterm = oo - 2.0f * oc + (cx * cx + cy * cy + cz * cz - r * r);
    const float cd = cx * dx + cy * dy + cz * dz;
    bool valid;
    if (CHEAP) {
      valid = sphere_occ_cheap<COMPAT>(cterm, cd - od, a, inv_a);
    } else {
      const float b = 2.0f * (od - cd);
      const float disc = b * b - 4.0f * a * cterm;
      const bool has = disc >= 0.0f;
      const float sq = sqrtf(has ? disc : 0.0f);
      const float num_near = -b - sq;
      const float num_far = -b + sq;
      const float tj = (num_near > 0.0f ? num_near : num_far) * inv2a;
      valid = has && num_far > 0.0f && (!COMPAT || tj < FAR);
    }
    if (valid) return true;
  }
  return false;
}

// Unit mirror direction d - 2(d.n)n (reference common.py:114-120). Returns
// the reciprocal norm of d - 2(d.n)n, which the backward kernel's adjoint of
// the normalisation needs.
__device__ __forceinline__ float reflect_dir(float dx, float dy, float dz,
                                             float nx, float ny, float nz,
                                             float& rx, float& ry, float& rz) {
  const float ddn = dx * nx + dy * ny + dz * nz;
  rx = dx - 2.0f * ddn * nx;
  ry = dy - 2.0f * ddn * ny;
  rz = dz - 2.0f * ddn * nz;
  const float rn = rnorm(rx, ry, rz);
  rx *= rn;
  ry *= rn;
  rz *= rn;
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
  float px = ray.ox + ts * ray.dx, py = ray.oy + ts * ray.dy, pz = ray.oz + ts * ray.dz;
  if (h.plane) {
    f.nx = h.qx; f.ny = h.qy; f.nz = h.qz;
    f.srn = 1.0f;
  } else {
    const float sx = px - h.qx, sy = py - h.qy, sz = pz - h.qz;
    const float sn = rnorm(sx, sy, sz);
    f.nx = sx * sn; f.ny = sy * sn; f.nz = sz * sn;
    f.srn = sn;
  }
  f.ux = px; f.uy = py; f.uz = pz;
  f.px = px + BIAS * f.nx;
  f.py = py + BIAS * f.ny;
  f.pz = pz + BIAS * f.nz;
  f.ar = h.ar; f.ag = h.ag; f.ab = h.ab;
  return f;
}

// Closest hit -> normal-biased hit point, unit normal and albedo.
template <bool COMPAT>
__device__ __forceinline__ Surface primary_geometry(const SceneView& s,
                                                    const Ray& ray) {
  return surface<COMPAT>(ray, closest_hit<COMPAT>(s, ray));
}

// One shading evaluation (reference trace, trace.py:45-112): ambient +
// Lambert over unoccluded lights (+ Phong in clean mode), and the next
// mirror ray. A miss returns black with alive = false and no next ray.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ TraceOut trace(const SceneView& s, const Ray& ray) {
  TraceOut o;
  const Surface f = primary_geometry<COMPAT>(s, ray);
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
    float lx = s.lts[l] - f.px, ly = s.lts[nl + l] - f.py, lz = s.lts[2 * nl + l] - f.pz;
    const float ln = rnorm(lx, ly, lz);
    lx *= ln; ly *= ln; lz *= ln;
    const bool occ = occluded<COMPAT, CHEAP>(s, f.px, f.py, f.pz, lx, ly, lz);
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
  o.next = {f.px + BIAS * rx, f.py + BIAS * ry, f.pz + BIAS * rz, rx, ry, rz};
  return o;
}

// Primary trace + up to `depth` mirror bounces; bounce i adds
// reflection^(i+1) * rgb_i. A ray that misses stops: its weight is 0 from
// then on, so stopping is exact.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ Rgb sample_chain(const SceneView& s, float px,
                                            float py, int depth) {
  TraceOut t = trace<COMPAT, CHEAP>(s, raygen(s.p, px, py));
  float r = t.r, g = t.g, b = t.b;
  const float refl = s.p[P_REFL];
  float w = 1.0f;
  for (int bounce = 0; bounce < depth && t.alive; ++bounce) {
    w = w * refl;
    t = trace<COMPAT, CHEAP>(s, t.next);
    r = r + w * t.r;
    g = g + w * t.g;
    b = b + w * t.b;
  }
  return {r, g, b};
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

}  // namespace rt
