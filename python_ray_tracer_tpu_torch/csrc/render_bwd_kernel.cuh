// Backward render kernel for Hopper (sm_90a): scene and camera gradients of
// the render, by hand-derived reverse-mode adjoints of the whole chain (ray
// generation -> closest hit -> normal -> ambient/Lambert/Phong with shadow
// rays -> mirror bounces -> AA), one thread per sample chain.
//
// Replaces the TPU kernel python_ray_tracer_tpu/ops/pallas/render_bwd.py
// _make_bwd_kernel (:736), with its helpers _norm_adj (:70), _fwd_trace_res
// (:144) and _bwd_trace (:464). Modes (C enum below):
//   COT_NOAA    cotangent image in, no AA              (render_bwd.py:1039-1044)
//   COT_AA      cotangent image in, 9 chains a pixel   (:1045-1064)
//   FUSED_NOAA  target in: the kernel renders the pixel, forms the MSE loss
//               partial and its cotangent, then reverse-sweeps  (:958-977)
//   FUSED_AA    target and the aa_shared render in: loss partial and
//               cotangent per pixel, then COT_AA's reverse chains
// Every mode fills the camera slots (position, rotation, fov).
//
// Output: the flat gradient vector of render_bwd.grad_layout,
//   [spheres 7*ns (cx cy cz r ar ag ab), planes 9*npl (ox oy oz nx ny nz ar
//   ag ab), lights 3*nl, amb, lamb, refl, spec, shin, cam_pos 3, rot 9, fov]
// plus a trailing loss slot in the fused modes.
//
// What bounds it on this card: FP32 ALU work, sqrt and division, as in the
// forward kernel, plus the adjoint reductions: every pixel contributes to
// every material, light and camera slot and to its hit object's slots.
//
// What the design does about it:
//   * the forward chain is recomputed per thread through rt_common.cuh's
//     raygen / closest_hit / occluded / surface / reflect_dir, the functions
//     the render kernel uses, in the arithmetic the render kernel uses for the
//     same scene (below); per bounce only (origin, direction, t, hit index, shadow
//     bitmask) is kept, in a per-thread array of MAX_DEPTH + 1 entries, and
//     the reverse sweep rebuilds the rest elementwise;
//   * no per-thread gradient vector (78 slots for the demo scene would
//     spill): each adjoint is warp-reduced with shuffles as it is produced
//     and lane 0 adds it to its warp's row of a shared-memory accumulator.
//     Per-object slots differ between lanes, so they are reduced one hit
//     object at a time (the lowest pending lane's object first). Material and
//     camera adjoints stay in registers until the chain ends;
//   * determinism without float atomics: every shared-memory row has one
//     writer, rows are summed in warp order into a per-block partial column
//     (partial[slot * n_blocks + block]), and a second kernel (reduce_rows)
//     sums each slot's column in a fixed tree order. Two runs give the same
//     bits;
//   * the collective operations need every lane of a warp, so no thread
//     returns early: pad pixels, skipped AA samples and dead rays run the
//     reverse loop with their contributions selected to 0 (selects, not
//     multiplies: an unused lane's values may be inf or NaN). A warp stops
//     sweeping bounces once all its lanes' chains have ended;
//   * the per-pixel cotangent and target are read only for in-bounds pixels.
// Making it fast (the shared-sample AA backward, the one-launch fused AA
// step, fewer reductions) is later work.
//
// Block shape: 16 x 8 threads (4 warps); threadIdx.x walks the image's y axis,
// the contiguous axis of the (w, h, 3) images; gridDim.z is the AA sample.

//
// This header holds the kernel and its launch. Two source files include it
// once each, after choosing rt_common.cuh's arithmetic, as the render kernel's
// two halves do: render_bwd_small.cu (contracted) for scenes the render kernel
// draws without tables, render_bwd.cu (pinned) for large scenes, so that the
// recomputed chain decides each hit as the forward did.
#pragma once

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

using namespace rt;

enum : int { COT_NOAA = 0, COT_AA = 1, FUSED_NOAA = 2, FUSED_AA = 3 };

constexpr int MAX_DEPTH = 8;                 // bounces a chain can keep residuals for
constexpr int BX = 16;                       // threads along y
constexpr int BY = 8;                        // threads along x
constexpr int NT = BX * BY;
constexpr int NWARPS = NT / 32;
constexpr float DEN_EPS = 1e-6f;             // grazing-hit clamp, render_bwd.py:60

// What one trace keeps for the reverse sweep.
struct Res {
  float ox, oy, oz, dx, dy, dz, t;
  int obj;         // hit object, -1 on a miss
  unsigned occ;    // bit l: light l (< 32) occluded
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
// re-tested: the same test on the same ray gives the same answer.
template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ LightTerm light_term(const SceneView& s, int l,
                                                const Surface& f, float Rx,
                                                float Ry, float Rz, unsigned& occ_bits,
                                                bool known) {
  LightTerm q;
  q.lrn = light_dir(s, l, f, q.lx, q.ly, q.lz);
  bool occ;
  if (known && l < 32) {
    occ = ((occ_bits >> l) & 1u) != 0u;
  } else {
    occ = occluded<COMPAT, CHEAP>(s, f.px, f.py, f.pz, q.lx, q.ly, q.lz);
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

template <bool COMPAT, bool CHEAP>
__device__ __forceinline__ Shade shade_of(const SceneView& s, const Surface& f, float Rx,
                                          float Ry, float Rz, unsigned& occ_bits,
                                          bool known) {
  Shade o{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int l = 0; l < s.nl; ++l) {
    const LightTerm q = light_term<COMPAT, CHEAP>(s, l, f, Rx, Ry, Rz, occ_bits, known);
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
// may be a miss) and the weighted color sum.
template <bool COMPAT, bool CHEAP>
__device__ int fwd_chain(const SceneView& s, Ray ray, int depth, Res* res, float& cr,
                         float& cg, float& cb) {
  const float refl = s.p[P_REFL];
  float w = 1.0f;
  cr = cg = cb = 0.0f;
  int k = 0;
  for (int bounce = 0; bounce <= depth; ++bounce) {
    const Hit h = closest_hit<COMPAT>(s, ray);
    res[k] = {ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, h.t, h.obj, 0u};
    ++k;
    const Surface f = surface<COMPAT>(ray, h);
    if (!f.alive) break;
    float Rx, Ry, Rz;
    reflect_dir(ray.dx, ray.dy, ray.dz, f.nx, f.ny, f.nz, Rx, Ry, Rz);
    unsigned occ = 0u;
    const Shade sh = shade_of<COMPAT, CHEAP>(s, f, Rx, Ry, Rz, occ, false);
    res[k - 1].occ = occ;
    cr = cr + w * sh.r;
    cg = cg + w * sh.g;
    cb = cb + w * sh.b;
    w = w * refl;
    ray = bounce_ray(f, Rx, Ry, Rz);
  }
  return k;
}

// Material adjoints kept in registers over a chain.
struct MatAcc {
  float amb, lamb, refl, spec, shin;
};

// Reverse sweep of one trace (render_bwd.py:464-700). g: the pixel's
// cotangent in sample color space; w: the trace's weight refl^i; dw: d w /
// d refl = i refl^(i-1). ob/db: in, the cotangents of the next trace's
// origin and direction; out, this trace's. Every lane of the warp must call
// it; `act` selects whether this lane's trace contributes.
template <bool COMPAT, bool CHEAP>
__device__ void bwd_trace(const SceneView& s, const Slots& sl, float* row, int lane,
                          const Res& rs, bool act, float g0, float g1, float g2,
                          float w, float dw, float* ob, float* db, MatAcc& ma) {
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
  const Shade sh = shade_of<COMPAT, CHEAP>(s, f, Rx, Ry, Rz, occ, true);
  const bool has_spec = !COMPAT && s.nl > 0;

  const float gr = w * g0, gg = w * g1, gb = w * g2;
  // rgb = shade * albedo (+ spec * spec_sum)
  const float shade_bar = gr * f.ar + gg * f.ag + gb * f.ab;
  const float abr = sh.shade * gr, abg = sh.shade * gg, abb = sh.shade * gb;
  ma.amb += act ? shade_bar : 0.0f;
  ma.lamb += act ? shade_bar * sh.lam_sum : 0.0f;
  ma.refl += act ? dw * (g0 * sh.r + g1 * sh.g + g2 * sh.b) : 0.0f;
  const float lam_sum_bar = shade_bar * lamb;
  float spec_sum_bar = 0.0f, shin_bar = 0.0f;
  if (has_spec) {
    const float gsum = gr + gg + gb;
    spec_sum_bar = P[P_SPEC] * gsum;
    ma.spec += act ? gsum * sh.spec_sum : 0.0f;
  }

  // next trace: o_next = Pb + BIAS * R, d_next = R
  float Rbx = BIAS * ob[0] + db[0], Rby = BIAS * ob[1] + db[1], Rbz = BIAS * ob[2] + db[2];
  float pbbx = ob[0], pbby = ob[1], pbbz = ob[2];   // cotangent of Pb
  float lnx = 0.0f, lny = 0.0f, lnz = 0.0f;
  for (int l = 0; l < s.nl; ++l) {
    const LightTerm q = light_term<COMPAT, CHEAP>(s, l, f, Rx, Ry, Rz, occ, true);
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
    acc(row, sl.lts + 3 * l + 0, act ? Lbx : 0.0f, lane);
    acc(row, sl.lts + 3 * l + 1, act ? Lby : 0.0f, lane);
    acc(row, sl.lts + 3 * l + 2, act ? Lbz : 0.0f, lane);
    pbbx -= Lbx; pbby -= Lby; pbbz -= Lbz;
  }
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
    const float cx = s.sph[j], cy = s.sph[ns + j], cz = s.sph[2 * ns + j];
    const float r = s.sph[3 * ns + j];
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
  acc_obj<7>(row, sbase, sv, lane);
  acc_obj<9>(row, pbase, pv, lane);
  ob[0] = act ? obx : 0.0f; ob[1] = act ? oby : 0.0f; ob[2] = act ? obz : 0.0f;
  db[0] = act ? dbx : 0.0f; db[1] = act ? dby : 0.0f; db[2] = act ? dbz : 0.0f;
}

template <bool COMPAT, bool CHEAP>
__global__ void __launch_bounds__(NT)
render_bwd_kernel(const float* __restrict__ params, const float* __restrict__ sph,
                  int ns, const float* __restrict__ pln, int npl,
                  const float* __restrict__ lts, int nl, const float* __restrict__ img,
                  const float* __restrict__ target, float* __restrict__ partial,
                  int W, int H, int depth, int mode) {
  const bool fused = mode == FUSED_NOAA || mode == FUSED_AA;
  const bool aa = mode == COT_AA || mode == FUSED_AA;
  const Slots sl(ns, npl, nl, fused);
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + 7 * ns;
  float* s_lts = s_pln + 9 * npl;
  float* s_acc = s_lts + 3 * nl;               // NWARPS rows of sl.n slots
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int i = tid; i < N_PARAMS; i += NT) s_p[i] = params[i];
  for (int i = tid; i < 7 * ns; i += NT) s_sph[i] = sph[i];
  for (int i = tid; i < 9 * npl; i += NT) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += NT) s_lts[i] = lts[i];
  for (int i = tid; i < NWARPS * sl.n; i += NT) s_acc[i] = 0.0f;
  __syncthreads();
  const SceneView s{s_p, s_sph, ns, s_pln, npl, s_lts, nl};
  const int lane = tid & 31;
  float* row = s_acc + (tid >> 5) * sl.n;

  const int x = blockIdx.y * BY + threadIdx.y, y = blockIdx.x * BX + threadIdx.x;
  const int smp = blockIdx.z;                  // AA sample, 0 = primary
  const bool inb = x < W && y < H;
  const bool interior = x >= 1 && x <= W - 2 && y >= 1 && y <= H - 2;
  // A border pixel takes its primary sample alone.
  const bool on = inb && (!aa || interior || smp == 0);
  const size_t pix = inb ? (static_cast<size_t>(x) * H + y) * 3 : 0;

  const RayGen rg = raygen_full(s_p, static_cast<float>(x) + s_p[P_OFFS + 2 * smp],
                                static_cast<float>(y) + s_p[P_OFFS + 2 * smp + 1]);
  Res res[MAX_DEPTH + 1];
  res[0] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0u};
  int K = 1;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (on) K = fwd_chain<COMPAT, CHEAP>(s, rg.ray, depth, res, cr, cg, cb);

  // Cotangent (g0, g1, g2) of the stored pixel.
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, loss = 0.0f;
  if (inb) {
    if (fused) {
      const float inv_denom = static_cast<float>(1.0 / (3.0 * W * static_cast<double>(H)));
      const float two_inv = static_cast<float>(2.0 / (3.0 * W * static_cast<double>(H)));
      float st0, st1, st2;
      if (mode == FUSED_NOAA) {        // compat stores (r, b, g)
        st0 = cr; st1 = COMPAT ? cb : cg; st2 = COMPAT ? cg : cb;
      } else {
        st0 = img[pix]; st1 = img[pix + 1]; st2 = img[pix + 2];
      }
      const float d0 = st0 - target[pix], d1 = st1 - target[pix + 1],
                  d2 = st2 - target[pix + 2];
      loss = smp == 0 ? (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom : 0.0f;
      g0 = two_inv * d0; g1 = two_inv * d1; g2 = two_inv * d2;
    } else {
      g0 = img[pix]; g1 = img[pix + 1]; g2 = img[pix + 2];
    }
  }
  // Into sample color space: the primary sample's compat store swap; AA
  // neighbours land unswapped; interior AA weights 1/9.
  const float wgt = (aa && interior) ? static_cast<float>(1.0 / 9.0) : 1.0f;
  const bool swap = COMPAT && smp == 0;
  const float sr = wgt * g0, sg = wgt * (swap ? g2 : g1), sb = wgt * (swap ? g1 : g2);

  // Reverse sweep over the chain's traces.
  const float refl = s_p[P_REFL];
  MatAcc ma{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ob[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
  const int kmax = __reduce_max_sync(FULL, K);
  for (int i = kmax - 1; i >= 0; --i) {
    float w = 1.0f, dw = 0.0f;       // refl^i and i refl^(i-1)
    for (int k = 0; k < i; ++k) {
      dw = dw * refl + w;
      w = w * refl;
    }
    const Res rs = res[i < K ? i : K - 1];
    const bool act = on && i < K && rs.obj >= 0;
    bwd_trace<COMPAT, CHEAP>(s, sl, row, lane, rs, act, sr, sg, sb, w, dw, ob, db, ma);
  }

  // Camera: position takes the primary origin's cotangent; d = normalize(R p),
  // p = (focal, pcy, pcz); focal = cot(fov/2) with fov in degrees.
  const float focal = s_p[P_FOCAL];
  float ubx = db[0], uby = db[1], ubz = db[2];
  norm_adj(rg.ray.dx, rg.ray.dy, rg.ray.dz, rg.dn, ubx, uby, ubz);
  if (!on) ubx = uby = ubz = 0.0f;
  const float pvec[3] = {focal, rg.pcy, rg.pcz};
  const float ub[3] = {ubx, uby, ubz};
  for (int c = 0; c < 3; ++c) acc(row, sl.cam + c, ob[c], lane);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) acc(row, sl.cam + 3 + 3 * r + c, ub[r] * pvec[c], lane);
  const float focal_bar = s_p[P_ROT + 0] * ubx + s_p[P_ROT + 3] * uby + s_p[P_ROT + 6] * ubz;
  const float dfdf = -(1.0f + focal * focal) * static_cast<float>(3.14159265358979 / 360.0);
  acc(row, sl.cam + 12, focal_bar * dfdf, lane);
  acc(row, sl.mat + 0, ma.amb, lane);
  acc(row, sl.mat + 1, ma.lamb, lane);
  acc(row, sl.mat + 2, ma.refl, lane);
  acc(row, sl.mat + 3, ma.spec, lane);
  acc(row, sl.mat + 4, ma.shin, lane);
  if (fused) acc(row, sl.loss, loss, lane);

  // The block's partial: its warps' rows summed in warp order.
  __syncthreads();
  write_block_partial(s_acc, NWARPS, sl.n, partial, tid, NT);
}

template <bool COMPAT, bool CHEAP>
cudaError_t launch(const float* params, const float* sph, int ns, const float* pln,
                   int npl, const float* lts, int nl, const float* img,
                   const float* target, float* partial, int W, int H, int depth,
                   int mode, int n_grads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (N_PARAMS + 7 * ns + 9 * npl + 3 * nl +
                                       NWARPS * static_cast<size_t>(n_grads));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_bwd_kernel<COMPAT, CHEAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int S = (mode == COT_AA || mode == FUSED_AA) ? 9 : 1;
  const dim3 block(BX, BY);
  const dim3 grid((H + BX - 1) / BX, (W + BY - 1) / BY, S);
  render_bwd_kernel<COMPAT, CHEAP><<<grid, block, smem, stream>>>(
      params, sph, ns, pln, npl, lts, nl, img, target, partial, W, H, depth, mode);
  return cudaGetLastError();
}


// All arguments as rt_render_bwd's (render_bwd.cu), checked there.
inline cudaError_t dispatch(const float* params, const float* sph, int ns, const float* pln,
                            int npl, const float* lts, int nl, const float* img,
                            const float* target, float* partial, int n_grads, int W, int H,
                            int depth, int mode, bool compat, bool cheap, cudaStream_t st) {
  if (compat) {
    return cheap ? launch<true, true>(params, sph, ns, pln, npl, lts, nl, img, target,
                                      partial, W, H, depth, mode, n_grads, st)
                 : launch<true, false>(params, sph, ns, pln, npl, lts, nl, img, target,
                                       partial, W, H, depth, mode, n_grads, st);
  }
  return cheap ? launch<false, true>(params, sph, ns, pln, npl, lts, nl, img, target,
                                     partial, W, H, depth, mode, n_grads, st)
               : launch<false, false>(params, sph, ns, pln, npl, lts, nl, img, target,
                                      partial, W, H, depth, mode, n_grads, st);
}

}  // namespace
