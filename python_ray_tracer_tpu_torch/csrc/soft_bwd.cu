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
// The plane's t adjoint masks den by |den| > 1e-8 and leaves num unmasked, as
// ops/soft.py's autograd does.
//
// What bounds it on this card: FP32 ALU work (expf, sqrtf, divides) and the
// adjoint reductions. Per pixel and object i the forward is recomputed (cover,
// weight sweep, one shadow sweep per light) and every sphere j gets a
// (center, radius) adjoint from i's weight and from each of i's shadow rays:
// those per-occluder adjoints are dense (every lane has one for every j), so
// each (i, j) pair costs 4 warp reductions per light. The bytes are tiny: the
// scene, one (W, H, 3) image in, the partial sums out.
//
// What the design does about it:
//   * forward values are recomputed per object through soft_common.cuh, the
//     functions soft_fwd.cu uses (O(1) state, no residual arrays), so the fused
//     loss is the forward kernel's render;
//   * no light-count limit and no per-light arrays: the loop over lights runs
//     outside the occluder sweeps; each light's transmission is recomputed just
//     before its adjoint sweep, and the weight's occluder adjoints ride in the
//     last light's sweep (a separate sweep when there are no lights), so a
//     pair (i, j) costs 4 nl warp reductions (4 with no lights);
//   * reductions as in render_bwd.cu: warp_sum with shuffles, lane 0 adds to
//     its warp's shared-memory row, the block sums its rows in warp order into
//     its partial column, and a second kernel sums each column in a fixed tree.
//     No float atomics: two runs give the same bits;
//   * every lane runs every loop (the trip counts are the scene's), so the
//     warp collectives see all 32 lanes; pad pixels carry a zero cotangent.
// The TPU's slab accumulation and its RT_SOFT_* hooks are TPU measurement
// choices and are not ported; fewer reductions are later work.
//
// Block shape: 16 x 8 threads (4 warps); threadIdx.x walks the image's y axis.

#include <cuda_runtime.h>

#include "soft_common.cuh"

namespace {

using namespace rt;

constexpr int BX = 16;                       // threads along y
constexpr int BY = 8;                        // threads along x
constexpr int NT = BX * BY;
constexpr int NWARPS = NT / 32;

// Cotangents of the primary ray's origin and direction, carried over objects.
struct RayBar {
  float ox, oy, oz, dx, dy, dz;
};

// One sweep over the sphere occluders of object gi (global index, depth t_i):
// COMP adds the adjoints of gi's compositing weight (wbar_wi = wbar * w_i),
// SHADOW those of its transmission toward light L from P (vis_fac = -visbar *
// vis). Each sphere's (center, radius) slots take their sum; the primary ray,
// P and L take theirs. Every lane of the warp must call it.
template <bool COMP, bool SHADOW>
__device__ __forceinline__ void occluder_sweep(const SceneView& s, float* row, int lane,
                                               const Ray& ray, float tau, int gi,
                                               float t_i, float wbar_wi, float px,
                                               float py, float pz, const LightDir& L,
                                               float vis_fac, RayBar& rb, float* Pb,
                                               float* Lb) {
  const int ns = s.ns;
  for (int j = 0; j < ns; ++j) {
    const float r = s.sph[3 * ns + j];
    float cbx = 0.0f, cby = 0.0f, cbz = 0.0f, rbar = 0.0f;
    if (COMP) {
      const Cover c = sphere_cover<true>(s, j, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                         ray.dz, tau);
      const float xbar = closer(c.t, j, t_i, gi) ? -wbar_wi * c.a : 0.0f;
      const CoverAdj d = soft_cover_adj<false>(c, ray.dx, ray.dy, ray.dz, r, tau, xbar,
                                               0.0f);
      cbx += d.cx; cby += d.cy; cbz += d.cz; rbar += d.r;
      rb.ox += d.ox; rb.oy += d.oy; rb.oz += d.oz;
      rb.dx += d.dx; rb.dy += d.dy; rb.dz += d.dz;
    }
    if (SHADOW) {
      const Cover c = sphere_cover<false>(s, j, px, py, pz, L.x, L.y, L.z, tau);
      const CoverAdj d = soft_cover_adj<false>(c, L.x, L.y, L.z, r, tau, vis_fac * c.a,
                                               0.0f);
      cbx += d.cx; cby += d.cy; cbz += d.cz; rbar += d.r;
      Pb[0] += d.ox; Pb[1] += d.oy; Pb[2] += d.oz;
      Lb[0] += d.dx; Lb[1] += d.dy; Lb[2] += d.dz;
    }
    acc(row, 7 * j + 0, cbx, lane);
    acc(row, 7 * j + 1, cby, lane);
    acc(row, 7 * j + 2, cbz, lane);
    acc(row, 7 * j + 3, rbar, lane);
  }
}

// Reverse sweep of object gi (spheres 0..ns-1, then planes) for a pixel whose
// color cotangent is (g0, g1, g2) (soft_bwd.py sphere_iter :440-478,
// plane_iter :483-533). Every lane of the warp must call it.
__device__ void object_adjoint(const SceneView& s, const Slots& sl, float* row, int lane,
                               const Ray& ray, float tau, int gi, float g0, float g1,
                               float g2, RayBar& rb) {
  const int ns = s.ns;
  const bool sphere = gi < ns;
  Cover cv{};
  PlaneCover pc{};
  float a, t;
  if (sphere) {
    cv = sphere_cover<true>(s, gi, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, tau);
    a = cv.a;
    t = cv.t;
  } else {
    pc = plane_cover(s, gi - ns, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz);
    a = pc.a;
    t = pc.t;
  }
  const SoftObj o = soft_surface(s, ray, tau, gi, a, t);
  const float amb = s.p[P_AMB], lamb = s.p[P_LAMB];
  // color = w * shade * albedo, shade = amb + lam_sum
  const float gA = g0 * o.ar + g1 * o.ag + g2 * o.ab;
  const float sbar = o.w * gA;
  float lam_sum = 0.0f, lamb_acc = 0.0f, wbar_wi = 0.0f;
  float Nb[3] = {0.0f, 0.0f, 0.0f}, Pb[3] = {0.0f, 0.0f, 0.0f};
  const int nl = s.nl;
  if (nl == 0) {
    wbar_wi = amb * gA * o.w;
    float Lb[3] = {0.0f, 0.0f, 0.0f};
    occluder_sweep<true, false>(s, row, lane, ray, tau, gi, t, wbar_wi, o.px, o.py, o.pz,
                                LightDir{0.0f, 0.0f, 0.0f, 1.0f}, 0.0f, rb, Pb, Lb);
  }
  for (int l = 0; l < nl; ++l) {
    const LightDir L = light_dir(s, l, o.px, o.py, o.pz);
    const float ldotn = L.x * o.nx + L.y * o.ny + L.z * o.nz;
    const float lam = lamb * ldotn;
    const bool pos = lam > 0.0f;
    const float relu = pos ? lam : 0.0f;
    const float vis = transmission(s, o.px, o.py, o.pz, L, tau);
    lam_sum += relu * vis;
    const float relubar = sbar * vis;
    lamb_acc += pos ? relubar * ldotn : 0.0f;
    const float ldotnbar = pos ? relubar * lamb : 0.0f;
    Nb[0] += ldotnbar * L.x;
    Nb[1] += ldotnbar * L.y;
    Nb[2] += ldotnbar * L.z;
    float Lb[3] = {ldotnbar * o.nx, ldotnbar * o.ny, ldotnbar * o.nz};
    const float vis_fac = -(sbar * relu) * vis;
    if (l == nl - 1) {       // the shade is complete: the weight's adjoints ride along
      wbar_wi = (amb + lam_sum) * gA * o.w;
      occluder_sweep<true, true>(s, row, lane, ray, tau, gi, t, wbar_wi, o.px, o.py,
                                 o.pz, L, vis_fac, rb, Pb, Lb);
    } else {
      occluder_sweep<false, true>(s, row, lane, ray, tau, gi, t, 0.0f, o.px, o.py, o.pz,
                                  L, vis_fac, rb, Pb, Lb);
    }
    // L = (light - P) * rn
    norm_adj(L.x, L.y, L.z, L.rn, Lb[0], Lb[1], Lb[2]);
    acc(row, sl.lts + 3 * l + 0, Lb[0], lane);
    acc(row, sl.lts + 3 * l + 1, Lb[1], lane);
    acc(row, sl.lts + 3 * l + 2, Lb[2], lane);
    Pb[0] -= Lb[0];
    Pb[1] -= Lb[1];
    Pb[2] -= Lb[2];
  }
  const float s_val = amb + lam_sum;
  acc(row, sl.mat + 0, sbar, lane);
  acc(row, sl.mat + 1, lamb_acc, lane);
  const int abase = sphere ? 7 * gi + 4 : sl.pln + 9 * (gi - ns) + 6;
  acc(row, abase + 0, o.w * s_val * g0, lane);
  acc(row, abase + 1, o.w * s_val * g1, lane);
  acc(row, abase + 2, o.w * s_val * g2, lane);

  float vb[3] = {Nb[0], Nb[1], Nb[2]};
  if (sphere) {
    // N = (P - c) * nn: P takes vb, the center -vb
    norm_adj(o.nx, o.ny, o.nz, o.nn, vb[0], vb[1], vb[2]);
    for (int c = 0; c < 3; ++c) Pb[c] += vb[c];
  }
  // P = o + t d
  rb.ox += Pb[0]; rb.oy += Pb[1]; rb.oz += Pb[2];
  const float tbar = Pb[0] * ray.dx + Pb[1] * ray.dy + Pb[2] * ray.dz;
  rb.dx += t * Pb[0]; rb.dy += t * Pb[1]; rb.dz += t * Pb[2];

  if (sphere) {
    // own coverage (x_i) and blend depth (t_i)
    const float r = s.sph[3 * ns + gi];
    const CoverAdj d = soft_cover_adj<true>(cv, ray.dx, ray.dy, ray.dz, r, tau,
                                            wbar_wi * (1.0f - cv.a), tbar);
    acc(row, 7 * gi + 0, d.cx - vb[0], lane);
    acc(row, 7 * gi + 1, d.cy - vb[1], lane);
    acc(row, 7 * gi + 2, d.cz - vb[2], lane);
    acc(row, 7 * gi + 3, d.r, lane);
    rb.ox += d.ox; rb.oy += d.oy; rb.oz += d.oz;
    rb.dx += d.dx; rb.dy += d.dy; rb.dz += d.dz;
  } else {
    // t = max(num / den_safe, 1e-4), num = n.(p0 - o), den = n.d; the plane's
    // alpha is an indicator and has no adjoint
    const int k = gi - ns, np = s.npl, base = sl.pln + 9 * k;
    const float p0x = s.pln[k], p0y = s.pln[np + k], p0z = s.pln[2 * np + k];
    const float t_m = pc.t_pre > 1e-4f ? tbar : 0.0f;
    const float inv_den = 1.0f / pc.den_safe;
    const float numbar = t_m * inv_den;
    const float denbar = pc.den_ok ? -(t_m * pc.t_pre) * inv_den : 0.0f;
    acc(row, base + 0, numbar * o.nx, lane);
    acc(row, base + 1, numbar * o.ny, lane);
    acc(row, base + 2, numbar * o.nz, lane);
    acc(row, base + 3, denbar * ray.dx + Nb[0] + numbar * (p0x - ray.ox), lane);
    acc(row, base + 4, denbar * ray.dy + Nb[1] + numbar * (p0y - ray.oy), lane);
    acc(row, base + 5, denbar * ray.dz + Nb[2] + numbar * (p0z - ray.oz), lane);
    rb.ox -= numbar * o.nx; rb.oy -= numbar * o.ny; rb.oz -= numbar * o.nz;
    rb.dx += denbar * o.nx; rb.dy += denbar * o.ny; rb.dz += denbar * o.nz;
  }
}

__global__ void __launch_bounds__(NT)
soft_bwd_kernel(const float* __restrict__ params, const float* __restrict__ sph, int ns,
                const float* __restrict__ pln, int npl, const float* __restrict__ lts,
                int nl, float tau, const float* __restrict__ img,
                float* __restrict__ partial, int W, int H, int fused) {
  const Slots sl(ns, npl, nl, fused != 0);
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
  const bool inb = x < W && y < H;
  const size_t pix = inb ? (static_cast<size_t>(x) * H + y) * 3 : 0;
  const RayGen rg = raygen_full(s_p, static_cast<float>(x) + s_p[P_X0],
                                static_cast<float>(y));

  // Cotangent of the pixel's color: the image in, or in FUSED the MSE's.
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, loss = 0.0f;
  if (fused) {
    const Rgb c = soft_pixel(s, rg.ray, tau);
    if (inb) {
      const float inv_denom = static_cast<float>(1.0 / (3.0 * W * static_cast<double>(H)));
      const float two_inv = static_cast<float>(2.0 / (3.0 * W * static_cast<double>(H)));
      const float d0 = c.r - img[pix], d1 = c.g - img[pix + 1], d2 = c.b - img[pix + 2];
      loss = (d0 * d0 + d1 * d1 + d2 * d2) * inv_denom;
      g0 = two_inv * d0; g1 = two_inv * d1; g2 = two_inv * d2;
    }
  } else if (inb) {
    g0 = img[pix]; g1 = img[pix + 1]; g2 = img[pix + 2];
  }

  RayBar rb{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int K = ns + npl;
  for (int gi = 0; gi < K; ++gi) object_adjoint(s, sl, row, lane, rg.ray, tau, gi, g0, g1,
                                                g2, rb);

  // Camera: position takes the origin's cotangent; d = normalize(R p),
  // p = (focal, pcy, pcz); focal = cot(fov/2) with fov in degrees.
  const float focal = s_p[P_FOCAL];
  float ub[3] = {rb.dx, rb.dy, rb.dz};
  norm_adj(rg.ray.dx, rg.ray.dy, rg.ray.dz, rg.dn, ub[0], ub[1], ub[2]);
  const float ob[3] = {inb ? rb.ox : 0.0f, inb ? rb.oy : 0.0f, inb ? rb.oz : 0.0f};
  for (int c = 0; c < 3; ++c) ub[c] = inb ? ub[c] : 0.0f;
  const float pvec[3] = {focal, rg.pcy, rg.pcz};
  for (int c = 0; c < 3; ++c) acc(row, sl.cam + c, ob[c], lane);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) acc(row, sl.cam + 3 + 3 * r + c, ub[r] * pvec[c], lane);
  const float focal_bar = s_p[P_ROT + 0] * ub[0] + s_p[P_ROT + 3] * ub[1] +
                          s_p[P_ROT + 6] * ub[2];
  const float dfdf = -(1.0f + focal * focal) * static_cast<float>(3.14159265358979 / 360.0);
  acc(row, sl.cam + 12, focal_bar * dfdf, lane);
  if (fused) acc(row, sl.loss, loss, lane);

  __syncthreads();
  write_block_partial(s_acc, NWARPS, sl.n, partial, tid, NT);
}

}  // namespace

extern "C" {

// Launch the soft backward kernel on `stream`: per-block partial sums into
// partial (n_grads x n_rows, n_rows = ceil(H/16) * ceil(W/8)); rt_reduce_rows
// then sums them. img: the (W, H, 3) cotangent, or with fused the target.
// n_grads = 7 ns + 9 npl + 3 nl + 18, + 1 with fused. Returns
// cudaGetLastError() after the launch.
int rt_soft_bwd(const float* params, const float* sph, int ns, const float* pln, int npl,
                const float* lts, int nl, float tau, const float* img, float* partial,
                int n_rows, int n_grads, int W, int H, int fused, void* stream) {
  if (W <= 0 || H <= 0 || ns < 0 || npl < 0 || nl < 0 || !(tau > 0.0f) ||
      img == nullptr || (W + BY - 1) / BY > 65535 ||
      n_grads != 7 * ns + 9 * npl + 3 * nl + 18 + (fused ? 1 : 0) ||
      static_cast<long long>(n_rows) !=
          static_cast<long long>((H + BX - 1) / BX) * ((W + BY - 1) / BY)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (N_PARAMS + 7 * static_cast<size_t>(ns) +
                                       9 * static_cast<size_t>(npl) +
                                       3 * static_cast<size_t>(nl) +
                                       NWARPS * static_cast<size_t>(n_grads));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(BX, BY);
  const dim3 grid((H + BX - 1) / BX, (W + BY - 1) / BY);
  soft_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      params, sph, ns, pln, npl, lts, nl, tau, img, partial, W, H, fused);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
