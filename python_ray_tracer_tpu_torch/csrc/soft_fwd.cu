// Soft-visibility forward render for Hopper (sm_90a): sigmoid sphere coverage,
// opaque planes, soft shadow transmission, ambient + Lambert, and order-free
// front-to-back compositing, one thread per pixel.
//
// Replaces the TPU kernel python_ray_tracer_tpu/ops/pallas/soft_pallas.py
// _make_soft_kernel (:72, pallas_call at :297) and its wrapper
// render_image_soft_pallas (:259-307). Clean-mode camera grid, unswapped
// channels, output (W, H, 3) float32.
//
// What bounded the first port of this kernel (0.53 ms on the demo scene at
// 1000x1000 tau 0.05, 33.05 ms at 100 spheres 512x512, 18x and 620x its bound,
// H100 at 700 W): every object was covered, weighted by K fresh covers and
// shaded with one shadow sweep of ns covers a light, whatever its alpha:
// ~40,000 covers a pixel at 100 spheres. What bounds this one: FP32 issue in
// the live objects' shadow sweeps (a cover a lit (object, light, sphere ahead)
// triple), with IEEE sqrt, exp and division.
//
// What the design does about it (the soft backward kernel's forward half,
// soft_bwd.cu):
//   * each object's primary cover is taken once a pixel, and the live ones
//     (alpha > 0) go, in ascending index, into a lane-private table in shared
//     memory (index, a, t; slot-major, so neighbouring lanes hit neighbouring
//     banks). The compositing weights come from the table's (a, t):
//       w_i = a_i prod_{j != i} (1 - a_j [t_j < t_i or (t_j == t_i and j < i)]),
//     the order-free form of ops/soft.py's stable depth sort. A pixel with
//     more than `cap` live objects takes them in chunks of `cap`, each chunk's
//     weights from one sweep of fresh covers;
//   * exact skips, each of a term that is exactly 0: an object with alpha 0
//     (behind the ray origin, or its squared closest-approach distance past
//     (r (1 + 90 tau))^2, where expf overflows and the sigmoid is exactly 0,
//     dropped before its sqrt), an object with weight 0, a light whose
//     Lambert term is <= 0 (no shadow sweep), a shadow occluder with alpha 0
//     (the same test), and a transmission that reached 0 (its sweep stops);
//   * objects and occluders stay in ascending order and every cover keeps the
//     first port's arithmetic (soft_common.cuh's soft_cover, the division by
//     tau r), so each skipped factor was exactly 1 and each skipped term
//     exactly 0 there: the image is the first port's, bit for bit;
//   * the parameter vector and the scene's SoA tables are staged in shared
//     memory at block start, so every object read is a broadcast; no atomics
//     (each output element has one writer).
// The table's chunk size, one rule: cap = min(K, 32), halved until the block's
// shared memory (the scene and NT x 4 x cap floats) fits 227 KB.
//
// The global form (G; render_cuda.scene_form, past the scenes whose staged
// form fits a block at cap 1: 8,220 spheres at 1 plane and 3 lights): the
// sphere table is read where it lies in device memory, through the read-only
// cache, and the block stages the rest, so cap follows the same rule without
// the sphere table. The same operations on the same floats, but nvcc contracts
// the two instantiations on its own, so the forms agree within the kernel's
// rule against the plain version (soft_cuda.image_rule), not bit for bit.
//
// Block: NT = 128 threads, 16 along the image's y axis (the contiguous axis of
// the (w, h, 3) output) and 8 along x; a one-dimensional grid of
// ceil(H / 16) * ceil(W / 8) blocks.

#include <cuda_runtime.h>

#include "soft_common.cuh"

namespace {

using namespace rt;

constexpr int BX = 16;           // threads along y
constexpr int BY = 8;            // threads along x
constexpr int NT = BX * BY;
constexpr int MAX_CAP = 32;
constexpr int SMEM_LIMIT = 227 * 1024;

// Lane-private table fields (slot-major: field f of entry e at (f cap + e) NT).
enum : int { T_KEY = 0, T_A, T_T, T_W, N_FIELDS };

// Sphere j's soft cover of a ray in soft_cover's arithmetic; false where its
// alpha is exactly 0: t_ca <= 0, b^2 past dead2 = (r dead_k)^2 with dead_k = 1
// + 90 tau (the pre-activation is then below -89.9, expf overflows and the
// sigmoid is 0; tested before the sqrt), or a sigmoid that underflows.
// Word i of the sphere table: staged in shared memory, or G, where it lies.
template <bool G>
__device__ __forceinline__ float sph_word(const SceneView& s, int i) {
  if constexpr (G) {
    return __ldg(s.sph + i);
  } else {
    return s.sph[i];
  }
}

template <bool NEED_T, bool G>
__device__ __forceinline__ bool live_cover(const SceneView& s, int j, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           float tau, float dead_k, float& a, float& t) {
  const int ns = s.ns;
  const float r = sph_word<G>(s, 3 * ns + j);
  const float Lx = sph_word<G>(s, j) - ox, Ly = sph_word<G>(s, ns + j) - oy,
              Lz = sph_word<G>(s, 2 * ns + j) - oz;
  const float t_ca = Lx * dx + Ly * dy + Lz * dz;
  if (!(t_ca > 0.0f)) return false;
  const float vx = Lx - t_ca * dx, vy = Ly - t_ca * dy, vz = Lz - t_ca * dz;
  const float d2 = vx * vx + vy * vy + vz * vz;
  const float rd = r * dead_k;
  if (d2 > rd * rd) return false;
  const float b = sqrtf(d2 > 1e-12f ? d2 : 1e-12f);
  a = sigmoid(-(b - r) / (tau * r));
  if (NEED_T) {
    const float chord2 = r * r - d2;
    const bool inside = chord2 > 1e-12f;
    const float hc = sqrtf(inside ? chord2 : 1.0f);
    t = fmaxf(inside ? t_ca - hc : t_ca, 1e-4f);
  }
  return a > 0.0f;
}

// One lane's pixel: its primary ray and its column of the table.
template <bool G>
struct Pix {
  const SceneView& s;
  Ray ray;
  float tau, dead_k;
  float* tab;
  int cap;

  __device__ float& T(int f, int e) const { return tab[(f * cap + e) * NT]; }
  __device__ int gi(int e) const { return __float_as_int(T(T_KEY, e)); }

  // Object k's primary cover: false where its alpha is 0.
  __device__ bool cover(int k, float& a, float& t) const {
    if (k < s.ns) {
      return live_cover<true, G>(s, k, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, tau,
                              dead_k, a, t);
    }
    const PlaneCover p = plane_cover(s, k - s.ns, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy,
                                     ray.dz);
    a = p.a;
    t = p.t;
    return a > 0.0f;
  }

  // The next `cap` live objects from *k on into the table; *k stops at the
  // first live object that did not fit, or at K.
  __device__ int build(int* k) const {
    const int K = s.ns + s.npl;
    int n = 0;
    for (; *k < K; ++*k) {
      float a, t;
      if (!cover(*k, a, t)) continue;
      if (n == cap) break;
      T(T_KEY, n) = __int_as_float(*k);
      T(T_A, n) = a;
      T(T_T, n) = t;
      ++n;
    }
    return n;
  }

  // The entries' weights: from the table where it holds every live object,
  // else from one sweep of fresh covers (objects ascending, as the weight's
  // factors are taken).
  __device__ void weights(int n, bool complete) const {
    if (complete) {
      for (int e = 0; e < n; ++e) {
        const float t = T(T_T, e);
        const int g = gi(e);
        float w = T(T_A, e);
        for (int e2 = 0; e2 < n; ++e2) {
          if (closer(T(T_T, e2), gi(e2), t, g)) w *= 1.0f - T(T_A, e2);
        }
        T(T_W, e) = w;
      }
      return;
    }
    for (int e = 0; e < n; ++e) T(T_W, e) = T(T_A, e);
    const int K = s.ns + s.npl;
    for (int k = 0; k < K; ++k) {
      float a, t;
      if (!cover(k, a, t)) continue;
      for (int e = 0; e < n; ++e) {
        if (closer(t, k, T(T_T, e), gi(e))) T(T_W, e) *= 1.0f - a;
      }
    }
  }

  // Shadow transmission prod_j (1 - alpha_j) from P toward L, spheres
  // ascending, dead occluders skipped, stopping once it is 0.
  __device__ float transmission(float px, float py, float pz, const LightDir& L) const {
    float vis = 1.0f;
    for (int j = 0; j < s.ns && vis != 0.0f; ++j) {
      float a, t;
      if (live_cover<false, G>(s, j, px, py, pz, L.x, L.y, L.z, tau, dead_k, a, t)) {
        vis *= 1.0f - a;
      }
    }
    return vis;
  }

  // The table's n entries shaded and composited into (r, g, b), in order.
  __device__ void shade(int n, float& r, float& g, float& b) const {
    const float amb = s.p[P_AMB], lamb = s.p[P_LAMB];
    const int ns = s.ns;
    for (int e = 0; e < n; ++e) {
      const float w = T(T_W, e);
      if (w == 0.0f) continue;
      const int k = gi(e);
      const float t = T(T_T, e);
      const float px = ray.ox + t * ray.dx, py = ray.oy + t * ray.dy, pz = ray.oz + t * ray.dz;
      float nx, ny, nz, ar, ag, ab;
      if (k < ns) {
        const float vx = px - sph_word<G>(s, k), vy = py - sph_word<G>(s, ns + k),
                    vz = pz - sph_word<G>(s, 2 * ns + k);
        const float vv = vx * vx + vy * vy + vz * vz;
        const float nn = 1.0f / sqrtf(vv > 0.0f ? vv : 1.0f);
        nx = vx * nn; ny = vy * nn; nz = vz * nn;
        ar = sph_word<G>(s, 4 * ns + k); ag = sph_word<G>(s, 5 * ns + k);
        ab = sph_word<G>(s, 6 * ns + k);
      } else {
        const int q = k - ns, np = s.npl;
        nx = s.pln[3 * np + q]; ny = s.pln[4 * np + q]; nz = s.pln[5 * np + q];
        ar = s.pln[6 * np + q]; ag = s.pln[7 * np + q]; ab = s.pln[8 * np + q];
      }
      float lam_sum = 0.0f;
      for (int l = 0; l < s.nl; ++l) {
        const LightDir L = light_dir(s, l, px, py, pz);
        const float lam = lamb * (L.x * nx + L.y * ny + L.z * nz);
        if (!(lam > 0.0f)) continue;
        const float vis = transmission(px, py, pz, L);
        lam_sum += (lam > 0.0f ? lam : 0.0f) * vis;
      }
      r += w * (amb * ar + lam_sum * ar);
      g += w * (amb * ag + lam_sum * ag);
      b += w * (amb * ab + lam_sum * ab);
    }
  }
};

// staged: the sphere table among the words (the staged form).
inline size_t smem_words(int ns, int npl, int nl, int cap, bool staged = true) {
  return N_PARAMS + (staged ? 7 * static_cast<size_t>(ns) : 0) +
         9 * static_cast<size_t>(npl) + 3 * static_cast<size_t>(nl) +
         static_cast<size_t>(NT) * N_FIELDS * cap;
}

template <bool G>
__global__ void __launch_bounds__(NT)
soft_fwd_kernel(const float* __restrict__ params, const float* __restrict__ sph, int ns,
                const float* __restrict__ pln, int npl, const float* __restrict__ lts,
                int nl, float tau, float* __restrict__ out, int W, int H, int cap) {
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + (G ? 0 : 7 * ns);
  float* s_lts = s_pln + 9 * npl;
  float* s_tab = s_lts + 3 * nl;
  const int tid = threadIdx.x;
  for (int i = tid; i < N_PARAMS; i += NT) s_p[i] = params[i];
  if (!G) {
    for (int i = tid; i < 7 * ns; i += NT) s_sph[i] = sph[i];
  }
  for (int i = tid; i < 9 * npl; i += NT) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += NT) s_lts[i] = lts[i];
  __syncthreads();
  const SceneView s{s_p, G ? sph : s_sph, ns, s_pln, npl, s_lts, nl, G};

  const int nby = (H + BX - 1) / BX;
  const int x = static_cast<int>(blockIdx.x) / nby * BY + tid / BX;
  const int y = static_cast<int>(blockIdx.x) % nby * BX + tid % BX;
  if (x >= W || y >= H) return;
  const Pix<G> px{s, raygen(s_p, static_cast<float>(x) + s_p[P_X0], static_cast<float>(y)),
               tau, 1.0f + 90.0f * tau, s_tab + tid, cap};
  const int K = ns + npl;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  int k = 0;
  for (bool first = true; k < K; first = false) {
    const int n = px.build(&k);
    px.weights(n, first && k == K);
    px.shade(n, r, g, b);
  }
  float* o = out + (static_cast<size_t>(x) * H + y) * 3;
  o[0] = r;
  o[1] = g;
  o[2] = b;
}

// The table's chunk size for a scene in a form (the rule in the head of this
// file).
int plan_cap(int ns, int npl, int nl, bool staged = true) {
  int cap = ns + npl < MAX_CAP ? (ns + npl > 0 ? ns + npl : 1) : MAX_CAP;
  while (cap > 1 &&
         4 * smem_words(ns, npl, nl, cap, staged) > static_cast<size_t>(SMEM_LIMIT)) {
    cap /= 2;
  }
  return cap;
}

}  // namespace

extern "C" {

// The soft forward kernel's chunk size (live objects a pixel keeps in its
// table at once) for a scene in a form (staged 0: the global form).
int rt_soft_fwd_cap(int ns, int npl, int nl, int staged) {
  return plan_cap(ns, npl, nl, staged != 0);
}

// Soft render of a W x H image into out (W, H, 3) float32 on `stream`. params:
// the N_PARAMS vector packed with the clean-mode grid; sph/pln/lts: the
// (7,ns)/(9,npl)/(3,nl) SoA tables; tau > 0 the coverage softness. staged: the
// sphere table in shared memory; 0 takes the global form (render_cuda.
// scene_form). Returns cudaGetLastError() after the launch (0 on success).
int rt_soft_fwd(const float* params, const float* sph, int ns, const float* pln, int npl,
                const float* lts, int nl, float tau, float* out, int W, int H, int staged,
                void* stream) {
  if (W <= 0 || H <= 0 || ns < 0 || npl < 0 || nl < 0 || !(tau > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cap = plan_cap(ns, npl, nl, staged != 0);
  const size_t smem = sizeof(float) * smem_words(ns, npl, nl, cap, staged != 0);
  if (smem > static_cast<size_t>(SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = staged ? soft_fwd_kernel<false> : soft_fwd_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks =
      static_cast<long long>((H + BX - 1) / BX) * ((W + BY - 1) / BY);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      params, sph, ns, pln, npl, lts, nl, tau, out, W, H, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
