// Soft-visibility forward render for Hopper (sm_90a): sigmoid sphere coverage,
// opaque planes, soft shadow transmission, ambient + Lambert, and order-free
// front-to-back compositing, one thread per pixel.
//
// Replaces the TPU kernel python_ray_tracer_tpu/ops/pallas/soft_pallas.py
// _make_soft_kernel (:72, pallas_call at :297) and its wrapper
// render_image_soft_pallas (:259-307). Clean-mode camera grid, unswapped
// channels, output (W, H, 3) float32.
//
// What bounds it on this card: FP32 ALU work with expf, sqrtf and divides.
// Per pixel every object i is covered, shaded with one shadow sweep over all
// spheres per light, and weighted by one sweep over all objects:
// K cover + K nl (ns shadow covers + light setup) + K^2 compositing factors,
// K = ns + npl. The bytes are tiny: the scene (~60 floats for the demo) and 12
// bytes written per pixel.
//
// What the design does about it:
//   * the parameter vector and the scene's SoA tables are staged in shared
//     memory at block start, so every object read is a broadcast;
//   * the compositing weight uses the order-free identity
//     w_i = a_i prod_{j != i} (1 - a_j [t_j < t_i or (t_j == t_i and j < i)]),
//     which reproduces the stable depth sort of ops/soft.py without a sort;
//   * O(1) state per thread: the occluders' covers are recomputed inside each
//     object's sweeps (the TPU kernel's "rolled" form) for every scene size,
//     so there is no unroll or register limit and no per-thread array; loops
//     over objects and lights run at run time;
//   * no atomics: each output element has one writer.
// The TPU's unrolled/rolled split (_SOFT_UNROLL_LIMIT) was a TPU register limit
// and is not ported. Making it fast (caching the per-pixel camera covers,
// skipping zero-alpha objects) is later work.
//
// Block shape: 16x16 threads; threadIdx.x walks the image's y axis, the
// contiguous axis of the (w, h, 3) output.

#include <cuda_runtime.h>

#include "soft_common.cuh"

namespace {

using namespace rt;

constexpr int TILE = 16;

__global__ void __launch_bounds__(TILE * TILE)
soft_fwd_kernel(const float* __restrict__ params, const float* __restrict__ sph, int ns,
                const float* __restrict__ pln, int npl, const float* __restrict__ lts,
                int nl, float tau, float* __restrict__ out, int W, int H) {
  extern __shared__ float smem[];
  float* s_p = smem;
  float* s_sph = s_p + N_PARAMS;
  float* s_pln = s_sph + 7 * ns;
  float* s_lts = s_pln + 9 * npl;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < N_PARAMS; i += TILE * TILE) s_p[i] = params[i];
  for (int i = tid; i < 7 * ns; i += TILE * TILE) s_sph[i] = sph[i];
  for (int i = tid; i < 9 * npl; i += TILE * TILE) s_pln[i] = pln[i];
  for (int i = tid; i < 3 * nl; i += TILE * TILE) s_lts[i] = lts[i];
  __syncthreads();
  const SceneView s{s_p, s_sph, ns, s_pln, npl, s_lts, nl};

  const int x = blockIdx.y * TILE + threadIdx.y, y = blockIdx.x * TILE + threadIdx.x;
  if (x >= W || y >= H) return;
  const Ray ray = raygen(s_p, static_cast<float>(x) + s_p[P_X0], static_cast<float>(y));
  const Rgb c = soft_pixel(s, ray, tau);
  float* o = out + (static_cast<size_t>(x) * H + y) * 3;
  o[0] = c.r;
  o[1] = c.g;
  o[2] = c.b;
}

}  // namespace

extern "C" {

// Soft render of a W x H image into out (W, H, 3) float32 on `stream`. params:
// the N_PARAMS vector packed with the clean-mode grid; sph/pln/lts: the
// (7,ns)/(9,npl)/(3,nl) SoA tables; tau > 0 the coverage softness. Returns
// cudaGetLastError() after the launch (0 on success).
int rt_soft_fwd(const float* params, const float* sph, int ns, const float* pln, int npl,
                const float* lts, int nl, float tau, float* out, int W, int H,
                void* stream) {
  if (W <= 0 || H <= 0 || ns < 0 || npl < 0 || nl < 0 || !(tau > 0.0f) ||
      (W + TILE - 1) / TILE > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * (N_PARAMS + 7 * static_cast<size_t>(ns) +
                                       9 * static_cast<size_t>(npl) +
                                       3 * static_cast<size_t>(nl));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        soft_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(TILE, TILE);
  const dim3 grid((H + TILE - 1) / TILE, (W + TILE - 1) / TILE);
  soft_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      params, sph, ns, pln, npl, lts, nl, tau, out, W, H);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
