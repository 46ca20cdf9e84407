// The light cells of the render kernel's bounce-level shadow rays, built on
// the card once a frame: for each light, an axial cube map of LC_R x LC_R
// direction cells a face, each cell's row the ascending indices of the spheres
// that a shadow ray filed under it can report (rt_common.cuh occluded_cells
// reads them and derives the test). No TPU kernel builds such a table: the
// JAX package's bounce shadow rays sweep Morton groups (render_pallas.py
// _any_hit_multi_grouped), and its per-(tile, level, light) lists are plain
// jnp outside any kernel; this kernel serves the redesign of the render
// kernel's bounce levels (TPU kernel 1, _make_kernel, and the TABLES
// instantiations of kernels 2 and 7, which share the header's trace).
//
// What bounds it: FP32 work, one ~12-operation cone test a (row, sphere) pair
// (3 lights x 3 x 64 x 64 rows x 1000 spheres: 37 M tests), then the rows'
// 5 MB written once. The design:
//   * one warp a (light, cell) row; its lanes take the spheres 32 at a time
//     and a ballot with a population count appends the kept ones in
//     ascending index (no atomics, no sort: the rows are deterministic);
//   * a block serves one light (blockIdx.y): it stages the light's per-sphere
//     terms (w = c - l, sqrt(|w|^2 - rho^2), rho) in shared memory once, so a
//     test reads 5 broadcast words; its warps stride over the light's rows;
//   * every block takes the scene's reach (max |c| + r, |l|) itself, a
//     shared-memory max over its warps, so the header (reach, s_max) needs no
//     second launch and no host sync; block (0, 0) writes it;
//   * the slots past a row's count are written 0 and an overflowed row's count
//     is -1 after its first LC_K entries, so the rows equal the plain
//     version's (light_cells_cuda.light_cells_plain) integer for integer;
//   * every operation of the test is pinned (rt_common.cuh fm / fa / fs and
//     IEEE square root and division), the same float32 bits as the plain
//     version's tensor ops;
//   * past the 11,620 spheres whose terms fit a block's 227 KB (the chunked
//     form, CHUNKED, light_cells_cuda.chunk_spheres), a block takes its rows
//     a warp's worth at a time and sweeps the spheres in chunks of `chunk`:
//     it stages a chunk's terms, each warp appends that chunk's kept spheres
//     to its row, and the next chunk follows. The terms are the same floats
//     and the spheres come in the same ascending order, so every row is the
//     staged form's; each chunk's terms are computed once for every 8 rows
//     of the block (the staged form: once for all its rows).

#include "rt_common.cuh"

namespace {

using namespace rt;

constexpr int LC_WARPS = 8;        // warps a block
// Blocks over all lights: five a streaming multiprocessor, as many as the
// kernel's 48 registers let reside (two a multiprocessor took 124 us at 1000
// spheres on the H100, latency-bound in each warp's ballot chain).
constexpr int LC_BLOCKS = 132 * 5;

// A grown cell's central direction c^ (global axes) and the cosine and sine of
// the largest angle from c^ to the grown square's corners.
struct CellCone {
  float x, y, z, cb, sb;
};

__device__ __forceinline__ float ss3(float x, float y, float z) {
  return fa(fa(fm(x, x), fm(y, y)), fm(z, z));
}

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

__device__ __forceinline__ CellCone cell_cone(int cell) {
  const int face = cell / (LC_R * LC_R), iu = (cell / LC_R) % LC_R, iv = cell % LC_R;
  constexpr float STEP = 2.0f / LC_R;                          // exact
  const float u0 = fs(fm(static_cast<float>(iu), STEP), 1.0f);  // exact
  const float v0 = fs(fm(static_cast<float>(iv), STEP), 1.0f);
  const float mu = fa(u0, 0.5f * STEP), mv = fa(v0, 0.5f * STEP);
  const float lo[2] = {fs(u0, LC_GROW), fs(v0, LC_GROW)};
  const float hi[2] = {fa(fa(u0, STEP), LC_GROW), fa(fa(v0, STEP), LC_GROW)};
  const float ic = rsqrt_ieee(ss3(mu, mv, 1.0f));
  const float ca = fm(mu, ic), cc = fm(mv, ic), cz = ic;
  float cb = 1.0f, sb = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a = (k & 1) ? hi[0] : lo[0], b = (k & 2) ? hi[1] : lo[1];
    const float iq = rsqrt_ieee(ss3(a, b, 1.0f));
    const float qa = fm(a, iq), qb = fm(b, iq), qz = iq;
    const float dot = fa(fa(fm(ca, qa), fm(cc, qb)), fm(cz, qz));
    const float x = fs(fm(cc, qz), fm(cz, qb));
    const float y = fs(fm(cz, qa), fm(ca, qz));
    const float z = fs(fm(ca, qb), fm(cc, qa));
    cb = fminf(cb, dot);
    sb = fmaxf(sb, __fsqrt_rn(ss3(x, y, z)));
  }
  // face coordinates (u, v) are the two other axes in ascending order
  if (face == 0) return {cz, ca, cc, cb, sb};
  if (face == 1) return {ca, cz, cc, cb, sb};
  return {ca, cc, cz, cb, sb};
}

// Light l's terms of spheres [j0, j1) into the five arrays (index j - j0):
// w = c - l, p = sqrt(|w|^2 - rho^2) (-1 where the grown ball holds the
// light) and rho = r + m.
__device__ __forceinline__ void stage_terms(const float* __restrict__ sph, int ns, float lx,
                                            float ly, float lz, float m, int j0, int j1,
                                            float* s_wx, float* s_wy, float* s_wz,
                                            float* s_p, float* s_rho, int tid, int nt) {
  for (int j = j0 + tid; j < j1; j += nt) {
    const float wx = fs(sph[j], lx), wy = fs(sph[ns + j], ly), wz = fs(sph[2 * ns + j], lz);
    const float ww = ss3(wx, wy, wz);
    const float rho = fa(sph[3 * ns + j], m);
    const float rr = fm(rho, rho);
    const int i = j - j0;
    s_wx[i] = wx;
    s_wy[i] = wy;
    s_wz[i] = wz;
    s_p[i] = rr >= fm(ww, LC_HOLDS) ? -1.0f : __fsqrt_rn(fs(ww, rr));
    s_rho[i] = rho;
  }
}

// One warp's sweep of spheres [j0, j1) (terms at index j - j0) for the row of
// cone c: the kept ones appended to slots from *n on.
__device__ __forceinline__ void sweep_terms(const CellCone& c, float tau, int j0, int j1,
                                            const float* s_wx, const float* s_wy,
                                            const float* s_wz, const float* s_p,
                                            const float* s_rho, int* slots, int& n,
                                            int lane) {
  for (int base = j0; base < j1; base += 32) {
    const int j = base + lane;
    bool keep = false;
    if (j < j1) {
      const int i = j - j0;
      const float x = fabsf(fa(fa(fm(c.x, s_wx[i]), fm(c.y, s_wy[i])), fm(c.z, s_wz[i])));
      const float p = s_p[i];
      keep = p < 0.0f || fa(x, tau) >= fs(fm(c.cb, p), fm(c.sb, s_rho[i]));
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    const int pos = n + __popc(bal & ((1u << lane) - 1u));
    if (keep && pos < LC_K) slots[pos] = j;
    n += __popc(bal);
  }
}

// CHUNKED: the terms staged `chunk` spheres at a time (chunk > 0); else all of
// them at once (ns words each).
template <bool CHUNKED>
__global__ void __launch_bounds__(LC_WARPS * 32)
light_cells_kernel(const float* __restrict__ sph, int ns, const float* __restrict__ lts,
                   int nl, int* __restrict__ idx, int* __restrict__ cnt,
                   float* __restrict__ hdr, int chunk) {
  extern __shared__ float smem[];   // wx, wy, wz, p, rho: ns (CHUNKED: chunk) each
  __shared__ float s_red[LC_WARPS];
  const int l = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NT = LC_WARPS * 32;

  // the scene's reach: the largest |c| + r and |l|, rounded up
  float rc = 0.0f;
  for (int j = tid; j < ns; j += NT) {
    rc = fmaxf(rc, fa(__fsqrt_rn(ss3(sph[j], sph[ns + j], sph[2 * ns + j])), sph[3 * ns + j]));
  }
  for (int k = tid; k < nl; k += NT) {
    rc = fmaxf(rc, __fsqrt_rn(ss3(lts[k], lts[nl + k], lts[2 * nl + k])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rc = fmaxf(rc, __shfl_xor_sync(FULL, rc, o));
  if (lane == 0) s_red[warp] = rc;
  __syncthreads();
  rc = s_red[0];
#pragma unroll
  for (int w = 1; w < LC_WARPS; ++w) rc = fmaxf(rc, s_red[w]);
  const float reach = fm(rc, LC_REACH_UP);
  const float s_max = fm(LC_SCALE, reach);
  const float m = fm(LC_MARGIN, s_max), tau = fm(LC_TAU, s_max);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    hdr[0] = reach;
    hdr[1] = s_max;
  }

  // this light's per-sphere terms; p < 0 marks a grown ball that holds the light
  const int cap = CHUNKED ? chunk : ns;
  float* s_wx = smem;
  float* s_wy = s_wx + cap;
  float* s_wz = s_wy + cap;
  float* s_p = s_wz + cap;
  float* s_rho = s_p + cap;
  const float lx = lts[l], ly = lts[nl + l], lz = lts[2 * nl + l];
  if (!CHUNKED) {
    stage_terms(sph, ns, lx, ly, lz, m, 0, ns, s_wx, s_wy, s_wz, s_p, s_rho, tid, NT);
    __syncthreads();
    for (int cell = blockIdx.x * LC_WARPS + warp; cell < LC_ROWS;
         cell += gridDim.x * LC_WARPS) {
      const CellCone c = cell_cone(cell);
      const size_t row = static_cast<size_t>(l) * LC_ROWS + cell;
      int* slots = idx + row * LC_K;
      int n = 0;
      sweep_terms(c, tau, 0, ns, s_wx, s_wy, s_wz, s_p, s_rho, slots, n, lane);
      for (int i = min(n, LC_K) + lane; i < LC_K; i += 32) slots[i] = 0;
      if (lane == 0) cnt[row] = n > LC_K ? -1 : n;
    }
    return;
  }
  // the block's rows, a warp's worth at a time (the loop's bound is the
  // block's, so every warp meets the barriers), the chunks inside
  for (int cell0 = blockIdx.x * LC_WARPS; cell0 < LC_ROWS; cell0 += gridDim.x * LC_WARPS) {
    const int cell = cell0 + warp;
    const bool mine = cell < LC_ROWS;
    const CellCone c = cell_cone(mine ? cell : 0);
    const size_t row = static_cast<size_t>(l) * LC_ROWS + cell;
    int* slots = idx + row * LC_K;
    int n = 0;
    for (int j0 = 0; j0 < ns; j0 += chunk) {
      const int j1 = min(j0 + chunk, ns);
      __syncthreads();   // the previous chunk's terms are read
      stage_terms(sph, ns, lx, ly, lz, m, j0, j1, s_wx, s_wy, s_wz, s_p, s_rho, tid, NT);
      __syncthreads();
      if (mine) sweep_terms(c, tau, j0, j1, s_wx, s_wy, s_wz, s_p, s_rho, slots, n, lane);
    }
    if (mine) {
      for (int i = min(n, LC_K) + lane; i < LC_K; i += 32) slots[i] = 0;
      if (lane == 0) cnt[row] = n > LC_K ? -1 : n;
    }
  }
}

}  // namespace

extern "C" {

// Build the light cells of a scene on `stream`: sph (7, ns) and lts (3, nl)
// are the render kernel's SoA tables (device pointers, nl >= 1); idx
// (nl * LC_ROWS * LC_K) and cnt (nl * LC_ROWS) int32 receive the rows, row
// (light * 3 + face) * LC_R * LC_R + iu * LC_R + iv, and hdr (2) float32 the
// scene's reach and s_max (rt_common.cuh occluded_cells). chunk: 0 stages
// every sphere's terms at once; > 0, the chunked form, that many at a time
// (light_cells_cuda.chunk_spheres). Returns cudaGetLastError() after the
// launch (0 on success).
int rt_light_cells(const float* sph, int ns, const float* lts, int nl, int* idx, int* cnt,
                   float* hdr, int chunk, void* stream) {
  if (ns < 0 || nl < 1 || nl > 65535 || chunk < 0 || !sph || !lts || !idx || !cnt || !hdr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 5 * static_cast<size_t>(chunk > 0 ? chunk : ns);
  const auto kernel = chunk > 0 ? light_cells_kernel<true> : light_cells_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_light = max(1, min((LC_ROWS + LC_WARPS - 1) / LC_WARPS, LC_BLOCKS / nl));
  kernel<<<dim3(per_light, nl), LC_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, ns, lts, nl, idx, cnt, hdr, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The light cells' shape this library was built for (rt_common.cuh LC_R,
// LC_K).
void rt_light_cells_shape(int* r, int* k) {
  *r = LC_R;
  *k = LC_K;
}

}  // extern "C"
