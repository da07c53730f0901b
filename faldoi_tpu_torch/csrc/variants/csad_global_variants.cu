// K14's and K15's forms, timed against each other and against the
// library's (csad_global.cu, included below) by faldoi_tpu_torch/cli/
// k8_variants.py, which builds this file itself (kernels/build.py does
// not):
//   K14 (faldoi_k14v, faldoi_tvcsad_global_loop's arguments after the
//   variant):
//     0  the former K14 (its primal kernel before the ranking, copied: four
//        lanes a pixel counting every PD iteration, no rank launch);
//     1  ranked b pixel-major, a thread a pixel in 256-thread blocks, the
//        counting path out of line, no register cap (233 registers: the
//        out-of-line path's arrays take the kernel's budget);
//     2  the same with the ranked b plane-major;
//     3  four lanes a pixel, lane 0 searching, the counting path in line
//        (the K8 loop's form), pixel-major; 4 the same plane-major;
//     5  a thread a pixel with the counting path in line, pixel-major;
//     6  variant 1 in 128-thread blocks;
//     7  variant 1 at four blocks an SM (64 registers); 8 the same
//        plane-major; 9, 10 the same at eight blocks an SM (32 registers);
//     11 a thread a pixel at four blocks an SM, counting in line; 12 the
//        same plane-major (the library's);
//     30 variant 12 without the counting path (SASS counts only);
//   K15 (faldoi_k15v, faldoi_nltvcsad_global_loop's arguments after the
//   variant, then two (h, w) scratch planes for v):
//     1  the primal phase selects v itself, the ranked b pixel-major, the
//        counting path out of line;
//     2  the same plane-major (the library's);
//     3  the counting path in line, pixel-major;
//     4  three launches an iteration: K6's dual phase, a ranked v-step
//        launch writing v (pixel-major, out of line), the former primal
//        phase reading it;
//     30 variant 2 without the counting path (SASS counts only);
//   and faldoi_k15v_former_step, the former K15's library step (K6's
//   dual phase, then the primal phase on the v K8's whole-image form
//   wrote), which the script calls after the library's K8 every iteration,
//   as the former wrapper did.
// Every form is held bit for bit to its twin by the script.

#include "../csad_global.cu"

namespace {

constexpr int kG = 4;   // lanes a cell (K8's group)

// The other layout of the ranked b timed: (h w, 48), a pixel's probes in
// its own six 32-byte sectors.
struct PixelMajor {   // (h w, 48): a pixel's probes in its own six sectors
  __host__ __device__ static long long col(long long cell, long long) {
    return cell * kNd;
  }
  __host__ __device__ static int stride(long long) { return 1; }
};


// K14's primal phase with four lanes a pixel (K8's group), lane 0
// searching and stepping; 32 pixels a 128-thread block, summed as the
// library's thread-a-pixel form sums them.
template <class L, int FB>
__global__ void __launch_bounds__(kErrCells * kG)
    tvcsad_primal4_kernel(TvArgs a, int h, int w) {
  if (a.state[1] == 0) return;
  const long long n = (long long)h * w;
  const long long cell = ((long long)blockIdx.x * kErrCells * kG + threadIdx.x) / kG;
  const int g = threadIdx.x % kG;
  double e = 0.0;
  if (cell < n) {   // whole groups
    const int r = (int)(cell / w), c = (int)(cell % w);
    const float u1 = a.u1[cell], u2 = a.u2[cell];
    const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.grad[cell];
    const float dot = (gx * u1 + gy * u2) / den;
    const float med = image_select<kG, L, FB>(a.rb, a.ok, a.b, n, cell, r, c, h, w,
                                               dot, a.lt * den, g, group_mask<kG>());
    if (g == 0) e = tvcsad_primal_step(a, cell, r, c, h, w, u1, u2, gx, gy, den, med);
  }
  // the warp's 8 cells (lanes 0, 4, ..., 28) by a tree; 0 past the image
  e = e + __shfl_down_sync(0xffffffffu, e, 16);
  e = e + __shfl_down_sync(0xffffffffu, e, 8);
  e = e + __shfl_down_sync(0xffffffffu, e, 4);
  __shared__ double ws[kG];
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = ws[0];
#pragma unroll
    for (int k = 1; k < kG; ++k) s = s + ws[k];
    a.part[blockIdx.x] = s;
  }
}

// The whole loop with that primal phase.
template <class L, int FB>
cudaError_t tvcsad_loop4(const TvArgs& a, int h, int w, float tol2, int max_iters,
                         cudaStream_t st) {
  const long long n = (long long)h * w;
  const unsigned dual = (unsigned)((n + kDualThreads - 1) / kDualThreads);
  const int nparts = (int)((n + kErrCells - 1) / kErrCells);
  tvcsad_init_kernel<<<1, 1, 0, st>>>(a.state, tol2, max_iters);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || max_iters <= 0) return e;
  e = launch_rank_image<L>(a.b, a.grad, a.lt, const_cast<float*>(a.rb),
                           const_cast<unsigned char*>(a.ok), a.state + 1, h, w, st);
  if (e != cudaSuccess) return e;
  for (int it = 0; it < max_iters; ++it) {
    tvcsad_dual_kernel<<<dual, kDualThreads, 0, st>>>(a, h, w);
    tvcsad_primal4_kernel<L, FB><<<nparts, kErrCells * kG, 0, st>>>(a, h, w);
    tvcsad_finish_kernel<<<1, kFinishThreads, 0, st>>>(
        a.part, nparts, a.state, (double)n, tol2, max_iters);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

namespace former {

constexpr int kPrimalThreads = 128;   // four lanes a cell, 32 cells a block

// K14's primal phase before the ranking: the counting selection every PD
// iteration (csad_select.cuh, group_entries + group_select).
__global__ void __launch_bounds__(kPrimalThreads)
    tvcsad_primal_kernel(TvArgs a, int h, int w) {
  constexpr int S = kNd / kG;
  if (a.state[1] == 0) return;
  const long long n = (long long)h * w;
  const long long cell = ((long long)blockIdx.x * kPrimalThreads + threadIdx.x) / kG;
  const int g = threadIdx.x % kG;
  double e = 0.0;
  if (cell < n) {   // whole groups
    const int r = (int)(cell / w), c = (int)(cell % w);
    const float u1 = a.u1[cell], u2 = a.u2[cell];
    const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.grad[cell];
    const float dot = (gx * u1 + gy * u2) / den;
    float bv[S], av[S];
    int key[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = a.b[(g + kG * s) * n + cell];
    const int nn = group_entries<kG>(av, key, bv, r, c, h, w, dot, g);
    const float med = group_select<kG>(av, key, nn, a.lt * den, g,
                                       group_mask<kG>());
    if (g == 0) {
      const float v1 = u1 - (gx * med) / den;
      const float v2 = u2 - (gy * med) / den;
      const float div1 = div_at(a.xi11, a.xi12, r, c, h, w);
      const float div2 = div_at(a.xi21, a.xi22, r, c, h, w);
      const float nu1 = u1 - a.tau * (-div1 + (u1 - v1) / a.theta);
      const float nu2 = u2 - a.tau * (-div2 + (u2 - v2) / a.theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      e = (double)(e1 * e1 + e2 * e2);
      a.u1b[cell] = 2.0f * nu1 - u1;
      a.u2b[cell] = 2.0f * nu2 - u2;
      a.u1[cell] = nu1;
      a.u2[cell] = nu2;
    }
  }
  // the warp's 8 cells (lanes 0, 4, ..., 28) by a tree; 0 past the image
  e = e + __shfl_down_sync(0xffffffffu, e, 16);
  e = e + __shfl_down_sync(0xffffffffu, e, 8);
  e = e + __shfl_down_sync(0xffffffffu, e, 4);
  __shared__ double ws[kPrimalThreads / 32];
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = ws[0];
#pragma unroll
    for (int k = 1; k < kPrimalThreads / 32; ++k) s = s + ws[k];
    a.part[blockIdx.x] = s;
  }
}

cudaError_t tvcsad_loop(const TvArgs& a, int h, int w, float tol2, int max_iters,
                        cudaStream_t st) {
  const long long n = (long long)h * w;
  const unsigned primal = (unsigned)((n * kG + kPrimalThreads - 1) / kPrimalThreads);
  const unsigned dual = (unsigned)((n + kDualThreads - 1) / kDualThreads);
  tvcsad_init_kernel<<<1, 1, 0, st>>>(a.state, tol2, max_iters);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  for (int it = 0; it < max_iters; ++it) {
    tvcsad_dual_kernel<<<dual, kDualThreads, 0, st>>>(a, h, w);
    tvcsad_primal_kernel<<<primal, kPrimalThreads, 0, st>>>(a, h, w);
    tvcsad_finish_kernel<<<1, kFinishThreads, 0, st>>>(
        a.part, (int)primal, a.state, (double)n, tol2, max_iters);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// K15's primal phase before the ranking: K6's with the v that K8 wrote (v =
// u where grad <= GRAD_IS_ZERO, global_faldoi.cpp:1735-1737) in place of
// the threshold.
__global__ void __launch_bounds__(kTileW * kTileH, kK6Blocks)
    nltvcsad_primal_kernel(GlobalPlanes p, const float* __restrict__ v1p,
                           const float* __restrict__ v2p, int h, int w,
                           float theta, float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r >= h || c >= w) return;
  const long long i = (long long)r * w + c;
  float d1, d2;
  pair_divergence(p, r, c, h, w, &d1, &d2);
  const float a = p.u1[i], b = p.u2[i];
  const bool gok = p.grad[i] > kGradIsZero;
  const float v1 = gok ? v1p[i] : a;
  const float v2 = gok ? v2p[i] : b;
  const float wt = p.wt[i];
  d1 = d1 / wt;
  d2 = d2 / wt;
  const float nu1 = a - tau * (d1 + (a - v1) / theta);
  const float nu2 = b - tau * (d2 + (b - v2) / theta);
  p.u1b[i] = 2.0f * nu1 - a;
  p.u2b[i] = 2.0f * nu2 - b;
  p.u1[i] = nu1;
  p.u2[i] = nu2;
}

}  // namespace former

// K15's ranked v-step alone, a thread a pixel: v where grad > GRAD_IS_ZERO
// (the former primal phase reads v only there).
template <class L>
__global__ void __launch_bounds__(256, 8)
    nltvcsad_vstep_kernel(GlobalPlanes p, CsadPlanes q, float* __restrict__ v1o,
                          float* __restrict__ v2o, int h, int w) {
  const long long hw = (long long)h * w;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= hw || !(p.grad[i] > kGradIsZero)) return;
  const int r = (int)(i / w), c = (int)(i % w);
  const float a = p.u1[i], b = p.u2[i];
  const float gx = p.i1wx[i], gy = p.i1wy[i], den = q.den[i];
  const float dot = (gx * a + gy * b) / den;
  const float med = image_select<1, L, kOutOfLine>(q.rb, q.ok, q.b, hw, i, r, c, h, w, dot,
                                             q.lt * den, 0, group_mask<1>());
  v1o[i] = a - (gx * med) / den;
  v2o[i] = b - (gy * med) / den;
}

cudaError_t nltvcsad_loop3(const GlobalPlanes& p, const CsadPlanes& q, float* v1,
                           float* v2, int h, int w, float theta, float tau,
                           int max_iters, cudaStream_t st) {
  if (max_iters <= 0) return cudaSuccess;
  cudaError_t e = launch_rank_image<PixelMajor>(
      q.b, q.den, q.lt, const_cast<float*>(q.rb), const_cast<unsigned char*>(q.ok),
      nullptr, h, w, st);
  if (e != cudaSuccess) return e;
  const dim3 block(kTileW, kTileH);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const unsigned cells = (unsigned)(((long long)h * w + 255) / 256);
  for (int it = 0; it < max_iters; ++it) {
    nltv_dual_kernel<<<tiles, block, 0, st>>>(p, h, w, tau);
    nltvcsad_vstep_kernel<PixelMajor><<<cells, 256, 0, st>>>(p, q, v1, v2, h, w);
    former::nltvcsad_primal_kernel<<<tiles, block, 0, st>>>(p, v1, v2, h, w, theta,
                                                             tau);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int faldoi_k14v(int variant, float* u1, float* u2, float* u1b, float* u2b,
                           float* xi11, float* xi12, float* xi21, float* xi22,
                           const float* b, const float* i1wx, const float* i1wy,
                           const float* grad, double* part, int* state, float* rb,
                           unsigned char* ok, int h, int w, float lt, float theta,
                           float tau, float tol2, int max_iters, void* stream) {
  if (h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  TvArgs a{u1, u2, u1b, u2b, xi11, xi12, xi21, xi22, b, i1wx, i1wy, grad,
           part, state, rb, ok, lt, theta, tau};
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return (int)former::tvcsad_loop(a, h, w, tol2, max_iters, st);
    case 1:
      return (int)tvcsad_loop<PixelMajor, 256, 1, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 2:
      return (int)tvcsad_loop<PlaneMajor, 256, 1, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 3:
      return (int)tvcsad_loop4<PixelMajor, kInLine>(a, h, w, tol2, max_iters, st);
    case 4:
      return (int)tvcsad_loop4<PlaneMajor, kInLine>(a, h, w, tol2, max_iters, st);
    case 5:
      return (int)tvcsad_loop<PixelMajor, 256, 1, kInLine>(a, h, w, tol2, max_iters, st);
    case 6:
      return (int)tvcsad_loop<PixelMajor, 128, 1, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 7:
      return (int)tvcsad_loop<PixelMajor, 256, 4, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 8:
      return (int)tvcsad_loop<PlaneMajor, 256, 4, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 9:
      return (int)tvcsad_loop<PixelMajor, 256, 8, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 10:
      return (int)tvcsad_loop<PlaneMajor, 256, 8, kOutOfLine>(a, h, w, tol2, max_iters, st);
    case 11:
      return (int)tvcsad_loop<PixelMajor, 256, 4, kInLine>(a, h, w, tol2, max_iters, st);
    case 12:
      return (int)tvcsad_loop<PlaneMajor, 256, 4, kInLine>(a, h, w, tol2, max_iters, st);
    case 30:   // SASS only
      return (int)tvcsad_loop<PlaneMajor, 256, 4, kNoFallback>(a, h, w, tol2, max_iters,
                                                               st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int faldoi_k15v(int variant, float* u1, float* u2, float* u1b, float* u2b,
                           const float* wt, const float* i1wx, const float* i1wy,
                           const float* den, const float* grad, float* sp, float* sq,
                           const float* wp, const float* b, float* rb,
                           unsigned char* ok, int h, int w, float lt, float theta,
                           float tau, int max_iters, float* v1, float* v2,
                           void* stream) {
  if (h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  GlobalPlanes p{u1, u2, u1b, u2b, wt, i1wx, i1wy, grad, nullptr, sp, sq, wp};
  CsadPlanes q{b, den, rb, ok, lt};
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 1:
      return (int)nltvcsad_loop<PixelMajor, kOutOfLine>(p, q, h, w, theta, tau, max_iters, st);
    case 2:
      return (int)nltvcsad_loop<PlaneMajor, kOutOfLine>(p, q, h, w, theta, tau, max_iters, st);
    case 3:
      return (int)nltvcsad_loop<PixelMajor, kInLine>(p, q, h, w, theta, tau, max_iters,
                                                   st);
    case 4:
      return (int)nltvcsad_loop3(p, q, v1, v2, h, w, theta, tau, max_iters, st);
    case 30:   // SASS only
      return (int)nltvcsad_loop<PlaneMajor, kNoFallback>(p, q, h, w, theta, tau,
                                                         max_iters, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the former K15's step: u1 u2 u1b u2b wt v1 v2 grad (h, w) and sp sq wp
// (24, h, w); K6's dual phase, then the primal phase on v
extern "C" int faldoi_k15v_former_step(float* u1, float* u2, float* u1b, float* u2b,
                                       const float* wt, const float* v1,
                                       const float* v2, const float* grad, float* sp,
                                       float* sq, const float* wp, int h, int w,
                                       float theta, float tau, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kTileW, kTileH);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  GlobalPlanes p{u1, u2, u1b, u2b, wt, nullptr, nullptr, grad, nullptr, sp, sq, wp};
  nltv_dual_kernel<<<tiles, block, 0, st>>>(p, h, w, tau);
  former::nltvcsad_primal_kernel<<<tiles, block, 0, st>>>(p, v1, v2, h, w, theta,
                                                           tau);
  return (int)cudaGetLastError();
}
