// K14 and K15: the whole-image PD loops of the CSAD family, on a ranked
// selection.
//
// Both replace XLA-lowered loops of the JAX package:
//   K14 (tvcsad_global_loop): the while_loop of faldoi_tpu/core/
//      global_step_csad.py::_tvcsad_jit (global_step_csad.py:106-133), one
//      warp of the TV-CSAD global step (methods 4 and 5), tol-gated;
//   K15 (nltvcsad_global_loop): the fori_loop of faldoi_tpu/core/
//      global_step_csad.py::_nltvcsad_jit (global_step_csad.py:165-182),
//      one warp of the NLTV-CSAD global step (methods 6 and 7), a fixed
//      max_iters iterations.
// Both run the twins' operations in the twins' order (faldoi_tpu_torch/
// core/global_step_csad.py::tvcsad_global_loop_plain and
// nltvcsad_global_loop_plain); with --fmad=false every value rounds as
// there, and the v-step is K8's selection (csad_select.cuh), which picks
// one of the entries the twin sorts.
//
// The selection.  Within a warp b, n and l_t denom stay fixed and only dot
// moves, so each call ranks every pixel's inside b once (a launch after
// the warp's b is built: rank_entries, four lanes a pixel) into a buffer of
// 48 floats a pixel (85.7 MB at 436x1024, allocated by the wrapper once a
// call) and a byte a pixel, ok: every inside b and l_t denom finite.
// Every PD iteration a pixel then takes the merge-path search of six probes
// over its column (the argument that it finds the twin's entry, the sign
// of a zero included, is at the top of csad.cu); a pixel whose ok is clear
// or whose dot is not finite takes K8's counting path on its 48 b planes
// (csad_select.cuh, image_select) for that iteration, inside the same
// kernel.  The ranked b are plane-major (48, h, w): every interior pixel
// starts its search at the same rank, so a warp's first probes read
// consecutive addresses of one plane.  On an H100 at 436x1024
// (csrc/variants/csad_global_variants.cu, cli/k8_variants.py) that was
// 10% faster than pixel-major (h w, 48) for K14 and 5% for K15; a thread
// a pixel 1.75x faster than four lanes a pixel with lane 0 searching
// (K14); without a register cap the counting path's arrays set the whole
// kernel's registers (233: 8 warps an SM), so the primal phases take 64
// (K6's 32x8 tiles at four blocks an SM for K15, 256 threads at four
// blocks for K14); there K14 is fastest with the counting path in line,
// K15 (whose divergence fills its registers) with it out of line; K15's
// v-step as a launch of its own, three an iteration, was 13% slower.
// Time per PD iteration at 436x1024: K14 ~53 us, the bytes of u, u_bar,
// the duals and the probes ~35 us; K15 ~170 us, of it K6's step ~140 us.
//
// K14, one PD iteration per pixel (tvcsad_PD, global_faldoi.cpp:1449-1637):
//   v      = K8's v-step of u on the warp's 48 breakpoint planes b
//   xi     = (xi + tau grad+(u_bar)) / max(1, hypot(xi_1, xi_2)), per flow
//            component (tvcsad_getD, :1428-1446), hypot as pd_common.hypot
//   nu     = u - tau (-div(xi) + (u - v) / theta),  u_bar = 2 nu - u
//   err    = (the float64 sum of the float32 (nu1 - u1)^2 + (nu2 - u2)^2)
//            / (h w), rounded to float32
// and the loop runs while err > tol^2 (err starts at +inf; a NaN stops it)
// and n < max_iters.  The neighbour reads are a ring of one pixel: the
// forward gradient of u_bar (right, down) and the divergence of the new xi
// (left, up).  One call enqueues the whole loop and reads nothing back: an
// init launch, the rank launch, then three plain launches an iteration,
// the launch boundaries being the barriers:
//   dual    a thread a pixel: xi from u_bar;
//   primal  a thread a pixel: the selection, the divergence, the primal
//           step and u, u_bar in place, and the squared update in float64;
//           each run of 8 pixels is summed by a shuffle tree (offsets 4, 2,
//           1), a warp's 4 runs in order, into the warp's partial;
//   finish  one 1024-thread block: thread t sums partials t, t + 1024, ...
//           in order, each warp by a shuffle tree (offsets 16, 8, 4, 2, 1),
//           then thread 0 the 32 warps in order; it writes err, the count
//           and the run flag.
// Every launch returns at once when the flag is down, so the card stops at
// the iteration the twin does, which sums in exactly this order
// (global_step_csad.py::ordered_err: blocks of 32 pixels, four runs of 8,
// as the former four lanes a pixel in 128-thread blocks summed them).  The
// count stays on the device.
//
// K15, one PD iteration per pixel (nltvcsad_PD, global_faldoi.cpp:
// 1642-1808): K6's dual phase (nltv_global.cuh: the 24 non-local duals of
// each component from u_bar), then a primal phase, a thread a pixel in
// K6's 32x8 tiles: the divergence by reciprocal pairs over wt, v by the
// selection where grad > GRAD_IS_ZERO (v = u elsewhere, :1735-1737; the
// selection is skipped there), the primal step, u and u_bar in place.  One
// call enqueues the rank launch and two launches an iteration; no v planes
// are written and nothing is read back.

#include "csad_select.cuh"
#include "nltv_global.cuh"

namespace {

using Layout = PlaneMajor;                   // the ranked b's
constexpr int kPrimalThreads = 256;          // K14's primal: a thread a pixel,
constexpr int kPrimalBlocks = 4;             // four blocks an SM: 64 registers
constexpr int kDualThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kErrCells = 32;                // pixels a partial of err

// ---------------------------------------------------------------------------
// K14

struct TvArgs {
  float* u1;       // (h, w) each, in place
  float* u2;
  float* u1b;
  float* u2b;
  float* xi11;
  float* xi12;
  float* xi21;
  float* xi22;
  const float* __restrict__ b;      // (48, h, w)
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ grad;   // the v-step's denominator
  double* part;    // a partial a run of 32 pixels
  int* state;      // the count, the run flag, err's bits
  const float* __restrict__ rb;            // the ranked b, 48 floats a pixel
  const unsigned char* __restrict__ ok;    // a byte a pixel
  float lt;
  float theta;
  float tau;
};

// pd_common.hypot: max * sqrt(1 + (min / max)^2), +inf where either is
// infinite, 0 where both are 0, NaN where either is NaN (and neither
// infinite), the root correctly rounded
__device__ __forceinline__ float hypot_rn(float x, float y) {
  const float a = fabsf(x), b = fabsf(y);
  if (isinf(a) || isinf(b)) return __int_as_float(kInfKey);
  if (isnan(a) || isnan(b)) return a + b;
  const float hi = a > b ? a : b, lo = a > b ? b : a;
  if (hi == 0.0f) return hi;
  const float q = lo / hi;
  return hi * __fsqrt_rn(1.0f + q * q);
}

// clamp(min=1), keeping a NaN
__device__ __forceinline__ float at_least_one(float x) {
  return x < 1.0f ? 1.0f : x;
}

// Backward-difference divergence with Chambolle boundaries (mask.c:39-83),
// the twins' stencils.divergence: w, h >= 3.
__device__ __forceinline__ float div_at(const float* vx, const float* vy,
                                        int r, int c, int h, int w) {
  const long long i = (long long)r * w + c;
  const float dx = c == 0 ? vx[i] : (c == w - 1 ? -vx[i - 1] : vx[i] - vx[i - 1]);
  const float dy = r == 0 ? vy[i] : (r == h - 1 ? -vy[i - w] : vy[i] - vy[i - w]);
  return dx + dy;
}

__global__ void tvcsad_init_kernel(int* state, float tol2, int max_iters) {
  state[0] = 0;
  state[1] = __int_as_float(kInfKey) > tol2 && max_iters > 0;
  state[2] = kInfKey;
}

// xi from the forward gradient of u_bar, per flow component.
__global__ void __launch_bounds__(kDualThreads)
    tvcsad_dual_kernel(TvArgs a, int h, int w) {
  if (a.state[1] == 0) return;
  const long long i = (long long)blockIdx.x * kDualThreads + threadIdx.x;
  if (i >= (long long)h * w) return;
  const int r = (int)(i / w), c = (int)(i % w);
  const float b1 = a.u1b[i], b2 = a.u2b[i];
  const float u1x = c < w - 1 ? a.u1b[i + 1] - b1 : 0.0f;
  const float u1y = r < h - 1 ? a.u1b[i + w] - b1 : 0.0f;
  const float u2x = c < w - 1 ? a.u2b[i + 1] - b2 : 0.0f;
  const float u2y = r < h - 1 ? a.u2b[i + w] - b2 : 0.0f;
  const float x11 = a.xi11[i], x12 = a.xi12[i], x21 = a.xi21[i],
              x22 = a.xi22[i];
  const float n1 = at_least_one(hypot_rn(x11, x12));
  const float n2 = at_least_one(hypot_rn(x21, x22));
  a.xi11[i] = (x11 + a.tau * u1x) / n1;
  a.xi12[i] = (x12 + a.tau * u1y) / n1;
  a.xi21[i] = (x21 + a.tau * u2x) / n2;
  a.xi22[i] = (x22 + a.tau * u2y) / n2;
}

// The primal step of pixel `cell` after its selection med; returns the
// squared update.
__device__ __forceinline__ double tvcsad_primal_step(const TvArgs& a, long long cell,
                                                     int r, int c, int h, int w,
                                                     float u1, float u2, float gx,
                                                     float gy, float den, float med) {
  const float v1 = u1 - (gx * med) / den;
  const float v2 = u2 - (gy * med) / den;
  const float div1 = div_at(a.xi11, a.xi12, r, c, h, w);
  const float div2 = div_at(a.xi21, a.xi22, r, c, h, w);
  const float nu1 = u1 - a.tau * (-div1 + (u1 - v1) / a.theta);
  const float nu2 = u2 - a.tau * (-div2 + (u2 - v2) / a.theta);
  const float e1 = nu1 - u1, e2 = nu2 - u2;
  a.u1b[cell] = 2.0f * nu1 - u1;
  a.u2b[cell] = 2.0f * nu2 - u2;
  a.u1[cell] = nu1;
  a.u2[cell] = nu2;
  return (double)(e1 * e1 + e2 * e2);
}

// The v-step by the ranked selection, the primal step and the warp's
// partial of the squared updates, a thread a pixel (T a block, at least
// MINB blocks an SM: the counting path would otherwise set the kernel's
// registers, in line or out of line); L: the ranked b's layout, FB: where
// the counting path goes (csad_select.cuh).
template <int T, int MINB, class L, int FB>
__global__ void __launch_bounds__(T, MINB) tvcsad_primal_kernel(TvArgs a, int h,
                                                                int w) {
  if (a.state[1] == 0) return;
  const long long n = (long long)h * w;
  const long long cell = (long long)blockIdx.x * T + threadIdx.x;
  double e = 0.0;
  if (cell < n) {
    const int r = (int)(cell / w), c = (int)(cell % w);
    const float u1 = a.u1[cell], u2 = a.u2[cell];
    const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.grad[cell];
    const float dot = (gx * u1 + gy * u2) / den;
    const float med = image_select<1, L, FB>(a.rb, a.ok, a.b, n, cell, r, c, h, w,
                                              dot, a.lt * den, 0, group_mask<1>());
    e = tvcsad_primal_step(a, cell, r, c, h, w, u1, u2, gx, gy, den, med);
  }
  // each run of 8 pixels by a tree, then the warp's 4 runs in order; 0 past
  // the image
  e = e + __shfl_down_sync(0xffffffffu, e, 4);
  e = e + __shfl_down_sync(0xffffffffu, e, 2);
  e = e + __shfl_down_sync(0xffffffffu, e, 1);
  const double e8 = __shfl_sync(0xffffffffu, e, 8);
  const double e16 = __shfl_sync(0xffffffffu, e, 16);
  const double e24 = __shfl_sync(0xffffffffu, e, 24);
  if ((threadIdx.x & 31) == 0 && cell < n) a.part[cell / kErrCells] = ((e + e8) + e16) + e24;
}

// err from the partials in a fixed order; the count and the run flag.
__global__ void __launch_bounds__(kFinishThreads)
    tvcsad_finish_kernel(const double* part, int nparts, int* state, double hw,
                         float tol2, int max_iters) {
  if (state[1] == 0) return;
  double s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += kFinishThreads) s = s + part[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = s + __shfl_down_sync(0xffffffffu, s, off);
  __shared__ double ws[kFinishThreads / 32];
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x != 0) return;
  double t = ws[0];
  for (int k = 1; k < kFinishThreads / 32; ++k) t = t + ws[k];
  const float err = __double2float_rn(t / hw);
  const int it = state[0] + 1;
  state[0] = it;
  state[2] = __float_as_int(err);
  state[1] = err > tol2 && it < max_iters;
}

// The whole loop of one warp, the primal phase a thread a pixel in blocks
// of PT, MINB of them an SM at least, on the ranked b in layout L: init,
// rank, then dual, primal, finish an iteration.
template <class L, int PT, int MINB, int FB>
cudaError_t tvcsad_loop(const TvArgs& a, int h, int w, float tol2, int max_iters,
                        cudaStream_t st) {
  const long long n = (long long)h * w;
  const unsigned dual = (unsigned)((n + kDualThreads - 1) / kDualThreads);
  const int nparts = (int)((n + kErrCells - 1) / kErrCells);
  const unsigned primal = (unsigned)((n + PT - 1) / PT);
  tvcsad_init_kernel<<<1, 1, 0, st>>>(a.state, tol2, max_iters);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || max_iters <= 0) return e;
  e = launch_rank_image<L>(a.b, a.grad, a.lt, const_cast<float*>(a.rb),
                           const_cast<unsigned char*>(a.ok), a.state + 1, h, w, st);
  if (e != cudaSuccess) return e;
  for (int it = 0; it < max_iters; ++it) {
    tvcsad_dual_kernel<<<dual, kDualThreads, 0, st>>>(a, h, w);
    tvcsad_primal_kernel<PT, MINB, L, FB><<<primal, PT, 0, st>>>(a, h, w);
    tvcsad_finish_kernel<<<1, kFinishThreads, 0, st>>>(
        a.part, nparts, a.state, (double)n, tol2, max_iters);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K15

struct CsadPlanes {
  const float* __restrict__ b;             // (48, h, w)
  const float* __restrict__ den;           // the breakpoints' denominator
  const float* __restrict__ rb;            // the ranked b, 48 floats a pixel
  const unsigned char* __restrict__ ok;    // a byte a pixel
  float lt;
};

// The primal phase of one iteration, a thread a pixel: the divergence by
// reciprocal pairs, v by the ranked selection where grad > GRAD_IS_ZERO
// (else v = u), the primal step.
template <class L, int FB>
__global__ void __launch_bounds__(kTileW * kTileH, kK6Blocks)
    nltvcsad_primal_kernel(GlobalPlanes p, CsadPlanes q, int h, int w, float theta,
                           float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r >= h || c >= w) return;
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  float d1, d2;
  pair_divergence(p, r, c, h, w, &d1, &d2);
  const float a = p.u1[i], b = p.u2[i];
  float v1 = a, v2 = b;
  if (p.grad[i] > kGradIsZero) {
    const float gx = p.i1wx[i], gy = p.i1wy[i], den = q.den[i];
    const float dot = (gx * a + gy * b) / den;
    const float med = image_select<1, L, FB>(q.rb, q.ok, q.b, hw, i, r, c, h, w, dot,
                                              q.lt * den, 0, group_mask<1>());
    v1 = a - (gx * med) / den;
    v2 = b - (gy * med) / den;
  }
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

template <class L, int FB>
cudaError_t nltvcsad_loop(const GlobalPlanes& p, const CsadPlanes& q, int h, int w,
                          float theta, float tau, int max_iters, cudaStream_t st) {
  if (max_iters <= 0) return cudaSuccess;
  cudaError_t e = launch_rank_image<L>(q.b, q.den, q.lt, const_cast<float*>(q.rb),
                                       const_cast<unsigned char*>(q.ok), nullptr, h,
                                       w, st);
  if (e != cudaSuccess) return e;
  const dim3 block(kTileW, kTileH);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  for (int it = 0; it < max_iters; ++it) {
    nltv_dual_kernel<<<tiles, block, 0, st>>>(p, h, w, tau);
    nltvcsad_primal_kernel<L, FB><<<tiles, block, 0, st>>>(p, q, h, w, theta, tau);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// K14: u1 u2 u1b u2b xi11 xi12 xi21 xi22 (h, w) in place, b (48, h, w),
// i1wx i1wy grad (h, w); part: ceil(h w / 32) doubles of scratch; state: 3
// ints (the count, the run flag, err's bits), the count read by the
// caller; rb (h w 48 floats) and ok (h w bytes): scratch for the ranked b.
// h, w >= 3.  The whole loop enqueued on the stream.
extern "C" int faldoi_tvcsad_global_loop(
    float* u1, float* u2, float* u1b, float* u2b, float* xi11, float* xi12,
    float* xi21, float* xi22, const float* b, const float* i1wx,
    const float* i1wy, const float* grad, double* part, int* state, float* rb,
    unsigned char* ok, int h, int w, float lt, float theta, float tau, float tol2,
    int max_iters, void* stream) {
  if (h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  TvArgs a{u1, u2, u1b, u2b, xi11, xi12, xi21, xi22, b, i1wx, i1wy, grad,
           part, state, rb, ok, lt, theta, tau};
  return (int)tvcsad_loop<Layout, kPrimalThreads, kPrimalBlocks, kInLine>(
      a, h, w, tol2, max_iters, (cudaStream_t)stream);
}

// K15: u1 u2 u1b u2b wt i1wx i1wy den grad (h, w) in place where written,
// sp sq wp (24, h, w), wp symmetric (planes 0-11 are read), b (48, h, w);
// rb (h w 48 floats) and ok (h w bytes): scratch for the ranked b.  h, w
// >= 3.  The whole loop enqueued on the stream.
extern "C" int faldoi_nltvcsad_global_loop(
    float* u1, float* u2, float* u1b, float* u2b, const float* wt,
    const float* i1wx, const float* i1wy, const float* den, const float* grad,
    float* sp, float* sq, const float* wp, const float* b, float* rb,
    unsigned char* ok, int h, int w, float lt, float theta, float tau, int max_iters,
    void* stream) {
  if (h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  GlobalPlanes p{u1, u2, u1b, u2b, wt, i1wx, i1wy, grad, nullptr, sp, sq, wp};
  CsadPlanes q{b, den, rb, ok, lt};
  return (int)nltvcsad_loop<Layout, kOutOfLine>(p, q, h, w, theta, tau, max_iters,
                                         (cudaStream_t)stream);
}
