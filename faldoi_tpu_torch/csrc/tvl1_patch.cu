// K12: the TV-L1 patch solve of methods 0 and 1 (plain and Gaussian-
// weighted), every warp's PD loop and the energy, in one launch a call.
//
// Replaces the XLA-lowered faldoi_tpu/core/functionals.py::
// _solve_tvl1_family (with _bounded_pd_loop and core/pd_common.py's
// tvl1_threshold, tvl2_getD and tvl2_getP), which JAX vmaps over the
// patches of a sweep (_sweep_body's solve) and of the seed insertion.  The
// plain twin is faldoi_tpu_torch/core/functionals.py::
// _solve_tvl1_family_plain; every step below follows its operation order,
// so with --fmad=false (and IEEE division and square root) the two are equal
// bit for bit.  Per canvas (a patch of P x P cells, valid box [0, ph) x [0,
// pw) at image origin (oy, ox)):
//   1. the source crop from i0pad as K0's stack form cuts it (a negative
//      origin counts from the padded end, then clamps so the window fits),
//      from the patch's own lane;
//   2. each warp: (I1, I1x, I1y) sampled at the cells' displaced points
//      exactly as K4's patch form samples them (bicubic_common.cuh, shared
//      with bicubic.cu), then grad = I1x^2 + I1y^2 and rho_c = I1w - I1x u1
//      - I1y u2 - I0;
//   3. the tol-gated PD loop, at most max_iters steps, while err > tol^2
//      (err starts at +inf; a NaN stops it; the twin's masked unroll): the
//      three-way threshold (l_t a cell for method 1: lambda theta W, W the
//      window product of _weight2d with its clamped indices), the forward
//      gradients of u_bar on the box, getD with its correctly rounded norm
//      clamped at 1, the divergence of the new xi with Chambolle's box
//      edges, getP, u_bar = 2 u - u_old, err = the maximum squared update
//      over the box; xi and v carry over to the next warp, u_bar restarts
//      from u;
//   4. the energy: lambda |I1(u) - I0| (x W for method 1) + (1 / (2 theta))
//      |u - v|^2 + |grad u| on the box, u masked to it, summed over each row's
//      columns, then over the rows (canvas_sum), divided by ph * pw.
// The solved canvases come back zero outside the box.
//
// Design: a canvas a group of whole warps (128 threads at P 11, 32 at P 3),
// one thread a cell, two canvases a 256-thread block at P 11 and eight at
// P 3; only the cells inside the box compute, as nothing inside reads a
// cell outside it.  A thread keeps its cell's state (u, v, xi, the warp
// constants, l_t) in registers; u_bar and xi, which neighbours read, are
// mirrored in shared memory.  A PD step has two barriers: one before the
// dual half (it reads u_bar at the right and below) and one before the
// primal half (it reads the new xi at the left and above).  err is a warp
// max of the squared updates' bits (they are >= 0, so the bit order is the
// value order and a NaN's bits win), folded into the canvas's slot with a
// shared atomicMax; two slots alternate.  A canvas that stops keeps its
// state; the block leaves the loop when none of its canvases runs (the
// second barrier's vote).  The launch replaces K0's stack crop, the two K4
// patch-form samples and ~650 small ops a call.
//
// Bound on the H100: the 16 taps of 3 planes a cell a warp are L1/L2
// reads; device-memory bytes are the canvases in and out (~5 floats a
// cell); operations ~90 a cell a PD step.  In practice the barriers and the
// dependent IEEE divisions and square roots of a step.

#include <cuda_runtime.h>
#include <math.h>

#include "bicubic_common.cuh"

namespace {

constexpr float kGradIsZero = 1e-8f;   // params.GRAD_IS_ZERO
constexpr int kSolveThreads = 256;     // threads a block at most, P <= 16
constexpr int kMaxThreads = 1024;      // one canvas of P 32

struct SolveArgs {
  const float* __restrict__ i0pad;     // (L,) H' x W'
  const float* __restrict__ i1s;       // (L,) 3 x h x w: I1, I1x, I1y
  const long long* __restrict__ ci;    // (B,) patch centre column
  const long long* __restrict__ cj;    // (B,) patch centre row
  const long long* __restrict__ oy;    // (B,) canvas origin
  const long long* __restrict__ ox;
  const long long* __restrict__ ph;    // (B,) valid box
  const long long* __restrict__ pw;
  const long long* __restrict__ lane;  // (B,) or null
  const float* __restrict__ u1;        // (B, P, P) init
  const float* __restrict__ u2;
  const float* __restrict__ lam;       // 0-d scalars on the card
  const float* __restrict__ theta;
  const float* __restrict__ tau;
  const float* __restrict__ tol;
  const float* __restrict__ w1d;       // (>= 2 wr + 1,) or null (method 0)
  float* __restrict__ u1o;
  float* __restrict__ u2o;
  float* __restrict__ ener;            // (B,)
  int hp, wp, h, w, b, p, wr, warps, max_iters;
};

__host__ __device__ constexpr int canvas_threads(int p) {
  return (p * p + 31) / 32 * 32;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The box divergence of (vx, vy) at cell t = (r, c) with Chambolle's edges
// (utils.cpp:63-112): (x, y) are the cell's own values, the left and upper
// neighbours' are read from shared memory.
__device__ __forceinline__ float div_cell(const float* vx, const float* vy,
                                          float x, float y, int t, int r,
                                          int c, int p, int bh, int bw) {
  const float dx = c == 0 ? x : (c == bw - 1 ? -vx[t - 1] : x - vx[t - 1]);
  const float dy = r == 0 ? y : (r == bh - 1 ? -vy[t - p] : y - vy[t - p]);
  return dx + dy;
}

// NaN-keeping max of two squared updates' bits as unsigned integers
__device__ __forceinline__ unsigned warp_max_bits(unsigned bits) {
  return __reduce_max_sync(0xffffffffu, bits);
}

// P > 0: the patch side at compile time; P = -1: any side whose canvas
// fits kSolveThreads; P = 0: any side up to 32.
template <int P>
__global__ void __launch_bounds__(P != 0 ? kSolveThreads : kMaxThreads)
    tvl1_patch_kernel(SolveArgs a, int cpb) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : a.p;
  const int pp = p * p;
  const int cs = canvas_threads(p);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;     // this thread's cell
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < a.b;
  // shared: per canvas u_bar (2 pp), xi (4 pp), then 2 err slots a canvas
  float* sb1 = smem + (size_t)(lc < cpb ? lc : 0) * 6 * pp;
  float* sb2 = sb1 + pp;
  float* s11 = sb2 + pp;
  float* s12 = s11 + pp;
  float* s21 = s12 + pp;
  float* s22 = s21 + pp;
  unsigned* slots =
      reinterpret_cast<unsigned*>(smem + (size_t)cpb * 6 * pp) +
      2 * (lc < cpb ? lc : 0);
  const int r = t / p, c = t - (t / p) * p;
  int bh = 0, bw = 0, oy = 0, ox = 0;
  long long ln = 0;
  if (canvas) {
    bh = (int)a.ph[k];
    bw = (int)a.pw[k];
    oy = (int)a.oy[k];
    ox = (int)a.ox[k];
    ln = a.lane != nullptr ? a.lane[k] : 0;
  }
  const bool inb = canvas && t < pp && r < bh && c < bw;
  const float lam = *a.lam, theta = *a.theta, tau = *a.tau, tol = *a.tol;
  const float tol2 = tol * tol;
  const long long at = (long long)k * pp + t;

  // 1. the source crop (K0's stack form) and the weight of the cell
  float i0 = 0.0f, lt = lam * theta, wgt = 1.0f;
  float u1 = 0.0f, u2 = 0.0f;
  if (inb) {
    int oyc = oy < 0 ? oy + a.hp : oy, oxc = ox < 0 ? ox + a.wp : ox;
    oyc = clampi(oyc, 0, a.hp - p);
    oxc = clampi(oxc, 0, a.wp - p);
    i0 = a.i0pad[ln * a.hp * a.wp + (long long)(oyc + r) * a.wp + (oxc + c)];
    if (a.w1d != nullptr) {
      const int cj = (int)a.cj[k], ci = (int)a.ci[k];
      const int ridx = clampi(oy + r - cj + a.wr, 0, 2 * a.wr);
      const int cidx = clampi(ox + c - ci + a.wr, 0, 2 * a.wr);
      wgt = a.w1d[ridx] * a.w1d[cidx];
      lt = lt * wgt;
    }
    u1 = a.u1[at];
    u2 = a.u2[at];
  }
  const float* i1 = a.i1s + ln * 3LL * a.h * a.w;
  const long long plane = (long long)a.h * a.w;
  float x11 = 0.0f, x12 = 0.0f, x21 = 0.0f, x22 = 0.0f;
  float v1 = u1, v2 = u2;

  for (int warp = 0; warp < a.warps; ++warp) {
    // 2. the warp constants at the cell's displaced point
    float gx = 0.0f, gy = 0.0f, grad = 0.0f, rho_c = 0.0f;
    if (inb) {
      int wx0, wy0;
      float wx[4], wy[4];
      patch_cell_weights(oy, ox, r, c, u1, u2, a.h, a.w, &wx0, &wy0, wx, wy);
      const float* win = i1 + (long long)wy0 * a.w + wx0;
      const float i1w = contract(win, a.w, wy, wx);
      gx = contract(win + plane, a.w, wy, wx);
      gy = contract(win + 2 * plane, a.w, wy, wx);
      grad = gx * gx + gy * gy;
      rho_c = ((i1w - gx * u1) - gy * u2) - i0;
      sb1[t] = u1;
      sb2[t] = u2;
    }
    // 3. the PD loop
    bool run = canvas;
    float err = __int_as_float(0x7f800000);   // +inf
    for (int it = 0; it < a.max_iters; ++it) {
      __syncthreads();   // u_bar and the last step's err are in place
      if (run && it > 0) {
        err = __uint_as_float(slots[(it - 1) & 1]);
      }
      run = run && err > tol2;
      float nv1 = 0.0f, nv2 = 0.0f;
      if (run && inb) {
        // threshold (tvl2_model.cpp:364-391)
        const float rho = (rho_c + gx * u1) + gy * u2;
        const float fi = grad < kGradIsZero
                             ? 0.0f
                             : __fdiv_rn(-rho, grad == 0.0f ? 1.0f : grad);
        const bool lo = rho < -lt * grad;
        const bool hi = rho > lt * grad;
        const float d1 = lo ? lt * gx : (hi ? -lt * gx : fi * gx);
        const float d2 = lo ? lt * gy : (hi ? -lt * gy : fi * gy);
        nv1 = u1 + d1;
        nv2 = u2 + d2;
        // forward gradients of u_bar on the box, getD (tvl2_model.cpp:82-118)
        const float b1 = sb1[t], b2 = sb2[t];
        const float u1x = c < bw - 1 ? sb1[t + 1] - b1 : 0.0f;
        const float u1y = r < bh - 1 ? sb1[t + p] - b1 : 0.0f;
        const float u2x = c < bw - 1 ? sb2[t + 1] - b2 : 0.0f;
        const float u2y = r < bh - 1 ? sb2[t + p] - b2 : 0.0f;
        float n = __fsqrt_rn(((x11 * x11 + x12 * x12) + x21 * x21) + x22 * x22);
        n = n < 1.0f ? 1.0f : n;   // clamp(min=1) keeping NaN, as the twin
        x11 = __fdiv_rn(x11 + tau * u1x, n);
        x12 = __fdiv_rn(x12 + tau * u1y, n);
        x21 = __fdiv_rn(x21 + tau * u2x, n);
        x22 = __fdiv_rn(x22 + tau * u2y, n);
        s11[t] = x11;
        s12[t] = x12;
        s21[t] = x21;
        s22[t] = x22;
      }
      if (canvas && t == 0) slots[it & 1] = 0u;
      if (!__syncthreads_or(run)) break;   // the new xi is in place
      unsigned bits = 0u;
      if (run && inb) {
        // divergence of the new xi (utils.cpp:63-112), getP (:122-172)
        const float div1 = div_cell(s11, s12, x11, x12, t, r, c, p, bh, bw);
        const float div2 = div_cell(s21, s22, x21, x22, t, r, c, p, bh, bw);
        const float nu1 = u1 - tau * (-div1 + __fdiv_rn(u1 - nv1, theta));
        const float nu2 = u2 - tau * (-div2 + __fdiv_rn(u2 - nv2, theta));
        const float e1 = nu1 - u1, e2 = nu2 - u2;
        bits = __float_as_uint(e1 * e1 + e2 * e2);
        sb1[t] = 2.0f * nu1 - u1;
        sb2[t] = 2.0f * nu2 - u2;
        u1 = nu1;
        u2 = nu2;
        v1 = nv1;
        v2 = nv2;
      }
      bits = warp_max_bits(bits);
      if (run && (threadIdx.x & 31) == 0) atomicMax(slots + (it & 1), bits);
    }
    __syncthreads();   // every read of u_bar and xi is done
  }

  // 4. the energy (tvl2_model.cpp:174-243; tvl2w_model.cpp:227)
  float val = 0.0f;
  const float m1 = inb ? u1 : 0.0f, m2 = inb ? u2 : 0.0f;
  if (inb) {
    sb1[t] = m1;
    sb2[t] = m2;
  }
  __syncthreads();
  if (inb) {
    const float u1x = c < bw - 1 ? sb1[t + 1] - m1 : 0.0f;
    const float u1y = r < bh - 1 ? sb1[t + p] - m1 : 0.0f;
    const float u2x = c < bw - 1 ? sb2[t + 1] - m2 : 0.0f;
    const float u2y = r < bh - 1 ? sb2[t + p] - m2 : 0.0f;
    int wx0, wy0;
    float wx[4], wy[4];
    patch_cell_weights(oy, ox, r, c, m1, m2, a.h, a.w, &wx0, &wy0, wx, wy);
    const float i1w = contract(i1 + (long long)wy0 * a.w + wx0, a.w, wy, wx);
    float dt = lam * fabsf(i1w - i0);
    if (a.w1d != nullptr) dt = dt * wgt;
    const float e1 = m1 - v1, e2 = m2 - v2;
    const float dc = __fdiv_rn(1.0f, 2.0f * theta) * (e1 * e1 + e2 * e2);
    const float g =
        __fsqrt_rn(((u1x * u1x + u1y * u1y) + u2x * u2x) + u2y * u2y);
    val = (dc + dt) + g;
  }
  if (canvas && t < pp) s11[t] = val;
  __syncthreads();
  if (canvas && t < p) {   // canvas_sum: row t over its columns, one warp
    float s = s11[t * p];
    for (int cx = 1; cx < p; ++cx) s = s + s11[t * p + cx];
    const unsigned mask = p == 32 ? 0xffffffffu : (1u << p) - 1u;
    float tot = __shfl_sync(mask, s, 0);   // then over the rows
    for (int rr = 1; rr < p; ++rr) tot = tot + __shfl_sync(mask, s, rr);
    if (t == 0) a.ener[k] = __fdiv_rn(tot, (float)(bh * bw));
  }
  if (canvas && t < pp) {
    a.u1o[at] = m1;
    a.u2o[at] = m2;
  }
}

template <int P>
cudaError_t launch_solve(const SolveArgs& a, cudaStream_t st) {
  const int cs = canvas_threads(a.p);
  const int cpb = kSolveThreads / cs > 0 ? kSolveThreads / cs : 1;
  const size_t smem = (size_t)cpb * (6 * a.p * a.p * sizeof(float) +
                                     2 * sizeof(unsigned));
  const unsigned grid = (unsigned)((a.b + cpb - 1) / cpb);
  tvl1_patch_kernel<P><<<grid, cpb * cs, smem, st>>>(a, cpb);
  return cudaGetLastError();
}

}  // namespace

// i0pad (L, hp, wp), i1s (L, 3, h, w) (L = 1 without a lane index); the
// (B,) int64 vectors ci cj oy ox ph pw and lane (or null); u1, u2 (B, p, p);
// lam theta tau tol 0-d float32 on the card; w1d the window (method 1) or
// null (method 0); outputs u1o, u2o (B, p, p) and ener (B,).
extern "C" int faldoi_tvl1_patch_solve(
    const float* i0pad, const float* i1s, const long long* ci,
    const long long* cj, const long long* oy, const long long* ox,
    const long long* ph, const long long* pw, const long long* lane,
    const float* u1, const float* u2, const float* lam, const float* theta,
    const float* tau, const float* tol, const float* w1d, float* u1o,
    float* u2o, float* ener, int hp, int wp, int h, int w, int b, int p,
    int wr, int warps, int max_iters, void* stream) {
  if (b <= 0) return 0;
  if (p <= 0 || p * p > 1024 || p > hp || p > wp || h < 4 || w < 4)
    return (int)cudaErrorInvalidValue;
  SolveArgs a{i0pad, i1s, ci, cj, oy, ox, ph, pw, lane, u1, u2, lam, theta,
              tau, tol, w1d, u1o, u2o, ener, hp, wp, h, w, b, p, wr, warps,
              max_iters};
  cudaStream_t st = (cudaStream_t)stream;
  if (p == 11) return (int)launch_solve<11>(a, st);
  if (p == 3) return (int)launch_solve<3>(a, st);
  if (canvas_threads(p) <= kSolveThreads) return (int)launch_solve<-1>(a, st);
  return (int)launch_solve<0>(a, st);
}
