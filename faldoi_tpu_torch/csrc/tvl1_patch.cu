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
// Design: a canvas is a group of G threads (whole warps), each thread
// holding CELLS cells t = (thread in the group) + G j in registers (u, v,
// xi, the warp constants, l_t); u_bar and xi, which neighbours read, are
// mirrored in the group's shared memory.  A PD step has two barriers of the
// group only: one before the dual half (it reads u_bar at the right and
// below) and one before the primal half (it reads the new xi at the left
// and above).  A group of one warp syncs with __syncwarp() and takes err
// from the warp's max of the squared updates' bits (they are >= 0, so the
// bit order is the value order and a NaN's bits win); a larger group syncs
// on a named barrier of its own (bar.sync 1 + its slot, G threads) and
// folds the warps' maxima into one of two alternating shared slots with an
// atomicMax.  No canvas waits on another, and a canvas whose err falls to
// tol^2 leaves its loop at once.  Only the cells inside the box compute, as
// nothing inside reads a cell outside it, and no cell runs a division or a
// root whose result is known exactly (kSkip, div_rn).  The layouts (G,
// CELLS, canvases a block, the launch bounds) were measured against each
// other and against the former form, a 256-thread block of two canvases
// on block barriers, by faldoi_tpu_torch/cli/patch_variants.py
// (csrc/variants/patch_variants.cu); the library launches the fastest
// bit-equal one (launch_library).  The launch replaces K0's stack crop,
// the two K4 patch-form samples and ~650 small ops a call.
//
// Bound on the H100: the 16 taps of 3 planes a cell a warp are L1/L2
// reads; device-memory bytes are the canvases in and out (~5 floats a
// cell); operations ~90 a cell a PD step.  In practice the instructions a
// step issues: up to 7 IEEE divisions and a square root, each a sequence
// of ~10, are about a third of a step's ~270.

#include <cuda_runtime.h>
#include <math.h>

#include "bicubic_common.cuh"

namespace {

constexpr float kGradIsZero = 1e-8f;   // params.GRAD_IS_ZERO
constexpr int kMaxThreads = 1024;      // one canvas of P 32
constexpr int kGenericThreads = 256;   // threads a block at most, P <= 16

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

// How a kernel divides and takes the root: kIeee, every division and root
// as the IEEE sequence; kSkip, the same but without the divisions and the
// root whose results are known exactly (the norm of xi is 1 where its square
// is <= 1, a quotient by 1 is its numerator, the threshold's quotient is
// only used between its two bounds): bit-equal; kFast, the approximate
// instructions instead (a timing variant only, never on a path, not
// bit-equal), to size their share of the time.
constexpr int kIeee = 0, kFast = 1, kSkip = 2;

template <int MODE>
__device__ __forceinline__ float div_rn(float x, float y) {
  return MODE == kFast ? __fdividef(x, y) : __fdiv_rn(x, y);
}

template <int MODE>
__device__ __forceinline__ float sqrt_rn(float x) {
  if (MODE == kFast) {
    float r;
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  }
  return __fsqrt_rn(x);
}

// The barrier of one canvas's g threads: the warp's own for one warp, else
// the named barrier id.
__device__ __forceinline__ void canvas_sync(int g, int id) {
  if (g == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(g) : "memory");
}

// P > 0: the patch side, a canvas on G threads with CELLS cells each and
// CPB canvases a block, all at compile time; P = 0: any side up to 32, a
// canvas on canvas_threads(p) threads (one cell each), cpb of them a block.
// MODE: kIeee, kSkip or kFast (div_rn).
template <int P, int G, int CELLS, int CPB, int MODE, int MINB>
__global__ void __launch_bounds__(P > 0 ? G * CPB : kMaxThreads, MINB)
    tvl1_patch_kernel(SolveArgs a, int g_rt, int cpb_rt) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : a.p;
  const int pp = p * p;
  const int g = P > 0 ? G : g_rt;            // threads a canvas
  const int cpb = P > 0 ? CPB : cpb_rt;
  const int lc = threadIdx.x / g;            // the canvas's slot in the block
  const int gt = threadIdx.x - lc * g;       // the thread in the canvas
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = k < a.b;
  const int bar = 1 + lc;
  // shared, a canvas: u_bar (2 pp), xi (4 pp), 2 err slots
  float* sb1 = smem + (size_t)lc * (6 * pp + 2);
  float* sb2 = sb1 + pp;
  float* s11 = sb2 + pp;
  float* s12 = s11 + pp;
  float* s21 = s12 + pp;
  float* s22 = s21 + pp;
  unsigned* slots = reinterpret_cast<unsigned*>(s22 + pp);
  int bh = 0, bw = 0, oy = 0, ox = 0;
  long long ln = 0;
  if (canvas) {
    bh = (int)a.ph[k];
    bw = (int)a.pw[k];
    oy = (int)a.oy[k];
    ox = (int)a.ox[k];
    ln = a.lane != nullptr ? a.lane[k] : 0;
  }
  const float lam = *a.lam, theta = *a.theta, tau = *a.tau, tol = *a.tol;
  const float tol2 = tol * tol;
  const float* i1 = a.i1s + ln * 3LL * a.h * a.w;
  const long long plane = (long long)a.h * a.w;

  // 1. the source crop (K0's stack form), the weight and the init of each
  // of this thread's cells
  int tt[CELLS], rr[CELLS], cc[CELLS];
  bool inb[CELLS];
  float i0[CELLS], lt[CELLS], wgt[CELLS], u1[CELLS], u2[CELLS], v1[CELLS],
      v2[CELLS], x11[CELLS], x12[CELLS], x21[CELLS], x22[CELLS];
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    const int t = gt + g * j;
    tt[j] = t;
    rr[j] = t / p;
    cc[j] = t - rr[j] * p;
    inb[j] = canvas && t < pp && rr[j] < bh && cc[j] < bw;
    i0[j] = 0.0f;
    lt[j] = lam * theta;
    wgt[j] = 1.0f;
    u1[j] = 0.0f;
    u2[j] = 0.0f;
    if (inb[j]) {
      int oyc = oy < 0 ? oy + a.hp : oy, oxc = ox < 0 ? ox + a.wp : ox;
      oyc = clampi(oyc, 0, a.hp - p);
      oxc = clampi(oxc, 0, a.wp - p);
      i0[j] = a.i0pad[ln * a.hp * a.wp + (long long)(oyc + rr[j]) * a.wp +
                      (oxc + cc[j])];
      if (a.w1d != nullptr) {
        const int cj = (int)a.cj[k], ci = (int)a.ci[k];
        const int ridx = clampi(oy + rr[j] - cj + a.wr, 0, 2 * a.wr);
        const int cidx = clampi(ox + cc[j] - ci + a.wr, 0, 2 * a.wr);
        wgt[j] = a.w1d[ridx] * a.w1d[cidx];
        lt[j] = lt[j] * wgt[j];
      }
      const long long at = (long long)k * pp + t;
      u1[j] = a.u1[at];
      u2[j] = a.u2[at];
    }
    v1[j] = u1[j];
    v2[j] = u2[j];
    x11[j] = x12[j] = x21[j] = x22[j] = 0.0f;
  }

  for (int warp = 0; warp < a.warps; ++warp) {
    // 2. the warp constants at each cell's displaced point
    float gx[CELLS], gy[CELLS], grad[CELLS], rho_c[CELLS];
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      gx[j] = gy[j] = grad[j] = rho_c[j] = 0.0f;
      if (inb[j]) {
        int wx0, wy0;
        float wx[4], wy[4];
        patch_cell_weights(oy, ox, rr[j], cc[j], u1[j], u2[j], a.h, a.w, &wx0,
                           &wy0, wx, wy);
        const float* win = i1 + (long long)wy0 * a.w + wx0;
        const float i1w = contract(win, a.w, wy, wx);
        gx[j] = contract(win + plane, a.w, wy, wx);
        gy[j] = contract(win + 2 * plane, a.w, wy, wx);
        grad[j] = gx[j] * gx[j] + gy[j] * gy[j];
        rho_c[j] = ((i1w - gx[j] * u1[j]) - gy[j] * u2[j]) - i0[j];
        sb1[tt[j]] = u1[j];
        sb2[tt[j]] = u2[j];
      }
    }
    // 3. the PD loop
    float err = __int_as_float(0x7f800000);   // +inf
    for (int it = 0; it < a.max_iters; ++it) {
      canvas_sync(g, bar);   // u_bar and the last step's err are in place
      if (g > 32 && it > 0) err = __uint_as_float(slots[(it - 1) & 1]);
      if (!(canvas && err > tol2)) break;   // the same in the whole group
      float nv1[CELLS], nv2[CELLS];
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        nv1[j] = nv2[j] = 0.0f;
        if (!inb[j]) continue;
        const int t = tt[j], r = rr[j], c = cc[j];
        // threshold (tvl2_model.cpp:364-391)
        const float rho = (rho_c[j] + gx[j] * u1[j]) + gy[j] * u2[j];
        const bool lo = rho < -lt[j] * grad[j];
        const bool hi = rho > lt[j] * grad[j];
        float fi = 0.0f;
        if ((MODE != kSkip || !(lo || hi)) && !(grad[j] < kGradIsZero))
          fi = div_rn<MODE>(-rho, grad[j] == 0.0f ? 1.0f : grad[j]);
        const float d1 = lo ? lt[j] * gx[j] : (hi ? -lt[j] * gx[j] : fi * gx[j]);
        const float d2 = lo ? lt[j] * gy[j] : (hi ? -lt[j] * gy[j] : fi * gy[j]);
        nv1[j] = u1[j] + d1;
        nv2[j] = u2[j] + d2;
        // forward gradients of u_bar on the box, getD (tvl2_model.cpp:82-118)
        const float b1 = sb1[t], b2 = sb2[t];
        const float u1x = c < bw - 1 ? sb1[t + 1] - b1 : 0.0f;
        const float u1y = r < bh - 1 ? sb1[t + p] - b1 : 0.0f;
        const float u2x = c < bw - 1 ? sb2[t + 1] - b2 : 0.0f;
        const float u2y = r < bh - 1 ? sb2[t + p] - b2 : 0.0f;
        const float n2 = ((x11[j] * x11[j] + x12[j] * x12[j]) +
                          x21[j] * x21[j]) + x22[j] * x22[j];
        if (MODE == kSkip && n2 <= 1.0f) {
          // the norm clamped at 1 is 1, and x / 1 is x exactly
          x11[j] = x11[j] + tau * u1x;
          x12[j] = x12[j] + tau * u1y;
          x21[j] = x21[j] + tau * u2x;
          x22[j] = x22[j] + tau * u2y;
        } else {
          float n = sqrt_rn<MODE>(n2);
          n = n < 1.0f ? 1.0f : n;   // clamp(min=1) keeping NaN, as the twin
          x11[j] = div_rn<MODE>(x11[j] + tau * u1x, n);
          x12[j] = div_rn<MODE>(x12[j] + tau * u1y, n);
          x21[j] = div_rn<MODE>(x21[j] + tau * u2x, n);
          x22[j] = div_rn<MODE>(x22[j] + tau * u2y, n);
        }
        s11[t] = x11[j];
        s12[t] = x12[j];
        s21[t] = x21[j];
        s22[t] = x22[j];
      }
      if (g > 32 && gt == 0) slots[it & 1] = 0u;
      canvas_sync(g, bar);   // the new xi is in place
      unsigned bits = 0u;
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        if (!inb[j]) continue;
        const int t = tt[j], r = rr[j], c = cc[j];
        // divergence of the new xi (utils.cpp:63-112), getP (:122-172)
        const float div1 = div_cell(s11, s12, x11[j], x12[j], t, r, c, p, bh, bw);
        const float div2 = div_cell(s21, s22, x21[j], x22[j], t, r, c, p, bh, bw);
        const float nu1 =
            u1[j] - tau * (-div1 + div_rn<MODE>(u1[j] - nv1[j], theta));
        const float nu2 =
            u2[j] - tau * (-div2 + div_rn<MODE>(u2[j] - nv2[j], theta));
        const float e1 = nu1 - u1[j], e2 = nu2 - u2[j];
        const unsigned eb = __float_as_uint(e1 * e1 + e2 * e2);
        bits = eb > bits ? eb : bits;
        sb1[t] = 2.0f * nu1 - u1[j];
        sb2[t] = 2.0f * nu2 - u2[j];
        u1[j] = nu1;
        u2[j] = nu2;
        v1[j] = nv1[j];
        v2[j] = nv2[j];
      }
      bits = __reduce_max_sync(0xffffffffu, bits);
      if (g == 32)
        err = __uint_as_float(bits);
      else if ((threadIdx.x & 31) == 0)
        atomicMax(slots + (it & 1), bits);
    }
    canvas_sync(g, bar);   // every read of u_bar and xi is done
  }

  // 4. the energy (tvl2_model.cpp:174-243; tvl2w_model.cpp:227)
  float m1[CELLS], m2[CELLS];
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    m1[j] = inb[j] ? u1[j] : 0.0f;
    m2[j] = inb[j] ? u2[j] : 0.0f;
    if (inb[j]) {
      sb1[tt[j]] = m1[j];
      sb2[tt[j]] = m2[j];
    }
  }
  canvas_sync(g, bar);
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    const int t = tt[j], r = rr[j], c = cc[j];
    float val = 0.0f;
    if (inb[j]) {
      const float u1x = c < bw - 1 ? sb1[t + 1] - m1[j] : 0.0f;
      const float u1y = r < bh - 1 ? sb1[t + p] - m1[j] : 0.0f;
      const float u2x = c < bw - 1 ? sb2[t + 1] - m2[j] : 0.0f;
      const float u2y = r < bh - 1 ? sb2[t + p] - m2[j] : 0.0f;
      int wx0, wy0;
      float wx[4], wy[4];
      patch_cell_weights(oy, ox, r, c, m1[j], m2[j], a.h, a.w, &wx0, &wy0, wx,
                         wy);
      const float i1w = contract(i1 + (long long)wy0 * a.w + wx0, a.w, wy, wx);
      float dt = lam * fabsf(i1w - i0[j]);
      if (a.w1d != nullptr) dt = dt * wgt[j];
      const float e1 = m1[j] - v1[j], e2 = m2[j] - v2[j];
      const float dc = div_rn<MODE>(1.0f, 2.0f * theta) * (e1 * e1 + e2 * e2);
      const float gn = sqrt_rn<MODE>(((u1x * u1x + u1y * u1y) + u2x * u2x) +
                                     u2y * u2y);
      val = (dc + dt) + gn;
    }
    if (canvas && t < pp) s11[t] = val;
  }
  canvas_sync(g, bar);
  if (canvas && gt < p) {   // canvas_sum: row gt over its columns, one warp
    float s = s11[gt * p];
    for (int cx = 1; cx < p; ++cx) s = s + s11[gt * p + cx];
    const unsigned mask = p == 32 ? 0xffffffffu : (1u << p) - 1u;
    float tot = __shfl_sync(mask, s, 0);   // then over the rows
    for (int r = 1; r < p; ++r) tot = tot + __shfl_sync(mask, s, r);
    if (gt == 0) a.ener[k] = __fdiv_rn(tot, (float)(bh * bw));
  }
#pragma unroll
  for (int j = 0; j < CELLS; ++j) {
    if (canvas && tt[j] < pp) {
      const long long at = (long long)k * pp + tt[j];
      a.u1o[at] = m1[j];
      a.u2o[at] = m2[j];
    }
  }
}

// A layout at compile time: side P, G threads a canvas with CELLS cells
// each, CPB canvases a block, at least MINB blocks an SM.
template <int P, int G, int CELLS, int CPB, int MODE, int MINB>
cudaError_t launch_solve(const SolveArgs& a, cudaStream_t st) {
  static_assert(G % 32 == 0 && G * CELLS >= P * P && CPB <= 15, "layout");
  const size_t smem = (size_t)CPB * (6 * P * P + 2) * sizeof(float);
  const unsigned grid = (unsigned)((a.b + CPB - 1) / CPB);
  tvl1_patch_kernel<P, G, CELLS, CPB, MODE, MINB>
      <<<grid, G * CPB, smem, st>>>(a, G, CPB);
  return cudaGetLastError();
}

// Any side up to 32: a thread a cell, as many canvases a block as fit
// kGenericThreads (one past P 16).
cudaError_t launch_generic(const SolveArgs& a, cudaStream_t st) {
  const int g = canvas_threads(a.p);
  const int cpb = kGenericThreads / g > 0 ? kGenericThreads / g : 1;
  const size_t smem = (size_t)cpb * (6 * a.p * a.p + 2) * sizeof(float);
  const unsigned grid = (unsigned)((a.b + cpb - 1) / cpb);
  tvl1_patch_kernel<0, 0, 1, 0, kSkip, 1><<<grid, g * cpb, smem, st>>>(a, g, cpb);
  return cudaGetLastError();
}

// The library's layouts, all kSkip: P 11 a thread a cell, two canvases a
// 256-thread block on named barriers (the fastest bit-equal layout at the
// lockstep sweep's L 2 B 16384); P 3 a canvas a warp (9 of 32 lanes),
// eight a block.
cudaError_t launch_library(const SolveArgs& a, cudaStream_t st) {
  if (a.p == 11) return launch_solve<11, 128, 1, 2, kSkip, 4>(a, st);
  if (a.p == 3) return launch_solve<3, 32, 1, 8, kSkip, 4>(a, st);
  return launch_generic(a, st);
}

bool valid_args(const SolveArgs& a) {
  return a.p > 0 && a.p * a.p <= 1024 && a.p <= a.hp && a.p <= a.wp &&
         a.h >= 4 && a.w >= 4;
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
  const SolveArgs a{i0pad, i1s, ci, cj, oy, ox, ph, pw, lane, u1, u2, lam,
                    theta, tau, tol, w1d, u1o, u2o, ener, hp, wp, h, w, b, p,
                    wr, warps, max_iters};
  if (!valid_args(a)) return (int)cudaErrorInvalidValue;
  return (int)launch_library(a, (cudaStream_t)stream);
}
