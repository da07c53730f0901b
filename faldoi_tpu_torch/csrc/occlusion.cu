// K9: the occlusion primal-dual loop of method 8 (TV-L1 with occlusions),
// in two forms.
//
// Replaces the XLA-lowered while_loop body of the JAX package's
// faldoi_tpu/core/occlusion.py::solve_occ_canvas (:173-241) with _get_xi
// (:81-111) and _get_chi (:114-136):
//   patch form:       one warp's whole tol-gated PD loop of B canvases of
//                     P x P (the m8 patch solve), one launch;
//   whole-image form: one PD iteration of the whole image (the m8 global
//                     step, _occ_global_jit :276), one call that enqueues
//                     plain launches: the v-step, two a xi step, the primal
//                     step (its squared update's maximum into a device
//                     slot), div u, two an eta / chi step.
//
// Per cell, a PD iteration (the twin: faldoi_tpu_torch/core/occlusion.py::
// occ_pd_step, in the same operation order; built with --fmad=false, IEEE
// division and square root, so the kernel and the twin agree bit for bit):
//   the v-step of the occlusion data term (occluded cells, chi != 0, take
//   the backward frame's constants and the flow negated), chi's forward
//   gradient, 24 steps of the weighted TV dual xi, the primal step
//   nu = v + theta div(g xi) + theta beta grad chi, F and G, div nu, 24
//   steps of eta and chi (clipped to [0, 1]), chi binarised at 0.6 and
//   zeroed outside the box, err = the largest in-box squared update.
// A canvas runs while err > tol^2 and its count < max_iters (err starts at
// +inf; a NaN err stops it), and keeps its state once it stops.
//
// Layout: the state is (11, N) planes u1 u2 chi xi11 xi12 xi21 xi22 eta1
// eta2 v1 v2, the warp constants (8, N) i1wx i1wy i_1wx i_1wy grad_1 grad__1
// rho_c1 rho_c_1, g (N,), with N = B P P (patch) or h w (whole image); the
// 14 scalars (core/occlusion.py SCALARS) are one float each on the device.
//
// Patch form: a thread a cell, a canvas of P^2 cells on consecutive
// threads, as many canvases a block as fit 128 threads (one at P 11,
// fourteen at P 3; one block of P^2 rounded up to warps above). Its state
// lives in registers; the stencils read their neighbours from six planes a
// canvas in shared memory (g xi x4, then v + theta div(g xi) x2; g eta x2,
// chi; nu x2; the squared updates), with a block barrier between a phase's
// writes and its neighbours' reads: ~100 barriers a PD iteration.  Bounds
// (H100): each input read once and each output written once a launch, 21
// planes of B P^2 floats, is 0.0248 ms at B 8192, P 11; its work is ~4,000
// float operations a cell a PD iteration (48 dual and eta / chi steps of
// ~80), so the issue rate and the barriers, not the bytes, hold it.
//
// Whole-image form: plain launches of a thread a pixel, the neighbours read
// from device memory (L1 / L2), the state updated in place in the output
// the wrapper cloned from the input; the step's err is the maximum of the
// squared updates by atomicMax on their bits (non-negative, a NaN made the
// positive quiet NaN so that it wins).  ~100 launches of ~1-2 planes each
// way: device memory, not operations, bounds each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kSteps = 24;             // ITER_XI - 1 = ITER_CHI - 1
constexpr float kGradIsZero = 1e-8f;   // GRAD_IS_ZERO
constexpr float kDelta = 0.6f;         // THRESHOLD_DELTA
constexpr int kBlock = 128;            // patch form: threads a block (P <= 11)
constexpr int kThreads = 256;          // whole-image form

enum { U1, U2, CHI, X11, X12, X21, X22, E1, E2, V1, V2 };
enum { IWX, IWY, I_WX, I_WY, GRAD1, GRAD_1, RHO1, RHO_1 };
// whole-image scratch planes
enum { SCX, SCY, SVI1, SVI2, SF, SG, SDIVU };

struct Scal {
  float lam, theta, beta, mu, tau_chi, l_t, muo, aio, lc, tb, tt, mte, a2,
      tol2;
};

__device__ __forceinline__ Scal load_scal(const float* s) {
  return Scal{s[0], s[1], s[2], s[3], s[4],  s[5],  s[6],
              s[7], s[8], s[9], s[10], s[11], s[12], s[13]};
}

// the v-step of the occlusion data term (occlusion.py :175-206)
__device__ __forceinline__ void vstep(const Scal& s, float u1, float u2,
                                      float chi, const float* w, float& v1,
                                      float& v2) {
  const float rho_1 = w[RHO1] + w[IWX] * u1 + w[IWY] * u2;
  const float rho__1 = w[RHO_1] + w[I_WX] * u1 + w[I_WY] * u2;
  const bool occ = chi != 0.0f;
  const float eps = occ ? -1.0f : 1.0f;
  const float alpha_i = occ ? s.aio : 1.0f;
  const float mu_t = occ ? s.muo : s.l_t;
  const float lam_v =
      occ ? rho__1 + s.lc * (u1 * w[I_WX] + u2 * w[I_WY]) : rho_1;
  const float grad = occ ? w[GRAD_1] : w[GRAD1];
  const float iwx = occ ? w[I_WX] : w[IWX];
  const float iwy = occ ? w[I_WY] : w[IWY];
  const float rho = occ ? rho__1 : rho_1;
  const bool small = grad < kGradIsZero;
  const float gs = small ? 1.0f : grad;
  const float vm1 = small ? u1 : u1 - eps * rho * iwx / gs;
  const float vm2 = small ? u2 : u2 - eps * rho * iwy / gs;
  const bool hi = lam_v > mu_t * grad;
  const bool lo = lam_v < -mu_t * grad;
  v1 = hi ? alpha_i * u1 - mu_t * eps * iwx
          : (lo ? alpha_i * u1 + mu_t * eps * iwx : vm1);
  v2 = hi ? alpha_i * u2 - mu_t * eps * iwy
          : (lo ? alpha_i * u2 + mu_t * eps * iwy : vm2);
}

// divergence_patch of (a, b) at (r, c) of a canvas of row stride ld with the
// box (bh, bw): a and b point at the cell; Chambolle's boundaries at the box
__device__ __forceinline__ float div_at(const float* a, const float* b, int r,
                                        int c, int bh, int bw, int ld) {
  if (!(r < bh && c < bw)) return 0.0f;
  const float dx = c == 0 ? a[0] : (c == bw - 1 ? -a[-1] : a[0] - a[-1]);
  const float dy = r == 0 ? b[0] : (r == bh - 1 ? -b[-ld] : b[0] - b[-ld]);
  return dx + dy;
}

// forward_gradient_patch of f at (r, c): zero on the box's last column / row
__device__ __forceinline__ void grad_at(const float* f, int r, int c, int bh,
                                        int bw, int ld, float& fx, float& fy) {
  fx = (c < bw - 1 && r < bh) ? f[1] - f[0] : 0.0f;
  fy = (r < bh - 1 && c < bw) ? f[ld] - f[0] : 0.0f;
}

// the xi step's update from the gradients of v + theta div(g xi)
__device__ __forceinline__ void xi_update(const Scal& s, float g, float g1x,
                                          float g1y, float g2x, float g2y,
                                          float& x11, float& x12, float& x21,
                                          float& x22) {
  const float vec11 = g * g1x, vec12 = g * g1y;
  const float vec21 = g * g2x, vec22 = g * g2y;
  const float den1 = 1.0f + s.tt * sqrtf(vec11 * vec11 + vec12 * vec12);
  const float den2 = 1.0f + s.tt * sqrtf(vec21 * vec21 + vec22 * vec22);
  x11 = (x11 + s.tt * vec11) / den1;
  x12 = (x12 + s.tt * vec12) / den1;
  x21 = (x21 + s.tt * vec21) / den2;
  x22 = (x22 + s.tt * vec22) / den2;
}

// the eta step (projected onto the unit ball)
__device__ __forceinline__ void eta_update(const Scal& s, float g, float cx,
                                           float cy, float& e1, float& e2) {
  const float f1 = e1 + s.mte * g * cx;
  const float f2 = e2 + s.mte * g * cy;
  const float ne = sqrtf(f1 * f1 + f2 * f2);
  const float scale = ne <= 1.0f ? 1.0f : ne;
  e1 = f1 / scale;
  e2 = f2 / scale;
}

// the chi step, clipped to [0, 1] by selections (a NaN stays NaN)
__device__ __forceinline__ float chi_update(const Scal& s, float chi,
                                            float dge, float div_u, float F,
                                            float G) {
  const float c = chi + s.tau_chi * (s.mu * dge - s.beta * div_u - F - G);
  return c < 0.0f ? 0.0f : (c > 1.0f ? 1.0f : c);
}

// F and G of the chi update
__device__ __forceinline__ void fg(const Scal& s, const float* w, float v1,
                                   float v2, float& F, float& G) {
  const float rho__1v = w[RHO_1] + w[I_WX] * v1 + w[I_WY] * v2;
  const float rho_1v = w[RHO1] + w[IWX] * v1 + w[IWY] * v2;
  F = s.lam * (fabsf(rho__1v) - fabsf(rho_1v));
  G = s.a2 * (v1 * v1 + v2 * v2);
}

// a NaN-propagating maximum (jnp.max, torch.amax)
__device__ __forceinline__ float nanmax(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// ---------------------------------------------------------------- patch form

struct PatchArgs {
  const float* st;     // (11, B, P, P)
  const float* wc;     // (8, B, P, P)
  const float* g;      // (B, P, P)
  const int* ph;       // (B,)
  const int* pw;
  const float* scal;   // (14,)
  float* out;          // (11, B, P, P)
  int* iters;          // (B,)
};

// shared memory a canvas: six planes of P^2 and the run flag
__host__ __device__ constexpr int canvas_floats(int pp) { return 6 * pp + 1; }

// the block of P^2 <= 128 (P 3 to 11) is 128 threads, so the registers a
// thread may take are not cut to 64 (no spills)
template <int P>
__global__ void __launch_bounds__(P > 0 && P * P <= kBlock ? kBlock : 1024)
    occ_patch_kernel(PatchArgs a, int nbc, int p_rt, int cpb, int max_iters) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int lc = threadIdx.x / pp;
  const int cell = threadIdx.x - lc * pp;
  const int k = blockIdx.x * cpb + lc;
  const bool active = lc < cpb && k < nbc;
  float* S = smem + (active ? lc : 0) * canvas_floats(pp);
  float* S0 = S;
  float* S1 = S + pp;
  float* S2 = S + 2 * pp;
  float* S3 = S + 3 * pp;
  float* W0 = S + 4 * pp;
  float* W1 = S + 5 * pp;
  float* flag = S + 6 * pp;
  const int r = cell / p, c = cell - (cell / p) * p;
  const long long n_all = (long long)nbc * pp;
  const long long ci = (long long)k * pp + cell;
  const Scal s = load_scal(a.scal);

  float x[11] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float w[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float g = 0.0f;
  int bh = 0, bw = 0;
  if (active) {
    bh = a.ph[k];
    bw = a.pw[k];
#pragma unroll
    for (int q = 0; q < 11; ++q) x[q] = a.st[q * n_all + ci];
#pragma unroll
    for (int q = 0; q < 8; ++q) w[q] = a.wc[q * n_all + ci];
    g = a.g[ci];
    if (cell == 0)
      flag[0] = (__int_as_float(0x7f800000) > s.tol2 && max_iters > 0) ? 1.0f
                                                                         : 0.0f;
  }
  const bool inb = r < bh && c < bw;
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    if (!__syncthreads_or(active && cell == 0 && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    float nv1 = 0.0f, nv2 = 0.0f, chix = 0.0f, chiy = 0.0f;
    if (run) {
      vstep(s, x[U1], x[U2], x[CHI], w, nv1, nv2);
      W0[cell] = x[CHI];
    }
    __syncthreads();
    if (run) grad_at(W0 + cell, r, c, bh, bw, p, chix, chiy);
    float x11 = x[X11], x12 = x[X12], x21 = x[X21], x22 = x[X22];
    // get_xi: 24 steps; W0 / W1 hold v + theta div(g xi) + theta beta grad chi
    for (int q = 0; q < kSteps; ++q) {
      if (run) {
        S0[cell] = g * x11;
        S1[cell] = g * x12;
        S2[cell] = g * x21;
        S3[cell] = g * x22;
      }
      __syncthreads();
      if (run) {
        const float d1 = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
        const float d2 = div_at(S2 + cell, S3 + cell, r, c, bh, bw, p);
        W0[cell] = nv1 + s.theta * d1 + s.tb * chix;
        W1[cell] = nv2 + s.theta * d2 + s.tb * chiy;
      }
      __syncthreads();
      if (run) {
        float g1x, g1y, g2x, g2y;
        grad_at(W0 + cell, r, c, bh, bw, p, g1x, g1y);
        grad_at(W1 + cell, r, c, bh, bw, p, g2x, g2y);
        xi_update(s, g, g1x, g1y, g2x, g2y, x11, x12, x21, x22);
      }
    }
    if (run) {
      S0[cell] = g * x11;
      S1[cell] = g * x12;
      S2[cell] = g * x21;
      S3[cell] = g * x22;
    }
    __syncthreads();
    float nu1 = 0.0f, nu2 = 0.0f, diff = 0.0f, F = 0.0f, G = 0.0f;
    if (run) {
      const float d1 = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
      const float d2 = div_at(S2 + cell, S3 + cell, r, c, bh, bw, p);
      nu1 = nv1 + s.theta * d1 + s.tb * chix;
      nu2 = nv2 + s.theta * d2 + s.tb * chiy;
      const float e1 = nu1 - x[U1], e2 = nu2 - x[U2];
      diff = e1 * e1 + e2 * e2;
      fg(s, w, nv1, nv2, F, G);
    }
    __syncthreads();
    if (run) {
      S0[cell] = nu1;
      S1[cell] = nu2;
    }
    __syncthreads();
    float div_u = 0.0f;
    if (run) div_u = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
    __syncthreads();
    // get_chi: 24 steps from the chi gradient above; W0 holds chi
    float e1 = x[E1], e2 = x[E2], ch = x[CHI], cx = chix, cy = chiy;
    for (int q = 0; q < kSteps; ++q) {
      if (run) {
        eta_update(s, g, cx, cy, e1, e2);
        S0[cell] = g * e1;
        S1[cell] = g * e2;
      }
      __syncthreads();
      if (run) {
        const float dge = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
        ch = chi_update(s, ch, dge, div_u, F, G);
        W0[cell] = ch;
      }
      __syncthreads();
      if (run && q + 1 < kSteps) grad_at(W0 + cell, r, c, bh, bw, p, cx, cy);
    }
    // the squared updates of the box, then the canvas's maximum and its gate
    if (run) W1[cell] = inb ? diff : 0.0f;
    __syncthreads();
    if (run) {
      ++nit;
      x[U1] = nu1;
      x[U2] = nu2;
      x[CHI] = (ch > kDelta && inb) ? 1.0f : 0.0f;
      x[X11] = x11;
      x[X12] = x12;
      x[X21] = x21;
      x[X22] = x22;
      x[E1] = e1;
      x[E2] = e2;
      x[V1] = nv1;
      x[V2] = nv2;
      if (cell == 0) {
        float m = W1[0];
        for (int q = 1; q < pp; ++q) m = nanmax(m, W1[q]);
        flag[0] = (m > s.tol2 && nit < max_iters) ? 1.0f : 0.0f;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < 11; ++q) a.out[q * n_all + ci] = x[q];
  if (cell == 0) a.iters[k] = nit;
}

template <int P>
cudaError_t launch_patch(const PatchArgs& a, int nbc, int p, int max_iters,
                         cudaStream_t st) {
  const int pp = p * p;
  const int threads = pp <= kBlock ? kBlock : (pp + 31) / 32 * 32;
  const int cpb = threads / pp;
  const size_t smem = (size_t)cpb * canvas_floats(pp) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  occ_patch_kernel<P><<<grid, threads, smem, st>>>(a, nbc, p, cpb, max_iters);
  return cudaGetLastError();
}

// ---------------------------------------------------------- whole-image form

struct GlobalArgs {
  float* st;           // (11, h, w), updated in place
  const float* wc;     // (8, h, w)
  const float* g;      // (h, w)
  const float* scal;   // (14,)
  float* sc;           // (7, h, w) scratch
  unsigned* err;       // the step's err, as float bits
  int h, w;
};

__device__ __forceinline__ bool pixel(const GlobalArgs& a, long long& i,
                                      int& r, int& c) {
  i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)a.h * a.w) return false;
  r = (int)(i / a.w);
  c = (int)(i - (long long)r * a.w);
  return true;
}

// the v-step; chi's gradient into the scratch
__global__ void __launch_bounds__(kThreads) occ_g_vstep(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = a.wc[q * n + i];
  float v1, v2, cx, cy;
  vstep(s, a.st[U1 * n + i], a.st[U2 * n + i], a.st[CHI * n + i], w, v1, v2);
  a.st[V1 * n + i] = v1;
  a.st[V2 * n + i] = v2;
  grad_at(a.st + CHI * n + i, r, c, a.h, a.w, a.w, cx, cy);
  a.sc[SCX * n + i] = cx;
  a.sc[SCY * n + i] = cy;
}

// xi step, first half: v + theta div(g xi) + theta beta grad chi
__global__ void __launch_bounds__(kThreads) occ_g_xi_a(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  const float* g = a.g + i;
  float gx[4][3];   // g xi at the pixel, its left and its upper neighbour
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* x = a.st + (X11 + q) * n + i;
    gx[q][0] = g[0] * x[0];
    gx[q][1] = c > 0 ? g[-1] * x[-1] : 0.0f;
    gx[q][2] = r > 0 ? g[-a.w] * x[-a.w] : 0.0f;
  }
  float d[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* ga = gx[2 * q];
    const float* gb = gx[2 * q + 1];
    const float dx = c == 0 ? ga[0] : (c == a.w - 1 ? -ga[1] : ga[0] - ga[1]);
    const float dy = r == 0 ? gb[0] : (r == a.h - 1 ? -gb[2] : gb[0] - gb[2]);
    d[q] = dx + dy;
  }
  a.sc[SVI1 * n + i] = a.st[V1 * n + i] + s.theta * d[0] + s.tb * a.sc[SCX * n + i];
  a.sc[SVI2 * n + i] = a.st[V2 * n + i] + s.theta * d[1] + s.tb * a.sc[SCY * n + i];
}

// xi step, second half: the dual update from the gradients of the above
__global__ void __launch_bounds__(kThreads) occ_g_xi_b(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  float g1x, g1y, g2x, g2y;
  grad_at(a.sc + SVI1 * n + i, r, c, a.h, a.w, a.w, g1x, g1y);
  grad_at(a.sc + SVI2 * n + i, r, c, a.h, a.w, a.w, g2x, g2y);
  float* x = a.st + i;
  float x11 = x[X11 * n], x12 = x[X12 * n], x21 = x[X21 * n], x22 = x[X22 * n];
  xi_update(s, a.g[i], g1x, g1y, g2x, g2y, x11, x12, x21, x22);
  x[X11 * n] = x11;
  x[X12 * n] = x12;
  x[X21 * n] = x21;
  x[X22 * n] = x22;
}

// the primal step nu (into u), its squared update's maximum, F and G
__global__ void __launch_bounds__(kThreads) occ_g_nu(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  const float* g = a.g + i;
  float gx[4][3];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* x = a.st + (X11 + q) * n + i;
    gx[q][0] = g[0] * x[0];
    gx[q][1] = c > 0 ? g[-1] * x[-1] : 0.0f;
    gx[q][2] = r > 0 ? g[-a.w] * x[-a.w] : 0.0f;
  }
  float d[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* ga = gx[2 * q];
    const float* gb = gx[2 * q + 1];
    const float dx = c == 0 ? ga[0] : (c == a.w - 1 ? -ga[1] : ga[0] - ga[1]);
    const float dy = r == 0 ? gb[0] : (r == a.h - 1 ? -gb[2] : gb[0] - gb[2]);
    d[q] = dx + dy;
  }
  const float v1 = a.st[V1 * n + i], v2 = a.st[V2 * n + i];
  const float nu1 = v1 + s.theta * d[0] + s.tb * a.sc[SCX * n + i];
  const float nu2 = v2 + s.theta * d[1] + s.tb * a.sc[SCY * n + i];
  const float e1 = nu1 - a.st[U1 * n + i], e2 = nu2 - a.st[U2 * n + i];
  const float diff = e1 * e1 + e2 * e2;
  atomicMax(a.err, diff != diff ? 0x7fc00000u : __float_as_uint(diff));
  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = a.wc[q * n + i];
  float F, G;
  fg(s, w, v1, v2, F, G);
  a.sc[SF * n + i] = F;
  a.sc[SG * n + i] = G;
  a.st[U1 * n + i] = nu1;
  a.st[U2 * n + i] = nu2;
}

// div nu (u holds nu now)
__global__ void __launch_bounds__(kThreads) occ_g_divu(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  a.sc[SDIVU * n + i] =
      div_at(a.st + U1 * n + i, a.st + U2 * n + i, r, c, a.h, a.w, a.w);
}

// eta step: from chi's gradient at the pixel
__global__ void __launch_bounds__(kThreads) occ_g_eta(GlobalArgs a) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  float cx, cy;
  grad_at(a.st + CHI * n + i, r, c, a.h, a.w, a.w, cx, cy);
  float e1 = a.st[E1 * n + i], e2 = a.st[E2 * n + i];
  eta_update(s, a.g[i], cx, cy, e1, e2);
  a.st[E1 * n + i] = e1;
  a.st[E2 * n + i] = e2;
}

// chi step; the last one binarises
__global__ void __launch_bounds__(kThreads) occ_g_chi(GlobalArgs a, int last) {
  long long i;
  int r, c;
  if (!pixel(a, i, r, c)) return;
  const long long n = (long long)a.h * a.w;
  const Scal s = load_scal(a.scal);
  const float* g = a.g + i;
  const float* e1 = a.st + E1 * n + i;
  const float* e2 = a.st + E2 * n + i;
  const float a0 = g[0] * e1[0], al = c > 0 ? g[-1] * e1[-1] : 0.0f;
  const float b0 = g[0] * e2[0], bu = r > 0 ? g[-a.w] * e2[-a.w] : 0.0f;
  const float dx = c == 0 ? a0 : (c == a.w - 1 ? -al : a0 - al);
  const float dy = r == 0 ? b0 : (r == a.h - 1 ? -bu : b0 - bu);
  float ch = chi_update(s, a.st[CHI * n + i], dx + dy, a.sc[SDIVU * n + i],
                        a.sc[SF * n + i], a.sc[SG * n + i]);
  if (last) ch = ch > kDelta ? 1.0f : 0.0f;
  a.st[CHI * n + i] = ch;
}

}  // namespace

// patch form: st (11, B, P, P), wc (8, B, P, P), g (B, P, P), ph pw (B,)
// int32, scal (14,), out (11, B, P, P), iters (B,); p^2 <= 1024
extern "C" int faldoi_occ_patch_loop(const float* st, const float* wc,
                                     const float* g, const int* ph,
                                     const int* pw, const float* scal,
                                     float* out, int* iters, int nbc, int p,
                                     int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  if (p <= 0 || p * p > 1024) return (int)cudaErrorInvalidValue;
  PatchArgs a{st, wc, g, ph, pw, scal, out, iters};
  cudaStream_t s = (cudaStream_t)stream;
  if (p == 11) return (int)launch_patch<11>(a, nbc, p, max_iters, s);
  if (p == 3) return (int)launch_patch<3>(a, nbc, p, max_iters, s);
  return (int)launch_patch<0>(a, nbc, p, max_iters, s);
}

namespace {

// one whole-image PD iteration enqueued on s
cudaError_t enqueue_global(float* st, const float* wc, const float* g,
                           const float* scal, float* scratch, float* err,
                           int h, int w, cudaStream_t s) {
  if (h <= 0 || w <= 0) return cudaSuccess;
  GlobalArgs a{st, wc, g, scal, scratch, (unsigned*)err, h, w};
  const long long n = (long long)h * w;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaError_t e = cudaMemsetAsync(err, 0, sizeof(float), s);
  if (e != cudaSuccess) return e;
  occ_g_vstep<<<grid, kThreads, 0, s>>>(a);
  for (int q = 0; q < kSteps; ++q) {
    occ_g_xi_a<<<grid, kThreads, 0, s>>>(a);
    occ_g_xi_b<<<grid, kThreads, 0, s>>>(a);
  }
  occ_g_nu<<<grid, kThreads, 0, s>>>(a);
  occ_g_divu<<<grid, kThreads, 0, s>>>(a);
  for (int q = 0; q < kSteps; ++q) {
    occ_g_eta<<<grid, kThreads, 0, s>>>(a);
    occ_g_chi<<<grid, kThreads, 0, s>>>(a, q + 1 == kSteps);
  }
  return cudaGetLastError();
}

}  // namespace

// whole-image form, one PD iteration: st (11, h, w) updated in place, wc
// (8, h, w), g (h, w), scal (14,), scratch (7, h, w), err one float
extern "C" int faldoi_occ_global_step(float* st, const float* wc,
                                      const float* g, const float* scal,
                                      float* scratch, float* err, int h, int w,
                                      void* stream) {
  return (int)enqueue_global(st, wc, g, scal, scratch, err, h, w,
                             (cudaStream_t)stream);
}

// the kernel launches one whole-image call enqueues, counted as the kernel
// nodes of a CUDA graph captured from one call on a private stream (the
// graph is never run): *n_kernels
extern "C" int faldoi_occ_global_step_kernels(float* st, const float* wc,
                                              const float* g, const float* scal,
                                              float* scratch, float* err, int h,
                                              int w, int* n_kernels) {
  *n_kernels = 0;
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t graph = nullptr;
  e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    const cudaError_t le = enqueue_global(st, wc, g, scal, scratch, err, h, w, s);
    e = cudaStreamEndCapture(s, &graph);
    if (e == cudaSuccess) e = le;
  }
  size_t n = 0;
  if (e == cudaSuccess) e = cudaGraphGetNodes(graph, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (e == cudaSuccess && n > 0) e = cudaGraphGetNodes(graph, nodes.data(), &n);
  for (size_t k = 0; e == cudaSuccess && k < n; ++k) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[k], &t);
    if (e == cudaSuccess && t == cudaGraphNodeTypeKernel) ++*n_kernels;
  }
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaStreamDestroy(s);
  return (int)e;
}
