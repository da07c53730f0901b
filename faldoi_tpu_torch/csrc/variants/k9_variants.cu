// K9's design variants and former forms, timed against each other and
// against the library's kernels (occlusion.cu, included below) by
// faldoi_tpu_torch/cli/k9_variants.py, which builds this file itself
// (kernels/build.py does not):
//   patch variant 0: the former patch form (occlusion.cu's
//       occ_patch_kernel before its launch bounds asked for 12 blocks an SM
//       at P 11) with two timing-only switches: a thread a cell, a canvas a
//       128-thread block, two block barriers an inner step;
//   patch variant 1: variant 0 without the barriers inside the 24-step
//       loops: WRONG results, timing only (what the barriers cost);
//   patch variant 2: variant 0 with every square root and division
//       replaced by a multiply: WRONG results, timing only (what they cost);
//   patch variant 3: a thread a cell, one block barrier an inner step: each
//       cell recomputes its right and lower neighbours' v + theta div(g xi)
//       and its left and upper neighbours' eta from double-buffered shared
//       planes (g xi, chi, eta);
//   patch variant 4: a canvas a warp, P^2 / 32 cells a lane, __syncwarp;
//   patch variant 5: variant 0 held to 8 blocks an SM by its launch
//       bounds (64 registers a thread; the library asks for 12);
//   the library's whole-image loop at depths 1-3 and with 512 threads a
//       block;
//   the former whole-image form: one PD iteration as 99 plain launches (the
//       v-step, two a xi step, the primal step, div u, two an eta / chi
//       step), the err into a device slot for the host to read;
//   the grid barrier alone: a cooperative kernel of n grid.sync().
// Every variant but 1 and 2 is held bit for bit to its twin by the script.

#include "../occlusion.cu"

// K5 in a namespace of its own (its file's names would clash with
// occlusion.cu's), for the block count its launch takes
namespace k5 {
#include "../global_pd.cu"
}  // namespace k5

namespace {

// the v-step, the xi and the eta updates of occlusion.cu with the square
// roots and divisions as multiplies when Fast (timing only)
template <bool Fast>
__device__ __forceinline__ float vsqrt(float x) {
  return Fast ? x * 0.5f : sqrtf(x);
}

template <bool Fast>
__device__ __forceinline__ float vdiv(float a, float b) {
  return Fast ? a * b : a / b;
}

template <bool Fast>
__device__ __forceinline__ void vstep_v(const Scal& s, float u1, float u2,
                                        float chi, const float* w, float& v1,
                                        float& v2) {
  if (!Fast) return vstep(s, u1, u2, chi, w, v1, v2);
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
  const float vm1 = small ? u1 : u1 - vdiv<Fast>(eps * rho * iwx, gs);
  const float vm2 = small ? u2 : u2 - vdiv<Fast>(eps * rho * iwy, gs);
  const bool hi = lam_v > mu_t * grad;
  const bool lo = lam_v < -mu_t * grad;
  v1 = hi ? alpha_i * u1 - mu_t * eps * iwx
          : (lo ? alpha_i * u1 + mu_t * eps * iwx : vm1);
  v2 = hi ? alpha_i * u2 - mu_t * eps * iwy
          : (lo ? alpha_i * u2 + mu_t * eps * iwy : vm2);
}

template <bool Fast>
__device__ __forceinline__ void xi_update_v(const Scal& s, float g, float g1x,
                                            float g1y, float g2x, float g2y,
                                            float& x11, float& x12, float& x21,
                                            float& x22) {
  const float vec11 = g * g1x, vec12 = g * g1y;
  const float vec21 = g * g2x, vec22 = g * g2y;
  const float den1 = 1.0f + s.tt * vsqrt<Fast>(vec11 * vec11 + vec12 * vec12);
  const float den2 = 1.0f + s.tt * vsqrt<Fast>(vec21 * vec21 + vec22 * vec22);
  x11 = vdiv<Fast>(x11 + s.tt * vec11, den1);
  x12 = vdiv<Fast>(x12 + s.tt * vec12, den1);
  x21 = vdiv<Fast>(x21 + s.tt * vec21, den2);
  x22 = vdiv<Fast>(x22 + s.tt * vec22, den2);
}

template <bool Fast>
__device__ __forceinline__ void eta_update_v(const Scal& s, float g, float cx,
                                             float cy, float& e1, float& e2) {
  const float f1 = e1 + s.mte * g * cx;
  const float f2 = e2 + s.mte * g * cy;
  const float ne = vsqrt<Fast>(f1 * f1 + f2 * f2);
  const float scale = ne <= 1.0f ? 1.0f : ne;
  e1 = vdiv<Fast>(f1, scale);
  e2 = vdiv<Fast>(f2, scale);
}

// the block of P^2 <= 128 (P 3 to 11) is 128 threads, so the registers a
// thread may take are not cut to 64 (no spills)
template <int P, bool Sync, bool Fast, int MinB = 1>
__global__ void __launch_bounds__(P > 0 && P * P <= kBlock ? kBlock : 1024,
                                  MinB)
    former_patch_kernel(PatchArgs a, int nbc, int p_rt, int cpb, int max_iters) {
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
      vstep_v<Fast>(s, x[U1], x[U2], x[CHI], w, nv1, nv2);
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
      if (Sync) __syncthreads();
      if (run) {
        const float d1 = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
        const float d2 = div_at(S2 + cell, S3 + cell, r, c, bh, bw, p);
        W0[cell] = nv1 + s.theta * d1 + s.tb * chix;
        W1[cell] = nv2 + s.theta * d2 + s.tb * chiy;
      }
      if (Sync) __syncthreads();
      if (run) {
        float g1x, g1y, g2x, g2y;
        grad_at(W0 + cell, r, c, bh, bw, p, g1x, g1y);
        grad_at(W1 + cell, r, c, bh, bw, p, g2x, g2y);
        xi_update_v<Fast>(s, g, g1x, g1y, g2x, g2y, x11, x12, x21, x22);
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
        eta_update_v<Fast>(s, g, cx, cy, e1, e2);
        S0[cell] = g * e1;
        S1[cell] = g * e2;
      }
      if (Sync) __syncthreads();
      if (run) {
        const float dge = div_at(S0 + cell, S1 + cell, r, c, bh, bw, p);
        ch = chi_update(s, ch, dge, div_u, F, G);
        W0[cell] = ch;
      }
      if (Sync) __syncthreads();
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
        // the timing-only variants run every iteration (their err is wrong)
        flag[0] = ((m > s.tol2 || !Sync || Fast) && nit < max_iters) ? 1.0f
                                                                     : 0.0f;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < 11; ++q) a.out[q * n_all + ci] = x[q];
  if (cell == 0) a.iters[k] = nit;
}

template <int P, bool Sync, bool Fast, int MinB = 1>
cudaError_t launch_former_patch(const PatchArgs& a, int nbc, int p, int max_iters,
                         cudaStream_t st) {
  const int pp = p * p;
  const int threads = pp <= kBlock ? kBlock : (pp + 31) / 32 * 32;
  const int cpb = threads / pp;
  const size_t smem = (size_t)cpb * canvas_floats(pp) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  former_patch_kernel<P, Sync, Fast, MinB><<<grid, threads, smem, st>>>(
      a, nbc, p, cpb, max_iters);
  return cudaGetLastError();
}


// -------------------------------------- patch variant 3: one barrier a step

// shared floats a canvas: g xi x4 twice, v x2, chi's gradient x2, chi twice,
// eta x2 twice, g, the squared updates, the run flag
__host__ __device__ constexpr int onebar_floats(int pp) { return 20 * pp + 1; }

// v + theta div(g xi) + theta beta grad chi at cell e (row r, column c)
__device__ __forceinline__ void w_at(const Scal& s, float* const* gx,
                                     const float* nv1, const float* nv2,
                                     const float* cg1, const float* cg2, int e,
                                     int r, int c, int bh, int bw, int p,
                                     float& w1, float& w2) {
  const float d1 = div_at(gx[0] + e, gx[1] + e, r, c, bh, bw, p);
  const float d2 = div_at(gx[2] + e, gx[3] + e, r, c, bh, bw, p);
  w1 = nv1[e] + s.theta * d1 + s.tb * cg1[e];
  w2 = nv2[e] + s.theta * d2 + s.tb * cg2[e];
}

// the eta step at cell e (row r, column c) from chi and eta of the step before
__device__ __forceinline__ void eta_at(const Scal& s, const float* ch,
                                       const float* et1, const float* et2,
                                       const float* gp, int e, int r, int c,
                                       int bh, int bw, int p, float& e1,
                                       float& e2) {
  float cx, cy;
  grad_at(ch + e, r, c, bh, bw, p, cx, cy);
  e1 = et1[e];
  e2 = et2[e];
  eta_update(s, gp[e], cx, cy, e1, e2);
}

template <int P>
__global__ void __launch_bounds__(kBlock)
    onebar_patch_kernel(PatchArgs a, int nbc, int p_rt, int cpb,
                        int max_iters) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int lc = threadIdx.x / pp;
  const int cell = threadIdx.x - lc * pp;
  const int k = blockIdx.x * cpb + lc;
  const bool active = lc < cpb && k < nbc;
  float* S = smem + (active ? lc : 0) * onebar_floats(pp);
  float* GX[2][4];
  for (int b = 0; b < 2; ++b)
    for (int q = 0; q < 4; ++q) GX[b][q] = S + (4 * b + q) * pp;
  float* NV1 = S + 8 * pp;
  float* NV2 = S + 9 * pp;
  float* CG1 = S + 10 * pp;
  float* CG2 = S + 11 * pp;
  float* CH[2] = {S + 12 * pp, S + 13 * pp};
  float* ET[2][2] = {{S + 14 * pp, S + 15 * pp}, {S + 16 * pp, S + 17 * pp}};
  float* GP = S + 18 * pp;
  float* DF = S + 19 * pp;
  float* flag = S + 20 * pp;
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
    GP[cell] = g;
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
      NV1[cell] = nv1;
      NV2[cell] = nv2;
      CH[0][cell] = x[CHI];
      ET[0][0][cell] = x[E1];
      ET[0][1][cell] = x[E2];
      GX[0][0][cell] = g * x[X11];
      GX[0][1][cell] = g * x[X12];
      GX[0][2][cell] = g * x[X21];
      GX[0][3][cell] = g * x[X22];
    }
    __syncthreads();
    if (run) {
      grad_at(CH[0] + cell, r, c, bh, bw, p, chix, chiy);
      CG1[cell] = chix;
      CG2[cell] = chiy;
    }
    __syncthreads();
    float x11 = x[X11], x12 = x[X12], x21 = x[X21], x22 = x[X22];
    int b = 0;
    for (int q = 0; q < kSteps; ++q) {
      if (run) {
        float w1, w2, wr1 = 0.0f, wr2 = 0.0f, wd1 = 0.0f, wd2 = 0.0f;
        w_at(s, GX[b], NV1, NV2, CG1, CG2, cell, r, c, bh, bw, p, w1, w2);
        const bool hasr = c < bw - 1 && r < bh, hasd = r < bh - 1 && c < bw;
        if (hasr)
          w_at(s, GX[b], NV1, NV2, CG1, CG2, cell + 1, r, c + 1, bh, bw, p,
               wr1, wr2);
        if (hasd)
          w_at(s, GX[b], NV1, NV2, CG1, CG2, cell + p, r + 1, c, bh, bw, p,
               wd1, wd2);
        const float g1x = hasr ? wr1 - w1 : 0.0f, g1y = hasd ? wd1 - w1 : 0.0f;
        const float g2x = hasr ? wr2 - w2 : 0.0f, g2y = hasd ? wd2 - w2 : 0.0f;
        xi_update(s, g, g1x, g1y, g2x, g2y, x11, x12, x21, x22);
        GX[b ^ 1][0][cell] = g * x11;
        GX[b ^ 1][1][cell] = g * x12;
        GX[b ^ 1][2][cell] = g * x21;
        GX[b ^ 1][3][cell] = g * x22;
      }
      __syncthreads();
      b ^= 1;
    }
    float nu1 = 0.0f, nu2 = 0.0f, diff = 0.0f, F = 0.0f, G = 0.0f;
    if (run) {
      w_at(s, GX[b], NV1, NV2, CG1, CG2, cell, r, c, bh, bw, p, nu1, nu2);
      const float e1 = nu1 - x[U1], e2 = nu2 - x[U2];
      diff = e1 * e1 + e2 * e2;
      fg(s, w, nv1, nv2, F, G);
      GX[b ^ 1][0][cell] = nu1;
      GX[b ^ 1][1][cell] = nu2;
    }
    __syncthreads();
    float div_u = 0.0f;
    if (run) div_u = div_at(GX[b ^ 1][0] + cell, GX[b ^ 1][1] + cell, r, c, bh,
                            bw, p);
    // get_chi: 24 steps; a cell recomputes its left and upper neighbours' eta
    float e1 = x[E1], e2 = x[E2], ch = x[CHI];
    int cb = 0;
    for (int q = 0; q < kSteps; ++q) {
      if (run) {
        eta_at(s, CH[cb], ET[cb][0], ET[cb][1], GP, cell, r, c, bh, bw, p, e1,
               e2);
        float a0 = g * e1, b0 = g * e2, al = 0.0f, bu = 0.0f;
        if (c > 0) {
          float l1, l2;
          eta_at(s, CH[cb], ET[cb][0], ET[cb][1], GP, cell - 1, r, c - 1, bh,
                 bw, p, l1, l2);
          al = GP[cell - 1] * l1;
        }
        if (r > 0) {
          float u1, u2;
          eta_at(s, CH[cb], ET[cb][0], ET[cb][1], GP, cell - p, r - 1, c, bh,
                 bw, p, u1, u2);
          bu = GP[cell - p] * u2;
        }
        float dge = 0.0f;
        if (inb) {
          const float dx = c == 0 ? a0 : (c == bw - 1 ? -al : a0 - al);
          const float dy = r == 0 ? b0 : (r == bh - 1 ? -bu : b0 - bu);
          dge = dx + dy;
        }
        ch = chi_update(s, ch, dge, div_u, F, G);
        CH[cb ^ 1][cell] = ch;
        ET[cb ^ 1][0][cell] = e1;
        ET[cb ^ 1][1][cell] = e2;
      }
      __syncthreads();
      cb ^= 1;
    }
    if (run) DF[cell] = inb ? diff : 0.0f;
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
        float m = DF[0];
        for (int q = 1; q < pp; ++q) m = nanmax(m, DF[q]);
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
cudaError_t launch_onebar(const PatchArgs& a, int nbc, int p, int max_iters,
                          cudaStream_t st) {
  const int pp = p * p;
  const int threads = pp <= kBlock ? kBlock : (pp + 31) / 32 * 32;
  const int cpb = threads / pp;
  const size_t smem = (size_t)cpb * onebar_floats(pp) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  onebar_patch_kernel<P><<<grid, threads, smem, st>>>(a, nbc, p, cpb,
                                                      max_iters);
  return cudaGetLastError();
}

// -------------------------------------- patch variant 4: a canvas a warp

// The patch form with a canvas a warp (P <= 11): CPL = ceil(P^2 / 32) cells
// a lane (lane l holds cells l, l + 32, ..), or at P^2 <= 16 several
// canvases a warp, P^2 lanes each; the stencils read their neighbours from
// the canvas's six shared planes as in occ_patch_kernel, with __syncwarp
// between a phase's writes and its neighbours' reads.  A warp runs while
// one of its canvases runs; a canvas's err is its lanes' largest squared
// update in the box (shuffles when one canvas fills the warp).  The 24-step
// loops are not unrolled, so that k9_variants.py can read a step's
// instructions off the SASS.  It lost to the thread a cell (PERF.md 6): a
// lane's four cells run one after another, each step's square roots and
// divisions a dependent chain, so a canvas takes ~3.5x as long.
constexpr int kWarpBlock = 128;  // threads a block of the warp form

template <int CPL>
__global__ void __launch_bounds__(kWarpBlock)
    occ_patch_warp_kernel(PatchArgs a, int nbc, int p, int cpw, int max_iters) {
  extern __shared__ float smem[];
  const int pp = p * p;
  const int lane = threadIdx.x & 31;
  const int grp = CPL == 1 ? lane / pp : 0;
  const int sub = lane - grp * pp;
  const long long k =
      ((long long)blockIdx.x * (kWarpBlock / 32) + (threadIdx.x >> 5)) * cpw +
      grp;
  const bool active = grp < cpw && k < nbc;
  float* S = smem + ((threadIdx.x >> 5) * cpw + (active ? grp : 0)) *
                        canvas_floats(pp);
  float* S0 = S;
  float* S1 = S + pp;
  float* S2 = S + 2 * pp;
  float* S3 = S + 3 * pp;
  float* W0 = S + 4 * pp;
  float* W1 = S + 5 * pp;
  float* flag = S + 6 * pp;
  const long long n_all = (long long)nbc * pp;
  const Scal s = load_scal(a.scal);
  int bh = 0, bw = 0;
  if (active) {
    bh = a.ph[k];
    bw = a.pw[k];
  }
  int cell[CPL], r[CPL], c[CPL];
  bool ok[CPL], inb[CPL];
  float x[CPL][11], g[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    cell[j] = sub + 32 * j;
    ok[j] = active && cell[j] < pp;
    r[j] = cell[j] / p;
    c[j] = cell[j] - r[j] * p;
    inb[j] = r[j] < bh && c[j] < bw;
    const long long ci = k * pp + cell[j];
#pragma unroll
    for (int q = 0; q < 11; ++q) x[j][q] = ok[j] ? a.st[q * n_all + ci] : 0.0f;
    g[j] = ok[j] ? a.g[ci] : 0.0f;
  }
  if (active && sub == 0)
    flag[0] = (__int_as_float(0x7f800000) > s.tol2 && max_iters > 0) ? 1.0f
                                                                        : 0.0f;
  __syncwarp();
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    const bool run = active && flag[0] != 0.0f;
    if (!__any_sync(0xffffffffu, run)) break;
    float nv1[CPL], nv2[CPL], chix[CPL], chiy[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      nv1[j] = nv2[j] = chix[j] = chiy[j] = 0.0f;
      if (run && ok[j]) {
        const long long ci = k * pp + cell[j];
        float w[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = a.wc[q * n_all + ci];
        vstep(s, x[j][U1], x[j][U2], x[j][CHI], w, nv1[j], nv2[j]);
        W0[cell[j]] = x[j][CHI];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (run && ok[j])
        grad_at(W0 + cell[j], r[j], c[j], bh, bw, p, chix[j], chiy[j]);
    // get_xi: 24 steps; W0 / W1 hold v + theta div(g xi) + theta beta grad chi
#pragma unroll 1
    for (int q = 0; q < kSteps; ++q) {
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (run && ok[j]) {
          S0[cell[j]] = g[j] * x[j][X11];
          S1[cell[j]] = g[j] * x[j][X12];
          S2[cell[j]] = g[j] * x[j][X21];
          S3[cell[j]] = g[j] * x[j][X22];
        }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (run && ok[j]) {
          const int e = cell[j];
          const float d1 = div_at(S0 + e, S1 + e, r[j], c[j], bh, bw, p);
          const float d2 = div_at(S2 + e, S3 + e, r[j], c[j], bh, bw, p);
          W0[e] = nv1[j] + s.theta * d1 + s.tb * chix[j];
          W1[e] = nv2[j] + s.theta * d2 + s.tb * chiy[j];
        }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (run && ok[j]) {
          float g1x, g1y, g2x, g2y;
          grad_at(W0 + cell[j], r[j], c[j], bh, bw, p, g1x, g1y);
          grad_at(W1 + cell[j], r[j], c[j], bh, bw, p, g2x, g2y);
          xi_update(s, g[j], g1x, g1y, g2x, g2y, x[j][X11], x[j][X12],
                    x[j][X21], x[j][X22]);
        }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (run && ok[j]) {
        S0[cell[j]] = g[j] * x[j][X11];
        S1[cell[j]] = g[j] * x[j][X12];
        S2[cell[j]] = g[j] * x[j][X21];
        S3[cell[j]] = g[j] * x[j][X22];
      }
    __syncwarp();
    float nu1[CPL], nu2[CPL], diff[CPL], F[CPL], G[CPL], du[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      nu1[j] = nu2[j] = diff[j] = F[j] = G[j] = du[j] = 0.0f;
      if (run && ok[j]) {
        const int e = cell[j];
        const float d1 = div_at(S0 + e, S1 + e, r[j], c[j], bh, bw, p);
        const float d2 = div_at(S2 + e, S3 + e, r[j], c[j], bh, bw, p);
        nu1[j] = nv1[j] + s.theta * d1 + s.tb * chix[j];
        nu2[j] = nv2[j] + s.theta * d2 + s.tb * chiy[j];
        const float e1 = nu1[j] - x[j][U1], e2 = nu2[j] - x[j][U2];
        diff[j] = e1 * e1 + e2 * e2;
        const long long ci = k * pp + e;
        float w[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = a.wc[q * n_all + ci];
        fg(s, w, nv1[j], nv2[j], F[j], G[j]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (run && ok[j]) {
        S0[cell[j]] = nu1[j];
        S1[cell[j]] = nu2[j];
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (run && ok[j])
        du[j] = div_at(S0 + cell[j], S1 + cell[j], r[j], c[j], bh, bw, p);
    __syncwarp();
    // get_chi: 24 steps from the chi gradient above; W0 holds chi
#pragma unroll 1
    for (int q = 0; q < kSteps; ++q) {
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (run && ok[j]) {
          eta_update(s, g[j], chix[j], chiy[j], x[j][E1], x[j][E2]);
          S0[cell[j]] = g[j] * x[j][E1];
          S1[cell[j]] = g[j] * x[j][E2];
        }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (run && ok[j]) {
          const float dge =
              div_at(S0 + cell[j], S1 + cell[j], r[j], c[j], bh, bw, p);
          x[j][CHI] = chi_update(s, x[j][CHI], dge, du[j], F[j], G[j]);
          W0[cell[j]] = x[j][CHI];
        }
      __syncwarp();
      if (q + 1 < kSteps) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (run && ok[j])
            grad_at(W0 + cell[j], r[j], c[j], bh, bw, p, chix[j], chiy[j]);
      }
    }
    // the squared updates of the box, then the canvas's maximum and its gate
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (run && ok[j]) {
        const float d = inb[j] ? diff[j] : 0.0f;
        m = nanmax(m, d);
        W1[cell[j]] = d;
        x[j][U1] = nu1[j];
        x[j][U2] = nu2[j];
        x[j][CHI] = (x[j][CHI] > kDelta && inb[j]) ? 1.0f : 0.0f;
        x[j][V1] = nv1[j];
        x[j][V2] = nv2[j];
      }
    if (run) ++nit;
    if (cpw == 1) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    __syncwarp();
    if (run && sub == 0) {
      if (cpw > 1)
        for (int q = 1; q < pp; ++q) m = nanmax(m, W1[q]);
      flag[0] = (m > s.tol2 && nit < max_iters) ? 1.0f : 0.0f;
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (ok[j]) {
      const long long ci = k * pp + cell[j];
#pragma unroll
      for (int q = 0; q < 11; ++q) a.out[q * n_all + ci] = x[j][q];
    }
  if (active && sub == 0) a.iters[k] = nit;
}

template <int CPL>
cudaError_t launch_patch_warp(const PatchArgs& a, int nbc, int p, int max_iters,
                              cudaStream_t st) {
  const int pp = p * p;
  const int cpw = CPL == 1 ? 32 / pp : 1;
  const int per_block = kWarpBlock / 32 * cpw;
  const size_t smem = (size_t)per_block * canvas_floats(pp) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + per_block - 1) / per_block);
  occ_patch_warp_kernel<CPL><<<grid, kWarpBlock, smem, st>>>(a, nbc, p, cpw,
                                                             max_iters);
  return cudaGetLastError();
}

// ------------------------------------------------------ the grid barrier

__global__ void grid_sync_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

// ------------------------------------- the former whole-image form (moved)

constexpr int kThreads = 256;          // whole-image form
// whole-image scratch planes
enum { SCX, SCY, SVI1, SVI2, SF, SG, SDIVU };

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


template <int P>
cudaError_t launch_variant(int variant, const PatchArgs& a, int nbc, int p,
                           int max_iters, cudaStream_t s) {
  if (variant == 0) return launch_former_patch<P, true, false>(a, nbc, p, max_iters, s);
  if (variant == 1) return launch_former_patch<P, false, false>(a, nbc, p, max_iters, s);
  if (variant == 2) return launch_former_patch<P, true, true>(a, nbc, p, max_iters, s);
  if (variant == 3) return launch_onebar<P>(a, nbc, p, max_iters, s);
  if (variant == 4) {
    const int pp = p * p;
    if (pp <= 32) return launch_patch_warp<1>(a, nbc, p, max_iters, s);
    if (pp <= 64) return launch_patch_warp<2>(a, nbc, p, max_iters, s);
    if (pp <= 96) return launch_patch_warp<3>(a, nbc, p, max_iters, s);
    if (pp <= 128) return launch_patch_warp<4>(a, nbc, p, max_iters, s);
  }
  if (variant == 5) return launch_former_patch<P, true, false, 8>(a, nbc, p, max_iters, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// patch variant `variant` (0-3 above) with the library's patch-form arguments
extern "C" int faldoi_k9v_patch(int variant, const float* st, const float* wc,
                                const float* g, const int* ph, const int* pw,
                                const float* scal, float* out, int* iters,
                                int nbc, int p, int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  if (p <= 0 || p * p > 1024) return (int)cudaErrorInvalidValue;
  PatchArgs a{st, wc, g, ph, pw, scal, out, iters};
  cudaStream_t s = (cudaStream_t)stream;
  if (p == 11) return (int)launch_variant<11>(variant, a, nbc, p, max_iters, s);
  if (p == 3) return (int)launch_variant<3>(variant, a, nbc, p, max_iters, s);
  return (int)launch_variant<0>(variant, a, nbc, p, max_iters, s);
}

// the library's whole-image loop at depth 1-3 (the library's is kGDepth)
// with 1024 or 512 threads a block (the library's: 1024): its plan
// (faldoi_occ_global_loop_plan's out) and a launch with its arguments
extern "C" int faldoi_k9v_global_plan(int depth, int nt, int h, int w,
                                      long long* out) {
  Plan p{};
  cudaError_t e = cudaErrorInvalidValue;
  if (nt == 1024 && depth == 1) e = plan_loop<1, 1024>(h, w, p);
  if (nt == 1024 && depth == 2) e = plan_loop<2, 1024>(h, w, p);
  if (nt == 1024 && depth == 3) e = plan_loop<3, 1024>(h, w, p);
  if (nt == 512 && depth == 2) e = plan_loop<2, 512>(h, w, p);
  if (nt == 512 && depth == 3) e = plan_loop<3, 512>(h, w, p);
  if (e != cudaSuccess) return (int)e;
  const long long v[8] = {scratch_floats(p, h, w), p.th, p.tw, p.ty, p.tx,
                          p.blocks, p.resident, (long long)p.smem};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

extern "C" int faldoi_k9v_global_loop(int depth, int nt, float* st,
                                      const float* wc, const float* g,
                                      const float* scal, float* scratch,
                                      long long scratch_n, int h, int w,
                                      int max_iters, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nt == 1024 && depth == 1)
    return (int)launch_loop<1, 1024>(st, wc, g, scal, scratch, scratch_n, h, w,
                                     max_iters, s);
  if (nt == 1024 && depth == 2)
    return (int)launch_loop<2, 1024>(st, wc, g, scal, scratch, scratch_n, h, w,
                                     max_iters, s);
  if (nt == 1024 && depth == 3)
    return (int)launch_loop<3, 1024>(st, wc, g, scal, scratch, scratch_n, h, w,
                                     max_iters, s);
  if (nt == 512 && depth == 2)
    return (int)launch_loop<2, 512>(st, wc, g, scal, scratch, scratch_n, h, w,
                                    max_iters, s);
  if (nt == 512 && depth == 3)
    return (int)launch_loop<3, 512>(st, wc, g, scal, scratch, scratch_n, h, w,
                                    max_iters, s);
  return (int)cudaErrorInvalidValue;
}

// one cooperative launch of `blocks` blocks of `threads` that pass `syncs`
// grid barriers and do nothing else
extern "C" int faldoi_k9v_grid_sync(int blocks, int threads, int syncs,
                                    void* stream) {
  void* args[] = {&syncs};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_kernel, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the co-resident blocks of `threads` the barrier kernel can take
extern "C" int faldoi_k9v_grid_sync_capacity(int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_sync_kernel,
                                                      threads, 0);
  *blocks = per_sm * sms;
  return (int)e;
}

// the blocks K5's launch (global_pd.cu's faldoi_global_pd_loop) takes at
// h x w: every 32x8 tile's, at most as many as can be co-resident
extern "C" int faldoi_k9v_k5_blocks(int h, int w, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k5::pd_loop_kernel, k5::kTileW * k5::kTileH, 0);
  const long long ntiles = (long long)((w + k5::kTileW - 1) / k5::kTileW) *
                           ((h + k5::kTileH - 1) / k5::kTileH);
  const long long resident = (long long)per_sm * sms;
  *blocks = (int)(ntiles < resident ? ntiles : resident);
  return (int)e;
}

// whole-image form, one PD iteration: st (11, h, w) updated in place, wc
// (8, h, w), g (h, w), scal (14,), scratch (7, h, w), err one float
extern "C" int faldoi_k9v_global_step(float* st, const float* wc,
                                      const float* g, const float* scal,
                                      float* scratch, float* err, int h, int w,
                                      void* stream) {
  return (int)enqueue_global(st, wc, g, scal, scratch, err, h, w,
                             (cudaStream_t)stream);
}

// the kernel launches one whole-image call enqueues, counted as the kernel
// nodes of a CUDA graph captured from one call on a private stream (the
// graph is never run): *n_kernels
extern "C" int faldoi_k9v_global_step_kernels(float* st, const float* wc,
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
