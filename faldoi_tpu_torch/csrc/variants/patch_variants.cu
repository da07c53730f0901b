// K12's and K13's former forms and design variants, timed against
// the library's forms by faldoi_tpu_torch/cli/patch_variants.py
// (chip_smoke.py times the former forms beside the library's).  No wrapper
// of the package calls them.
//
// Built on its own (nvcc -shared, the library's flags), it includes the
// library's two sources, so the library's layouts are instantiated here
// beside the others.  Every variant but K12's kFast ones computes exactly
// what its plain twin does, in the twin's order, so each is held bit for
// bit to it; the kFast ones (divisions and the root by the approximate
// instructions) are only timed, to size the IEEE sequences' share.
//
// faldoi_k13v_fill(variant, <faldoi_poisson_fill's arguments>):
//   0  the former form: a thread a cell of the finest level, two canvases
//      a 256-thread block at P 11, a block barrier after each colour or
//      front, the pyramid's sides, offsets and boxes at run time;
//   1  the library's form: a warp a patch, a lane a row, the relaxation in
//      shared memory, __syncwarp() between steps, at most 32 registers;
//   2  the same with the lane's row in registers during the relaxation
//      (exact: skewed, cell (r, d - r) in register d, so every lane's front d
//      is its register d; the rows above and below by warp shuffles), no
//      shared memory and no __syncwarp() inside a level (P 11 and 3; other
//      sides take the library's);
//   3  the library's form without its bound of 32 registers;
//   4  variant 2 with red-black's row skewed by the row's parity, so that
//      a colour's cells are compile-time registers (relax_regs_skew).
// faldoi_k12v_solve(variant, <faldoi_tvl1_patch_solve's arguments>): at P
// 11 (other sides: 0 the former form, else the library's layout)
//   0  the former form: two canvases a 256-thread block, a thread a cell,
//      two block barriers and a block-wide vote a PD step, 64 registers;
//   1  (a) one canvas a 128-thread block, __launch_bounds__(128, 8);
//   2  (a) two canvases a 256-thread block on named barriers (bar.sync id,
//      128), __launch_bounds__(256, 4);
//   3, 4, 5  variant 2 held to 5, 6 and 8 blocks an SM (b);
//   6  variant 1 held to 12 blocks an SM (b);
//   7  (c) one canvas a warp, four cells a lane, eight canvases a block,
//      __syncwarp() and the warp's max for err, no launch bound;
//   8, 9  variant 7 held to 2 and 3 blocks an SM (b);
//   10 (d) variant 2 with kFast (approximate divisions and root);
//   11 (d) variant 7 with kFast;
//   12 the library's form (tvl1_patch.cu's launch_library) at every P:
//      variant 2's layout with kSkip, the divisions and the root whose
//      results are known exactly left out (bit-equal);
//   13 variant 8 with kSkip.
// Variants 1-9 divide with kIeee, every division and root.

#include "../poisson_fill.cu"
#include "../tvl1_patch.cu"

namespace {

// ---- K13's former form (csrc/poisson_fill.cu before the redesign), unchanged
namespace former13 {

constexpr int kMaxLevels = 6;     // P <= 32 halves to 1 in at most 6 levels
constexpr int kFillThreads = 256; // threads a block, canvases packed
constexpr int kMaxThreads = 1024; // one canvas of P 32

struct Pyramid {
  int n;                   // levels
  int side[kMaxLevels];    // level sides, finest first
  int off[kMaxLevels];     // their offsets in a canvas's shared floats
  int total;               // shared floats a canvas
};

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// One relaxation update of cell (r, c) of a level of side s with box (bh,
// bw): y + ts * (-4 y + right + left + down + up).
__device__ __forceinline__ float relax_cell(const float* y, int r, int c,
                                            int s, int bh, int bw, float ts) {
  const int i = r * s + c;
  const float yc = y[i];
  const float right = c + 1 < bw ? y[i + 1] : yc;
  const float left = c - 1 >= 0 ? y[i - 1] : yc;
  const float down = r + 1 < bh ? y[i + s] : yc;
  const float up = r - 1 >= 0 ? y[i - s] : yc;
  float lap = -4.0f * yc;
  lap = lap + right;
  lap = lap + left;
  lap = lap + down;
  lap = lap + up;
  return yc + ts * lap;
}

// Canvas g of the nplanes x b canvases (plane g / b, patch g % b): threads
// [lc * pp, (lc + 1) * pp) of the block hold it, cpb canvases a block.
template <bool EXACT>
__global__ void __launch_bounds__(kMaxThreads)
    poisson_fill_kernel(const float* __restrict__ x0,
                        const float* __restrict__ x1, float* __restrict__ o0,
                        float* __restrict__ o1,
                        const long long* __restrict__ ph,
                        const long long* __restrict__ pw, int b, int nplanes,
                        int p, Pyramid pyr, float ts, int niter, int cpb) {
  extern __shared__ float smem[];
  const int pp = p * p;
  const int lc = threadIdx.x / pp;
  const int t = threadIdx.x - lc * pp;       // the cell at the finest level
  const long long g = (long long)blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && g < (long long)nplanes * b;
  const int k = canvas ? (int)(g % b) : 0;
  const int plane = canvas ? (int)(g / b) : 0;
  float* cv = smem + (lc < cpb ? lc : 0) * pyr.total;
  // the boxes of every level, halved as the twin halves them
  int bh[kMaxLevels], bw[kMaxLevels];
  bh[0] = canvas ? (int)ph[k] : 0;
  bw[0] = canvas ? (int)pw[k] : 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    bh[l] = (bh[l - 1] + 1) >> 1;
    bw[l] = (bw[l - 1] + 1) >> 1;
  }
  const long long at = (long long)k * pp + t;
  if (canvas) cv[t] = (plane == 0 ? x0 : x1)[at];
  __syncthreads();
  // zoom-outs, finest to coarsest
  for (int l = 1; l < pyr.n; ++l) {
    const int s = pyr.side[l], sp = pyr.side[l - 1];
    if (canvas && t < s * s) {
      const int r = t / s, c = t - (t / s) * s;
      const float* par = cv + pyr.off[l - 1];
      float sum = 0.0f;
      int cnt = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int rr = 2 * r + (d >> 1), cc = 2 * c + (d & 1);
        const float v = rr < sp && cc < sp && rr < bh[l - 1] && cc < bw[l - 1]
                            ? par[rr * sp + cc]
                            : nan_f();
        const bool fin = finite(v);
        cnt += fin;
        sum = sum + (fin ? v : 0.0f);
      }
      cv[pyr.off[l] + t] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : nan_f();
    }
    __syncthreads();
  }
  // coarse to fine: init, then the relaxation of the holes in the box
  float mine = 0.0f;
  for (int l = pyr.n - 1; l >= 0; --l) {
    const int s = pyr.side[l];
    const bool cell = canvas && t < s * s;
    const int r = cell ? t / s : 0, c = cell ? t - (t / s) * s : 0;
    float* y = cv + pyr.off[l];
    bool upd = false;
    if (cell) {
      const float xk = y[t];
      const bool hole = !finite(xk);
      const bool inbox = r < bh[l] && c < bw[l];
      const float init = l == pyr.n - 1
                             ? 0.0f
                             : cv[pyr.off[l + 1] + (r >> 1) * pyr.side[l + 1] +
                                  (c >> 1)];
      float v = inbox ? (hole ? init : xk) : 0.0f;
      v = finite(v) ? v : 0.0f;
      y[t] = v;
      upd = hole && inbox;
    }
    __syncthreads();
    const int parity = (r + c) & 1;
    for (int it = 0; it < niter; ++it) {
      if (EXACT) {
        for (int d = 0; d < 2 * s - 1; ++d) {
          if (upd && r + c == d)
            y[t] = relax_cell(y, r, c, s, bh[l], bw[l], ts);
          __syncthreads();
        }
      } else {
#pragma unroll
        for (int colour = 0; colour < 2; ++colour) {
          if (upd && parity == colour)
            y[t] = relax_cell(y, r, c, s, bh[l], bw[l], ts);
          __syncthreads();
        }
      }
    }
    if (l == 0 && cell) mine = y[t];
  }
  if (canvas) (plane == 0 ? o0 : o1)[at] = mine;
}

int fill(const float* x0, const float* x1,
                                   float* o0, float* o1, const long long* ph,
                                   const long long* pw, int b, int nplanes,
                                   int p, const int* sides, int n_levels,
                                   float timestep, int niter, int exact,
                                   void* stream) {
  if (b <= 0) return 0;
  if (p <= 0 || p * p > 1024 || nplanes < 1 || nplanes > 2 || n_levels < 1 ||
      n_levels > kMaxLevels || sides[0] != p)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr{};
  pyr.n = n_levels;
  int total = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (l > 0 && sides[l] != (sides[l - 1] + 1) / 2)
      return (int)cudaErrorInvalidValue;
    pyr.side[l] = sides[l];
    pyr.off[l] = total;
    total += sides[l] * sides[l];
  }
  pyr.total = total;
  const int pp = p * p;
  const int cpb = kFillThreads / pp > 0 ? kFillThreads / pp : 1;
  const int threads = (cpb * pp + 31) / 32 * 32;
  const long long canvases = (long long)nplanes * b;
  const long long blocks = (canvases + cpb - 1) / cpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cpb * total * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (exact)
    poisson_fill_kernel<true><<<(unsigned)blocks, threads, smem, st>>>(
        x0, x1, o0, o1, ph, pw, b, nplanes, p, pyr, timestep, niter, cpb);
  else
    poisson_fill_kernel<false><<<(unsigned)blocks, threads, smem, st>>>(
        x0, x1, o0, o1, ph, pw, b, nplanes, p, pyr, timestep, niter, cpb);
  return (int)cudaGetLastError();
}

}  // namespace former13

// ---- K12's former form (csrc/tvl1_patch.cu before the redesign), unchanged; it samples
// with the same bicubic_common.cuh
namespace former12 {

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

int solve(
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

}  // namespace former12

// ---- K13 variant 2: the relaxation with the lane's row in registers
namespace k13v {

template <int S, bool EXACT>
__device__ __forceinline__ void relax_regs(float* y, int r, int bh, int bw,
                                           unsigned upd, float ts, int niter) {
  constexpr int J = EXACT ? 2 * S - 1 : S;
  float R[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = EXACT ? j - r : j;
    R[j] = r < S && c >= 0 && c < S ? y[r * S + c] : 0.0f;
  }
  for (int it = 0; it < niter; ++it) {
    if (EXACT) {
#pragma unroll
      for (int d = 0; d < J; ++d) {
        const float nx = R[d + 1 < J ? d + 1 : d];   // (r, c + 1), old
        const float pv = R[d > 0 ? d - 1 : d];       // (r, c - 1), updated
        const float dn = __shfl_down_sync(0xffffffffu, nx, 1);
        const float upv = __shfl_up_sync(0xffffffffu, pv, 1);
        const int c = d - r;
        if ((unsigned)c < (unsigned)S && ((upd >> c) & 1u)) {
          const float yc = R[d];
          const float right = c + 1 < bw ? nx : yc;
          const float left = c - 1 >= 0 ? pv : yc;
          const float down = r + 1 < bh ? dn : yc;
          const float up = r - 1 >= 0 ? upv : yc;
          float lap = -4.0f * yc;
          lap = lap + right;
          lap = lap + left;
          lap = lap + down;
          lap = lap + up;
          R[d] = yc + ts * lap;
        }
      }
    } else {
#pragma unroll
      for (int colour = 0; colour < 2; ++colour) {
#pragma unroll
        for (int c = 0; c < S; ++c) {
          const float dn = __shfl_down_sync(0xffffffffu, R[c], 1);
          const float upv = __shfl_up_sync(0xffffffffu, R[c], 1);
          if (((r + c) & 1) == colour && ((upd >> c) & 1u)) {
            const float yc = R[c];
            const float right = c + 1 < bw ? R[c + 1 < S ? c + 1 : c] : yc;
            const float left = c - 1 >= 0 ? R[c > 0 ? c - 1 : c] : yc;
            const float down = r + 1 < bh ? dn : yc;
            const float up = r - 1 >= 0 ? upv : yc;
            float lap = -4.0f * yc;
            lap = lap + right;
            lap = lap + left;
            lap = lap + down;
            lap = lap + up;
            R[c] = yc + ts * lap;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = EXACT ? j - r : j;
    if (r < S && c >= 0 && c < S) y[r * S + c] = R[j];
  }
}

// Red-black with the row in registers skewed by the row's parity: register
// j holds column j - (r & 1), so that every lane's cells of colour col are
// its registers j = col, col + 2, ...: the colour's slots are compile-time,
// about half the columns, and no lane evaluates a cell of the other colour.
// The rows above and below hold column c in register c + 1 - (r & 1) (the
// other parity), so each register of the other colour is shuffled up and
// down once a colour and each slot picks j + 1 or j - 1 by parity.
template <int S>
__device__ __forceinline__ void relax_regs_skew(float* y, int r, int bh,
                                                int bw, unsigned upd, float ts,
                                                int niter) {
  constexpr int J = S + 1;
  const int odd = r & 1;
  float R[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = j - odd;
    R[j] = r < S && c >= 0 && c < S ? y[r * S + c] : 0.0f;
  }
  const unsigned updj = upd << odd;   // bit j: the cell in register j
  const int bwr = bw + odd;           // right neighbour in the box: j + 1 < bwr
  const bool down_in = r + 1 < bh, up_in = r >= 1;
  for (int it = 0; it < niter; ++it) {
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      float up[J] = {}, dn[J] = {};
#pragma unroll
      for (int k = 1 - col; k < J; k += 2) {
        up[k] = __shfl_up_sync(0xffffffffu, R[k], 1);
        dn[k] = __shfl_down_sync(0xffffffffu, R[k], 1);
      }
#pragma unroll
      for (int j = col; j < J; j += 2) {
        if ((updj >> j) & 1u) {
          const int jp = j + 1 < J ? j + 1 : j, jm = j > 0 ? j - 1 : j;
          const float yc = R[j];
          const float right = j + 1 < bwr ? R[jp] : yc;
          const float left = j - 1 >= odd ? R[jm] : yc;
          const float down = down_in ? (odd ? dn[jm] : dn[jp]) : yc;
          const float upv = up_in ? (odd ? up[jm] : up[jp]) : yc;
          float lap = -4.0f * yc;
          lap = lap + right;
          lap = lap + left;
          lap = lap + down;
          lap = lap + upv;
          R[j] = yc + ts * lap;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = j - odd;
    if (r < S && c >= 0 && c < S) y[r * S + c] = R[j];
  }
}

// Levels L, L - 1, ..., 0 of a compile-time pyramid: init, relaxation in
// registers (SKEW: red-black by relax_regs_skew), back to shared memory.
template <int P, int NL, bool EXACT, bool SKEW, int L>
__device__ __forceinline__ void regs_levels(const FillLane& f, float ts,
                                            int niter) {
  if constexpr (L >= 0) {
    constexpr int S = level_side(P, L);
    constexpr bool kLast = L + 1 >= NL;
    float* y = f.cv + level_off(P, L);
    const int bh = halved(f.bh0, L), bw = halved(f.bw0, L);
    const unsigned upd = init_level<S>(
        f, y, kLast ? nullptr : f.cv + level_off(P, L + 1), S,
        kLast ? 1 : level_side(P, L + 1), bh, bw);
    __syncwarp();
    if constexpr (SKEW && !EXACT)
      relax_regs_skew<S>(y, f.r, bh, bw, upd, ts, niter);
    else
      relax_regs<S, EXACT>(y, f.r, bh, bw, upd, ts, niter);
    __syncwarp();
    regs_levels<P, NL, EXACT, SKEW, L - 1>(f, ts, niter);
  }
}

template <int P, int NL, bool EXACT, bool SKEW>
__global__ void __launch_bounds__(kFillThreads, 8)
    fill_regs_kernel(FillArgs a, Pyramid pyr) {
  extern __shared__ float smem[];
  const FillLane f = fill_begin<P, NL>(a, pyr, smem);
  zoom_levels<P, NL - 1>(f);
  regs_levels<P, NL, EXACT, SKEW, NL - 1>(f, a.ts, a.niter);
  fill_end(f, a, P * P);
}

template <int P, int NL, bool SKEW>
cudaError_t launch_regs(const FillArgs& a, const Pyramid& pyr, bool exact,
                        cudaStream_t st) {
  const long long blocks = (fill_warps(a) + kFillWarps - 1) / kFillWarps;
  const size_t smem = (size_t)kFillWarps * 2 * pyr.total * sizeof(float);
  if (exact)
    fill_regs_kernel<P, NL, true, SKEW>
        <<<(unsigned)blocks, kFillThreads, smem, st>>>(a, pyr);
  else
    fill_regs_kernel<P, NL, false, SKEW>
        <<<(unsigned)blocks, kFillThreads, smem, st>>>(a, pyr);
  return cudaGetLastError();
}

}  // namespace k13v

}  // namespace

extern "C" int faldoi_k13v_fill(int variant, const float* x0, const float* x1,
                                float* o0, float* o1, const long long* ph,
                                const long long* pw, int b, int nplanes, int p,
                                const int* sides, int n_levels, float timestep,
                                int niter, int exact, void* stream) {
  if (variant == 0)
    return former13::fill(x0, x1, o0, o1, ph, pw, b, nplanes, p, sides,
                          n_levels, timestep, niter, exact, stream);
  const bool compiled = (p == 11 && n_levels == 5) || (p == 3 && n_levels == 3);
  if (variant == 1 || ((variant == 2 || variant == 4) && !compiled))
    return faldoi_poisson_fill(x0, x1, o0, o1, ph, pw, b, nplanes, p, sides,
                               n_levels, timestep, niter, exact, stream);
  if (b <= 0) return 0;
  Pyramid pyr{};
  if (p <= 0 || p * p > 1024 || nplanes < 1 || nplanes > 2 ||
      !make_pyramid(p, sides, n_levels, &pyr))
    return (int)cudaErrorInvalidValue;
  const FillArgs a{x0, x1, o0, o1, ph, pw, b, nplanes, p, timestep, niter};
  cudaStream_t st = (cudaStream_t)stream;
  const bool ex = exact != 0;
  if (variant == 2)
    return (int)(p == 11 ? k13v::launch_regs<11, 5, false>(a, pyr, ex, st)
                         : k13v::launch_regs<3, 3, false>(a, pyr, ex, st));
  if (variant == 4)
    return (int)(p == 11 ? k13v::launch_regs<11, 5, true>(a, pyr, ex, st)
                         : k13v::launch_regs<3, 3, true>(a, pyr, ex, st));
  if (variant == 3) {
    if (p == 11 && n_levels == 5) return (int)launch_fill<11, 5, 1>(a, pyr, ex, st);
    if (p == 3 && n_levels == 3) return (int)launch_fill<3, 3, 1>(a, pyr, ex, st);
    return (int)launch_fill<0, 0, 1>(a, pyr, ex, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int faldoi_k12v_solve(
    int variant, const float* i0pad, const float* i1s, const long long* ci,
    const long long* cj, const long long* oy, const long long* ox,
    const long long* ph, const long long* pw, const long long* lane,
    const float* u1, const float* u2, const float* lam, const float* theta,
    const float* tau, const float* tol, const float* w1d, float* u1o,
    float* u2o, float* ener, int hp, int wp, int h, int w, int b, int p,
    int wr, int warps, int max_iters, void* stream) {
  if (variant == 0)
    return former12::solve(i0pad, i1s, ci, cj, oy, ox, ph, pw, lane, u1, u2,
                           lam, theta, tau, tol, w1d, u1o, u2o, ener, hp, wp,
                           h, w, b, p, wr, warps, max_iters, stream);
  if (b <= 0) return 0;
  const SolveArgs a{i0pad, i1s, ci, cj, oy, ox, ph, pw, lane, u1, u2, lam,
                    theta, tau, tol, w1d, u1o, u2o, ener, hp, wp, h, w, b, p,
                    wr, warps, max_iters};
  if (!valid_args(a) || variant < 0 || variant > 13)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (p != 11 || variant == 12) return (int)launch_library(a, st);
  switch (variant) {
    case 1: return (int)launch_solve<11, 128, 1, 1, kIeee, 8>(a, st);
    case 2: return (int)launch_solve<11, 128, 1, 2, kIeee, 4>(a, st);
    case 3: return (int)launch_solve<11, 128, 1, 2, kIeee, 5>(a, st);
    case 4: return (int)launch_solve<11, 128, 1, 2, kIeee, 6>(a, st);
    case 5: return (int)launch_solve<11, 128, 1, 2, kIeee, 8>(a, st);
    case 6: return (int)launch_solve<11, 128, 1, 1, kIeee, 12>(a, st);
    case 7: return (int)launch_solve<11, 32, 4, 8, kIeee, 1>(a, st);
    case 8: return (int)launch_solve<11, 32, 4, 8, kIeee, 2>(a, st);
    case 9: return (int)launch_solve<11, 32, 4, 8, kIeee, 3>(a, st);
    case 10: return (int)launch_solve<11, 128, 1, 2, kFast, 4>(a, st);
    case 11: return (int)launch_solve<11, 32, 4, 8, kFast, 1>(a, st);
    case 13: return (int)launch_solve<11, 32, 4, 8, kSkip, 2>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
