// K16: the NLTV-CSAD patch loop around K8's selection.
//
// It replaces an XLA-lowered loop of the JAX package: the nltv_reg body of
// faldoi_tpu/core/functionals.py::_solve_csad_family (functionals.py:
// 535-579) run by _bounded_pd_loop (:579), one warp of B NLTV-CSAD patch
// solves (methods 6 and 7) on P x P canvases.  (K14 and K15, the
// whole-image CSAD loops, are csad_global.cu.)
//
// It runs the twin's operations in the twin's order (faldoi_tpu_torch/core/
// functionals.py::nltvcsad_patch_loop_plain); with --fmad=false every value
// rounds as there, and the v-step is K8's selection (csad_select.cuh),
// which picks one of the entries the twin sorts.
//
// The design: K8's loop (csrc/csad.cu, csad_loop_kernel: a canvas on whole
// warps of a block, four lanes a cell, each lane twelve b values and the
// cell's state in registers, b ranked once a call and the selection a merge-path
// search every PD iteration, RankedSmem) with K7's non-local regulariser
// (csrc/nltv.cu) in place of the inert TV.  One iteration per canvas
// cell:
//   v      = K8's v-step of u
//   nlgr_j = (w_j (u_bar - u_bar[x + d_j])) / wt,  j over the 24 offsets of
//            a 5x5 window
//   sc_j   = w_j > 0 ? (sc_j + tau nlgr_j) / (1 + tau |nlgr_j|) : sc_j
//   div    = 0 + sum over j in order of w_j (sc_j - sc_{23-j}[x + d_j]),
//            not normalised (aux_energy_model.cpp:178-212)
//   nu     = u - tau (div + (u - v) / theta),  u_bar = 2 nu - u
//   err    = canvas_sum of the in-box squared updates / (ph pw)
// as a masked unroll: a canvas runs while err > tol^2 and n < max_iters and
// then freezes.  A canvas's 48 duals, u_bar and its squared updates live in
// shared memory, and its 24 weights where they fit (75 floats a cell:
// 36 KB a canvas at P 11; past P 27 the weights are read from device
// memory), then at P 11 and 3 the ranked b (48 floats a cell, 59 KB a
// canvas in all at P 11, two blocks an SM under __launch_bounds__(512,
// 2)); the runtime path counts every iteration (Counting).  The 48 dual steps
// of a cell are shared by its lanes (lane g takes pairs g, g + G, ...; a
// step changes only its own dual, so any order is the twin's); each
// component's divergence, a chain of 24 additions in order, is one lane's
// (lane 0 the first, lane 1 the second) and reaches the group by a
// shuffle.  Three barriers an iteration: before the dual steps (u_bar and
// the run flags of the last step), before the divergence (the new duals),
// before err (the squared updates).  Canvases that take no step (max_iters
// 0, tol^2 >= +inf) keep their u and v.  Bound (B 8192, P 11): the canvases
// read once (u, v, 48 b, 3 warp planes, 24 weights, wt, l_t where per
// cell, the duals where given) and written once: ~290 MB, 0.087 ms at
// 3.35 TB/s, against K8's and K7's operations for every step a canvas runs.

#include "csad_select.cuh"
#include "nltv_common.cuh"

namespace {

constexpr int kNlThreads = 1024;             // threads a K16 block at most

// ---------------------------------------------------------------------------
// K16

struct NlArgs {
  const float* __restrict__ u1;        // (B, P, P) each
  const float* __restrict__ u2;
  const float* __restrict__ v1;
  const float* __restrict__ v2;
  const float* __restrict__ b;         // (48, B, P, P)
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ denom;
  const float* __restrict__ wp;        // (24, B, P, P), box-masked
  const float* __restrict__ wt;        // (B, P, P)
  const float* __restrict__ lt;        // (B, P, P) if lt_cells, else one
  const float* __restrict__ scal;      // theta, tau, tol^2
  const int* __restrict__ ph;          // (B,)
  const int* __restrict__ pw;
  const float* __restrict__ duals_in;  // (2, 24, B, P, P) or null: zeros
  float* __restrict__ u1o;             // (B, P, P) each
  float* __restrict__ u2o;
  float* __restrict__ v1o;
  float* __restrict__ v2o;
  int* __restrict__ iters;             // (B,)
  float* __restrict__ duals_out;       // (2, 24, B, P, P) or null
};

// threads a canvas: G lanes a cell, on whole warps
__host__ __device__ constexpr int nl_canvas_threads(int p, int g) {
  return (p * p * g + 31) / 32 * 32;
}

// floats of shared memory a canvas: the 48 duals, u_bar (two components)
// and the squared updates (p^2 each), the run flag, then the 24 weights
// when they are kept there (WS), then the selection's sel floats a cell
__host__ __device__ constexpr int nl_canvas_floats(int p, bool ws, int sel = 0) {
  return (2 * kNl + 3 + (ws ? kNl : 0) + sel) * p * p + 1;
}

// One component's divergence at (r, c): its 24 terms in order from 0.
template <bool WS>
__device__ __forceinline__ float nl_divergence(const float* sdc, const float* sw,
                                               const float* wg, long long plane,
                                               int cell, int r, int c, int p,
                                               int pp) {
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < kNl; ++j) {
    const int rr = r + nl_dy(j), cx = c + nl_dx(j);
    const bool in = rr >= 0 && rr < p && cx >= 0 && cx < p;
    const float nb = in ? sdc[(kNl - 1 - j) * pp + rr * p + cx] : 0.0f;
    const float w = WS ? sw[j * pp + cell] : wg[j * plane];
    d = d + w * (sdc[j * pp + cell] - nb);
  }
  return d;
}

// P > 0: the patch side at compile time; P = 0: any side with p^2 G <= T.
// G lanes a cell, at most T threads a block, at least MINB blocks an SM;
// WS: the weights in shared memory; Sel: the selection (as the K8 loop's,
// csad.cu), Sel::kSmem shared floats a cell after the weights.
template <int P, int G, int T, bool WS, int MINB, class Sel>
__global__ void __launch_bounds__(T, MINB)
    nltvcsad_patch_kernel(NlArgs a, int nbc, int p_rt, int cpb, int lt_cells,
                          int max_iters) {
  constexpr int S = kNd / G;
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int cs = nl_canvas_threads(p, G);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;   // this thread in its canvas
  const int cell = t / G, g = t % G;
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < nbc;
  const bool active = canvas && cell < pp;   // whole groups
  float* sd = smem + (lc < cpb ? lc : 0) * nl_canvas_floats(p, WS, Sel::kSmem);
  float* ub = sd + 2 * kNl * pp;                                     // [2][pp]
  float* ec = ub + 2 * pp;                                           // [pp]
  float* flag = ec + pp;                                             // [1]
  float* sw = flag + 1;                                              // [24][pp]
  float* sb = sw + (WS ? kNl : 0) * pp + (cell < pp ? cell : 0);    // [sel][pp]
  const int r = cell / p, c = cell - (cell / p) * p;
  const long long plane = (long long)nbc * pp;
  const long long ci = (long long)k * pp + cell;
  const float* wg = a.wp + ci;   // read only where active and !WS
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];
  const bool leader = canvas && t == 0;
  const unsigned gmask = group_mask<G>();

  float u1 = 0.0f, u2 = 0.0f, v1 = 0.0f, v2 = 0.0f, gx = 0.0f, gy = 0.0f,
        den = 1.0f, lt = 0.0f, wt = 1.0f, npx = 1.0f;
  float bv[S];
  int bh = 0, bw = 0;
  if (canvas) {
    bh = a.ph[k];
    bw = a.pw[k];
    npx = (float)(bh * bw);
  }
  if (active) {
    u1 = a.u1[ci];
    u2 = a.u2[ci];
    v1 = a.v1[ci];
    v2 = a.v2[ci];
    gx = a.i1wx[ci];
    gy = a.i1wy[ci];
    den = a.denom[ci];
    wt = a.wt[ci];
    lt = lt_cells ? a.lt[ci] : a.lt[0];
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = a.b[(g + G * s) * plane + ci];
    // this lane's share of the duals (and weights) in shared memory
    for (int q = g; q < 2 * kNl; q += G)
      sd[q * pp + cell] = a.duals_in ? a.duals_in[q * plane + ci] : 0.0f;
    if (WS)
      for (int j = g; j < kNl; j += G) sw[j * pp + cell] = a.wp[j * plane + ci];
    if (g == 0) {
      ub[cell] = u1;
      ub[pp + cell] = u2;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = 0.0f;
  }
  const bool inb = r < bh && c < bw;
  const float ltg = lt * den;
  typename Sel::State sst;
  if (active) Sel::setup(sst, bv, r, c, bh, bw, ltg, g, gmask, sb, pp);
  // err = +inf before the first step
  if (leader) flag[0] = __int_as_float(kInfKey) > tol2 && max_iters > 0 ? 1.0f : 0.0f;
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    // publishes u_bar and the run flags of the last step
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    float nv1 = 0.0f, nv2 = 0.0f;
    if (run) {
      const float dot = (gx * u1 + gy * u2) / den;
      const float med = Sel::select(sst, bv, dot, ltg, r, c, bh, bw, g, gmask, sb, pp);
      nv1 = u1 - (gx * med) / den;
      nv2 = u2 - (gy * med) / den;
      // nltvl1_getD (nltv_model.cpp:211-273), this lane's dual steps; a
      // weight of 0 keeps its dual, so the step is skipped
      for (int q = g; q < 2 * kNl; q += G) {
        const int cc = q >= kNl, j = q - cc * kNl;
        const float w = WS ? sw[j * pp + cell] : wg[j * plane];
        if (!(w > 0.0f)) continue;
        const int rr = r + nl_dy(j), cx = c + nl_dx(j);
        const bool in = rr >= 0 && rr < p && cx >= 0 && cx < p;
        const float nb = in ? ub[cc * pp + rr * p + cx] : 0.0f;
        float* s = sd + q * pp + cell;
        *s = dual_step(*s, w, ub[cc * pp + cell], nb, wt, tau);
      }
    }
    __syncthreads();
    if (run) {
      float dv1 = 0.0f, dv2 = 0.0f;   // lane 0: component 1; lane 1 % G: 2
      if (g == 0)
        dv1 = nl_divergence<WS>(sd, sw, wg, plane, cell, r, c, p, pp);
      if (g == (G > 1 ? 1 : 0))
        dv2 = nl_divergence<WS>(sd + kNl * pp, sw, wg, plane, cell, r, c, p, pp);
      const float d1 = __shfl_sync(gmask, dv1, 0, G);
      const float d2 = __shfl_sync(gmask, dv2, G > 1 ? 1 : 0, G);
      const float nu1 = u1 - tau * (d1 + (u1 - nv1) / theta);
      const float nu2 = u2 - tau * (d2 + (u2 - nv2) / theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      if (g == 0) {
        ec[cell] = inb ? e1 * e1 + e2 * e2 : 0.0f;
        ub[cell] = 2.0f * nu1 - u1;
        ub[pp + cell] = 2.0f * nu2 - u2;
      }
      u1 = nu1;
      u2 = nu2;
      v1 = nv1;
      v2 = nv2;
      ++nit;
    }
    __syncthreads();
    if (run && t < p) {   // canvas_sum: row t over its columns, one warp
      float s = ec[t * p];
      for (int cx = 1; cx < p; ++cx) s = s + ec[t * p + cx];
      const unsigned mask = p == 32 ? 0xffffffffu : (1u << p) - 1u;
      float tot = __shfl_sync(mask, s, 0);   // then over the rows
      for (int rr = 1; rr < p; ++rr) tot = tot + __shfl_sync(mask, s, rr);
      const float err = tot / npx;
      if (t == 0) flag[0] = err > tol2 && nit < max_iters ? 1.0f : 0.0f;
    }
  }
  if (!active) return;
  // each lane writes the duals it stepped: final once its own last step is
  if (a.duals_out)
    for (int q = g; q < 2 * kNl; q += G) a.duals_out[q * plane + ci] = sd[q * pp + cell];
  if (g != 0) return;
  a.u1o[ci] = u1;
  a.u2o[ci] = u2;
  a.v1o[ci] = v1;
  a.v2o[ci] = v2;
  if (t == 0) a.iters[k] = nit;
}

template <int P, int G, int T, bool WS, int MINB = 1, class Sel = Counting<G>>
cudaError_t launch_nl(const NlArgs& a, int nbc, int p, int lt_cells,
                      int max_iters, cudaStream_t st) {
  const int cs = nl_canvas_threads(p, G);
  const int cpb = T / cs;
  const size_t smem = (size_t)cpb * nl_canvas_floats(p, WS, Sel::kSmem) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nltvcsad_patch_kernel<P, G, T, WS, MINB, Sel>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  nltvcsad_patch_kernel<P, G, T, WS, MINB, Sel><<<grid, cpb * cs, smem, st>>>(
      a, nbc, p, cpb, lt_cells, max_iters);
  return cudaGetLastError();
}

// any side: G lanes a cell as the K8 loop takes them, the weights in shared
// memory while a block's canvases fit the opt-in limit
template <int G>
cudaError_t launch_nl_any(const NlArgs& a, int nbc, int p, int lt_cells,
                          int max_iters, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int cpb = kNlThreads / nl_canvas_threads(p, G);
  if ((size_t)cpb * nl_canvas_floats(p, true) * sizeof(float) <= (size_t)optin)
    return launch_nl<0, G, kNlThreads, true>(a, nbc, p, lt_cells, max_iters, st);
  return launch_nl<0, G, kNlThreads, false>(a, nbc, p, lt_cells, max_iters, st);
}

}  // namespace

// K16: ins = u1 u2 v1 v2 b i1wx i1wy denom wp wt lt scal ph pw duals_in,
// outs = u1 u2 v1 v2 iters duals_out (duals_in/out may be null); nbc
// canvases of p x p, p^2 <= 1024; lt one value or one a cell.
extern "C" int faldoi_nltvcsad_patch_loop(
    const float* u1, const float* u2, const float* v1, const float* v2,
    const float* b, const float* i1wx, const float* i1wy, const float* denom,
    const float* wp, const float* wt, const float* lt, const float* scal,
    const int* ph, const int* pw, const float* duals_in, float* u1o,
    float* u2o, float* v1o, float* v2o, int* iters, float* duals_out, int nbc,
    int p, int lt_cells, int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  if (p <= 0 || p * p > 1024) return (int)cudaErrorInvalidValue;
  NlArgs a{u1, u2, v1, v2, b, i1wx, i1wy, denom, wp, wt, lt, scal, ph, pw,
           duals_in, u1o, u2o, v1o, v2o, iters, duals_out};
  cudaStream_t st = (cudaStream_t)stream;
  // four lanes a cell, a canvas a 512-thread block at P 11 (eight at P 3);
  // fewer lanes where a canvas would not fit a block
  if (p == 11)
    return (int)launch_nl<11, 4, 512, true, 2, RankedSmem<4>>(a, nbc, p, lt_cells,
                                                             max_iters, st);
  if (p == 3)
    return (int)launch_nl<3, 4, 512, true, 2, RankedSmem<4>>(a, nbc, p, lt_cells,
                                                            max_iters, st);
  if (p * p * 4 <= kNlThreads)
    return (int)launch_nl_any<4>(a, nbc, p, lt_cells, max_iters, st);
  if (p * p * 2 <= kNlThreads)
    return (int)launch_nl_any<2>(a, nbc, p, lt_cells, max_iters, st);
  return (int)launch_nl_any<1>(a, nbc, p, lt_cells, max_iters, st);
}
