// K6 and K7: the NLTV-L1 primal-dual loops, global and per patch.
//
// Both replace XLA-lowered loops of the JAX package:
//   K6 (nltv_global_loop): the fori_loop body of faldoi_tpu/core/
//      global_step_nltv.py::_nltvl1_jit (global_step_nltv.py:48-63), one
//      warp of the global NLTV step, a fixed max_iters iterations;
//   K7 (nltv_patch_loop): the tol-gated PD loop of faldoi_tpu/core/
//      functionals.py::_solve_nltv_family (functionals.py:448-469), one
//      warp of B patch solves on P x P canvases.
//
// Neighbour j of a cell (the 24 offsets of a 5x5 window without its centre,
// dy outer and dx inner) is (dy, dx); its reciprocal is 23 - j, at (-dy,
// -dx).  One iteration of both loops, per cell and flow component:
//   v      = the TV-L1 threshold of u (tvl2_model.cpp:364-391)
//   nlgr_j = (w_j * (u_bar - u_bar[x + d_j])) / wt
//   sc_j   = w_j > 0 ? (sc_j + tau nlgr_j) / (1 + tau |nlgr_j|) : sc_j
//   div    = 0 + sum over j in order of w_j * (sc_j - sc_{23-j}[x + d_j])
//            (K6 then divides by wt; K7's patch divergence is unnormalised,
//            aux_energy_model.cpp:178-212)
//   nu     = u - tau (div + (u - v) / theta),  u_bar = 2 nu - u,  u = nu
// The divergence reads duals that the neighbours updated in the same
// iteration, so each loop has a barrier between its dual and its primal
// phase, and one before the next dual phase reads u_bar at the neighbours.
// A neighbour outside the image (K6) or the canvas (K7) reads 0, as the
// twins' zero-filled shifts do; its weight is 0 there.  The operation order
// is the twins' (faldoi_tpu_torch/core/global_step_nltv.py::
// nltv_global_loop_plain, faldoi_tpu_torch/core/functionals.py::
// nltv_patch_loop_plain); with --fmad=false both round identically.
//
// K6: a thread a pixel, a 32x8 tile a block, and two plain launches an
// iteration (the dual phase, then the primal phase; the launch boundary is
// the barrier), all enqueued by one call.  Measured on an H100 at 436x1024,
// this is 10% faster than K5's structure, one cooperative launch with two
// grid barriers an iteration, and 28% faster than one fused pass an
// iteration that recomputes each neighbour's reciprocal dual from
// ping-pong buffers (70-108 registers a thread).  The state lives in device
// memory: u, u_bar (4 planes), the 48 dual planes (85.7 MB at 436x1024), and
// the 24 weight planes and wt it reads.  Bound: per call 81 planes read
// once and 52 written once (237 MB at 436x1024, 0.071 ms at 3.35 TB/s)
// against ~656 float operations a pixel an iteration (1.75 ms at 400
// iterations and 67 TFLOP/s): bound by operations.  In practice each
// iteration streams the 48 dual planes and the 24 weights through device
// memory about twice (they do not fit the 50 MB L2).
//
// K7: a thread a canvas cell, floor(128 / P^2) canvases a block (one at P
// 11, fourteen at P 3).  A canvas's 48 duals, u_bar and the error terms live
// in shared memory, where the neighbour reads go; a cell's 24 weights and
// its constants stay in registers for the whole loop.  The loop is the
// masked unroll of JAX's _bounded_pd_loop: a canvas runs while err > tol^2
// and n < max_iters (err starts at +inf; a NaN err freezes it); err is the
// canvas_sum of the in-box squared updates (columns, then rows, in order)
// over the box's cell count.  A block leaves the loop when none of its
// canvases runs.  The duals start at 0 in the kernel unless given, and are
// written out only when asked (the local step's single warp needs neither).
// Bound: the canvases read once (u, v, the four warp constants, the 24
// weights, wt, l_t where per cell) and u, v written once: 37 canvases at B
// 8192, P 11 (147 MB, 0.044 ms) against ~606 float operations a cell an
// iteration run.

#include <cuda_runtime.h>

namespace {

constexpr float kGradIsZero = 1e-8f;
constexpr int kNd = 24;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kPatchThreads = 128;  // threads a block, for P^2 <= 128

// offset j -> (dy, dx): the 5x5 window without its centre, row-major
__host__ __device__ constexpr int off_dy(int j) { return (j < 12 ? j : j + 1) / 5 - 2; }
__host__ __device__ constexpr int off_dx(int j) { return (j < 12 ? j : j + 1) % 5 - 2; }

// The TV-L1 threshold (tvl2_model.cpp:364-391), the twins' tvl1_threshold.
__device__ __forceinline__ void threshold(float a, float b, float rc, float gx,
                                          float gy, float g, float lt,
                                          float* v1, float* v2) {
  const float rho = rc + gx * a + gy * b;
  const float fi = g < kGradIsZero ? 0.0f : -rho / (g == 0.0f ? 1.0f : g);
  const bool lo = rho < -lt * g;
  const bool hi = rho > lt * g;
  *v1 = a + (lo ? lt * gx : (hi ? -lt * gx : fi * gx));
  *v2 = b + (lo ? lt * gy : (hi ? -lt * gy : fi * gy));
}

__device__ __forceinline__ float dual_step(float s, float w, float u,
                                           float un, float wt, float tau) {
  const float g = w * (u - un) / wt;
  const float upd = (s + tau * g) / (1.0f + tau * fabsf(g));
  return w > 0.0f ? upd : s;
}

// ---------------------------------------------------------------------------
// K6

struct GlobalPlanes {
  float* u1;
  float* u2;
  float* u1b;
  float* u2b;
  const float* __restrict__ wt;
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ grad;
  const float* __restrict__ rho_c;
  float* sp;   // (24, h, w)
  float* sq;
  const float* __restrict__ wp;
};

__device__ __forceinline__ void global_dual_at(const GlobalPlanes& p, int r,
                                               int c, int h, int w,
                                               float tau) {
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  const float b1 = p.u1b[i], b2 = p.u2b[i], wt = p.wt[i];
#pragma unroll
  for (int j = 0; j < kNd; ++j) {
    const int rr = r + off_dy(j), cc = c + off_dx(j);
    const bool in = rr >= 0 && rr < h && cc >= 0 && cc < w;
    const long long o = (long long)rr * w + cc;
    const float n1 = in ? p.u1b[o] : 0.0f;
    const float n2 = in ? p.u2b[o] : 0.0f;
    const float wj = p.wp[j * hw + i];
    p.sp[j * hw + i] = dual_step(p.sp[j * hw + i], wj, b1, n1, wt, tau);
    p.sq[j * hw + i] = dual_step(p.sq[j * hw + i], wj, b2, n2, wt, tau);
  }
}

__device__ __forceinline__ void global_primal_at(const GlobalPlanes& p, int r,
                                                 int c, int h, int w,
                                                 float l_t, float theta,
                                                 float tau) {
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  const float a = p.u1[i], b = p.u2[i];
  float v1, v2;
  threshold(a, b, p.rho_c[i], p.i1wx[i], p.i1wy[i], p.grad[i], l_t, &v1, &v2);
  float d1 = 0.0f, d2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kNd; ++j) {
    const int rr = r + off_dy(j), cc = c + off_dx(j);
    const bool in = rr >= 0 && rr < h && cc >= 0 && cc < w;
    const long long o = (kNd - 1 - j) * hw + (long long)rr * w + cc;
    const float n1 = in ? p.sp[o] : 0.0f;
    const float n2 = in ? p.sq[o] : 0.0f;
    const float wj = p.wp[j * hw + i];
    d1 = d1 + wj * (p.sp[j * hw + i] - n1);
    d2 = d2 + wj * (p.sq[j * hw + i] - n2);
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

// One thread a pixel, one 32x8 tile a block: the dual phase, then (the next
// launch) the primal phase of one iteration.
__global__ void __launch_bounds__(kTileW * kTileH)
    nltv_dual_kernel(GlobalPlanes p, int h, int w, float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r < h && c < w) global_dual_at(p, r, c, h, w, tau);
}

__global__ void __launch_bounds__(kTileW * kTileH)
    nltv_primal_kernel(GlobalPlanes p, int h, int w, float l_t, float theta,
                       float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r < h && c < w) global_primal_at(p, r, c, h, w, l_t, theta, tau);
}

// ---------------------------------------------------------------------------
// K7

struct PatchArgs {
  const float* __restrict__ u1;   // (B, P, P) each
  const float* __restrict__ u2;
  const float* __restrict__ v1;
  const float* __restrict__ v2;
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ grad;
  const float* __restrict__ rho_c;
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

// floats of shared memory a canvas: 48 duals, 2 u_bar, the error terms
// (p^2 each) and the row sums (p)
__host__ __device__ constexpr int canvas_floats(int p) { return 51 * p * p + p; }

// P > 0: the patch side at compile time.
template <int P>
__global__ void __launch_bounds__(P > 0 ? kPatchThreads : 1024)
    nltv_patch_kernel(PatchArgs a, int b, int p_rt, int cpb, int lt_cells,
                      int max_iters) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int lc = threadIdx.x / pp;
  const int cell = threadIdx.x - lc * pp;
  const int k = blockIdx.x * cpb + lc;
  const bool active = lc < cpb && k < b;
  float* sd = smem + (active ? lc : 0) * canvas_floats(p);  // [48][pp]
  float* ub = sd + 48 * pp;                                  // [2][pp]
  float* es = ub + 2 * pp;                                   // [pp]
  float* rs = es + pp;                                       // [p]
  const int r = cell / p, c = cell - r * p;
  const long long plane = (long long)b * pp;
  const long long ci = (long long)k * pp + cell;
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];

  float u1 = 0.0f, u2 = 0.0f, v1 = 0.0f, v2 = 0.0f, gx = 0.0f, gy = 0.0f,
        g = 0.0f, rc = 0.0f, wt = 1.0f, lt = 0.0f, npx = 1.0f;
  float w[kNd];
  bool inbox = false;
  if (active) {
    u1 = a.u1[ci];
    u2 = a.u2[ci];
    v1 = a.v1[ci];
    v2 = a.v2[ci];
    gx = a.i1wx[ci];
    gy = a.i1wy[ci];
    g = a.grad[ci];
    rc = a.rho_c[ci];
    wt = a.wt[ci];
    lt = lt_cells ? a.lt[ci] : a.lt[0];
    const int bh = a.ph[k], bw = a.pw[k];
    inbox = r < bh && c < bw;
    npx = (float)(bh * bw);
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      w[j] = a.wp[j * plane + ci];
      sd[j * pp + cell] = a.duals_in ? a.duals_in[j * plane + ci] : 0.0f;
      sd[(kNd + j) * pp + cell] =
          a.duals_in ? a.duals_in[(kNd + j) * plane + ci] : 0.0f;
    }
    ub[cell] = u1;
    ub[pp + cell] = u2;
  } else {
#pragma unroll
    for (int j = 0; j < kNd; ++j) w[j] = 0.0f;
  }
  float err = __int_as_float(0x7f800000);  // +inf: every canvas runs once
  int n = 0;
  for (int it = 0; it < max_iters; ++it) {
    const bool run = active && err > tol2 && n < max_iters;
    // the barrier that publishes u_bar (and the duals) of the last step
    if (!__syncthreads_or(run)) break;
    float nv1 = 0.0f, nv2 = 0.0f;
    if (run) {
      threshold(u1, u2, rc, gx, gy, g, lt, &nv1, &nv2);
      const float b1 = ub[cell], b2 = ub[pp + cell];
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int rr = r + off_dy(j), cc = c + off_dx(j);
        const bool in = rr >= 0 && rr < p && cc >= 0 && cc < p;
        const float n1 = in ? ub[rr * p + cc] : 0.0f;
        const float n2 = in ? ub[pp + rr * p + cc] : 0.0f;
        float* s1 = sd + j * pp + cell;
        float* s2 = sd + (kNd + j) * pp + cell;
        *s1 = dual_step(*s1, w[j], b1, n1, wt, tau);
        *s2 = dual_step(*s2, w[j], b2, n2, wt, tau);
      }
    }
    __syncthreads();
    float nu1 = 0.0f, nu2 = 0.0f;
    if (run) {
      float d1 = 0.0f, d2 = 0.0f;
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        const int rr = r + off_dy(j), cc = c + off_dx(j);
        const bool in = rr >= 0 && rr < p && cc >= 0 && cc < p;
        const int m = kNd - 1 - j;
        const float n1 = in ? sd[m * pp + rr * p + cc] : 0.0f;
        const float n2 = in ? sd[(kNd + m) * pp + rr * p + cc] : 0.0f;
        d1 = d1 + w[j] * (sd[j * pp + cell] - n1);
        d2 = d2 + w[j] * (sd[(kNd + j) * pp + cell] - n2);
      }
      nu1 = u1 - tau * (d1 + (u1 - nv1) / theta);
      nu2 = u2 - tau * (d2 + (u2 - nv2) / theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      es[cell] = inbox ? e1 * e1 + e2 * e2 : 0.0f;
    }
    __syncthreads();
    if (run && cell < p) {  // canvas_sum: each row over its columns
      float s = es[cell * p];
      for (int cc = 1; cc < p; ++cc) s = s + es[cell * p + cc];
      rs[cell] = s;
    }
    __syncthreads();
    if (run) {  // then over the rows; every cell of the canvas alike
      float t = rs[0];
      for (int rr = 1; rr < p; ++rr) t = t + rs[rr];
      err = t / npx;
      ub[cell] = 2.0f * nu1 - u1;
      ub[pp + cell] = 2.0f * nu2 - u2;
      u1 = nu1;
      u2 = nu2;
      v1 = nv1;
      v2 = nv2;
      ++n;
    }
  }
  if (!active) return;
  a.u1o[ci] = u1;
  a.u2o[ci] = u2;
  a.v1o[ci] = v1;
  a.v2o[ci] = v2;
  if (cell == 0) a.iters[k] = n;
  if (a.duals_out) {
    // every thread of the canvas passed the last barrier of its loop, so its
    // duals are final (a canvas that left the loop early wrote none since)
#pragma unroll
    for (int j = 0; j < kNd; ++j) {
      a.duals_out[j * plane + ci] = sd[j * pp + cell];
      a.duals_out[(kNd + j) * plane + ci] = sd[(kNd + j) * pp + cell];
    }
  }
}

template <int P>
cudaError_t launch_patch(const PatchArgs& a, int b, int p, int cpb,
                         int lt_cells, int max_iters, cudaStream_t st) {
  const int threads = ((cpb * p * p + 31) / 32) * 32;
  const size_t smem = (size_t)cpb * canvas_floats(p) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nltv_patch_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((b + cpb - 1) / cpb);
  nltv_patch_kernel<P><<<grid, threads, smem, st>>>(a, b, p, cpb, lt_cells,
                                                     max_iters);
  return cudaGetLastError();
}

}  // namespace

// K6: u1 u2 u1b u2b wt i1wx i1wy grad rho_c (h, w) and sp sq wp (24, h, w),
// all float32 on one device; the whole loop enqueued on the stream, two
// launches an iteration.
extern "C" int faldoi_nltv_global_loop(
    float* u1, float* u2, float* u1b, float* u2b, const float* wt,
    const float* i1wx, const float* i1wy, const float* grad,
    const float* rho_c, float* sp, float* sq, const float* wp, int h, int w,
    float l_t, float theta, float tau, int max_iters, void* stream) {
  if (max_iters <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(kTileW, kTileH);
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  GlobalPlanes p{u1, u2, u1b, u2b, wt, i1wx, i1wy, grad, rho_c, sp, sq, wp};
  for (int n = 0; n < max_iters; ++n) {
    nltv_dual_kernel<<<tiles, block, 0, st>>>(p, h, w, tau);
    nltv_primal_kernel<<<tiles, block, 0, st>>>(p, h, w, l_t, theta, tau);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K7: ins = u1 u2 v1 v2 i1wx i1wy grad rho_c wp wt lt scal ph pw duals_in,
// outs = u1 u2 v1 v2 iters duals_out (duals_in/out may be null); b canvases
// of p x p, p^2 <= 1024.
extern "C" int faldoi_nltv_patch_loop(
    const float* u1, const float* u2, const float* v1, const float* v2,
    const float* i1wx, const float* i1wy, const float* grad,
    const float* rho_c, const float* wp, const float* wt, const float* lt,
    const float* scal, const int* ph, const int* pw, const float* duals_in,
    float* u1o, float* u2o, float* v1o, float* v2o, int* iters,
    float* duals_out, int b, int p, int lt_cells, int max_iters,
    void* stream) {
  if (b <= 0) return 0;
  if (p <= 0 || p * p > 1024) return (int)cudaErrorInvalidValue;
  PatchArgs a{u1, u2, v1, v2, i1wx, i1wy, grad, rho_c, wp, wt, lt, scal,
              ph, pw, duals_in, u1o, u2o, v1o, v2o, iters, duals_out};
  const int cpb = p * p <= kPatchThreads ? kPatchThreads / (p * p) : 1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (p == 11)
    e = launch_patch<11>(a, b, p, cpb, lt_cells, max_iters, st);
  else if (p == 3)
    e = launch_patch<3>(a, b, p, cpb, lt_cells, max_iters, st);
  else
    e = launch_patch<0>(a, b, p, cpb, lt_cells, max_iters, st);
  return (int)e;
}

