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
// K6: two plain launches an iteration (the dual phase, then the primal
// phase; the launch boundary is the barrier), all enqueued by one call.
// The state lives in device memory: u, u_bar (4 planes), the 48 dual planes
// (85.7 MB at 436x1024), wt and the weights; it does not fit the 50 MB L2,
// so the loop is bound by the bytes it streams an iteration.  Bound as the
// row counts it: per call 81 planes read once and 52 written once (237 MB at
// 436x1024, 0.071 ms at 3.35 TB/s) against ~656 float operations a pixel an
// iteration (1.75 ms at 400 iterations and 67 TFLOP/s): bound by operations.
// What the design does about the bytes:
//  * the weights are symmetric, w_j(x) == w_{23-j}(x + d_j) bit for bit
//    (nltv_weights builds them so; the wrapper states it as a precondition
//    and the card checks hold the kernel to the twin, which reads all 24
//    planes), so only planes 0-11 are read: w_j(x) for j >= 12 is plane
//    23 - j at x + d_j.  12 planes (21.4 MB at 436x1024) can stay in L2;
//  * the dual phase reads each dual plane once at x and writes it once,
//    both marked streaming (evict first), a thread a pixel, with the loads
//    of four offsets issued before their dual steps (restrict pointers);
//  * the primal phase takes the reciprocal pairs (j, 23 - j), j = 0..11, in
//    turn, so a pair's planes are read at x and at x -+ d_j together and
//    the shifted reads find the lines in L1: term j, w_j(x) (sc_j(x) -
//    sc_{23-j}(x + d_j)), and term 23 - j, w_j(x - d_j) (sc_{23-j}(x) -
//    sc_j(x - d_j)).  Terms 0-11 fold into the sum as they come; terms
//    12-23 wait in registers and fold after the last pair, so the sum runs
//    over j in order from zero, as the twin's.
// That is ~111 plane passes from device memory in the dual phase and ~71 in
// the primal, against 133 for the state read and written once an iteration.
// Both phases take 32x8 tiles at four blocks an SM (64 registers a thread).
// On an H100 at 436x1024, staging the pairs in shared memory (cp.async, a
// halo of 2) lost to L1, and one launch an iteration that recomputes the
// primal on the tile's halo (u_bar kept in shared memory, duals and u
// ping-ponged) came out no faster; the dual phase runs at ~1.3x the time of
// streaming its 48 dual planes in and out alone.
//
// K7: two threads a canvas cell, one a flow component (242 of 256 threads
// at P 11), one canvas a block at P 11 (eight at P 3, a canvas's threads
// on whole warps).  A canvas's 48 duals, u_bar, u and the last step's
// updates live in shared memory, where the neighbour reads go; a cell's 24
// weights and its constants stay in registers for the whole loop.  Each
// thread runs the 24 dual steps and the divergence of its component (half
// the dependent division chain of a cell, twice the warps in flight); the
// threshold needs both components and reads the other from shared memory.
// A dual step of weight 0 keeps its dual and is skipped (it would discard
// its update).  The loop is the masked unroll of JAX's _bounded_pd_loop: a
// canvas runs while err > tol^2 and n < max_iters (err starts at +inf; a
// NaN err freezes it); err is the canvas_sum of the in-box squared updates
// (each row over its columns, then the rows, in order) over the box's cell
// count: the canvas's first P threads, one warp, take a row each, and sum
// the rows by shuffles, so an iteration has three block barriers.  A block
// leaves the loop when none of its canvases runs.  The duals start at 0 in
// the kernel unless given, and are written out only when asked (the local
// step's single warp needs neither).  Bound: the canvases read once (u, v,
// the four warp constants, the 24 weights, wt, l_t where per cell) and u, v
// written once: 37 canvases at B 8192, P 11 (147 MB, 0.044 ms) against
// ~661 float operations a cell an iteration run.  What holds it: the
// dependent IEEE divisions of the dual steps (two a step) and the barriers,
// so the design puts more warps in flight rather than moving fewer bytes.

#include <cuda_runtime.h>

namespace {

constexpr float kGradIsZero = 1e-8f;
constexpr int kNd = 24;
constexpr int kHalf = kNd / 2;
constexpr int kTileW = 32;    // K6, both phases: a 32x8 tile a block
constexpr int kTileH = 8;
constexpr int kDualLoads = 4; // offsets whose loads go out together
constexpr int kK6Blocks = 4;  // blocks an SM: 64 registers a thread
constexpr int kPatchThreads = 256;  // threads a K7 block, for 2 P^2 <= 256

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
  const float* __restrict__ wp;   // (24, h, w), symmetric: planes 0-11 read
};

// The dual phase of one iteration, a thread a pixel.
__global__ void __launch_bounds__(kTileW * kTileH, kK6Blocks)
    nltv_dual_kernel(GlobalPlanes p, int h, int w, float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r >= h || c >= w) return;
  const float* __restrict__ u1b = p.u1b;
  const float* __restrict__ u2b = p.u2b;
  const float* __restrict__ wp = p.wp;
  float* __restrict__ sp = p.sp;
  float* __restrict__ sq = p.sq;
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  const float b1 = __ldg(u1b + i), b2 = __ldg(u2b + i);
  const float wt = __ldg(p.wt + i);
#pragma unroll
  for (int j0 = 0; j0 < kNd; j0 += kDualLoads) {
    float s1[kDualLoads], s2[kDualLoads], wj[kDualLoads], n1[kDualLoads],
        n2[kDualLoads];
#pragma unroll
    for (int q = 0; q < kDualLoads; ++q) {
      const int j = j0 + q;
      const int rr = r + off_dy(j), cc = c + off_dx(j);
      const bool in = rr >= 0 && rr < h && cc >= 0 && cc < w;
      const long long o = (long long)rr * w + cc;
      n1[q] = in ? __ldg(u1b + o) : 0.0f;
      n2[q] = in ? __ldg(u2b + o) : 0.0f;
      // w_j(x), or for j >= 12 its mirror w_{23-j}(x + d_j)
      wj[q] = j < kHalf ? __ldg(wp + j * hw + i)
                        : (in ? __ldg(wp + (kNd - 1 - j) * hw + o) : 0.0f);
      s1[q] = __ldcs(sp + j * hw + i);
      s2[q] = __ldcs(sq + j * hw + i);
    }
#pragma unroll
    for (int q = 0; q < kDualLoads; ++q) {
      const int j = j0 + q;
      __stcs(sp + j * hw + i, dual_step(s1[q], wj[q], b1, n1[q], wt, tau));
      __stcs(sq + j * hw + i, dual_step(s2[q], wj[q], b2, n2[q], wt, tau));
    }
  }
}

// The primal phase of one iteration, a thread a pixel: the divergence by
// reciprocal pairs, then the threshold and the primal step.
__global__ void __launch_bounds__(kTileW * kTileH, kK6Blocks)
    nltv_primal_kernel(GlobalPlanes p, int h, int w, float l_t, float theta,
                       float tau) {
  const int r = blockIdx.y * kTileH + threadIdx.y;
  const int c = blockIdx.x * kTileW + threadIdx.x;
  if (r >= h || c >= w) return;
  const float* __restrict__ sp = p.sp;
  const float* __restrict__ sq = p.sq;
  const float* __restrict__ wp = p.wp;
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  float d1 = 0.0f, d2 = 0.0f;
  float m1[kHalf], m2[kHalf];   // terms 23 - j, folded after term 11
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const int m = kNd - 1 - j;
    const int rp = r + off_dy(j), cp = c + off_dx(j);
    const int rn = r - off_dy(j), cn = c - off_dx(j);
    const bool ip = rp >= 0 && rp < h && cp >= 0 && cp < w;
    const bool in = rn >= 0 && rn < h && cn >= 0 && cn < w;
    const long long op = (long long)rp * w + cp, on = (long long)rn * w + cn;
    const float wj = __ldg(wp + j * hw + i);                  // w_j(x)
    const float wm = in ? __ldg(wp + j * hw + on) : 0.0f;     // w_{23-j}(x)
    d1 = d1 + wj * (__ldg(sp + j * hw + i) - (ip ? __ldg(sp + m * hw + op) : 0.0f));
    d2 = d2 + wj * (__ldg(sq + j * hw + i) - (ip ? __ldg(sq + m * hw + op) : 0.0f));
    m1[j] = wm * (__ldg(sp + m * hw + i) - (in ? __ldg(sp + j * hw + on) : 0.0f));
    m2[j] = wm * (__ldg(sq + m * hw + i) - (in ? __ldg(sq + j * hw + on) : 0.0f));
  }
#pragma unroll
  for (int j = kHalf - 1; j >= 0; --j) {
    d1 = d1 + m1[j];
    d2 = d2 + m2[j];
  }
  const float a = p.u1[i], b = p.u2[i];
  float v1, v2;
  threshold(a, b, p.rho_c[i], p.i1wx[i], p.i1wy[i], p.grad[i], l_t, &v1, &v2);
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

// floats of shared memory a canvas: 48 duals, then u_bar, u and the last
// update of each component (p^2 each), then the canvas's run flag
__host__ __device__ constexpr int canvas_floats(int p) { return 54 * p * p + 1; }

// threads a canvas: nc components a thread, on whole warps
__host__ __device__ constexpr int canvas_threads(int p, int nc) {
  return ((2 / nc) * p * p + 31) / 32 * 32;
}

// P > 0: the patch side at compile time.  NC: flow components a thread (1:
// two threads a cell; 2: one, for canvases too large for two).
template <int P, int NC>
__global__ void __launch_bounds__(P > 0 ? kPatchThreads : 1024, P > 0 ? 4 : 1)
    nltv_patch_kernel(PatchArgs a, int b, int p_rt, int cpb, int lt_cells,
                      int max_iters) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int cs = canvas_threads(p, NC);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;
  const int c0 = NC == 2 ? 0 : t / pp;     // this thread's first component
  const int cell = t - c0 * pp;
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < b;
  const bool active = canvas && t < (2 / NC) * pp;
  float* sd = smem + (lc < cpb ? lc : 0) * canvas_floats(p);  // [2][24][pp]
  float* ub = sd + 48 * pp;                                   // [2][pp]
  float* un = ub + 2 * pp;                                    // [2][pp]
  float* ec = un + 2 * pp;                                    // [2][pp]
  float* flag = ec + 2 * pp;                                  // [1]
  const int r = cell / p, c = cell - r * p;
  const long long plane = (long long)b * pp;
  const long long ci = (long long)k * pp + cell;
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];
  const bool leader = canvas && t == 0;

  float u[NC], v[NC];
  float gx = 0.0f, gy = 0.0f, g = 0.0f, rc = 0.0f, wt = 1.0f, lt = 0.0f,
        npx = 1.0f;
  float w[kNd];
  int bh = 0, bw = 0;
#pragma unroll
  for (int q = 0; q < NC; ++q) u[q] = v[q] = 0.0f;
  if (canvas) {
    bh = a.ph[k];
    bw = a.pw[k];
    npx = (float)(bh * bw);
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int cc = c0 + q;
      u[q] = (cc == 0 ? a.u1 : a.u2)[ci];
      v[q] = (cc == 0 ? a.v1 : a.v2)[ci];
      ub[cc * pp + cell] = u[q];
      un[cc * pp + cell] = u[q];
#pragma unroll
      for (int j = 0; j < kNd; ++j)
        sd[(cc * kNd + j) * pp + cell] =
            a.duals_in ? a.duals_in[(cc * kNd + j) * plane + ci] : 0.0f;
    }
    gx = a.i1wx[ci];
    gy = a.i1wy[ci];
    g = a.grad[ci];
    rc = a.rho_c[ci];
    wt = a.wt[ci];
    lt = lt_cells ? a.lt[ci] : a.lt[0];
#pragma unroll
    for (int j = 0; j < kNd; ++j) w[j] = a.wp[j * plane + ci];
  } else {
#pragma unroll
    for (int j = 0; j < kNd; ++j) w[j] = 0.0f;
  }
  if (leader) flag[0] = max_iters > 0 ? 1.0f : 0.0f;   // err = +inf
  int n = 0;
  for (int it = 0; it < max_iters; ++it) {
    // the barrier that publishes u_bar, u, the duals and the run flags of
    // the last step
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    float nv[NC];
    if (run) {
      const float u1 = (NC == 2 || c0 == 0) ? u[0] : un[cell];
      const float u2 = NC == 2 ? u[NC - 1] : (c0 == 1 ? u[0] : un[pp + cell]);
      float nv1, nv2;
      threshold(u1, u2, rc, gx, gy, g, lt, &nv1, &nv2);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int cc = c0 + q;
        nv[q] = cc == 0 ? nv1 : nv2;
        const float* ubc = ub + cc * pp;
        const float bc = ubc[cell];
        float* sdc = sd + cc * kNd * pp + cell;
#pragma unroll
        for (int j = 0; j < kNd; ++j) {
          if (!(w[j] > 0.0f)) continue;   // dual_step keeps s: skip it
          const int rr = r + off_dy(j), cx = c + off_dx(j);
          const bool in = rr >= 0 && rr < p && cx >= 0 && cx < p;
          const float nb = in ? ubc[rr * p + cx] : 0.0f;
          sdc[j * pp] = dual_step(sdc[j * pp], w[j], bc, nb, wt, tau);
        }
      }
    }
    __syncthreads();
    if (run) {
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int cc = c0 + q;
        const float* sdc = sd + cc * kNd * pp;
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < kNd; ++j) {
          const int rr = r + off_dy(j), cx = c + off_dx(j);
          const bool in = rr >= 0 && rr < p && cx >= 0 && cx < p;
          const float nb = in ? sdc[(kNd - 1 - j) * pp + rr * p + cx] : 0.0f;
          d = d + w[j] * (sdc[j * pp + cell] - nb);
        }
        const float nu = u[q] - tau * (d + (u[q] - nv[q]) / theta);
        ec[cc * pp + cell] = nu - u[q];
        un[cc * pp + cell] = nu;
        ub[cc * pp + cell] = 2.0f * nu - u[q];
        u[q] = nu;
        v[q] = nv[q];
      }
      ++n;
    }
    __syncthreads();
    if (run && t < p) {   // canvas_sum: row t over its columns, one warp
      float s = 0.0f;
      for (int cx = 0; cx < p; ++cx) {
        const float e1 = ec[t * p + cx], e2 = ec[pp + t * p + cx];
        const float es = t < bh && cx < bw ? e1 * e1 + e2 * e2 : 0.0f;
        s = cx == 0 ? es : s + es;
      }
      const unsigned mask = p == 32 ? 0xffffffffu : (1u << p) - 1u;
      float tot = __shfl_sync(mask, s, 0);   // then over the rows
      for (int rr = 1; rr < p; ++rr) tot = tot + __shfl_sync(mask, s, rr);
      const float err = tot / npx;
      if (t == 0) flag[0] = err > tol2 && n < max_iters ? 1.0f : 0.0f;
    }
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int cc = c0 + q;
    (cc == 0 ? a.u1o : a.u2o)[ci] = u[q];
    (cc == 0 ? a.v1o : a.v2o)[ci] = v[q];
  }
  if (t == 0) a.iters[k] = n;
  if (a.duals_out) {
    // every thread of the canvas passed the last barrier of its loop, so its
    // duals are final (a canvas that left the loop early wrote none since)
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int cc = c0 + q;
#pragma unroll
      for (int j = 0; j < kNd; ++j)
        a.duals_out[(cc * kNd + j) * plane + ci] = sd[(cc * kNd + j) * pp + cell];
    }
  }
}

template <int P, int NC>
cudaError_t launch_patch(const PatchArgs& a, int b, int p, int lt_cells,
                         int max_iters, cudaStream_t st) {
  const int cs = canvas_threads(p, NC);
  const int cpb = cs <= kPatchThreads ? kPatchThreads / cs : 1;
  const size_t smem = (size_t)cpb * canvas_floats(p) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nltv_patch_kernel<P, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((b + cpb - 1) / cpb);
  nltv_patch_kernel<P, NC><<<grid, cpb * cs, smem, st>>>(a, b, p, cpb, lt_cells,
                                                         max_iters);
  return cudaGetLastError();
}

}  // namespace

// K6: u1 u2 u1b u2b wt i1wx i1wy grad rho_c (h, w) and sp sq wp (24, h, w),
// all float32 on one device, wp symmetric (planes 0-11 are read); the whole
// loop enqueued on the stream, two launches an iteration.
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
  cudaStream_t st = (cudaStream_t)stream;
  if (p == 11) return (int)launch_patch<11, 1>(a, b, p, lt_cells, max_iters, st);
  if (p == 3) return (int)launch_patch<3, 1>(a, b, p, lt_cells, max_iters, st);
  if (2 * p * p <= 1024)
    return (int)launch_patch<0, 1>(a, b, p, lt_cells, max_iters, st);
  return (int)launch_patch<0, 2>(a, b, p, lt_cells, max_iters, st);
}
