// K9: the occlusion primal-dual loop of method 8 (TV-L1 with occlusions),
// in two forms.
//
// Replaces the XLA-lowered while_loop body of the JAX package's
// faldoi_tpu/core/occlusion.py::solve_occ_canvas (:173-241) with _get_xi
// (:81-111) and _get_chi (:114-136):
//   patch form:       one warp's whole tol-gated PD loop of B canvases of
//                     P x P (the m8 patch solve), one launch;
//   whole-image form: one warp's whole tol-gated PD loop over the image
//                     (the m8 global step, _occ_global_jit :276), one
//                     cooperative launch with the tol exit on the card.
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
// planes of B P^2 floats, is 0.0248 ms at B 8192, P 11; its work is ~1,970
// float operations a cell a PD iteration (core/occlusion.py PD_OPS), 0.081
// ms at B 8192 and three PD iterations.  What holds it is the latency of
// the IEEE square roots and divisions (without them, timing only, it takes
// 36% of its time; without its inner barriers 94%: cli/k9_variants.py);
// a canvas a warp and one barrier a step (k9_variants.cu) lost to it.
//
// Whole-image form: one cooperative launch a warp (occ_global_loop_kernel
// below): co-resident blocks each own a tile and keep its state in shared
// memory, exchange only their tiles' frames through device memory, one grid
// barrier every K steps (48 / K a PD iteration); the err is the maximum of
// the squared updates by atomicMax on their bits (non-negative, a NaN made
// the positive quiet NaN so that it wins) into rotating device slots, read
// by every thread after the iteration's last barrier.  Bounds (H100): 31
// planes of h w floats each way once a launch (0.0165 ms at 436x1024) against
// ~1,970 float operations a pixel a PD iteration (core/occlusion.py PD_OPS;
// 0.013 ms an iteration at 436x1024): a launch of more than one iteration is
// bound by operations; in practice by the same latency as the patch form's,
// then by the phases (1.1 us a grid barrier; depth 3, 16 a PD iteration,
// was the fastest of depths 1-3).  The former form (one PD iteration as 99
// plain launches and the host's read of err) is csrc/variants/
// k9_variants.cu's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kSteps = 24;             // ITER_XI - 1 = ITER_CHI - 1
constexpr float kGradIsZero = 1e-8f;   // GRAD_IS_ZERO
constexpr float kDelta = 0.6f;         // THRESHOLD_DELTA
constexpr int kBlock = 128;            // patch form: threads a block (P <= 11)

enum { U1, U2, CHI, X11, X12, X21, X22, E1, E2, V1, V2 };
enum { IWX, IWY, I_WX, I_WY, GRAD1, GRAD_1, RHO1, RHO_1 };

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

// the block of P^2 <= 128 (P 3 to 11) is 128 threads; at P 11 the launch
// bounds ask for 12 blocks an SM (40 registers a thread, some spilled):
// more warps hide more of the square roots' and divisions' latency, which
// holds this form (PERF.md 6: 1.33 ms at B 8192 on an H100 against 1.77 at
// the 6 blocks that 78 registers allow; slower at P 3, which keeps them).
// A call that 6 blocks an SM already hold at once (B under 792 at P 11,
// 488 of the m8 path's 692 calls there) gains no warps and pays for the
// spills: ~8%
// slower (B 297 0.159 ms against 0.148, B 1 0.144 against 0.132); the sum
// over the path's calls still falls, as its large calls dominate it.  The
// wrapper knows B and could pick the bounds by it.
template <int P>
__global__ void __launch_bounds__(P > 0 && P * P <= kBlock ? kBlock : 1024,
                                  P == 11 ? 12 : 1)
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
#pragma unroll 1
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
#pragma unroll 1
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


// ------------------------------------------------- whole-image form: the loop

constexpr int kGDepth = 3;       // steps between two exchanges (the
                                 // fastest of 1-3, cli/k9_variants.py)
constexpr int kGThreads = 1024;  // threads a block (one block an SM)
constexpr int kGCells = 4096;    // chi-region pixels a block, in registers
constexpr int kGPlanes = 12;     // shared planes over a tile and its ring
constexpr int kXPlanes = 7;      // exchange planes: xi x4, eta x2, chi
// the shared planes; the first kXPlanes are the exchange planes' order
enum { PX11, PX12, PX21, PX22, PE1, PE2, PCHI, PV1, PV2, PW1, PW2, PG };

struct Plan {
  int th, tw;       // tile rows and columns (the last row / column of tiles
                    // may be cut by the image)
  int ty, tx;       // tiles down and across
  int ld, plane;    // a shared plane's row stride and its floats
  int blocks;       // co-resident blocks launched
  int resident;     // 1: a block holds one tile for the whole launch
  long long spill;  // floats a tile keeps in device memory between phases
                    // when not resident (its shared planes and slots)
  size_t smem;      // dynamic shared bytes a block
};

struct LoopArgs {
  float* st;          // (11, h, w), updated in place
  const float* wc;    // (8, h, w)
  const float* g;     // (h, w)
  const float* scal;  // (14,)
  float* xch;         // (2, 7, h, w) exchange planes
  float* spill;       // (tiles, spill) when not resident
  unsigned* slots;    // three err slots (float bits), then the count
  int h, w, max_iters;
  Plan p;
};

// a tile: rows r0..r1, columns c0..c1; its shared planes start at (orow, ocol)
struct Tile {
  int r0, r1, c0, c1, orow, ocol;
};

template <int R>
__device__ __forceinline__ Tile tile_of(const LoopArgs& a, int t) {
  const int tr = t / a.p.tx, tc = t - tr * a.p.tx;
  Tile T;
  T.r0 = tr * a.p.th;
  T.c0 = tc * a.p.tw;
  T.r1 = min(T.r0 + a.p.th, a.h) - 1;
  T.c1 = min(T.c0 + a.p.tw, a.w) - 1;
  T.orow = T.r0 - R;
  T.ocol = T.c0 - R;
  return T;
}

__device__ __forceinline__ bool in_tile(const Tile& T, int r, int c) {
  return r >= T.r0 && r <= T.r1 && c >= T.c0 && c <= T.c1;
}

// f(r, c, l) for every pixel of rows ra..rb and columns ca..cb clipped to the
// image, l its index in the tile's shared planes; the block's NT threads take
// the pixels in raster order
template <int NT, typename Fn>
__device__ __forceinline__ void each(const LoopArgs& a, const Tile& T, int ra,
                                     int rb, int ca, int cb, Fn f) {
  ra = max(ra, 0);
  ca = max(ca, 0);
  rb = min(rb, a.h - 1);
  cb = min(cb, a.w - 1);
  const int nc = cb - ca + 1;
  if (nc <= 0 || rb < ra) return;
  const int n = nc * (rb - ra + 1);
  const int dr = NT / nc, dc = NT - dr * nc;
  int r = threadIdx.x / nc, c = threadIdx.x - r * nc;
  for (int i = threadIdx.x; i < n; i += NT) {
    f(ra + r, ca + c, (ra + r - T.orow) * a.p.ld + (ca + c - T.ocol));
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// copy planes q0..q1-1 of the exchange planes x into the tile's ring (its
// shared region outside the tile)
template <int R, int NT>
__device__ __forceinline__ void get_ring(const LoopArgs& a, const Tile& T,
                                         float* sm, const float* x, int q0,
                                         int q1) {
  const long long n = (long long)a.h * a.w;
  each<NT>(a, T, T.r0 - R, T.r1 + R, T.c0 - R, T.c1 + R, [&](int r, int c,
                                                            int l) {
    if (in_tile(T, r, c)) return;
    const long long i = (long long)r * a.w + c;
    for (int q = q0; q < q1; ++q) sm[q * a.p.plane + l] = __ldcg(x + q * n + i);
  });
}

// copy planes q0..q1-1 of the tile's pixels within R of its edge (the rings
// of the tiles around read them) into the exchange planes x
template <int R, int NT>
__device__ __forceinline__ void put_frame(const LoopArgs& a, const Tile& T,
                                          const float* sm, float* x, int q0,
                                          int q1) {
  const long long n = (long long)a.h * a.w;
  each<NT>(a, T, T.r0, T.r1, T.c0, T.c1, [&](int r, int c, int l) {
    if (r - T.r0 >= R && T.r1 - r >= R && c - T.c0 >= R && T.c1 - c >= R)
      return;
    const long long i = (long long)r * a.w + c;
    for (int q = q0; q < q1; ++q) __stcg(x + q * n + i, sm[q * a.p.plane + l]);
  });
}

// a tile's shared planes and register slots to (save) or from its spill
template <int NT>
__device__ __forceinline__ void spill_io(const LoopArgs& a, int t, float* sm,
                                         float* F, float* G, float* D,
                                         bool save) {
  constexpr int kSlots = kGCells / NT;
  float* sp = a.spill + (long long)t * a.p.spill;
  const int nf = kGPlanes * a.p.plane;
  __syncthreads();
  for (int i = threadIdx.x; i < nf; i += NT) {
    if (save)
      __stcg(sp + i, sm[i]);
    else
      sm[i] = __ldcg(sp + i);
  }
  float* rs = sp + nf + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    float* o = rs + 3 * q * NT;
    if (save) {
      __stcg(o, F[q]);
      __stcg(o + NT, G[q]);
      __stcg(o + 2 * NT, D[q]);
    } else {
      F[q] = __ldcg(o);
      G[q] = __ldcg(o + NT);
      D[q] = __ldcg(o + 2 * NT);
    }
  }
  __syncthreads();
}

// div(g a, g b) at l (r, c) of the image from the shared planes: Chambolle's
// boundaries at the image's edge, the products as the twin forms them
__device__ __forceinline__ float div_g(const LoopArgs& a, const float* gp,
                                       const float* pa, const float* pb,
                                       int l, int r, int c) {
  const float a0 = gp[l] * pa[l];
  const float al = c > 0 ? gp[l - 1] * pa[l - 1] : 0.0f;
  const float b0 = gp[l] * pb[l];
  const float bu = r > 0 ? gp[l - a.p.ld] * pb[l - a.p.ld] : 0.0f;
  const float dx = c == 0 ? a0 : (c == a.w - 1 ? -al : a0 - al);
  const float dy = r == 0 ? b0 : (r == a.h - 1 ? -bu : b0 - bu);
  return dx + dy;
}

// div(a, b) at l: as div_g of planes that hold the products
__device__ __forceinline__ float div_p(const LoopArgs& a, const float* pa,
                                       const float* pb, int l, int r, int c) {
  const float a0 = pa[l], al = c > 0 ? pa[l - 1] : 0.0f;
  const float b0 = pb[l], bu = r > 0 ? pb[l - a.p.ld] : 0.0f;
  const float dx = c == 0 ? a0 : (c == a.w - 1 ? -al : a0 - al);
  const float dy = r == 0 ? b0 : (r == a.h - 1 ? -bu : b0 - bu);
  return dx + dy;
}

// forward gradient of a shared plane at l (r, c): zero on the image's last
// column / row
__device__ __forceinline__ void grad_p(const LoopArgs& a, const float* f, int l,
                                       int r, int c, float& fx, float& fy) {
  fx = c < a.w - 1 ? f[l + 1] - f[l] : 0.0f;
  fy = r < a.h - 1 ? f[l + a.p.ld] - f[l] : 0.0f;
}

// The whole tol-gated PD loop of one warp over the image, in one cooperative
// launch.  Every block owns tiles of th x tw pixels (one for the whole launch
// when resident) and keeps each tile's state in shared planes over the tile
// and a ring of R = K + 1 pixels: xi, eta, chi, v, g and a work pair (v +
// theta div(g xi) + theta beta grad chi in the xi steps, nu after them, g
// eta in the eta / chi steps).  A step reads its neighbours at distance 1
// (the diagonal ones (r - 1, c + 1) and (r + 1, c - 1) too), so a block
// computes K steps on its tile grown by K - 1, K - 2, .., 0 pixels, its
// neighbours' values in the ring recomputed from the same inputs (bit for bit
// the owner's), and then exchanges: it writes its tile's frame of width R to
// device memory (two alternating sets of exchange planes), the grid
// synchronises, and it reads its ring back.  A PD iteration is 48 / K
// phases, each ended by one grid barrier:
//   xi phase 0        the ring of eta and chi (the previous iteration's),
//                     the v-step on the tile grown by K (u read from the
//                     state in device memory), K xi steps;
//   xi phases 1..     the ring of xi, K xi steps;
//   chi phase 0       the ring of xi; nu on the tile grown by K up and left
//                     (its squared update's maximum on the tile folded into
//                     this iteration's err slot; u written to the state),
//                     div nu, F and G on the tile grown by K - 1 (into
//                     registers, kGCells / NT pixels a thread); K eta / chi
//                     steps;
//   chi phases 1..    the ring of eta and chi, K eta / chi steps, the last
//                     binarising chi.
// After the last barrier every thread reads the same err slot (three rotate,
// as in csrc/global_pd.cu) and decides the same way.  When the tiles are more
// than the blocks that can be co-resident (the image larger than the SMs'
// shared memory holds), each block walks its tiles in grid-stride order and
// a tile's shared planes and slots go to device memory between phases.
template <int K, int NT>
__global__ void __launch_bounds__(NT, 1)
    occ_global_loop_kernel(LoopArgs a) {
  constexpr int R = K + 1;
  constexpr int kSlots = kGCells / NT;
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  const Scal s = load_scal(a.scal);
  const long long n = (long long)a.h * a.w;
  const int ntiles = a.p.ty * a.p.tx;
  const int pl = a.p.plane, ld = a.p.ld;
  float* X[4] = {sm + PX11 * pl, sm + PX12 * pl, sm + PX21 * pl,
                 sm + PX22 * pl};
  float* E1p = sm + PE1 * pl;
  float* E2p = sm + PE2 * pl;
  float* CHp = sm + PCHI * pl;
  float* V1p = sm + PV1 * pl;
  float* V2p = sm + PV2 * pl;
  float* W1p = sm + PW1 * pl;
  float* W2p = sm + PW2 * pl;
  float* Gp = sm + PG * pl;
  float Fs[kSlots], Gs[kSlots], Ds[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) Fs[q] = Gs[q] = Ds[q] = 0.0f;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  const bool spills = !a.p.resident;

  // every tile's initial xi, eta, chi and g, its ring included
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile T = tile_of<R>(a, t);
    each<NT>(a, T, T.r0 - R, T.r1 + R, T.c0 - R, T.c1 + R,
         [&](int r, int c, int l) {
           const long long i = (long long)r * a.w + c;
#pragma unroll
           for (int q = 0; q < 4; ++q) X[q][l] = a.st[(X11 + q) * n + i];
           E1p[l] = a.st[E1 * n + i];
           E2p[l] = a.st[E2 * n + i];
           CHp[l] = a.st[CHI * n + i];
           Gp[l] = a.g[i];
         });
    if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, true);
  }
  __syncthreads();
  if (leader) atomicExch(a.slots, 0u);
  float err = __int_as_float(0x7f800000);  // +inf: the loop runs at least once
  int it = 0, par = 0;
  while (err > s.tol2 && it < a.max_iters) {
    unsigned* slot = a.slots + it % 3;
    if (leader) atomicExch(a.slots + (it + 1) % 3, 0u);
    // the xi phases
    for (int seg = 0; seg < kSteps / K; ++seg) {
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile T = tile_of<R>(a, t);
        if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, false);
        const float* xr = a.xch + (long long)par * kXPlanes * n;
        if (seg > 0)
          get_ring<R, NT>(a, T, sm, xr, PX11, PX22 + 1);
        else if (it > 0)
          get_ring<R, NT>(a, T, sm, xr, PE1, PCHI + 1);
        __syncthreads();
        if (seg == 0) {
          each<NT>(a, T, T.r0 - K, T.r1 + K, T.c0 - K, T.c1 + K,
               [&](int r, int c, int l) {
                 const long long i = (long long)r * a.w + c;
                 float wv[8];
#pragma unroll
                 for (int q = 0; q < 8; ++q) wv[q] = a.wc[q * n + i];
                 vstep(s, __ldcg(a.st + U1 * n + i), __ldcg(a.st + U2 * n + i),
                       CHp[l], wv, V1p[l], V2p[l]);
               });
          __syncthreads();
        }
        for (int j = 0; j < K; ++j) {
          const int e = K - 1 - j;
          // v + theta div(g xi) + theta beta grad chi where the xi step on
          // the tile grown by e reads it: grown by e, and one more right
          // and down
          each<NT>(a, T, T.r0 - e, T.r1 + e + 1, T.c0 - e, T.c1 + e + 1,
               [&](int r, int c, int l) {
                 const float d1 = div_g(a, Gp, X[0], X[1], l, r, c);
                 const float d2 = div_g(a, Gp, X[2], X[3], l, r, c);
                 float cx, cy;
                 grad_p(a, CHp, l, r, c, cx, cy);
                 W1p[l] = V1p[l] + s.theta * d1 + s.tb * cx;
                 W2p[l] = V2p[l] + s.theta * d2 + s.tb * cy;
               });
          __syncthreads();
          each<NT>(a, T, T.r0 - e, T.r1 + e, T.c0 - e, T.c1 + e,
               [&](int r, int c, int l) {
                 float g1x, g1y, g2x, g2y;
                 grad_p(a, W1p, l, r, c, g1x, g1y);
                 grad_p(a, W2p, l, r, c, g2x, g2y);
                 xi_update(s, Gp[l], g1x, g1y, g2x, g2y, X[0][l], X[1][l],
                           X[2][l], X[3][l]);
               });
          __syncthreads();
        }
        put_frame<R, NT>(a, T, sm, a.xch + (long long)(par ^ 1) * kXPlanes * n,
                     PX11, PX22 + 1);
        if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, true);
      }
      grid.sync();
      par ^= 1;
    }
    // the eta / chi phases
    for (int seg = 0; seg < kSteps / K; ++seg) {
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile T = tile_of<R>(a, t);
        if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, false);
        const float* xr = a.xch + (long long)par * kXPlanes * n;
        if (seg == 0)
          get_ring<R, NT>(a, T, sm, xr, PX11, PX22 + 1);
        else
          get_ring<R, NT>(a, T, sm, xr, PE1, PCHI + 1);
        __syncthreads();
        // the chi region: the tile grown by K - 1, kSlots pixels a thread
        const int ra = max(T.r0 - (K - 1), 0), rb = min(T.r1 + K - 1, a.h - 1);
        const int ca = max(T.c0 - (K - 1), 0), cb = min(T.c1 + K - 1, a.w - 1);
        const int nc = cb - ca + 1, ncell = nc * (rb - ra + 1);
        if (seg == 0) {
          // nu where div nu is read, its squared update on the tile
          unsigned mx = 0u;
          each<NT>(a, T, T.r0 - K, T.r1 + K - 1, T.c0 - K, T.c1 + K - 1,
               [&](int r, int c, int l) {
                 const float d1 = div_g(a, Gp, X[0], X[1], l, r, c);
                 const float d2 = div_g(a, Gp, X[2], X[3], l, r, c);
                 float cx, cy;
                 grad_p(a, CHp, l, r, c, cx, cy);
                 const float nu1 = V1p[l] + s.theta * d1 + s.tb * cx;
                 const float nu2 = V2p[l] + s.theta * d2 + s.tb * cy;
                 W1p[l] = nu1;
                 W2p[l] = nu2;
                 if (!in_tile(T, r, c)) return;
                 const long long i = (long long)r * a.w + c;
                 const float e1 = nu1 - a.st[U1 * n + i];
                 const float e2 = nu2 - a.st[U2 * n + i];
                 const float diff = e1 * e1 + e2 * e2;
                 mx = max(mx, diff != diff ? 0x7fc00000u : __float_as_uint(diff));
                 a.st[U1 * n + i] = nu1;
                 a.st[U2 * n + i] = nu2;
               });
          mx = __reduce_max_sync(0xffffffffu, mx);
          if ((threadIdx.x & 31) == 0 && mx > 0u) atomicMax(slot, mx);
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int i = threadIdx.x + q * NT;
            if (i >= ncell) continue;
            const int r = ra + i / nc, c = ca + i % nc;
            const int l = (r - T.orow) * ld + (c - T.ocol);
            const long long gi = (long long)r * a.w + c;
            Ds[q] = div_p(a, W1p, W2p, l, r, c);
            float wv[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) wv[k] = a.wc[k * n + gi];
            fg(s, wv, V1p[l], V2p[l], Fs[q], Gs[q]);
          }
          __syncthreads();
        }
        for (int j = 0; j < K; ++j) {
          const int e = K - 1 - j;
          const bool last = seg == kSteps / K - 1 && j == K - 1;
          // eta (and g eta) where the chi step on the tile grown by e reads
          // it: grown by e, and one more left and up
          each<NT>(a, T, T.r0 - e - 1, T.r1 + e, T.c0 - e - 1, T.c1 + e,
               [&](int r, int c, int l) {
                 float cx, cy;
                 grad_p(a, CHp, l, r, c, cx, cy);
                 float e1 = E1p[l], e2 = E2p[l];
                 eta_update(s, Gp[l], cx, cy, e1, e2);
                 E1p[l] = e1;
                 E2p[l] = e2;
                 W1p[l] = Gp[l] * e1;
                 W2p[l] = Gp[l] * e2;
               });
          __syncthreads();
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int i = threadIdx.x + q * NT;
            if (i >= ncell) continue;
            const int r = ra + i / nc, c = ca + i % nc;
            if (r < T.r0 - e || r > T.r1 + e || c < T.c0 - e || c > T.c1 + e)
              continue;
            const int l = (r - T.orow) * ld + (c - T.ocol);
            float ch = chi_update(s, CHp[l], div_p(a, W1p, W2p, l, r, c),
                                  Ds[q], Fs[q], Gs[q]);
            if (last) ch = ch > kDelta ? 1.0f : 0.0f;
            CHp[l] = ch;
          }
          __syncthreads();
        }
        put_frame<R, NT>(a, T, sm, a.xch + (long long)(par ^ 1) * kXPlanes * n,
                     PE1, PCHI + 1);
        if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, true);
      }
      grid.sync();
      par ^= 1;
    }
    err = __uint_as_float(__ldcg(slot));
    ++it;
  }
  // every tile's chi, xi, eta and v (u is written as the loop goes)
  if (it > 0) {
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile T = tile_of<R>(a, t);
      if (spills) spill_io<NT>(a, t, sm, Fs, Gs, Ds, false);
      each<NT>(a, T, T.r0, T.r1, T.c0, T.c1, [&](int r, int c, int l) {
        const long long i = (long long)r * a.w + c;
        a.st[CHI * n + i] = CHp[l];
#pragma unroll
        for (int q = 0; q < 4; ++q) a.st[(X11 + q) * n + i] = X[q][l];
        a.st[E1 * n + i] = E1p[l];
        a.st[E2 * n + i] = E2p[l];
        a.st[V1 * n + i] = V1p[l];
        a.st[V2 * n + i] = V2p[l];
      });
    }
  }
  if (leader) a.slots[3] = (unsigned)it;
}

// the tiling of an h x w image at depth K on this device, and the kernel's
// shared-memory attribute set to it
template <int K, int NT = kGThreads>
cudaError_t plan_loop(int h, int w, Plan& p) {
  constexpr int R = K + 1;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  auto fits = [&](long long th, long long tw) {
    return (th + 2 * R) * (tw + 2 * R) * kGPlanes * (long long)sizeof(float) <=
               optin &&
           (th + 2 * K - 2) * (tw + 2 * K - 2) <= (long long)kGCells;
  };
  // resident: at most one tile an SM; the fewest pixels a thread handles in
  // a phase, then the fewest tiles (blocks at the barrier), then the
  // smallest shared planes
  long long best = -1;
  for (int ty = 1; ty <= sms && ty <= h; ++ty) {
    const int th = (h + ty - 1) / ty;
    if ((h + th - 1) / th != ty) continue;
    for (int tx = 1; tx * ty <= sms && tx <= w; ++tx) {
      const int tw = (w + tx - 1) / tx;
      if ((w + tw - 1) / tw != tx || !fits(th, tw)) continue;
      const long long area = (long long)(th + 2 * R) * (tw + 2 * R);
      const long long cost =
          ((area + NT - 1) / NT * (sms + 1) + ty * tx) *
              (1LL << 24) + area;
      if (best < 0 || cost < best) {
        best = cost;
        p.th = th;
        p.tw = tw;
        p.ty = ty;
        p.tx = tx;
      }
    }
  }
  p.resident = best >= 0;
  if (!p.resident) {  // the largest square tiles that fit, walked in turn
    int side = 1;
    while (fits(side + 1, side + 1)) ++side;
    p.th = p.tw = side;
    p.ty = (h + side - 1) / side;
    p.tx = (w + side - 1) / side;
  }
  p.ld = p.tw + 2 * R;
  p.plane = (p.th + 2 * R) * p.ld;
  p.smem = (size_t)kGPlanes * p.plane * sizeof(float);
  p.spill = p.resident ? 0 : (long long)kGPlanes * p.plane + 3LL * kGCells;
  e = cudaFuncSetAttribute(occ_global_loop_kernel<K, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, occ_global_loop_kernel<K, NT>, NT, p.smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = (long long)p.ty * p.tx;
  const long long cap = (long long)per_sm * sms;
  p.blocks = (int)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// floats of scratch a call needs: the slots and the count, the exchange
// planes, the spills
long long scratch_floats(const Plan& p, int h, int w) {
  return 4 + 2LL * kXPlanes * h * w + (long long)p.ty * p.tx * p.spill;
}

template <int K, int NT = kGThreads>
cudaError_t launch_loop(float* st, const float* wc, const float* g,
                        const float* scal, float* scratch,
                        long long scratch_n, int h, int w, int max_iters,
                        cudaStream_t s) {
  Plan p;
  cudaError_t e = plan_loop<K, NT>(h, w, p);
  if (e != cudaSuccess) return e;
  if (scratch_n < scratch_floats(p, h, w)) return cudaErrorInvalidValue;
  float* xch = scratch + 4;
  LoopArgs a{st, wc, g, scal, xch, xch + 2LL * kXPlanes * h * w,
             (unsigned*)scratch, h, w, max_iters, p};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)occ_global_loop_kernel<K, NT>,
                                  dim3(p.blocks), dim3(NT), args, p.smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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

// whole-image form, the plan of an h x w image: out[0..7] = scratch floats,
// tile rows, tile columns, tiles down, tiles across, blocks, resident,
// shared bytes a block
extern "C" int faldoi_occ_global_loop_plan(int h, int w, long long* out) {
  Plan p{};
  const cudaError_t e = plan_loop<kGDepth>(h, w, p);
  if (e != cudaSuccess) return (int)e;
  const long long v[8] = {scratch_floats(p, h, w), p.th, p.tw, p.ty, p.tx,
                          p.blocks, p.resident, (long long)p.smem};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

// whole-image form, one warp's whole loop: st (11, h, w) updated in place,
// wc (8, h, w), g (h, w), scal (14,), scratch (scratch_n floats, from the
// plan); the PD iterations run land in the scratch's fourth word (int32)
extern "C" int faldoi_occ_global_loop(float* st, const float* wc,
                                      const float* g, const float* scal,
                                      float* scratch, long long scratch_n,
                                      int h, int w, int max_iters,
                                      void* stream) {
  if (h <= 0 || w <= 0) return 0;
  return (int)launch_loop<kGDepth>(st, wc, g, scal, scratch, scratch_n, h, w,
                                   max_iters, (cudaStream_t)stream);
}

// the kernel launches one whole-image call enqueues, counted as the kernel
// nodes of a CUDA graph captured from one call on a private stream (the
// graph is never run): *n_kernels
extern "C" int faldoi_occ_global_loop_kernels(float* st, const float* wc,
                                              const float* g, const float* scal,
                                              float* scratch,
                                              long long scratch_n, int h, int w,
                                              int max_iters, int* n_kernels) {
  *n_kernels = 0;
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t graph = nullptr;
  e = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    const cudaError_t le =
        h > 0 && w > 0 ? launch_loop<kGDepth>(st, wc, g, scal, scratch,
                                              scratch_n, h, w, max_iters, s)
                       : cudaSuccess;
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
