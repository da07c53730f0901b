// K6's pieces that K15 (csad_global.cu) shares: the planes of a warp, the
// dual phase of one iteration (a thread a pixel) and the divergence by
// reciprocal pairs; their design is set out at the top of nltv.cu.

#pragma once

#include "nltv_common.cuh"

namespace {

constexpr float kGradIsZero = 1e-8f;
constexpr int kNlHalf = kNl / 2;
constexpr int kTileW = 32;    // K6, both phases: a 32x8 tile a block
constexpr int kTileH = 8;
constexpr int kDualLoads = 4; // offsets whose loads go out together
constexpr int kK6Blocks = 4;  // blocks an SM: 64 registers a thread

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
  for (int j0 = 0; j0 < kNl; j0 += kDualLoads) {
    float s1[kDualLoads], s2[kDualLoads], wj[kDualLoads], n1[kDualLoads],
        n2[kDualLoads];
#pragma unroll
    for (int q = 0; q < kDualLoads; ++q) {
      const int j = j0 + q;
      const int rr = r + nl_dy(j), cc = c + nl_dx(j);
      const bool in = rr >= 0 && rr < h && cc >= 0 && cc < w;
      const long long o = (long long)rr * w + cc;
      n1[q] = in ? __ldg(u1b + o) : 0.0f;
      n2[q] = in ? __ldg(u2b + o) : 0.0f;
      // w_j(x), or for j >= 12 its mirror w_{23-j}(x + d_j)
      wj[q] = j < kNlHalf ? __ldg(wp + j * hw + i)
                        : (in ? __ldg(wp + (kNl - 1 - j) * hw + o) : 0.0f);
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

// The divergence of both components at (r, c) by reciprocal pairs, summed
// over j in order from zero (before the division by wt).
__device__ __forceinline__ void pair_divergence(const GlobalPlanes& p, int r,
                                                int c, int h, int w,
                                                float* d1o, float* d2o) {
  const float* __restrict__ sp = p.sp;
  const float* __restrict__ sq = p.sq;
  const float* __restrict__ wp = p.wp;
  const long long hw = (long long)h * w;
  const long long i = (long long)r * w + c;
  float d1 = 0.0f, d2 = 0.0f;
  float m1[kNlHalf], m2[kNlHalf];   // terms 23 - j, folded after term 11
#pragma unroll
  for (int j = 0; j < kNlHalf; ++j) {
    const int m = kNl - 1 - j;
    const int rp = r + nl_dy(j), cp = c + nl_dx(j);
    const int rn = r - nl_dy(j), cn = c - nl_dx(j);
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
  for (int j = kNlHalf - 1; j >= 0; --j) {
    d1 = d1 + m1[j];
    d2 = d2 + m2[j];
  }
  *d1o = d1;
  *d2o = d2;
}

}  // namespace
