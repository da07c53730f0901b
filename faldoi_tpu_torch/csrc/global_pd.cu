// K5: the whole TV-L1 primal-dual loop of one warp of the global step, in
// one cooperative launch.
//
// Replaces the XLA-lowered lax.while_loop of faldoi_tpu/core/global_step.py::
// tvl2_global (global_step.py:74-93): per iteration threshold, forward
// gradients of u_bar, getD, divergence of the NEW xi, getP, over-relaxation
// and err = max(u_n); the loop runs while err > tol^2 (a float32 compare;
// err starts at +inf, and a NaN err stops it) and n < max_iters.
//
// The divergence at (r, c) reads the new xi at (r, c-1) and (r-1, c), which
// other blocks write, so an iteration has two phases with a grid barrier
// after each (cooperative_groups::this_grid().sync(), which needs a
// cooperative launch with every block co-resident):
//   dual phase    reads u_bar at (r, c), (r, c+1), (r+1, c) and the old xi
//                 at (r, c); writes the new xi in place;
//   primal phase  reads the new xi at (r, c), (r, c-1), (r-1, c), u and the
//                 warp constants at (r, c); writes u, u_bar in place and
//                 folds u_n into this iteration's err slot with an integer
//                 atomicMax on the float's bits (u_n >= 0, so the bit order
//                 is the value order; a NaN's bits win).
// After the second barrier every thread reads the same slot and decides the
// same way, so all blocks leave the loop together.  Three slots rotate:
// iteration n folds into slot n % 3 and block 0 zeroes slot (n+1) % 3 before
// the first barrier of iteration n, when every block has finished reading it
// (as iteration n-2's err, before the first barrier of iteration n-1).  The
// host reads only the iteration count, once per launch.
//
// Blocks of 32x8 threads walk the image's 32x8 tiles in grid-stride order;
// the grid holds as many blocks as can be co-resident.  The mutable planes
// carry no __restrict__: other blocks write them during the launch, so their
// loads must not go through the read-only (non-coherent) cache.
//
// Operation order matches the plain twin (faldoi_tpu_torch/core/
// global_step.py::global_pd_iteration_plain); with --fmad=false the two
// round identically.
//
// Bound: per launch, 20 float planes (12 read once, 8 written once; 35.7 MB
// at 436x1024, 10.7 us at 3.35 TB/s) against ~65 float operations a pixel an
// iteration (173 us at 400 iterations and 67 TFLOP/s), so a capped warp is
// bound by operations; in practice by the two grid barriers an iteration,
// with the 20 planes served from the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kGradIsZero = 1e-8f;
constexpr int kTileW = 32;
constexpr int kTileH = 8;

struct Planes {
  float* u1;
  float* u2;
  float* u1b;
  float* u2b;
  float* xi11;
  float* xi12;
  float* xi21;
  float* xi22;
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ grad;
  const float* __restrict__ rho_c;
};

__device__ __forceinline__ void dual_at(const Planes& p, int r, int c, int h,
                                        int w, float tau) {
  const long long i = (long long)r * w + c;
  const float a = p.u1b[i], b = p.u2b[i];
  const float u1x = c < w - 1 ? p.u1b[i + 1] - a : 0.0f;
  const float u1y = r < h - 1 ? p.u1b[i + w] - a : 0.0f;
  const float u2x = c < w - 1 ? p.u2b[i + 1] - b : 0.0f;
  const float u2y = r < h - 1 ? p.u2b[i + w] - b : 0.0f;
  const float x11 = p.xi11[i], x12 = p.xi12[i], x21 = p.xi21[i],
              x22 = p.xi22[i];
  float n = sqrtf(x11 * x11 + x12 * x12 + x21 * x21 + x22 * x22);
  n = n < 1.0f ? 1.0f : n;  // clamp(min=1) keeping NaN, as the twin
  p.xi11[i] = (x11 + tau * u1x) / n;
  p.xi12[i] = (x12 + tau * u1y) / n;
  p.xi21[i] = (x21 + tau * u2x) / n;
  p.xi22[i] = (x22 + tau * u2y) / n;
}

// Backward-difference divergence with Chambolle boundaries (mask.c:39-83).
__device__ __forceinline__ float div_at(const float* vx, const float* vy,
                                        int r, int c, int h, int w) {
  const long long i = (long long)r * w + c;
  const float dx = c == 0 ? vx[i] : (c == w - 1 ? -vx[i - 1] : vx[i] - vx[i - 1]);
  const float dy = r == 0 ? vy[i] : (r == h - 1 ? -vy[i - w] : vy[i] - vy[i - w]);
  return dx + dy;
}

// One pixel's primal update; returns the bits of its u_n.
__device__ __forceinline__ int primal_at(const Planes& p, int r, int c, int h,
                                         int w, float l_t, float theta,
                                         float tau) {
  const long long i = (long long)r * w + c;
  const float a = p.u1[i], b = p.u2[i];
  const float gx = p.i1wx[i], gy = p.i1wy[i], g = p.grad[i];
  // threshold (tvl2_model.cpp:364-391)
  const float rho = p.rho_c[i] + gx * a + gy * b;
  const float fi = g < kGradIsZero ? 0.0f : -rho / (g == 0.0f ? 1.0f : g);
  const bool lo = rho < -l_t * g;
  const bool hi = rho > l_t * g;
  const float d1 = lo ? l_t * gx : (hi ? -l_t * gx : fi * gx);
  const float d2 = lo ? l_t * gy : (hi ? -l_t * gy : fi * gy);
  const float v1 = a + d1;
  const float v2 = b + d2;
  // getP (tvl2_model.cpp:122-172) on the divergence of the new xi
  const float div1 = div_at(p.xi11, p.xi12, r, c, h, w);
  const float div2 = div_at(p.xi21, p.xi22, r, c, h, w);
  const float nu1 = a - tau * (-div1 + (a - v1) / theta);
  const float nu2 = b - tau * (-div2 + (b - v2) / theta);
  const float e1 = nu1 - a, e2 = nu2 - b;
  p.u1b[i] = 2.0f * nu1 - a;
  p.u2b[i] = 2.0f * nu2 - b;
  p.u1[i] = nu1;
  p.u2[i] = nu2;
  return __float_as_int(e1 * e1 + e2 * e2);
}

__global__ void __launch_bounds__(kTileW * kTileH)
    pd_loop_kernel(Planes p, int* slots, int* iters, int h, int w, float l_t,
                   float theta, float tau, float tol2, int max_iters) {
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int ntiles = tiles_x * ((h + kTileH - 1) / kTileH);
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0;
  const bool lane0 = ((threadIdx.y * kTileW + threadIdx.x) & 31) == 0;
  if (leader) atomicExch(slots, 0);
  float err = __int_as_float(0x7f800000);  // +inf: the loop runs at least once
  int n = 0;
  while (err > tol2 && n < max_iters) {
    int* slot = slots + n % 3;
    if (leader) atomicExch(slots + (n + 1) % 3, 0);
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int r = (t / tiles_x) * kTileH + threadIdx.y;
      const int c = (t % tiles_x) * kTileW + threadIdx.x;
      if (r < h && c < w) dual_at(p, r, c, h, w, tau);
    }
    grid.sync();
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int r = (t / tiles_x) * kTileH + threadIdx.y;
      const int c = (t % tiles_x) * kTileW + threadIdx.x;
      int bits = r < h && c < w ? primal_at(p, r, c, h, w, l_t, theta, tau) : 0;
      // warp-level max of the bit patterns, one atomic per warp
      for (int off = 16; off > 0; off >>= 1)
        bits = max(bits, __shfl_down_sync(0xffffffffu, bits, off));
      if (lane0 && bits > 0) atomicMax(slot, bits);
    }
    grid.sync();
    err = __int_as_float(__ldcg(slot));
    ++n;
  }
  if (leader) *iters = n;
}

}  // namespace

// scratch: 4 ints on the device (3 err slots, then the iteration count).
extern "C" int faldoi_global_pd_loop(
    float* u1, float* u2, float* u1b, float* u2b, float* xi11, float* xi12,
    float* xi21, float* xi22, const float* i1wx, const float* i1wy,
    const float* grad, const float* rho_c, int* scratch, int h, int w,
    float l_t, float theta, float tau, float tol2, int max_iters,
    void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int threads = kTileW * kTileH;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pd_loop_kernel,
                                                    threads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long ntiles =
      (long long)((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const long long resident = (long long)per_sm * sms;
  const unsigned blocks = (unsigned)(ntiles < resident ? ntiles : resident);
  Planes p{u1, u2, u1b, u2b, xi11, xi12, xi21, xi22, i1wx, i1wy, grad, rho_c};
  int* slots = scratch;
  int* iters = scratch + 3;
  void* args[] = {&p,    &slots, &iters, &h,        &w,        &l_t,
                  &theta, &tau,  &tol2,  &max_iters};
  e = cudaLaunchCooperativeKernel((const void*)pd_loop_kernel, dim3(blocks),
                                  dim3(kTileW, kTileH), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
