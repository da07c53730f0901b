// K5: one TV-L1 primal-dual iteration of the global step.
//
// Replaces the XLA-lowered body of faldoi_tpu/core/global_step.py::
// tvl2_global.pd_iteration (global_step.py:74-89): threshold, forward
// gradients of u_bar, getD, divergence of the NEW xi, getP, over-relaxation,
// and err = max(u_n).
//
// The divergence at (r, c) reads the new xi at (r, c-1) and (r-1, c), which
// other threads write, so the iteration is two launches on one stream:
//   dual_kernel   reads u_bar at (r, c), (r, c+1), (r+1, c) and the old xi at
//                 (r, c); writes the new xi in place;
//   primal_kernel reads the new xi at (r, c), (r, c-1), (r-1, c) and u, the
//                 warp constants at (r, c); writes u, u_bar in place and
//                 folds u_n into err with an integer atomicMax on the float's
//                 bits (u_n >= 0, so the bit order is the value order).
// err is zeroed on the stream first.  Operation order matches the plain
// twin (faldoi_tpu_torch/core/global_step.py::global_pd_iteration_plain);
// with --fmad=false the two round identically.
//
// Bound: device-memory bandwidth, ~19 float planes per iteration (~33 MB at
// 436x1024), two launches and the host's read of err.

#include <cuda_runtime.h>

namespace {

constexpr float kGradIsZero = 1e-8f;

__global__ void dual_kernel(const float* __restrict__ u1b,
                            const float* __restrict__ u2b, float* xi11,
                            float* xi12, float* xi21, float* xi22, int h,
                            int w, float tau) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long i = (long long)r * w + c;
  const float a = u1b[i], b = u2b[i];
  const float u1x = c < w - 1 ? u1b[i + 1] - a : 0.0f;
  const float u1y = r < h - 1 ? u1b[i + w] - a : 0.0f;
  const float u2x = c < w - 1 ? u2b[i + 1] - b : 0.0f;
  const float u2y = r < h - 1 ? u2b[i + w] - b : 0.0f;
  const float x11 = xi11[i], x12 = xi12[i], x21 = xi21[i], x22 = xi22[i];
  float n = sqrtf(x11 * x11 + x12 * x12 + x21 * x21 + x22 * x22);
  n = n < 1.0f ? 1.0f : n;  // clamp(min=1) keeping NaN, as the twin
  xi11[i] = (x11 + tau * u1x) / n;
  xi12[i] = (x12 + tau * u1y) / n;
  xi21[i] = (x21 + tau * u2x) / n;
  xi22[i] = (x22 + tau * u2y) / n;
}

// Backward-difference divergence with Chambolle boundaries (mask.c:39-83).
__device__ __forceinline__ float div_at(const float* __restrict__ vx,
                                        const float* __restrict__ vy, int r,
                                        int c, int h, int w) {
  const long long i = (long long)r * w + c;
  const float dx = c == 0 ? vx[i] : (c == w - 1 ? -vx[i - 1] : vx[i] - vx[i - 1]);
  const float dy = r == 0 ? vy[i] : (r == h - 1 ? -vy[i - w] : vy[i] - vy[i - w]);
  return dx + dy;
}

__global__ void primal_kernel(float* u1, float* u2, float* u1b, float* u2b,
                              const float* __restrict__ xi11,
                              const float* __restrict__ xi12,
                              const float* __restrict__ xi21,
                              const float* __restrict__ xi22,
                              const float* __restrict__ i1wx,
                              const float* __restrict__ i1wy,
                              const float* __restrict__ grad,
                              const float* __restrict__ rho_c, int* err,
                              int h, int w, float l_t, float theta,
                              float tau) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  int bits = 0;
  if (r < h && c < w) {
    const long long i = (long long)r * w + c;
    const float a = u1[i], b = u2[i];
    const float gx = i1wx[i], gy = i1wy[i], g = grad[i];
    // threshold (tvl2_model.cpp:364-391)
    const float rho = rho_c[i] + gx * a + gy * b;
    const float fi = g < kGradIsZero ? 0.0f : -rho / (g == 0.0f ? 1.0f : g);
    const bool lo = rho < -l_t * g;
    const bool hi = rho > l_t * g;
    const float d1 = lo ? l_t * gx : (hi ? -l_t * gx : fi * gx);
    const float d2 = lo ? l_t * gy : (hi ? -l_t * gy : fi * gy);
    const float v1 = a + d1;
    const float v2 = b + d2;
    // getP (tvl2_model.cpp:122-172) on the divergence of the new xi
    const float div1 = div_at(xi11, xi12, r, c, h, w);
    const float div2 = div_at(xi21, xi22, r, c, h, w);
    const float nu1 = a - tau * (-div1 + (a - v1) / theta);
    const float nu2 = b - tau * (-div2 + (b - v2) / theta);
    const float e1 = nu1 - a, e2 = nu2 - b;
    bits = __float_as_int(e1 * e1 + e2 * e2);
    u1b[i] = 2.0f * nu1 - a;
    u2b[i] = 2.0f * nu2 - b;
    u1[i] = nu1;
    u2[i] = nu2;
  }
  // warp-level max of the bit patterns, one atomic per warp
  for (int off = 16; off > 0; off >>= 1)
    bits = max(bits, __shfl_down_sync(0xffffffffu, bits, off));
  if ((threadIdx.x + threadIdx.y * blockDim.x) % 32 == 0 && bits > 0)
    atomicMax(err, bits);
}

}  // namespace

extern "C" int faldoi_global_pd_iteration(
    float* u1, float* u2, float* u1b, float* u2b, float* xi11, float* xi12,
    float* xi21, float* xi22, const float* i1wx, const float* i1wy,
    const float* grad, const float* rho_c, float* err, int h, int w,
    float l_t, float theta, float tau, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  dual_kernel<<<grid, block, 0, s>>>(u1b, u2b, xi11, xi12, xi21, xi22, h, w,
                                     tau);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  primal_kernel<<<grid, block, 0, s>>>(u1, u2, u1b, u2b, xi11, xi12, xi21,
                                       xi22, i1wx, i1wy, grad, rho_c,
                                       (int*)err, h, w, l_t, theta, tau);
  return (int)cudaGetLastError();
}
