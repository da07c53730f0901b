// K11: the bilateral pre-fill of the untrusted working flow, for L lanes of
// one frame at once.
//
// Replaces faldoi_tpu/core/bilateral.py::bilateral_filter_flow (:60; XLA-
// lowered fori_loop of 25 shifts a Jacobi iteration), which faldoi_tpu/core/
// match_growing.py::_bfill (:831) runs after each prune and requeue of
// bilateral=True.
//
// The flow starts as (u1, u2) where keep (trust or fixed) and 0 elsewhere;
// each of ``iters`` Jacobi iterations replaces every cell that is not kept by
// the weighted average over the 25 taps s = (dy, dx), dy outer, dx inner,
// -2..2, in JAX's shift order:
//   num_k = sum_s W[s] * f_k(y - dy_s, x),   den = sum_s W[s],
// each sum from 0 in that order, f read as 0 outside the image, then
// den = max(den, 1e-12) and f_k = num_k / den (IEEE division).  The tap is
// JAX's: its ``_shift(a, dy, dx)`` pads and slices so that it returns
// a[y - dy, x] (the column offset drops out), while its ``_inside`` mask in
// the weight tests (y + dy, x + dx); the port follows it.  The weight
// planes W (25, h, w) are the spatial constant times the colour weight times
// the inside mask, computed once a call on the host
// (faldoi_tpu_torch/core/bilateral.py::bilateral_weights) and read by this
// kernel and by its plain twin alike, so no exp is evaluated here.  The last
// launch writes keep ? u : f.
//
// One launch an iteration (reads one pair of flow buffers, writes the
// other), plus the seeding and the final select.  With --fmad=false every
// operation rounds as in the plain twin
// (faldoi_tpu_torch/core/bilateral.py::bilateral_filter_flow_plain).
//
// Bound: a launch reads the 25 weight planes and two flow planes (each flow
// cell 25 times, from L1/L2) and writes two: at 436x1024 about 48 MB an
// iteration, 14 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 2;

unsigned grid_for(long long cells) {
  long long g = (cells + kThreads - 1) / kThreads;
  return (unsigned)(g < 65535LL * 32 ? g : 65535LL * 32);
}

__global__ void seed_kernel(const float* __restrict__ u1,
                            const float* __restrict__ u2,
                            const unsigned char* __restrict__ keep,
                            float* __restrict__ f1, float* __restrict__ f2,
                            long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const bool k = keep[t] != 0;
    f1[t] = k ? u1[t] : 0.0f;
    f2[t] = k ? u2[t] : 0.0f;
  }
}

__global__ void jacobi_kernel(const float* __restrict__ wgt,
                              const unsigned char* __restrict__ keep,
                              const float* __restrict__ f1,
                              const float* __restrict__ f2,
                              float* __restrict__ g1, float* __restrict__ g2,
                              int lanes, int h, int w) {
  const long long hw = (long long)h * w;
  const long long total = lanes * hw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    if (keep[t] != 0) {
      g1[t] = f1[t];
      g2[t] = f2[t];
      continue;
    }
    const long long lane = t / hw, cell = t - lane * hw;
    const int y = (int)(cell / w), x = (int)(cell - (long long)y * w);
    const float* a1 = f1 + lane * hw;
    const float* a2 = f2 + lane * hw;
    float num1 = 0.0f, num2 = 0.0f, den = 0.0f;
    int s = 0;
    for (int dy = -kR; dy <= kR; ++dy) {
      for (int dx = -kR; dx <= kR; ++dx, ++s) {  // dx: in W only
        const int yy = y - dy;
        const bool in = yy >= 0 && yy < h;
        const long long q = (long long)yy * w + x;
        const float v1 = in ? a1[q] : 0.0f;
        const float v2 = in ? a2[q] : 0.0f;
        const float wv = wgt[s * hw + cell];
        num1 = num1 + wv * v1;
        num2 = num2 + wv * v2;
        den = den + wv;
      }
    }
    den = den < 1e-12f ? 1e-12f : den;  // clamp(min=1e-12) keeping NaN
    g1[t] = num1 / den;
    g2[t] = num2 / den;
  }
}

__global__ void select_kernel(const float* __restrict__ u1,
                              const float* __restrict__ u2,
                              const unsigned char* __restrict__ keep,
                              const float* __restrict__ f1,
                              const float* __restrict__ f2,
                              float* __restrict__ o1, float* __restrict__ o2,
                              long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const bool k = keep[t] != 0;
    o1[t] = k ? u1[t] : f1[t];
    o2[t] = k ? u2[t] : f2[t];
  }
}

}  // namespace

// wgt: (25, h, w); keep: (lanes, h, w) uint8; u1, u2, o1, o2: (lanes, h, w)
// float32; scratch: 4 x lanes x h x w float32.
extern "C" int faldoi_bilateral_filter(const float* wgt,
                                       const unsigned char* keep,
                                       const float* u1, const float* u2,
                                       float* scratch, float* o1, float* o2,
                                       int lanes, int h, int w, int iters,
                                       void* stream) {
  if (lanes <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)lanes * h * w;
  const unsigned g = grid_for(total);
  float* f1 = scratch;
  float* f2 = scratch + total;
  float* g1 = scratch + 2 * total;
  float* g2 = scratch + 3 * total;
  seed_kernel<<<g, kThreads, 0, st>>>(u1, u2, keep, f1, f2, total);
  for (int it = 0; it < iters; ++it) {
    jacobi_kernel<<<g, kThreads, 0, st>>>(wgt, keep, f1, f2, g1, g2, lanes, h,
                                          w);
    float* t1 = f1;
    float* t2 = f2;
    f1 = g1;
    f2 = g2;
    g1 = t1;
    g2 = t2;
  }
  select_kernel<<<g, kThreads, 0, st>>>(u1, u2, keep, f1, f2, o1, o2, total);
  return (int)cudaGetLastError();
}
