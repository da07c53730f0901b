// K11: the bilateral pre-fill of the untrusted working flow, for L lanes of
// one frame at once, in one launch over strips of columns.
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
// each sum from 0 in that order, each tap added on its own, f read as 0
// outside the image, then den = max(den, 1e-12) and f_k = num_k / den (IEEE
// division).  The tap is JAX's: its ``_shift(a, dy, dx)`` pads and slices so
// that it returns a[y - dy, x] (the column offset drops out), while its
// ``_inside`` mask in the weight tests (y + dy, x + dx); the port follows it.
// The output is keep ? u : f.
//
// The weights.  W[dy, dx] = S[dy^2 + dx^2] * (e_dy * inside(dy, dx)): the
// spatial constant (25 float32 values from the host, frozen from JAX), the
// colour factor e_dy = exp(-0.5 ((i0 - i0[y - dy, x]) / sigma)^2), which
// depends on dy alone, and the 0/1 inside mask.  The host computes the 5
// colour planes once a call (faldoi_tpu_torch/core/bilateral.py::
// bilateral_colour_planes: the exponential in float64, rounded once), and
// this kernel forms each weight from them with the same two float32
// products as the host's 25 planes (bilateral_weights), which the plain twin
// reads; so no exp is evaluated here and the weights are the twin's bit for
// bit.
//
// One launch.  A column's iterations read only that column (the taps keep
// x), so a block owns a strip of SW whole columns of one lane and runs all
// the iterations on it with no grid-wide synchronisation: the strip's flow
// (two planes) lives in shared memory twice, ping-ponged across the
// iterations with __syncthreads.  Both copies start as the seeded flow, so a
// kept cell, which is never written, holds u to the end, and the last copy
// is the output.  While loading, the block lists the strip's cells that are
// not kept (each warp appends its ballot of 32 cells at once), and the
// iterations walk that list: a warp's 32 lanes all work however the kept
// cells are scattered, and a kept cell costs nothing after the load.  A
// cell at least 2 rows and columns inside the image has every inside factor
// 1, so its weight in row dy is S * e_dy for the three distinct |dx|, three
// products a row, bit for bit the general S * (e_dy * 1); cells nearer the
// edge take the general form.  A warp loads 32 / SW rows of SW adjacent
// columns: whole 32-byte sectors.  SW is 8, or less where a strip of 8
// columns of h rows would not fit the shared memory of one block.
//
// With --fmad=false every operation rounds as in the plain twin
// (faldoi_tpu_torch/core/bilateral.py::bilateral_filter_flow_plain).
//
// Bound: the 5 colour planes, the flow, the keep mask and the output once
// (at 436x1024, two lanes: 24 MB, 7 us at 3.35 TB/s), or the float
// operations of the taps, 25 x 5 a cell that is not kept an iteration, if
// more.  The 5 colour values of a cell are re-read every iteration (L1/L2).

#include <cuda_runtime.h>

namespace {

constexpr int kStripThreads = 512;
constexpr int kR = 2;
constexpr int kW = 2 * kR + 1;
constexpr int kTaps = kW * kW;

struct Bilateral {
  const float* colour;  // (5, h, w)
  const unsigned char* keep;
  const float* u1;
  const float* u2;
  float* o1;
  float* o2;
  int h, w, iters;
  float spatial[kTaps];  // S[dy^2 + dx^2] in tap order
};

// The Jacobi update of one cell (y, x) of the strip, column tx, from the
// copies a1, a2: returns num1 / den and num2 / den.
template <int SW>
__device__ __forceinline__ void update_cell(const Bilateral& a, const float* a1,
                                            const float* a2, int y, int x,
                                            int tx, long long hw, float& f1,
                                            float& f2) {
  const float* ep = a.colour + (long long)y * a.w + x;
  float e[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) e[r] = __ldg(ep + r * hw);
  float num1 = 0.0f, num2 = 0.0f, den = 0.0f;
  if (y >= kR && y < a.h - kR && x >= kR && x < a.w - kR) {
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
      const int r = dy + kR;
      const float v1 = a1[(y - dy) * SW + tx];
      const float v2 = a2[(y - dy) * SW + tx];
      float wa[kR + 1];  // S * e_dy for |dx| = 0, 1, 2
#pragma unroll
      for (int d = 0; d <= kR; ++d) wa[d] = a.spatial[r * kW + kR - d] * e[r];
#pragma unroll
      for (int dx = -kR; dx <= kR; ++dx) {
        const float wv = wa[dx < 0 ? -dx : dx];
        num1 = num1 + wv * v1;
        num2 = num2 + wv * v2;
        den = den + wv;
      }
    }
  } else {
#pragma unroll
    for (int dy = -kR; dy <= kR; ++dy) {
      const int r = dy + kR;
      const bool rin = y + dy >= 0 && y + dy < a.h;
      const int yy = y - dy;
      const bool in = yy >= 0 && yy < a.h;
      const float v1 = in ? a1[yy * SW + tx] : 0.0f;
      const float v2 = in ? a2[yy * SW + tx] : 0.0f;
#pragma unroll
      for (int dx = -kR; dx <= kR; ++dx) {
        const float m = rin && x + dx >= 0 && x + dx < a.w ? 1.0f : 0.0f;
        const float wv = a.spatial[r * kW + dx + kR] * (e[r] * m);
        num1 = num1 + wv * v1;
        num2 = num2 + wv * v2;
        den = den + wv;
      }
    }
  }
  den = den < 1e-12f ? 1e-12f : den;  // clamp(min=1e-12) keeping NaN
  f1 = num1 / den;
  f2 = num2 / den;
}

template <int SW, int NT>
__global__ void __launch_bounds__(NT) bilateral_strip_kernel(Bilateral a) {
  extern __shared__ float sm[];
  __shared__ int n_open;
  const int h = a.h, w = a.w;
  const int n = h * SW;
  // the two copies of the two flow planes: A (read) and B (written), and
  // the list of the cells that are not kept
  float* A1 = sm;
  float* A2 = sm + n;
  float* B1 = sm + 2 * n;
  float* B2 = sm + 3 * n;
  int* open = reinterpret_cast<int*>(sm + 4 * n);
  const int x0 = blockIdx.x * SW;
  const long long hw = (long long)h * w;
  const long long lb = blockIdx.y * hw + x0;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) n_open = 0;
  __syncthreads();
  for (int l0 = 0; l0 < n; l0 += NT) {
    const int l = l0 + threadIdx.x;
    const int y = l / SW, tx = l % SW;
    bool listed = false;
    if (l < n && x0 + tx < w) {
      const long long i = lb + (long long)y * w + tx;
      const bool k = a.keep[i] != 0;
      const float v1 = k ? a.u1[i] : 0.0f;
      const float v2 = k ? a.u2[i] : 0.0f;
      A1[l] = v1;
      B1[l] = v1;
      A2[l] = v2;
      B2[l] = v2;
      listed = !k;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, listed);
    int base = 0;
    if (lane == 0 && ballot != 0) base = atomicAdd(&n_open, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (listed) open[base + __popc(ballot & ((1u << lane) - 1u))] = l;
  }
  __syncthreads();
  const int m = n_open;
  for (int it = 0; it < a.iters; ++it) {
    for (int i = threadIdx.x; i < m; i += NT) {
      const int l = open[i];
      const int y = l / SW, tx = l % SW;
      update_cell<SW>(a, A1, A2, y, x0 + tx, tx, hw, B1[l], B2[l]);
    }
    __syncthreads();
    float* t1 = A1;
    float* t2 = A2;
    A1 = B1;
    A2 = B2;
    B1 = t1;
    B2 = t2;
  }
  for (int l = threadIdx.x; l < n; l += NT) {
    const int y = l / SW, tx = l % SW;
    if (x0 + tx >= w) continue;
    const long long i = lb + (long long)y * w + tx;
    a.o1[i] = A1[l];
    a.o2[i] = A2[l];
  }
}

// a strip's shared memory a column: two copies of two flow planes and a
// list entry
constexpr size_t kColumnBytes = 4 * sizeof(float) + sizeof(int);

template <int SW, int NT>
cudaError_t launch_strips(const Bilateral& a, int lanes, cudaStream_t st) {
  const size_t smem = (size_t)SW * a.h * kColumnBytes;
  cudaError_t e = cudaFuncSetAttribute(
      bilateral_strip_kernel<SW, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.w + SW - 1) / SW), (unsigned)lanes);
  bilateral_strip_kernel<SW, NT><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace
// colour: (5, h, w) float32, the colour factors of bilateral_colour_planes;
// spatial: 25 float32 on the host, S[dy^2 + dx^2] in tap order; keep:
// (lanes, h, w) uint8; u1, u2, o1, o2: (lanes, h, w) float32.  Refuses
// (cudaErrorInvalidValue) a column too tall for one block's shared memory
// (h > ~11,600 rows on the H100) or more than 65535 lanes.
extern "C" int faldoi_bilateral_filter(const float* colour,
                                       const float* spatial,
                                       const unsigned char* keep,
                                       const float* u1, const float* u2,
                                       float* o1, float* o2, int lanes, int h,
                                       int w, int iters, void* stream) {
  if (lanes <= 0 || h <= 0 || w <= 0) return 0;
  if (lanes > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  Bilateral a{colour, keep, u1, u2, o1, o2, h, w, iters, {}};
  for (int s = 0; s < kTaps; ++s) a.spatial[s] = spatial[s];
  cudaStream_t st = (cudaStream_t)stream;
  const size_t need = (size_t)h * kColumnBytes;
  const size_t cap = (size_t)optin - 64;  // beside the static n_open
  constexpr int NT = kStripThreads;
  if (need * 8 <= cap) e = launch_strips<8, NT>(a, lanes, st);
  else if (need * 4 <= cap) e = launch_strips<4, NT>(a, lanes, st);
  else if (need * 2 <= cap) e = launch_strips<2, NT>(a, lanes, st);
  else if (need <= cap) e = launch_strips<1, NT>(a, lanes, st);
  else return (int)cudaErrorInvalidValue;
  return (int)e;
}
