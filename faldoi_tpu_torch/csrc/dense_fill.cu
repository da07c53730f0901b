// K10: the dense fill of the growing, a jump-flood nearest fill with its
// pinned red-black relaxation, for L lanes of C planes at once.
//
// Replaces faldoi_tpu/ops/poisson.py::nearest_fill_image (:307; XLA-lowered
// whole-image shifts and selects), which faldoi_tpu/core/local_step.py::
// _dense_fill (:229) runs for u and for v in every sweep of fill="dense".
//
// Jump flood.  Every cell carries the flat index of its nearest finite cell
// found so far (-1: none yet, JAX's "far" state at (-1e6, -1e6)) and that
// cell's squared distance (0 at a finite cell, +inf elsewhere).  The strides
// run from the largest power of two k with 2k < max(h, w) down to 1; within a
// stride JAX visits the 8 directions (dy, dx) in (-k, 0, k) x (-k, 0, k)
// IN ORDER, each reading the state the previous direction wrote, and takes
// the neighbour at (clamp(y - dy), clamp(x - dx)) when its squared distance
// is strictly smaller.  A one-pass JFA that reads all 8 neighbours from the
// state before the stride is a different function at ties, so every
// direction is one launch here, reading one index buffer and writing the
// other (the distance is the cell's own, updated in place).  The distance
// is computed in float32 as JAX computes it, (y - sy)^2 + (x - sx)^2 with
// the far state's coordinates -1e6, so the decisions are JAX's.
//
// The payload is not carried through the flood: the decisions depend only
// on the coordinates, so after the flood every hole takes the C planes'
// values at its nearest finite cell (0 with none).  JAX floods u and v
// apart over one fixed mask; one flood serves both.  Plane 0 decides which
// cells are finite; the wrapper checks that every plane agrees.
//
// Relaxation: smooth_iters red-black sweeps of the holes (red = (y + x)
// even first), y + timestep * lap with the Neumann (clamped) Laplacian
// summed as (((-4 y + right) + left) + down) + up, in place: a colour reads
// only the other colour.
//
// With --fmad=false every operation rounds as in the plain twin
// (faldoi_tpu_torch/ops/poisson.py::nearest_fill_image_plain).
//
// Bound: the fill reads the C input planes and writes the C output planes
// once; the flood's index and distance buffers (8 bytes a cell, 2 x 436 x
// 1024 x 8 = 7.1 MB for two lanes) live in the 50 MB L2.  In practice the
// 8 x 10 dependent launches of the flood at 436x1024 and their latency.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFar = -1.0e6f;

unsigned grid_for(long long cells) {
  long long g = (cells + kThreads - 1) / kThreads;
  return (unsigned)(g < 65535LL * 32 ? g : 65535LL * 32);
}

__global__ void flood_init_kernel(const float* __restrict__ x,
                                  int* __restrict__ seed,
                                  float* __restrict__ best, int lanes, int c,
                                  int h, int w) {
  const long long hw = (long long)h * w;
  const long long total = lanes * hw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long lane = t / hw, cell = t - lane * hw;
    const bool fin = isfinite(x[lane * c * hw + cell]);
    seed[t] = fin ? (int)cell : -1;
    best[t] = fin ? 0.0f : INFINITY;
  }
}

__global__ void flood_step_kernel(const int* __restrict__ seed_in,
                                  int* __restrict__ seed_out,
                                  float* __restrict__ best, int lanes, int h,
                                  int w, int dy, int dx) {
  const long long hw = (long long)h * w;
  const long long total = lanes * hw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long lane = t / hw, cell = t - lane * hw;
    const int y = (int)(cell / w), xx = (int)(cell - (long long)y * w);
    int ny = y - dy, nx = xx - dx;
    ny = ny < 0 ? 0 : (ny > h - 1 ? h - 1 : ny);
    nx = nx < 0 ? 0 : (nx > w - 1 ? w - 1 : nx);
    const int nb = seed_in[lane * hw + (long long)ny * w + nx];
    const float sy = nb < 0 ? kFar : (float)(nb / w);
    const float sx = nb < 0 ? kFar : (float)(nb - (nb / w) * w);
    const float ey = (float)y - sy, ex = (float)xx - sx;
    const float d2 = ey * ey + ex * ex;
    const float b = best[t];
    if (d2 < b) {
      best[t] = d2;
      seed_out[t] = nb;
    } else {
      seed_out[t] = seed_in[t];
    }
  }
}

__global__ void flood_take_kernel(const float* __restrict__ x,
                                  const int* __restrict__ seed,
                                  float* __restrict__ out, int lanes, int c,
                                  int h, int w) {
  const long long hw = (long long)h * w;
  const long long total = lanes * hw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long lane = t / hw, cell = t - lane * hw;
    const long long base = lane * c * hw;
    const bool fin = isfinite(x[base + cell]);
    const int s = seed[t];
    for (int k = 0; k < c; ++k) {
      const long long o = base + k * hw;
      out[o + cell] = fin ? x[o + cell] : (s < 0 ? 0.0f : x[o + s]);
    }
  }
}

__global__ void relax_kernel(const float* __restrict__ x, float* out,
                             int lanes, int c, int h, int w, int parity,
                             float timestep) {
  const long long hw = (long long)h * w;
  const long long total = lanes * hw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long lane = t / hw, cell = t - lane * hw;
    const int y = (int)(cell / w), xx = (int)(cell - (long long)y * w);
    if (((y + xx) & 1) != parity) continue;
    const long long base = lane * c * hw;
    if (isfinite(x[base + cell])) continue;
    for (int k = 0; k < c; ++k) {
      const float* p = out + base + k * hw;
      const float v = p[cell];
      const float right = xx + 1 < w ? p[cell + 1] : v;
      const float left = xx > 0 ? p[cell - 1] : v;
      const float down = y + 1 < h ? p[cell + w] : v;
      const float up = y > 0 ? p[cell - w] : v;
      float lap = -4.0f * v;
      lap = lap + right;
      lap = lap + left;
      lap = lap + down;
      lap = lap + up;
      out[base + k * hw + cell] = v + timestep * lap;
    }
  }
}

}  // namespace

// x, out: (lanes, c, h, w) float32; seed_a, seed_b: (lanes, h, w) int32
// scratch; best: (lanes, h, w) float32 scratch.  out may not alias x.
extern "C" int faldoi_dense_fill(const float* x, float* out, int* seed_a,
                                 int* seed_b, float* best, int lanes, int c,
                                 int h, int w, int smooth_iters,
                                 float timestep, void* stream) {
  if (lanes <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  if ((long long)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long cells = (long long)lanes * h * w;
  const unsigned g = grid_for(cells);
  flood_init_kernel<<<g, kThreads, 0, st>>>(x, seed_a, best, lanes, c, h, w);
  int k = 1;
  const int m = h > w ? h : w;
  while (k * 2 < m) k *= 2;
  int* cur = seed_a;
  int* nxt = seed_b;
  for (; k >= 1; k /= 2) {
    for (int dy = -k; dy <= k; dy += k) {
      for (int dx = -k; dx <= k; dx += k) {
        if (dy == 0 && dx == 0) continue;
        flood_step_kernel<<<g, kThreads, 0, st>>>(cur, nxt, best, lanes, h, w,
                                                  dy, dx);
        int* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
  }
  flood_take_kernel<<<g, kThreads, 0, st>>>(x, cur, out, lanes, c, h, w);
  for (int it = 0; it < smooth_iters; ++it) {
    relax_kernel<<<g, kThreads, 0, st>>>(x, out, lanes, c, h, w, 0, timestep);
    relax_kernel<<<g, kThreads, 0, st>>>(x, out, lanes, c, h, w, 1, timestep);
  }
  return (int)cudaGetLastError();
}
