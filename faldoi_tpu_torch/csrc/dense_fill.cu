// K10: the dense fill of the growing, a jump-flood nearest fill with its
// pinned red-black relaxation, for L lanes of C planes at once, in one
// cooperative launch.
//
// Replaces faldoi_tpu/ops/poisson.py::nearest_fill_image (:307; XLA-lowered
// whole-image shifts and selects), which faldoi_tpu/core/local_step.py::
// _dense_fill (:229) runs for u and for v in every sweep of fill="dense".
//
// Jump flood.  Every cell carries its nearest finite cell found so far as
// packed coordinates (y << 16 | x; -1: none yet, JAX's "far" state at
// (-1e6, -1e6)).  The strides run from the largest power of two k with 2k <
// max(h, w) down to 1; within a stride JAX visits the 8 directions (dy, dx)
// in (-k, 0, k) x (-k, 0, k) IN ORDER, each reading the state the previous
// direction wrote, and takes the neighbour at (clamp(y - dy), clamp(x - dx))
// when its squared distance is strictly smaller.  A one-pass JFA that reads
// all 8 neighbours from the state before the stride is a different function
// at ties, so the directions stay in order: each is one phase of the launch,
// reading one index buffer and writing the other, and a grid barrier
// (cg::this_grid().sync()) ends it.  The distance is computed in float32 as
// JAX computes it, ey * ey + ex * ex with ey = y - sy, ex = x - sx and the far
// state's coordinates -1e6, so the decisions are JAX's.
//
// No distance buffer.  JAX (and this kernel's former form) carry each
// cell's best squared distance beside its seed; here it is recomputed from
// the seed in every phase.  That gives the same sequence of seeds:
//  - for a real seed s the carried distance was always d2(y, x, s), computed
//    by the same float32 expression at the same cell, so the recomputed value
//    is the carried one bit for bit (0 at a finite cell, whose seed is
//    itself);
//  - for seed -1 the carried value is +inf (never updated) or d2 at the far
//    point (after a -1 candidate was taken), while the recomputed one is
//    always d2 at the far point, ~2e12.  A -1 candidate has exactly that
//    distance, so under the strict comparison it is never taken (where the
//    carried +inf took it, the seed stayed -1 all the same); a real
//    candidate's distance is at most (h - 1)^2 + (w - 1)^2 < 2e12, which
//    beats both.
// A phase then reads two int32 a cell (the neighbour's seed and its own) and
// writes one, 12 bytes against the former 16.
//
// The payload is not carried through the flood: the decisions depend only
// on the coordinates, so after the flood every hole takes the C planes'
// values at its nearest finite cell (0 with none).  JAX floods u and v
// apart over one fixed mask; one flood serves both.  Plane 0 decides which
// cells are finite (the first direction reads it in place of a seeding
// pass); the wrapper checks that every plane agrees.
//
// The take and the relaxation (smooth_iters red-black sweeps of the holes,
// red = (y + x) even first, y + timestep * lap with the Neumann (clamped)
// Laplacian summed as (((-4 y + right) + left) + down) + up, in place: a
// colour reads only the other colour) run after the flood in tiles of 64 x
// 64 cells with a halo of 2 x smooth_iters, in shared memory, with
// __syncthreads between the colours (fill_tiles): no grid barrier.
//
// The flood's phases: every thread walks the same cells in every phase (a
// grid-stride walk of the flat (lane, y, x) index, its coordinates advanced
// without a division), B = 4 cells at a time, all B cells' loads issued
// before any store.  8 x strides - 1 barriers in the flood and one before
// the tiles.  The grid is persistent: 1024 threads a block, as many blocks
// as the occupancy calculator allows on every SM (cooperative launch, every
// block resident), on the caller's stream, so a CUDA graph captures it.
// cli/fill_variants.py times other block sizes and batches, the barriers
// alone, and the short strides in shared-memory tiles, which lost.
//
// With --fmad=false every operation rounds as in the plain twin
// (faldoi_tpu_torch/ops/poisson.py::nearest_fill_image_plain).
//
// Bound: the fill reads the C input planes and writes the C output planes
// once; the flood's two index buffers (4 bytes a cell each, 2 x 2 x 436 x
// 1024 x 4 = 7.1 MB for two lanes) live in the 50 MB L2.  In practice the
// 8 x 10 dependent phases of the flood at 436x1024: each a grid barrier
// (~1.25 us) and a pass of 12 bytes a cell through L2, whose time grows
// with the lanes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFillThreads = 1024;
constexpr int kFillBatch = 4;
constexpr int kFar = -1000000;  // JAX's far point, -1e6, as an integer
constexpr int kTile = 64;       // the take and relaxation's tiles, kTile^2

struct Fill {
  const float* x;
  float* out;
  int* seed_a;
  int* seed_b;
  int lanes, c, h, w, smooth_iters;
  float timestep;
};

// the squared distance from (y, x) to the packed seed s (-1: the far point
// at (-1e6, -1e6)), in float32 as JAX's: ey = y - sy in float32 is exact for
// these integers (|ey| < 2^24), so it is formed as an integer and converted
// once, then ey * ey + ex * ex as JAX rounds it
__device__ __forceinline__ float dist2(int s, int y, int x) {
  const int sy = s < 0 ? kFar : s >> 16;
  const int sx = s < 0 ? kFar : s & 0xffff;
  const float ey = (float)(y - sy), ex = (float)(x - sx);
  return ey * ey + ex * ex;
}

// One cell of a thread's walk: t = lane * h * w + y * w + x (-1: none).
struct Cell {
  int t, lane, y, x;
};

// A thread's grid-stride walk over the flat (lane, y, x) index, the
// coordinates advanced without a division.  Every phase walks the same
// cells in the same order.
struct Walk {
  int t, total, step, lane, y, x, sy, sx, h, w;
  __device__ explicit Walk(const Fill& a)
      : total(a.lanes * a.h * a.w), h(a.h), w(a.w) {
    step = gridDim.x * blockDim.x;
    t = blockIdx.x * blockDim.x + threadIdx.x;
    const int hw = a.h * a.w;
    lane = t / hw;
    y = (t - lane * hw) / w;
    x = t - lane * hw - y * w;
    sy = step / w;
    sx = step - sy * w;
  }
  // the next B cells (t = -1 past the end)
  template <int B>
  __device__ __forceinline__ void take(Cell (&c)[B]) {
#pragma unroll
    for (int j = 0; j < B; ++j) {
      c[j] = Cell{t < total ? t : -1, lane, y, x};
      if (t >= total) continue;
      t += step;
      x += sx;
      y += sy;
      if (x >= w) {
        x -= w;
        ++y;
      }
      while (y >= h && t < total) {
        y -= h;
        ++lane;
      }
    }
  }
};

// One flood direction over this thread's cells, B at a time: all B cells'
// loads are issued before any store (the buffers may alias as far as the
// compiler knows, so loads after a store would wait for it).  in == nullptr:
// the first direction, which reads plane 0's finite cells.
template <int B>
__device__ __forceinline__ void flood_phase(const Fill& a, const int* in,
                                            int* out, int dy, int dx) {
  const int hw = a.h * a.w;
  Walk wk(a);
  while (wk.t < wk.total) {
    Cell c[B];
    wk.take(c);
    int nb[B], own[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      nb[j] = own[j] = -1;
      if (c[j].t < 0) continue;
      int ny = c[j].y - dy, nx = c[j].x - dx;
      ny = ny < 0 ? 0 : (ny > a.h - 1 ? a.h - 1 : ny);
      nx = nx < 0 ? 0 : (nx > a.w - 1 ? a.w - 1 : nx);
      const int q = ny * a.w + nx;
      if (in == nullptr) {
        const float* p = a.x + (long long)c[j].lane * a.c * hw;
        nb[j] = isfinite(p[q]) ? (ny << 16 | nx) : -1;
        own[j] = isfinite(p[c[j].t - c[j].lane * hw]) ? (c[j].y << 16 | c[j].x)
                                                       : -1;
      } else {
        nb[j] = __ldcg(in + c[j].lane * hw + q);
        own[j] = __ldcg(in + c[j].t);
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (c[j].t < 0) continue;
      out[c[j].t] = dist2(nb[j], c[j].y, c[j].x) < dist2(own[j], c[j].y, c[j].x)
                        ? nb[j]
                        : own[j];
    }
  }
}

// The take and the relaxation, one tile of kTile x kTile cells of a lane
// at a time in shared memory, after the flood: the tile and a halo of 2 x
// smooth_iters cells (clipped to the image) are loaded with the take (a
// finite cell keeps its value, a hole takes its nearest finite cell's, 0
// with none), then relaxed with __syncthreads between the colours (red =
// (y + x) even first; y + timestep * lap, the Neumann Laplacian summed as
// (((-4 y + right) + left) + down) + up, in place: a colour reads only the
// other colour), and the tile's cells are written.  A half-step moves what
// a cell reads by one cell, so after 2 x smooth_iters of them the tile's
// cells are exact; a read past the halo (not past the image) is clamped into
// it and only spoils the halo.  One plane at a time; `hole` flags the holes.
__device__ void fill_tiles(const Fill& a, const int* seed, float* v,
                           unsigned char* hole) {
  const int hw = a.h * a.w;
  const int halo = 2 * a.smooth_iters;
  const int ty = (a.h + kTile - 1) / kTile, tx = (a.w + kTile - 1) / kTile;
  const int ntiles = a.lanes * ty * tx;
  const int kRows = blockDim.x / 32;
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int lane = t / (ty * tx);
    const int y0 = (t - lane * ty * tx) / tx * kTile;
    const int x0 = (t - lane * ty * tx) % tx * kTile;
    const int ry0 = max(y0 - halo, 0), ry1 = min(y0 + kTile + halo, a.h);
    const int rx0 = max(x0 - halo, 0), rx1 = min(x0 + kTile + halo, a.w);
    const int rw = rx1 - rx0;
    const float* x0p = a.x + (long long)lane * a.c * hw;
    const int* sp = seed + lane * hw;
    __syncthreads();  // the previous tile's last reads
    for (int r = row; r < ry1 - ry0; r += kRows)
      for (int c = col; c < rw; c += 32)
        hole[r * rw + c] = !isfinite(x0p[(ry0 + r) * a.w + rx0 + c]);
    for (int k = 0; k < a.c; ++k) {
      const float* xp = x0p + (long long)k * hw;
      __syncthreads();  // the flags; the previous plane's writes
      for (int r = row; r < ry1 - ry0; r += kRows) {
        for (int c = col; c < rw; c += 32) {
          const int cell = (ry0 + r) * a.w + rx0 + c;
          float val = 0.0f;
          if (!hole[r * rw + c]) {
            val = xp[cell];
          } else {
            const int s = __ldcg(sp + cell);
            if (s >= 0) val = xp[(s >> 16) * a.w + (s & 0xffff)];
          }
          v[r * rw + c] = val;
        }
      }
      for (int it = 0; it < a.smooth_iters; ++it) {
        for (int parity = 0; parity < 2; ++parity) {
          __syncthreads();
          for (int r = row; r < ry1 - ry0; r += kRows) {
            const int gy = ry0 + r;
            // the first column of this row's colour, then every other one
            const int c0 = ((gy + rx0) & 1) == parity ? 0 : 1;
            for (int c = c0 + 2 * col; c < rw; c += 64) {
              const int l = r * rw + c;
              if (!hole[l]) continue;
              const int gx = rx0 + c;
              const float val = v[l];
              const float right = gx + 1 < a.w ? v[c + 1 < rw ? l + 1 : l] : val;
              const float left = gx > 0 ? v[c > 0 ? l - 1 : l] : val;
              const float down =
                  gy + 1 < a.h ? v[gy + 1 < ry1 ? l + rw : l] : val;
              const float up = gy > 0 ? v[gy > ry0 ? l - rw : l] : val;
              float lap = -4.0f * val;
              lap = lap + right;
              lap = lap + left;
              lap = lap + down;
              lap = lap + up;
              v[l] = val + a.timestep * lap;
            }
          }
        }
      }
      __syncthreads();
      float* op = a.out + ((long long)lane * a.c + k) * hw;
      const int ye = min(y0 + kTile, a.h), xe = min(x0 + kTile, a.w);
      for (int r = y0 + row; r < ye; r += kRows)
        for (int c = x0 + col; c < xe; c += 32)
          op[r * a.w + c] = v[(r - ry0) * rw + c - rx0];
    }
  }
}

// shared memory of the take and relaxation: a tile and its halo of 2 x
// smooth_iters cells, one float plane and the hole flags
__host__ __device__ inline size_t tile_side(int halo) {
  return kTile + 2 * (size_t)halo;
}
__host__ __device__ inline size_t tile_bytes(int smooth_iters) {
  const size_t side = tile_side(2 * smooth_iters);
  return side * side * (sizeof(float) + 1);
}

template <int NT, int B>
__global__ void __launch_bounds__(NT) dense_fill_kernel(Fill a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  int k = 1;
  const int m = a.h > a.w ? a.h : a.w;
  while (k * 2 < m) k *= 2;
  const int* cur = nullptr;  // the buffer the last phase wrote; none: plane 0
  for (; k >= 1; k /= 2) {
    for (int dy = -k; dy <= k; dy += k) {
      for (int dx = -k; dx <= k; dx += k) {
        if (dy == 0 && dx == 0) continue;
        if (cur != nullptr) grid.sync();
        int* out = cur == a.seed_a ? a.seed_b : a.seed_a;
        flood_phase<B>(a, cur, out, dy, dx);
        cur = out;
      }
    }
  }
  grid.sync();  // the final seeds, which the tiles' halos read
  const size_t side = tile_side(2 * a.smooth_iters);
  fill_tiles(a, cur, smem, reinterpret_cast<unsigned char*>(smem + side * side));
}

// Launches a fill kernel with NT threads a block and `smem` bytes of shared
// memory, as many blocks as cover `cells` (lanes x h x w) and are resident
// at once; `a` may carry 0 lanes for a launch of the barriers alone on that
// grid (cli/fill_variants.py).
template <int NT>
int launch_coop(void (*kernel)(Fill), const Fill& a, long long cells,
                size_t smem, cudaStream_t st) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long resident = (long long)per_sm * sms;
  const long long need = (cells + NT - 1) / NT;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  Fill arg = a;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(NT),
                                  args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (lanes, c, h, w) float32; seed_a, seed_b: (lanes, h, w) int32
// scratch.  out may not alias x.  Refuses (cudaErrorInvalidValue) a side the
// packed coordinates cannot hold (h >= 32768 or w >= 65536) or 2^31 cells or
// more, and (cudaErrorNotSupported) a device without cooperative launch.
extern "C" int faldoi_dense_fill(const float* x, float* out, int* seed_a,
                                 int* seed_b, int lanes, int c, int h, int w,
                                 int smooth_iters, float timestep,
                                 void* stream) {
  if (lanes <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const long long cells = (long long)lanes * h * w;
  if (h >= (1 << 15) || w >= (1 << 16) || cells >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Fill a{x, out, seed_a, seed_b, lanes, c, h, w, smooth_iters, timestep};
  return launch_coop<kFillThreads>(dense_fill_kernel<kFillThreads, kFillBatch>,
                                   a, cells, tile_bytes(smooth_iters),
                                   (cudaStream_t)stream);
}
