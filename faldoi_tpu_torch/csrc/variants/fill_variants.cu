// The former forms of K10 and K11, kept as variants for timing only
// (python -m faldoi_tpu_torch.cli.fill_variants; chip_smoke.py times them
// beside the library's forms).  No wrapper of the package calls them.
//
// faldoi_k10v_per_direction: the jump-flood dense fill as one launch a flood
// direction (80 at 436x1024) with a distance buffer beside the seeds (flat
// indices), then a take launch and one launch a red-black half-step;
// library form: csrc/dense_fill.cu.
// faldoi_k11v_per_iteration: the bilateral pre-fill as one launch a Jacobi
// iteration reading the 25 weight planes of
// faldoi_tpu_torch/core/bilateral.py::bilateral_weights, plus a seeding and
// a select launch; library form: csrc/bilateral.cu.
// The library's forms are included, and launched also with other block
// sizes, batches and strip widths (faldoi_k10v_form, faldoi_k11v_strips)
// and, for K10, with its barriers alone (no cell on the same grid) and with
// its short strides in shared-memory tiles (k10t).
// All are bit for bit the plain twins, as the library forms are.

#include <cuda_runtime.h>
#include <math.h>

#include "bilateral.cu"
#include "dense_fill.cu"

namespace k10v {

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

// x, out: (lanes, c, h, w) float32; seed_a, seed_b: (lanes, h, w) int32
// scratch; best: (lanes, h, w) float32 scratch.  out may not alias x.
int per_direction(const float* x, float* out, int* seed_a, int* seed_b,
                  float* best, int lanes, int c, int h, int w,
                  int smooth_iters, float timestep, void* stream) {
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

}  // namespace k10v

namespace k11v {

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

// wgt: (25, h, w); keep: (lanes, h, w) uint8; u1, u2, o1, o2: (lanes, h, w)
// float32; scratch: 4 x lanes x h x w float32.
int per_iteration(const float* wgt, const unsigned char* keep, const float* u1,
                  const float* u2, float* scratch, float* o1, float* o2,
                  int lanes, int h, int w, int iters, void* stream) {
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

}  // namespace k11v

// K10 with its short strides in shared memory, the strides up to KT as one
// tile pass each (tried: at 436x1024 slower than the library's grid-wide
// phases for KT 8 and 16; KT 2 level at L 2, 5% faster at L 1, 3% slower at
// L 8).
namespace k10t {

// The 8 directions of one short stride k, one tile of kTile x kTile cells
// of a lane at a time in shared memory: the tile and a halo of 3k cells
// (clipped to the image) are loaded from `in` (nullptr: plane 0's finite
// cells), the directions run in order with __syncthreads between them,
// each reading one copy and writing the other, and the tile's cells are
// written to `out`.  Within a stride a cell's value depends on cells at
// most 3k rows and 3k columns away (three of the 8 directions move each
// axis by k each way), so the tile's cells are exact; the image-edge clamp
// lands inside the region where the region reaches the edge, and a read
// past the halo is clamped into it and only spoils the halo.
__device__ void flood_tiles(const Fill& a, const int* in, int* out, int k,
                            int* s0, int* s1) {
  const int hw = a.h * a.w;
  const int halo = 3 * k;
  const int ty = (a.h + kTile - 1) / kTile, tx = (a.w + kTile - 1) / kTile;
  const int ntiles = a.lanes * ty * tx;
  const int rows = blockDim.x / 32;
  const int col = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int lane = t / (ty * tx);
    const int y0 = (t - lane * ty * tx) / tx * kTile;
    const int x0 = (t - lane * ty * tx) % tx * kTile;
    const int ry0 = max(y0 - halo, 0), ry1 = min(y0 + kTile + halo, a.h);
    const int rx0 = max(x0 - halo, 0), rx1 = min(x0 + kTile + halo, a.w);
    const int rw = rx1 - rx0;
    const float* xp = a.x + (long long)lane * a.c * hw;
    __syncthreads();  // the previous tile's last reads
    for (int r = row; r < ry1 - ry0; r += rows) {
      for (int c = col; c < rw; c += 32) {
        const int g = (ry0 + r) * a.w + rx0 + c;
        s0[r * rw + c] = in != nullptr ? __ldcg(in + lane * hw + g)
                         : isfinite(xp[g]) ? ((ry0 + r) << 16 | (rx0 + c))
                                           : -1;
      }
    }
    int* cur = s0;
    int* nxt = s1;
    for (int dy = -k; dy <= k; dy += k) {
      for (int dx = -k; dx <= k; dx += k) {
        if (dy == 0 && dx == 0) continue;
        __syncthreads();
        for (int r = row; r < ry1 - ry0; r += rows) {
          const int gy = ry0 + r;
          int ny = gy - dy;
          ny = ny < 0 ? 0 : (ny > a.h - 1 ? a.h - 1 : ny);
          ny = ny < ry0 ? ry0 : (ny > ry1 - 1 ? ry1 - 1 : ny);
          for (int c = col; c < rw; c += 32) {
            const int gx = rx0 + c;
            int nx = gx - dx;
            nx = nx < 0 ? 0 : (nx > a.w - 1 ? a.w - 1 : nx);
            nx = nx < rx0 ? rx0 : (nx > rx1 - 1 ? rx1 - 1 : nx);
            const int nb = cur[(ny - ry0) * rw + nx - rx0];
            const int own = cur[r * rw + c];
            nxt[r * rw + c] = dist2(nb, gy, gx) < dist2(own, gy, gx) ? nb : own;
          }
        }
        int* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
    __syncthreads();
    const int ye = min(y0 + kTile, a.h), xe = min(x0 + kTile, a.w);
    for (int r = y0 + row; r < ye; r += rows)
      for (int c = x0 + col; c < xe; c += 32)
        out[lane * hw + r * a.w + c] = cur[(r - ry0) * rw + c - rx0];
  }
}

template <int NT, int B, int KT>
__global__ void __launch_bounds__(NT) tiled_fill_kernel(Fill a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  int k = 1;
  const int m = a.h > a.w ? a.h : a.w;
  while (k * 2 < m) k *= 2;
  const int* cur = nullptr;
  for (; k >= 1; k /= 2) {
    if (k <= KT) {
      if (cur != nullptr) grid.sync();
      int* out = cur == a.seed_a ? a.seed_b : a.seed_a;
      int* s0 = reinterpret_cast<int*>(smem);
      flood_tiles(a, cur, out, k, s0, s0 + tile_side(3 * k) * tile_side(3 * k));
      cur = out;
      continue;
    }
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
  grid.sync();
  const size_t side = tile_side(2 * a.smooth_iters);
  fill_tiles(a, cur, smem, reinterpret_cast<unsigned char*>(smem + side * side));
}

template <int NT, int B, int KT>
int launch_tiled(const Fill& a, long long cells, cudaStream_t st) {
  const size_t flood = tile_side(3 * KT);
  const size_t b = 2 * flood * flood * sizeof(int);
  const size_t smem = b > tile_bytes(a.smooth_iters) ? b
                                                      : tile_bytes(a.smooth_iters);
  return launch_coop<NT>(tiled_fill_kernel<NT, B, KT>, a, cells, smem, st);
}

}  // namespace k10t

extern "C" {

int faldoi_k10v_per_direction(const float* x, float* out, int* seed_a,
                              int* seed_b, float* best, int lanes, int c,
                              int h, int w, int smooth_iters, float timestep,
                              void* stream) {
  return k10v::per_direction(x, out, seed_a, seed_b, best, lanes, c, h, w,
                             smooth_iters, timestep, stream);
}

int faldoi_k11v_per_iteration(const float* wgt, const unsigned char* keep,
                              const float* u1, const float* u2, float* scratch,
                              float* o1, float* o2, int lanes, int h, int w,
                              int iters, void* stream) {
  return k11v::per_iteration(wgt, keep, u1, u2, scratch, o1, o2, lanes, h, w,
                             iters, stream);
}

// The library's K10 with nt (256, 512 or 1024) threads a block, b (1, 4
// or 8) cells a batch in the grid-wide phases and the strides up to kt (0,
// 2, 8 or 16) in tiles; with barriers_only, the same grid and barriers
// without a cell.
int faldoi_k10v_form(const float* x, float* out, int* seed_a, int* seed_b,
                     int lanes, int c, int h, int w, int smooth_iters,
                     float timestep, int nt, int b, int kt, int barriers_only,
                     void* stream) {
  Fill a{x, out, seed_a, seed_b, barriers_only ? 0 : lanes, c, h, w,
         smooth_iters, timestep};
  const long long cells = (long long)lanes * h * w;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = tile_bytes(smooth_iters);
  switch (nt * 1000 + b * 100 + kt) {
    case 256100:
      return launch_coop<256>(dense_fill_kernel<256, 1>, a, cells, smem, st);
    case 512400:
      return launch_coop<512>(dense_fill_kernel<512, 4>, a, cells, smem, st);
    case 1024100:
      return launch_coop<1024>(dense_fill_kernel<1024, 1>, a, cells, smem, st);
    case 1024400:
      return launch_coop<1024>(dense_fill_kernel<1024, 4>, a, cells, smem, st);
    case 1024402: return k10t::launch_tiled<1024, 4, 2>(a, cells, st);
    case 1024408: return k10t::launch_tiled<1024, 4, 8>(a, cells, st);
    case 1024416: return k10t::launch_tiled<1024, 4, 16>(a, cells, st);
    case 512408: return k10t::launch_tiled<512, 4, 8>(a, cells, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The library's K11 on strips of sw (1, 2, 4 or 8) columns, nt (256 or
// 512) threads a block.
int faldoi_k11v_strips(const float* colour, const float* spatial,
                       const unsigned char* keep, const float* u1,
                       const float* u2, float* o1, float* o2, int lanes, int h,
                       int w, int iters, int sw, int nt, void* stream) {
  Bilateral a{colour, keep, u1, u2, o1, o2, h, w, iters, {}};
  for (int s = 0; s < kTaps; ++s) a.spatial[s] = spatial[s];
  cudaStream_t st = (cudaStream_t)stream;
  const int key = sw * 10000 + nt;
  cudaError_t e;
  switch (key) {
    case 80256: e = launch_strips<8, 256>(a, lanes, st); break;
    case 80512: e = launch_strips<8, 512>(a, lanes, st); break;
    case 40256: e = launch_strips<4, 256>(a, lanes, st); break;
    case 40512: e = launch_strips<4, 512>(a, lanes, st); break;
    case 20256: e = launch_strips<2, 256>(a, lanes, st); break;
    case 20512: e = launch_strips<2, 512>(a, lanes, st); break;
    case 10256: e = launch_strips<1, 256>(a, lanes, st); break;
    case 10512: e = launch_strips<1, 512>(a, lanes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
