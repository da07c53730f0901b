// K13: the canvas Poisson fill, coarse to fine, both relaxation modes, in
// one launch for every canvas of every plane.
//
// Replaces the XLA-lowered faldoi_tpu/ops/poisson.py::poisson_fill_canvas
// (with _relax, _zoom_out2, _zoom_in2), which JAX vmaps over the patches of
// a sweep (_sweep_body's build_init) and of the seed insertion.  The plain
// twin is faldoi_tpu_torch/ops/poisson.py::poisson_fill_canvas_plain; every
// step below follows its operation order, so with --fmad=false the two are
// equal bit for bit:
//   * zoom-out (elap_recsep.c:129-185): a child cell is the mean of the
//     finite cells of its 2x2 parent block, summed over the blocks (0,0),
//     (0,1), (1,0), (1,1) from 0 and divided by their count (IEEE), NaN
//     where none is finite; parent cells outside the parent's valid box, or
//     beyond its side, count as NaN; the box halves as (ph + 1) / 2;
//   * coarse to fine: the coarsest level starts from 0, each finer one from
//     the coarser result replicated over 2x2 blocks (elap_recsep.c:191-199);
//     a hole (a non-finite cell) takes that init, a cell outside the box 0,
//     and a non-finite result 0;
//   * relaxation (elap_recsep.c:49-68): niter iterations of y += timestep *
//     (-4 y + right + left + down + up) on the holes inside the box, the
//     neighbours read as getpixel_1 reads them (the cell itself past the
//     box), summed in that order.  Red-black: the cells with an even row +
//     column first, then the odd ones.  Exact (raster Gauss-Seidel): the
//     2s - 1 anti-diagonal fronts in order (a cell reads the updated front
//     before it and the old one after it).
// Cells outside the box come back as 0.
//
// Design: a warp a patch.  The warp holds two canvases with their whole
// pyramids (121 + 36 + 9 + 4 + 1 floats each at P 11) in its own slice of
// shared memory: the patch's u and v canvases, which share the box, or with
// one plane two patches; past P 16 one canvas.  Lane 16 q + r (lane r with
// one canvas) owns row r of canvas q at every level: its zoom-out children,
// its init, and its cells in every relaxation step.  No step reads a cell
// that the same step writes (the two colours, and two fronts, are never
// neighbours; a clamped neighbour is the cell itself, which its own lane
// reads before it writes), so a __syncwarp() follows each colour or front:
// no block barrier anywhere, and a warp that finishes leaves.  The holes of
// a lane's row are a bit mask in a register.  At P 11 and P 3 each level is
// its own template instance (sides and offsets constants, boxes by shifts:
// no stack frame, no runtime division); other sides up to 32 read the
// pyramid from the launch's parameters.  The canvases are read and written row-major by the
// whole warp (coalesced).  8 warps a block; at <= 32 registers a thread an
// SM keeps 64 warps, so 8192 patches are one wave.
//
// Bound on the H100: tiny work (~7 float operations a hole a relaxation
// step, ~9 a child cell a zoom-out) against one read and one write of each
// canvas; in practice the instructions the warps issue (a lane's update is
// five shared-memory reads, 7 operations, a write and its row's index
// arithmetic), which faldoi_tpu_torch/cli/patch_variants.py counts in the
// SASS and times beside the former form (a thread a cell on block
// barriers) and other layouts (the row in registers, other launch bounds).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 6;       // P <= 32 halves to 1 in at most 6 levels
constexpr int kFillWarps = 8;       // warps a block
constexpr int kFillThreads = 32 * kFillWarps;

struct Pyramid {
  int n;                   // levels
  int side[kMaxLevels];    // level sides, finest first
  int off[kMaxLevels];     // their offsets in a canvas's shared floats
  int total;               // shared floats a canvas
};

struct FillArgs {
  const float* __restrict__ x0;   // (b, p, p) plane 0
  const float* __restrict__ x1;   // plane 1 (null with one plane)
  float* __restrict__ o0;
  float* __restrict__ o1;
  const long long* __restrict__ ph;   // (b,) boxes shared by the planes
  const long long* __restrict__ pw;
  int b, nplanes, p;
  float ts;
  int niter;
};

// Level l's side: l halvings of p, each rounded up, are ceil(p / 2^l); the
// boxes halve the same way.
__host__ __device__ __forceinline__ constexpr int level_side(int p, int l) {
  return (p + (1 << l) - 1) >> l;
}

__host__ __device__ __forceinline__ constexpr int level_off(int p, int l) {
  int off = 0;
  for (int k = 0; k < l; ++k) off += level_side(p, k) * level_side(p, k);
  return off;
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// One relaxation update of cell (r, c) of a level of side s with box (bh,
// bw): y + ts * (-4 y + right + left + down + up).
__device__ __forceinline__ float relax_cell(const float* y, int r, int c,
                                            int s, int bh, int bw, float ts) {
  const int i = r * s + c;
  const float yc = y[i];
  const float right = c + 1 < bw ? y[i + 1] : yc;
  const float left = c - 1 >= 0 ? y[i - 1] : yc;
  const float down = r + 1 < bh ? y[i + s] : yc;
  const float up = r - 1 >= 0 ? y[i - s] : yc;
  float lap = -4.0f * yc;
  lap = lap + right;
  lap = lap + left;
  lap = lap + down;
  lap = lap + up;
  return yc + ts * lap;
}

// The warp's canvas q (of cpw): its plane, patch and whether it exists.
// Two planes and two canvases a warp: the patch's u and v; else the
// canvases g = warp * cpw + q of the plane-major list.
__device__ __forceinline__ bool warp_canvas(const FillArgs& a, long long warp,
                                            int cpw, int q, int* plane,
                                            int* k) {
  if (a.nplanes == 2 && cpw == 2) {
    *plane = q;
    *k = (int)warp;
    return warp < a.b;
  }
  const long long g = warp * cpw + q;
  *plane = g >= a.b ? 1 : 0;
  *k = (int)(g - (long long)*plane * a.b);
  return g < (long long)a.nplanes * a.b;
}

// ceil(x / 2^l): a side or a box after l halvings
__device__ __forceinline__ int halved(int x, int l) {
  return (x + (1 << l) - 1) >> l;
}

// One lane's part of a warp's canvases: its row r of canvas q (at cv in
// shared memory), the canvas's finest box, and the warp's slice (base).
struct FillLane {
  float* base;
  float* cv;
  long long warp;
  int lane, cpw, total, r;
  bool canvas;
  int bh0, bw0;
};

// The warp's canvases into its shared slice, row-major by the whole warp
// (coalesced), and this lane's row, canvas and box.
template <int P, int NL>
__device__ __forceinline__ FillLane fill_begin(const FillArgs& a,
                                               const Pyramid& pyr,
                                               float* smem) {
  FillLane f;
  const int p = P > 0 ? P : a.p;
  const int pp = p * p;
  f.total = P > 0 ? level_off(P, NL) : pyr.total;
  f.cpw = p <= 16 ? 2 : 1;
  f.lane = threadIdx.x & 31;
  f.warp = (long long)blockIdx.x * kFillWarps + (threadIdx.x >> 5);
  f.base = smem + (threadIdx.x >> 5) * f.cpw * f.total;
  for (int q = 0; q < f.cpw; ++q) {
    int plane, k;
    if (!warp_canvas(a, f.warp, f.cpw, q, &plane, &k)) continue;
    const float* x = (plane == 0 ? a.x0 : a.x1) + (long long)k * pp;
    for (int t = f.lane; t < pp; t += 32) f.base[q * f.total + t] = x[t];
  }
  const int q = f.cpw == 2 ? f.lane >> 4 : 0;
  f.r = f.cpw == 2 ? f.lane & 15 : f.lane;
  int plane = 0, k = 0;
  f.canvas = warp_canvas(a, f.warp, f.cpw, q, &plane, &k);
  f.cv = f.base + q * f.total;
  f.bh0 = f.canvas ? (int)a.ph[k] : 0;
  f.bw0 = f.canvas ? (int)a.pw[k] : 0;
  __syncwarp();
  return f;
}

// The level of side s below a parent of side sp with box (bhp, bwp): this
// lane's row of children.  S > 0: s at compile time (the loop unrolled).
template <int S>
__device__ __forceinline__ void zoom_out(const FillLane& f, const float* par,
                                         float* child, int s, int sp, int bhp,
                                         int bwp) {
  const int r = f.r;
  if (!f.canvas || r >= s) return;
#pragma unroll
  for (int c = 0; c < (S > 0 ? S : 32); ++c) {
    if (c >= s) break;
    float sum = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int rr = 2 * r + (d >> 1), cc = 2 * c + (d & 1);
      const float v = rr < sp && cc < sp && rr < bhp && cc < bwp
                          ? par[rr * sp + cc]
                          : nan_f();
      const bool fin = finite(v);
      cnt += fin;
      sum = sum + (fin ? v : 0.0f);
    }
    child[r * s + c] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : nan_f();
  }
}

// A level's init on this lane's row (a hole takes the coarser level's
// value, 0 at the coarsest (coarse null); a cell outside the box 0; a
// non-finite result 0); returns the row's holes in the box as a bit mask.
// The caller syncs the warp.
template <int S>
__device__ __forceinline__ unsigned init_level(const FillLane& f, float* y,
                                               const float* coarse, int s,
                                               int s1, int bh, int bw) {
  const int r = f.r;
  unsigned upd = 0u;
  if (!f.canvas || r >= s) return upd;
#pragma unroll
  for (int c = 0; c < (S > 0 ? S : 32); ++c) {
    if (c >= s) break;
    const float xk = y[r * s + c];
    const bool hole = !finite(xk);
    const bool inbox = r < bh && c < bw;
    const float init = coarse != nullptr ? coarse[(r >> 1) * s1 + (c >> 1)] : 0.0f;
    float v = inbox ? (hole ? init : xk) : 0.0f;
    v = finite(v) ? v : 0.0f;
    y[r * s + c] = v;
    upd |= (unsigned)(hole && inbox) << c;
  }
  return upd;
}

// niter relaxations of a level in shared memory, this lane's row: a
// __syncwarp() after each front (exact) or colour (red-black).
template <int S, bool EXACT>
__device__ __forceinline__ void relax_level(float* y, int r, int s, int bh,
                                            int bw, unsigned upd, float ts,
                                            int niter) {
  for (int it = 0; it < niter; ++it) {
    if (EXACT) {
#pragma unroll
      for (int d = 0; d < (S > 0 ? 2 * S - 1 : 63); ++d) {
        if (d >= 2 * s - 1) break;
        const int c = d - r;
        if ((unsigned)c < (unsigned)s && ((upd >> c) & 1u))
          y[r * s + c] = relax_cell(y, r, c, s, bh, bw, ts);
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int colour = 0; colour < 2; ++colour) {
        if (upd) {
#pragma unroll
          for (int j = 0; j < (S > 0 ? (S + 1) / 2 : 16); ++j) {
            const int c = 2 * j + ((r + colour) & 1);
            if (c < s && ((upd >> c) & 1u))
              y[r * s + c] = relax_cell(y, r, c, s, bh, bw, ts);
          }
        }
        __syncwarp();
      }
    }
  }
}

// The zoom-outs of levels 1..L of a compile-time pyramid, finest first.
template <int P, int L>
__device__ __forceinline__ void zoom_levels(const FillLane& f) {
  if constexpr (L >= 1) {
    zoom_levels<P, L - 1>(f);
    zoom_out<level_side(P, L)>(f, f.cv + level_off(P, L - 1),
                               f.cv + level_off(P, L), level_side(P, L),
                               level_side(P, L - 1), halved(f.bh0, L - 1),
                               halved(f.bw0, L - 1));
    __syncwarp();
  }
}

// Levels L..0 of a compile-time pyramid of NL levels, coarse to fine: the
// init, then the relaxation.
template <int P, int NL, bool EXACT, int L>
__device__ __forceinline__ void relax_levels(const FillLane& f, float ts,
                                             int niter) {
  if constexpr (L >= 0) {
    constexpr int S = level_side(P, L);
    constexpr bool kLast = L + 1 >= NL;
    float* y = f.cv + level_off(P, L);
    const int bh = halved(f.bh0, L), bw = halved(f.bw0, L);
    const unsigned upd = init_level<S>(
        f, y, kLast ? nullptr : f.cv + level_off(P, L + 1), S,
        kLast ? 1 : level_side(P, L + 1), bh, bw);
    __syncwarp();
    relax_level<S, EXACT>(y, f.r, S, bh, bw, upd, ts, niter);
    relax_levels<P, NL, EXACT, L - 1>(f, ts, niter);
  }
}

// The finest level out, row-major by the whole warp.
__device__ __forceinline__ void fill_end(const FillLane& f, const FillArgs& a,
                                         int pp) {
  __syncwarp();
  for (int q = 0; q < f.cpw; ++q) {
    int plane, k;
    if (!warp_canvas(a, f.warp, f.cpw, q, &plane, &k)) continue;
    float* o = (plane == 0 ? a.o0 : a.o1) + (long long)k * pp;
    for (int t = f.lane; t < pp; t += 32) o[t] = f.base[q * f.total + t];
  }
}

// P > 0: the pyramid of side P with NL levels at compile time (each level
// its own code, the sides and offsets constants); P = 0: any side up to
// 32, the pyramid from ``pyr``.  The relaxation in shared memory, a lane a
// row.
template <int P, int NL, bool EXACT, int MINB = 8>
__global__ void __launch_bounds__(kFillThreads, MINB)
    poisson_fill_kernel(FillArgs a, Pyramid pyr) {
  extern __shared__ float smem[];
  const FillLane f = fill_begin<P, NL>(a, pyr, smem);
  if constexpr (P > 0) {
    zoom_levels<P, NL - 1>(f);
    relax_levels<P, NL, EXACT, NL - 1>(f, a.ts, a.niter);
  } else {
    for (int l = 1; l < pyr.n; ++l) {
      zoom_out<0>(f, f.cv + pyr.off[l - 1], f.cv + pyr.off[l], pyr.side[l],
                  pyr.side[l - 1], halved(f.bh0, l - 1), halved(f.bw0, l - 1));
      __syncwarp();
    }
    for (int l = pyr.n - 1; l >= 0; --l) {
      const bool last = l + 1 >= pyr.n;
      float* y = f.cv + pyr.off[l];
      const int bh = halved(f.bh0, l), bw = halved(f.bw0, l);
      const unsigned upd = init_level<0>(
          f, y, last ? nullptr : f.cv + pyr.off[l + 1], pyr.side[l],
          last ? 1 : pyr.side[l + 1], bh, bw);
      __syncwarp();
      relax_level<0, EXACT>(y, f.r, pyr.side[l], bh, bw, upd, a.ts, a.niter);
    }
  }
  fill_end(f, a, (P > 0 ? P : a.p) * (P > 0 ? P : a.p));
}

// Warps and blocks of a launch: a warp holds two canvases (the u and v of a
// patch with two planes, two patches with one) up to P 16, else one.
inline long long fill_warps(const FillArgs& a) {
  const int cpw = a.p <= 16 ? 2 : 1;
  return a.nplanes == 2 && cpw == 2 ? (long long)a.b
                                    : ((long long)a.nplanes * a.b + cpw - 1) / cpw;
}

template <int P, int NL, int MINB = 8>
cudaError_t launch_fill(const FillArgs& a, const Pyramid& pyr, bool exact,
                        cudaStream_t st) {
  const int cpw = a.p <= 16 ? 2 : 1;
  const long long blocks = (fill_warps(a) + kFillWarps - 1) / kFillWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kFillWarps * cpw * pyr.total * sizeof(float);
  if (exact)
    poisson_fill_kernel<P, NL, true, MINB>
        <<<(unsigned)blocks, kFillThreads, smem, st>>>(a, pyr);
  else
    poisson_fill_kernel<P, NL, false, MINB>
        <<<(unsigned)blocks, kFillThreads, smem, st>>>(a, pyr);
  return cudaGetLastError();
}

// The pyramid of the twin's _level_sizes (sides, finest first), checked.
bool make_pyramid(int p, const int* sides, int n_levels, Pyramid* pyr) {
  if (n_levels < 1 || n_levels > kMaxLevels || sides[0] != p) return false;
  pyr->n = n_levels;
  int total = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (l > 0 && sides[l] != (sides[l - 1] + 1) / 2) return false;
    pyr->side[l] = sides[l];
    pyr->off[l] = total;
    total += sides[l] * sides[l];
  }
  pyr->total = total;
  return true;
}

}  // namespace

// x0, x1: the input planes ((b, p, p) each; x1 null with one plane), o0, o1
// the outputs; ph, pw: (b,) int64 boxes shared by the planes; sides: the
// levels' sides (the twin's _level_sizes), n_levels of them, finest first.
extern "C" int faldoi_poisson_fill(const float* x0, const float* x1,
                                   float* o0, float* o1, const long long* ph,
                                   const long long* pw, int b, int nplanes,
                                   int p, const int* sides, int n_levels,
                                   float timestep, int niter, int exact,
                                   void* stream) {
  if (b <= 0) return 0;
  Pyramid pyr{};
  if (p <= 0 || p * p > 1024 || nplanes < 1 || nplanes > 2 ||
      !make_pyramid(p, sides, n_levels, &pyr))
    return (int)cudaErrorInvalidValue;
  const FillArgs a{x0, x1, o0, o1, ph, pw, b, nplanes, p, timestep, niter};
  cudaStream_t st = (cudaStream_t)stream;
  if (p == 11 && n_levels == 5)
    return (int)launch_fill<11, 5>(a, pyr, exact != 0, st);
  if (p == 3 && n_levels == 3)
    return (int)launch_fill<3, 3>(a, pyr, exact != 0, st);
  return (int)launch_fill<0, 0>(a, pyr, exact != 0, st);
}
