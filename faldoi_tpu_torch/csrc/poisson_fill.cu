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
// Design: a canvas of P x P <= 1024 cells lives in a block's shared memory
// with its whole pyramid (121 + 36 + 9 + 4 + 1 floats at P 11), one thread
// a cell of the finest level, as many canvases a block as fit 256 threads
// (2 at P 11, 28 at P 3; past P 16 one canvas a block of up to 1024
// threads).  No relaxation step reads a cell that the same step writes (the
// two colours, and two fronts, are never neighbours; a clamped neighbour is
// the cell itself, which its own thread reads before it writes), so one
// barrier follows each colour or front.  The levels are
// rebuilt in place: a level's zoomed-out input is read once, by the cell's
// own thread, before the relaxed values overwrite it.  The input planes are
// read once and the outputs written once; the u and v canvases of a sweep
// are two planes of one launch.
//
// Bound on the H100: tiny work (~7 float operations a hole a relaxation
// step, ~10 a child cell a zoom-out) against one read and one write of
// each canvas; in practice the barriers (2 x 3 a level red-black, 3 x (2s -
// 1) exact) and the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 6;     // P <= 32 halves to 1 in at most 6 levels
constexpr int kFillThreads = 256; // threads a block, canvases packed
constexpr int kMaxThreads = 1024; // one canvas of P 32

struct Pyramid {
  int n;                   // levels
  int side[kMaxLevels];    // level sides, finest first
  int off[kMaxLevels];     // their offsets in a canvas's shared floats
  int total;               // shared floats a canvas
};

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

// Canvas g of the nplanes x b canvases (plane g / b, patch g % b): threads
// [lc * pp, (lc + 1) * pp) of the block hold it, cpb canvases a block.
template <bool EXACT>
__global__ void __launch_bounds__(kMaxThreads)
    poisson_fill_kernel(const float* __restrict__ x0,
                        const float* __restrict__ x1, float* __restrict__ o0,
                        float* __restrict__ o1,
                        const long long* __restrict__ ph,
                        const long long* __restrict__ pw, int b, int nplanes,
                        int p, Pyramid pyr, float ts, int niter, int cpb) {
  extern __shared__ float smem[];
  const int pp = p * p;
  const int lc = threadIdx.x / pp;
  const int t = threadIdx.x - lc * pp;       // the cell at the finest level
  const long long g = (long long)blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && g < (long long)nplanes * b;
  const int k = canvas ? (int)(g % b) : 0;
  const int plane = canvas ? (int)(g / b) : 0;
  float* cv = smem + (lc < cpb ? lc : 0) * pyr.total;
  // the boxes of every level, halved as the twin halves them
  int bh[kMaxLevels], bw[kMaxLevels];
  bh[0] = canvas ? (int)ph[k] : 0;
  bw[0] = canvas ? (int)pw[k] : 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    bh[l] = (bh[l - 1] + 1) >> 1;
    bw[l] = (bw[l - 1] + 1) >> 1;
  }
  const long long at = (long long)k * pp + t;
  if (canvas) cv[t] = (plane == 0 ? x0 : x1)[at];
  __syncthreads();
  // zoom-outs, finest to coarsest
  for (int l = 1; l < pyr.n; ++l) {
    const int s = pyr.side[l], sp = pyr.side[l - 1];
    if (canvas && t < s * s) {
      const int r = t / s, c = t - (t / s) * s;
      const float* par = cv + pyr.off[l - 1];
      float sum = 0.0f;
      int cnt = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int rr = 2 * r + (d >> 1), cc = 2 * c + (d & 1);
        const float v = rr < sp && cc < sp && rr < bh[l - 1] && cc < bw[l - 1]
                            ? par[rr * sp + cc]
                            : nan_f();
        const bool fin = finite(v);
        cnt += fin;
        sum = sum + (fin ? v : 0.0f);
      }
      cv[pyr.off[l] + t] = cnt > 0 ? __fdiv_rn(sum, (float)cnt) : nan_f();
    }
    __syncthreads();
  }
  // coarse to fine: init, then the relaxation of the holes in the box
  float mine = 0.0f;
  for (int l = pyr.n - 1; l >= 0; --l) {
    const int s = pyr.side[l];
    const bool cell = canvas && t < s * s;
    const int r = cell ? t / s : 0, c = cell ? t - (t / s) * s : 0;
    float* y = cv + pyr.off[l];
    bool upd = false;
    if (cell) {
      const float xk = y[t];
      const bool hole = !finite(xk);
      const bool inbox = r < bh[l] && c < bw[l];
      const float init = l == pyr.n - 1
                             ? 0.0f
                             : cv[pyr.off[l + 1] + (r >> 1) * pyr.side[l + 1] +
                                  (c >> 1)];
      float v = inbox ? (hole ? init : xk) : 0.0f;
      v = finite(v) ? v : 0.0f;
      y[t] = v;
      upd = hole && inbox;
    }
    __syncthreads();
    const int parity = (r + c) & 1;
    for (int it = 0; it < niter; ++it) {
      if (EXACT) {
        for (int d = 0; d < 2 * s - 1; ++d) {
          if (upd && r + c == d)
            y[t] = relax_cell(y, r, c, s, bh[l], bw[l], ts);
          __syncthreads();
        }
      } else {
#pragma unroll
        for (int colour = 0; colour < 2; ++colour) {
          if (upd && parity == colour)
            y[t] = relax_cell(y, r, c, s, bh[l], bw[l], ts);
          __syncthreads();
        }
      }
    }
    if (l == 0 && cell) mine = y[t];
  }
  if (canvas) (plane == 0 ? o0 : o1)[at] = mine;
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
  if (p <= 0 || p * p > 1024 || nplanes < 1 || nplanes > 2 || n_levels < 1 ||
      n_levels > kMaxLevels || sides[0] != p)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr{};
  pyr.n = n_levels;
  int total = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (l > 0 && sides[l] != (sides[l - 1] + 1) / 2)
      return (int)cudaErrorInvalidValue;
    pyr.side[l] = sides[l];
    pyr.off[l] = total;
    total += sides[l] * sides[l];
  }
  pyr.total = total;
  const int pp = p * p;
  const int cpb = kFillThreads / pp > 0 ? kFillThreads / pp : 1;
  const int threads = (cpb * pp + 31) / 32 * 32;
  const long long canvases = (long long)nplanes * b;
  const long long blocks = (canvases + cpb - 1) / cpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cpb * total * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (exact)
    poisson_fill_kernel<true><<<(unsigned)blocks, threads, smem, st>>>(
        x0, x1, o0, o1, ph, pw, b, nplanes, p, pyr, timestep, niter, cpb);
  else
    poisson_fill_kernel<false><<<(unsigned)blocks, threads, smem, st>>>(
        x0, x1, o0, o1, ph, pw, b, nplanes, p, pyr, timestep, niter, cpb);
  return (int)cudaGetLastError();
}
