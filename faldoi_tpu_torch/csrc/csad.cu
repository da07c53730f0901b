// K8: the CSAD median-of-breakpoints prox (the v-step of methods 4-7), and
// the K8 loop: the inert-TV patch PD loop of methods 4 and 5 around it.
//
// Replaces the XLA-lowered per-pixel sort of the JAX package:
//   global form: faldoi_tpu/core/global_step_csad.py::_csad_vstep (:68), the
//      v-step of the TV-CSAD and NLTV-CSAD global loops, on (h, w) planes;
//   patch form:  faldoi_tpu/core/functionals.py::_csad_vstep (:403), the
//      v-step of the CSAD patch solvers, on B canvases of P x P;
//   loop form:   faldoi_tpu/core/functionals.py::_solve_csad_family's
//      _bounded_pd_loop (:579) with the inert TV (:548), one warp of the
//      m4 / m5 patch solve: v-step, primal step, err, the tol gate.
//
// Per cell, with n the number of the 48 neighbours (a 7x7 window without its
// centre, dy outer and dx inner) that lie inside the image (global) or inside
// the canvas's valid box [0, ph) x [0, pw) (patch, loop; n = 0 outside the
// box):
//   dot   = (i1wx u1 + i1wy u2) / denom
//   A_j   = -(b_j - dot) for the n neighbours inside, +inf for the others
//   B_j   = (n - 2j) (l_t denom) for j = 0..n, +inf for j = n+1..48
//   med   = the entry at position n + 1 (0-based) of the 97 entries A_0..A_47,
//           B_0..B_48 in a stable ascending order, NaN after +inf
//           (jnp.sort's and torch.sort's order); the reference's it/2 + 1,
//           one past the true median
//   v     = (u1 - (i1wx med) / denom, u2 - (i1wy med) / denom)
// The selected value is one of the computed entries, so with the twin's
// operation order and --fmad=false the kernel is bit-equal to the twin
// (faldoi_tpu_torch/ops/csad.py::csad_vstep_plain), the sign of a selected
// zero included.
//
// Selection by counting, nothing sorted, by a group of G = 4 lanes a cell.
// An entry's position is the number of entries before it in the stable
// order.  Lane g holds A_j for j = g, g + 4, ..., as values and as integer
// keys (order_key: NaN last, -0 = +0; A_m comes before A_k when its key is
// smaller, or equal and m < k), and counts each against the cell's 48 keys,
// broadcast one by one with __shfl_sync.  Against B it is a count of
// B_j < A_k (every B entry comes after the A ones in the stable order): B is
// monotone in j when l_t denom is finite, so the count is a 6-probe binary
// search that recomputes (n - 2j) (l_t denom) as the twin does.  The 48 - n
// masked B entries (+inf) precede only a NaN.  A ballot finds the lane whose
// A entry sits at position n + 1; if none does, with a the number of A
// entries before position n + 1 (summed over the group by shuffles), med
// is the B entry of rank r = n + 1 - a in B's own stable order: B_(n - r)
// when l_t denom > 0, B_r when it is < 0 or +-0 (the equal zeros keep j's
// order), +inf beyond n.  When l_t denom is not finite (l_t inf or NaN) B
// is not monotone: both counts loop over the 49 entries (a slow path no
// solver takes).  One thread a cell with the 1128 pair compares unrolled in
// registers (127 registers), 8 and 16 lanes a cell were slower on the H100
// at the m4 path's shapes; csrc/variants/k8_variants.cu keeps them, the
// former insertion sort and the loop's variants.
//
// Layout: b is (48, N) with N = h*w (global) or B*P*P (patch, loop: the
// planes in (48, B, P, P)), so a warp reads the b planes of consecutive cells
// at consecutive addresses; the other planes are (N,).  l_t is a value, one
// float on the device, or one float a cell (the weighted methods' window).
//
// Bounds (H100, 3.35 TB/s): the whole-image form moves 55 planes a call
// (98 MB at 436x1024, 0.029 ms); its work is ~2,500 integer and float
// instructions a lane (48 shuffles, 576 keyed compares, twelve binary
// searches), four lanes a cell, so the issue rate, not the bytes, holds
// it.  The loop form reads its inputs once a launch and keeps them for all
// its iterations: a canvas a 512-thread block at P 11 (121 cells x 4 lanes;
// eight canvases a block at P 3), each lane its twelve b values and the
// cell's state in registers (every lane of a cell updates the same state;
// 103 registers, no spill), err summed as canvas_sum sums it (each row over
// its columns by one thread, then the rows by shuffles) and the tol gate
// in shared memory, two barriers an iteration.  With 8 lanes a cell a
// canvas needs a 1024-thread block, whose 64 registers a thread spill.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;                       // DT_R
constexpr int kSide = 2 * kR + 1;
constexpr int kNd = kSide * kSide - 1;      // 48 neighbours
constexpr int kThreads = 128;
constexpr int kLanes = 4;                   // lanes a cell
constexpr int kNanKey = 0x7fffffff;
constexpr int kInfKey = 0x7f800000;

// offset j -> (dy, dx): the 7x7 window without its centre, row-major
__host__ __device__ constexpr int off_dy(int j) {
  return (j < kNd / 2 ? j : j + 1) / kSide - kR;
}
__host__ __device__ constexpr int off_dx(int j) {
  return (j < kNd / 2 ? j : j + 1) % kSide - kR;
}

// An integer key of f whose signed order is the sort's: ascending, -0 equal
// to +0, every NaN equal and after +inf.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  if (isnan(f)) return kNanKey;
  if (f == 0.0f) return 0;
  return i < 0 ? i ^ 0x7fffffff : i;
}

// A float that compares as the (non-NaN) key does.
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k < 0 ? k ^ 0x7fffffff : k);
}

__device__ __forceinline__ float b_entry(int n, int j, float ltg) {
  return (float)(n - 2 * j) * ltg;
}

// #{j in [0, n]: B_j < x} for a non-NaN x, B monotone in j (ltg finite):
// non-increasing when dec (ltg >= 0 or -0), else non-decreasing.
__device__ __forceinline__ int b_below(float x, int n, float ltg, bool dec) {
  int lo = 0, len = n + 1;   // the first j where (B_j < x) == dec, in [0, n+1]
#pragma unroll
  for (int s = 0; s < 6; ++s) {   // n + 1 <= 49 < 2^6
    const int half = len >> 1, mid = lo + half;
    const bool q = (b_entry(n, mid, ltg) < x) == dec;
    if (len > 0) {
      lo = q ? lo : mid + 1;
      len = q ? half : len - half - 1;
    }
  }
  return dec ? n + 1 - lo : lo;
}

__device__ __forceinline__ int b_key(int n, int j, float ltg) {
  return j <= n ? order_key(b_entry(n, j, ltg)) : kInfKey;
}

// The slow path's count: B entries (all 49) strictly before key kx.
__device__ __forceinline__ int b_below_slow(int kx, int n, float ltg) {
  int c = 0;
#pragma unroll 1
  for (int j = 0; j <= kNd; ++j) c += b_key(n, j, ltg) < kx;
  return c;
}

// The slow path's B entry of rank r in B's stable order.
__device__ __forceinline__ float b_rank_slow(int r, int n, float ltg) {
#pragma unroll 1
  for (int j = 0; j <= kNd; ++j) {
    const int kj = b_key(n, j, ltg);
    int pos = 0;
#pragma unroll 1
    for (int i = 0; i <= kNd; ++i) {
      const int ki = b_key(n, i, ltg);
      pos += i < j ? ki <= kj : (i > j && ki < kj);
    }
    if (pos == r) return j <= n ? b_entry(n, j, ltg) : __int_as_float(kInfKey);
  }
  return __int_as_float(kInfKey);
}

// The selection of one cell by the G lanes of its group (g: this lane's
// place in it, gmask: the group's lanes of the warp).  av[s], key[s]: the
// value and key of A_(g + G s) (+inf and kInfKey where masked).  Returns med
// on every lane of the group.
template <int G>
__device__ __forceinline__ float group_select(const float (&av)[kNd / G],
                                              const int (&key)[kNd / G], int n,
                                              float ltg, int g, unsigned gmask) {
  constexpr int S = kNd / G;
  int pos[S];
#pragma unroll
  for (int s = 0; s < S; ++s) pos[s] = 0;
#pragma unroll
  for (int m = 0; m < kNd; ++m) {
    const int km = __shfl_sync(gmask, key[m / G], m % G, G);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = g + G * s;   // A_m before A_k
      pos[s] += m < k ? km <= key[s] : (m > k && km < key[s]);
    }
  }
  const bool fin = isfinite(ltg);
  const bool dec = !(ltg < 0.0f);
  int a = 0, won = -1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int p = pos[s];
    if (!fin)
      p += b_below_slow(key[s], n, ltg);
    else
      p += key[s] == kNanKey ? kNd + 1 : b_below(key_value(key[s]), n, ltg, dec);
    won = p == n + 1 ? s : won;
    a += p <= n;
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) a += __shfl_xor_sync(gmask, a, off, G);
  float mine = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (won == s) mine = av[s];
  const unsigned wb = __ballot_sync(gmask, won >= 0) & gmask;
  if (wb != 0)   // the winning lane's entry, to the whole group
    return __shfl_sync(gmask, mine, (__ffs(wb) - 1) % G, G);
  const int r = n + 1 - a;
  if (!fin) return b_rank_slow(r, n, ltg);
  if (r > n) return __int_as_float(kInfKey);
  return b_entry(n, ltg > 0.0f ? n - r : r, ltg);
}

// This lane's A entries of the cell at (r, c) of a box ph x pw: value and
// key of A_(g + G s) from bv[s] = b_(g + G s), +inf where the neighbour is
// outside (or the cell is).  Returns n.
template <int G>
__device__ __forceinline__ int group_entries(float (&av)[kNd / G],
                                             int (&key)[kNd / G],
                                             const float (&bv)[kNd / G], int r,
                                             int c, int ph, int pw, float dot,
                                             int g) {
  const bool in = r < ph && c < pw;
#pragma unroll
  for (int s = 0; s < kNd / G; ++s) {
    const int j = g + G * s;
    const int nr = r + off_dy(j), nc = c + off_dx(j);
    const bool inside = in && nr >= 0 && nr < ph && nc >= 0 && nc < pw;
    av[s] = inside ? -(bv[s] - dot) : __int_as_float(kInfKey);
    key[s] = order_key(av[s]);
  }
  // the window's rows and columns inside the box, less the centre
  const int rows = min(r + kR, ph - 1) - max(r - kR, 0) + 1;
  const int cols = min(c + kR, pw - 1) - max(c - kR, 0) + 1;
  return in ? rows * cols - 1 : 0;
}

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (threadIdx.x & 31 & ~(G - 1));
}

struct Args {
  const float* u1;
  const float* u2;
  const float* b;
  const float* i1wx;
  const float* i1wy;
  const float* denom;
  const float* lt;    // null: lt_val; else one value (lt_cells 0) or a cell's
  const int* ph;      // null: the global form (box = the image)
  const int* pw;
  float* v1;
  float* v2;
  float lt_val;
  int lt_cells;
};

// The v-step of cell `cell` at (r, c) of a box of ph x pw by its group; b
// planes `nb` apart.  Shared by the global and patch forms.
template <int G>
__device__ __forceinline__ void csad_cell(const Args& a, long long cell,
                                          long long nb, int r, int c, int ph,
                                          int pw) {
  const int g = threadIdx.x % G;
  const float u1 = a.u1[cell], u2 = a.u2[cell];
  const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.denom[cell];
  const float dot = (gx * u1 + gy * u2) / den;
  const float lt = a.lt == nullptr ? a.lt_val : a.lt[a.lt_cells ? cell : 0];
  float bv[kNd / G], av[kNd / G];
  int key[kNd / G];
#pragma unroll
  for (int s = 0; s < kNd / G; ++s) bv[s] = a.b[(g + G * s) * nb + cell];
  const int n = group_entries<G>(av, key, bv, r, c, ph, pw, dot, g);
  const float med = group_select<G>(av, key, n, lt * den, g, group_mask<G>());
  if (g != 0) return;
  a.v1[cell] = u1 - (gx * med) / den;
  a.v2[cell] = u2 - (gy * med) / den;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
csad_global_kernel(Args a, int h, int w) {
  const long long cell = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const long long n = (long long)h * w;
  if (cell >= n) return;   // the whole group
  csad_cell<G>(a, cell, n, (int)(cell / w), (int)(cell % w), h, w);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
csad_patch_kernel(Args a, int nb_canvas, int p) {
  const long long cell = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  const long long pp = (long long)p * p;
  const long long n = pp * nb_canvas;
  if (cell >= n) return;
  const int canvas = (int)(cell / pp), rc = (int)(cell % pp);
  csad_cell<G>(a, cell, n, rc / p, rc % p, a.ph[canvas], a.pw[canvas]);
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

struct LoopArgs {
  const float* __restrict__ u1;      // (B, P, P) each
  const float* __restrict__ u2;
  const float* __restrict__ v1;
  const float* __restrict__ v2;
  const float* __restrict__ b;       // (48, B, P, P)
  const float* __restrict__ i1wx;
  const float* __restrict__ i1wy;
  const float* __restrict__ denom;
  const float* __restrict__ lt;      // (B, P, P) if lt_cells, else one
  const float* __restrict__ scal;    // theta, tau, tol^2
  const int* __restrict__ ph;        // (B,)
  const int* __restrict__ pw;
  float* __restrict__ u1o;
  float* __restrict__ u2o;
  float* __restrict__ v1o;
  float* __restrict__ v2o;
  int* __restrict__ iters;           // (B,)
};

constexpr int kLoopThreads = 1024;   // threads a loop block at most

// threads a canvas: G lanes a cell, on whole warps
__host__ __device__ constexpr int loop_canvas_threads(int p, int g) {
  return (p * p * g + 31) / 32 * 32;
}

// The masked unroll of the inert-TV PD loop (the twin's
// csad_patch_loop_plain): a canvas runs while err > tol^2 and n <
// max_iters (err starts at +inf; a NaN err stops it).  P > 0: the patch
// side at compile time; P = 0: any side with p^2 G <= T.  G lanes a cell,
// at most T threads a block.
template <int P, int G, int T>
__global__ void __launch_bounds__(T)
    csad_loop_kernel(LoopArgs a, int nbc, int p_rt, int cpb, int lt_cells,
                     int max_iters) {
  constexpr int S = kNd / G;
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int cs = loop_canvas_threads(p, G);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;   // this thread in its canvas
  const int cell = t / G, g = t % G;
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < nbc;
  const bool active = canvas && cell < pp;   // whole groups
  float* ec = smem + (lc < cpb ? lc : 0) * (pp + 1);   // [pp] updates, flag
  float* flag = ec + pp;
  const int r = cell / p, c = cell - (cell / p) * p;
  const long long plane = (long long)nbc * pp;
  const long long ci = (long long)k * pp + cell;
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];
  const bool leader = canvas && t == 0;
  const unsigned gmask = group_mask<G>();

  float u1 = 0.0f, u2 = 0.0f, v1 = 0.0f, v2 = 0.0f, gx = 0.0f, gy = 0.0f,
        den = 1.0f, lt = 0.0f, npx = 1.0f;
  float bv[S];
  int bh = 0, bw = 0;
  if (canvas) {
    bh = a.ph[k];
    bw = a.pw[k];
    npx = (float)(bh * bw);
  }
  if (active) {
    u1 = a.u1[ci];
    u2 = a.u2[ci];
    v1 = a.v1[ci];
    v2 = a.v2[ci];
    gx = a.i1wx[ci];
    gy = a.i1wy[ci];
    den = a.denom[ci];
    lt = lt_cells ? a.lt[ci] : a.lt[0];
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = a.b[(g + G * s) * plane + ci];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = 0.0f;
  }
  const bool inb = r < bh && c < bw;
  const float ltg = lt * den;
  // err = +inf before the first step
  if (leader) flag[0] = __int_as_float(kInfKey) > tol2 && max_iters > 0 ? 1.0f : 0.0f;
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    // publishes the run flags of the last step (and frees ec)
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    if (run) {
      const float dot = (gx * u1 + gy * u2) / den;
      float av[S];
      int key[S];
      const int n = group_entries<G>(av, key, bv, r, c, bh, bw, dot, g);
      const float med = group_select<G>(av, key, n, ltg, g, gmask);
      const float nv1 = u1 - (gx * med) / den;
      const float nv2 = u2 - (gy * med) / den;
      const float nu1 = u1 - tau * ((u1 - nv1) / theta);
      const float nu2 = u2 - tau * ((u2 - nv2) / theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      if (g == 0) ec[cell] = inb ? e1 * e1 + e2 * e2 : 0.0f;
      u1 = nu1;
      u2 = nu2;
      v1 = nv1;
      v2 = nv2;
      ++nit;
    }
    __syncthreads();
    if (run && t < p) {   // canvas_sum: row t over its columns, one warp
      float s = ec[t * p];
      for (int cx = 1; cx < p; ++cx) s = s + ec[t * p + cx];
      const unsigned mask = p == 32 ? 0xffffffffu : (1u << p) - 1u;
      float tot = __shfl_sync(mask, s, 0);   // then over the rows
      for (int rr = 1; rr < p; ++rr) tot = tot + __shfl_sync(mask, s, rr);
      const float err = tot / npx;
      if (t == 0) flag[0] = err > tol2 && nit < max_iters ? 1.0f : 0.0f;
    }
  }
  if (!active || g != 0) return;
  a.u1o[ci] = u1;
  a.u2o[ci] = u2;
  a.v1o[ci] = v1;
  a.v2o[ci] = v2;
  if (t == 0) a.iters[k] = nit;
}

template <int P, int G, int T = kLoopThreads>
cudaError_t launch_loop(const LoopArgs& a, int nbc, int p, int lt_cells,
                        int max_iters, cudaStream_t st) {
  const int cs = loop_canvas_threads(p, G);
  const int cpb = T / cs;
  const size_t smem = (size_t)cpb * (p * p + 1) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  csad_loop_kernel<P, G, T><<<grid, cpb * cs, smem, st>>>(a, nbc, p, cpb,
                                                          lt_cells, max_iters);
  return cudaGetLastError();
}

}  // namespace

// global form: planes (h, w), b (48, h, w); lt null -> lt_val
extern "C" int faldoi_csad_vstep_global(
    const float* u1, const float* u2, const float* b, const float* i1wx,
    const float* i1wy, const float* denom, const float* lt, float lt_val,
    int lt_cells, float* v1, float* v2, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  Args a{u1, u2, b, i1wx, i1wy, denom, lt, nullptr, nullptr, v1, v2, lt_val,
         lt_cells};
  csad_global_kernel<kLanes><<<blocks_for((long long)h * w * kLanes), kThreads,
                               0, (cudaStream_t)stream>>>(a, h, w);
  return (int)cudaGetLastError();
}

// patch form: canvases (B, P, P), b (48, B, P, P), boxes ph, pw (B,) int32
extern "C" int faldoi_csad_vstep_patch(
    const float* u1, const float* u2, const float* b, const float* i1wx,
    const float* i1wy, const float* denom, const float* lt, float lt_val,
    int lt_cells, const int* ph, const int* pw, float* v1, float* v2,
    int nb_canvas, int p, void* stream) {
  if (nb_canvas <= 0) return 0;
  if (p <= 0) return (int)cudaErrorInvalidValue;
  Args a{u1, u2, b, i1wx, i1wy, denom, lt, ph, pw, v1, v2, lt_val, lt_cells};
  csad_patch_kernel<kLanes><<<blocks_for((long long)p * p * nb_canvas * kLanes),
                              kThreads, 0, (cudaStream_t)stream>>>(a, nb_canvas, p);
  return (int)cudaGetLastError();
}

// loop form: ins = u1 u2 v1 v2 b i1wx i1wy denom lt scal ph pw, outs = u1 u2
// v1 v2 iters; b canvases of p x p, p^2 <= 1024; lt one value or one a cell
extern "C" int faldoi_csad_patch_loop(
    const float* u1, const float* u2, const float* v1, const float* v2,
    const float* b, const float* i1wx, const float* i1wy, const float* denom,
    const float* lt, const float* scal, const int* ph, const int* pw,
    float* u1o, float* u2o, float* v1o, float* v2o, int* iters, int nbc,
    int p, int lt_cells, int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  if (p <= 0 || p * p > 1024) return (int)cudaErrorInvalidValue;
  LoopArgs a{u1, u2, v1, v2, b, i1wx, i1wy, denom, lt, scal, ph, pw,
             u1o, u2o, v1o, v2o, iters};
  cudaStream_t st = (cudaStream_t)stream;
  // 4 lanes a cell, a canvas a 512-thread block at P 11 (eight at P 3);
  // fewer lanes where a canvas would not fit a block
  if (p == 11)
    return (int)launch_loop<11, 4, 512>(a, nbc, p, lt_cells, max_iters, st);
  if (p == 3)
    return (int)launch_loop<3, 4, 512>(a, nbc, p, lt_cells, max_iters, st);
  if (p * p * 4 <= kLoopThreads)
    return (int)launch_loop<0, 4>(a, nbc, p, lt_cells, max_iters, st);
  if (p * p * 2 <= kLoopThreads)
    return (int)launch_loop<0, 2>(a, nbc, p, lt_cells, max_iters, st);
  return (int)launch_loop<0, 1>(a, nbc, p, lt_cells, max_iters, st);
}
