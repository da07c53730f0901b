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
// The loop kernels (the K8 loop here, K16 in csad_loops.cu; K14 and K15,
// the whole-image loops in csad_global.cu) rank instead (csad_select.cuh,
// RankedSmem, image_select).  Within a call b, n and l_t denom are fixed
// and only dot moves, so:
//   once a call, the n inside b_j are ranked in descending order (the
//     ascending order of order_key(-b_j), ties by j) by the counting above
//     among the 48 entries alone;
//   each PD iteration, with A[i] = -(b - dot) of the b of rank i (+inf for
//     i >= n) and B[q] the B entries in B's stable order, the number i* of
//     A entries among the first m = n + 2 of A u B (A first on equal keys)
//     is lo + #{i in [lo, hi): A[i] <= B[m - 1 - i]}, lo = max(m - 49, 0),
//     hi = min(m, 48), and med is the later of A[i* - 1] and B[m - 1 - i*]
//     (A[i* - 1] where it is greater, else the B entry) -- the merge path's
//     crossing, each probe recomputed with the twin's operations.
// Why that is the twin's entry.  Let dot, l_t denom and every inside b be
// finite.  Then no entry is NaN (finite - finite and a small integer times
// a finite float are finite or +-inf), and float order is key order.
// x -> -(x - dot) is non-increasing (rounding is monotone, negation exact),
// so A[0..47] is non-decreasing, and B[0..48] is too (B_j is monotone in j
// and B's stable order walks j the ascending way); the merge of two sorted
// lists with A first on equal keys is an ascending order of the 97 values
// with the same multiset of keys as the twin's stable sort, so the entry
// found has the key of the twin's entry at position n + 1.  Two entries of
// equal key are equal floats unless they are zeros of opposite sign, so
// every non-zero value found is the twin's bit for bit.  A zero is too:
// the key-0 entries stand in both orders as the A zeros, then the B zeros,
// and within each in j's order.  An A entry is a zero only where b == dot
// exactly, so the A zeros have equal b keys and the ranking keeps their j
// order (distinct b that round to one A, ranked by b and not by j, are
// never zeros); B holds one zero (j = n / 2) where l_t denom != 0 (the
// product of an integer >= 1 in size and a finite non-zero float is not a
// zero), and where l_t denom is +-0 every B entry is a zero and the
// stable order is j = 0..n, the order taken for l_t denom <= 0.  So the
// merge picks the twin's very entry and recomputes it with the twin's
// operations, its sign included.  Where dot, l_t denom or an inside b is
// not finite, the cell takes the counting path above (group_entries +
// group_select) for that iteration.  tests/test_torch_csad_ranked.py holds
// the rule (ops/csad.py::csad_ranked_select_plain) to the twin's sort on
// the CPU, on random canvases and on cells built for ties, zeros of both
// signs, infinities, NaN and every n.  A form that also sent found zeros
// to the counting path ("the zero rule", csrc/variants/k8_variants.cu)
// was 2.4x slower at P 11, B 8192 on the H100: a zero is found in ~1% of
// random cells at P 11 and ~10% at P 3 (the CPU model), and one such cell
// sends its whole warp down the counting path.
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
// cell's state in registers (every lane of a cell updates the same state),
// the ranked b in shared memory (48 floats a cell, 23 KB a canvas at P 11)
// beside the squared updates, err summed as canvas_sum sums it (each row
// over its columns by one thread, then the rows by shuffles) and the tol
// gate, two barriers an iteration.  Two blocks an SM at P 11 and 3
// (__launch_bounds__(512, 2): 64 registers, a few spills in the ranking
// and the counting fallback, none in the merge search).  A PD iteration's
// selection is ~150 SASS instructions a lane against ~3,200 counting
// every iteration (the former form, csrc/variants/k8_variants.cu, which
// also times the other layouts measured: the ranks in registers, 1, 2 or 8
// lanes a cell, one block an SM, the fallback out of line, the zero rule).
// The runtime path (any other P <= 32, which no solver takes) counts
// every iteration (Counting).

#include "csad_select.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                   // lanes a cell


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

// shared floats a canvas: the squared updates, the run flag and the
// selection's sel floats a cell
__host__ __device__ constexpr int loop_canvas_floats(int p, int sel) {
  return (1 + sel) * p * p + 1;
}

// The masked unroll of the inert-TV PD loop (the twin's
// csad_patch_loop_plain): a canvas runs while err > tol^2 and n <
// max_iters (err starts at +inf; a NaN err stops it).  P > 0: the patch
// side at compile time; P = 0: any side with p^2 G <= T.  G lanes a cell,
// at most T threads a block, at least MINB blocks an SM; Sel: the
// selection (RankedSmem<G> or Counting<G>, csad_select.cuh; csrc/variants/
// k8_variants.cu instantiates others), Sel::kSmem shared floats a cell
// beside the squared updates.
template <int P, int G, int T, int MINB, class Sel>
__global__ void __launch_bounds__(T, MINB)
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
  float* ec = smem + (lc < cpb ? lc : 0) * loop_canvas_floats(p, Sel::kSmem);
  float* flag = ec + pp;                     // [pp] updates, flag
  float* sb = flag + 1 + (cell < pp ? cell : 0);   // the selection's column
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
  typename Sel::State sst;
  if (active) Sel::setup(sst, bv, r, c, bh, bw, ltg, g, gmask, sb, pp);
  // err = +inf before the first step
  if (leader) flag[0] = __int_as_float(kInfKey) > tol2 && max_iters > 0 ? 1.0f : 0.0f;
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    // publishes the run flags of the last step (and frees ec)
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    if (run) {
      const float dot = (gx * u1 + gy * u2) / den;
      const float med = Sel::select(sst, bv, dot, ltg, r, c, bh, bw, g, gmask, sb, pp);
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

template <int P, int G, int T = kLoopThreads, int MINB = 1,
          class Sel = Counting<G>>
cudaError_t launch_loop(const LoopArgs& a, int nbc, int p, int lt_cells,
                        int max_iters, cudaStream_t st) {
  const int cs = loop_canvas_threads(p, G);
  const int cpb = T / cs;
  const size_t smem = (size_t)cpb * loop_canvas_floats(p, Sel::kSmem) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csad_loop_kernel<P, G, T, MINB, Sel>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  csad_loop_kernel<P, G, T, MINB, Sel><<<grid, cpb * cs, smem, st>>>(
      a, nbc, p, cpb, lt_cells, max_iters);
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
    return (int)launch_loop<11, 4, 512, 2, RankedSmem<4>>(a, nbc, p, lt_cells,
                                                         max_iters, st);
  if (p == 3)
    return (int)launch_loop<3, 4, 512, 2, RankedSmem<4>>(a, nbc, p, lt_cells,
                                                        max_iters, st);
  if (p * p * 4 <= kLoopThreads)
    return (int)launch_loop<0, 4>(a, nbc, p, lt_cells, max_iters, st);
  if (p * p * 2 <= kLoopThreads)
    return (int)launch_loop<0, 2>(a, nbc, p, lt_cells, max_iters, st);
  return (int)launch_loop<0, 1>(a, nbc, p, lt_cells, max_iters, st);
}
