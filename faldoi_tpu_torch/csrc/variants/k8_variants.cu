// K8's design variants, timed against each other and against the library's
// kernels (csad.cu and csad_loops.cu, included below) by
// faldoi_tpu_torch/cli/k8_variants.py, which builds this file itself
// (kernels/build.py does not):
//   v-step variant 0: the former kernel, one thread a cell: the n values
//       insertion-sorted in local memory, the second list built in order, a
//       merge walk to the rank n + 1;
//   v-step variant 1: one thread a cell, selection by counting with the
//       1128 pair compares of the 48 keys unrolled in registers;
//   v-step variants 8, 16: csad.cu's kernels with 8 or 16 lanes a cell (the
//       library's have 4);
//   loop variant 0: the former K8 loop (csad_loop_kernel before the
//       ranking, copied unchanged: the full counting selection every PD
//       iteration, 4 lanes a cell, a canvas a 512-thread block);
//   loop variant 1: the K8 loop with one thread a cell counting (variant
//       1's selection, a cell's 48 b values in registers), 128-thread blocks;
//   loop variants 2 and up: the library's loop kernel (csad.cu) with other
//       selections of the same face (csad_select.cuh): the ranks in
//       registers, each lane testing the ranks it holds (RankedRegs, here),
//       or the library's ranked b in shared memory (RankedSmem), at 1, 2,
//       4 or 8 lanes a cell, 128-1024 threads, one to three blocks an SM,
//       with the counting fallback out of line, and with the zero rule (a
//       found zero also takes the counting path); 30-32 only for the SASS
//       counts: the ranked forms without their fallback, and no selection
//       at all (med = dot, the rest of a PD iteration);
//   K16 variants (faldoi_k8v_nl): 0 the former K16 (nltvcsad_patch_kernel
//       before the ranking, copied unchanged), the others as the loop's.
// Every variant but the SASS-only forms is held bit for bit to its twin by
// the script.

#include "../csad.cu"
#include "../csad_loops.cu"

namespace {
#ifndef K8V_FORMER_ONLY
namespace insertion {

// a strictly before b in ascending order with NaN last
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

__device__ __forceinline__ void insert(float* list, int m, float v) {
  int i = m;
  while (i > 0 && before(v, list[i - 1])) {
    list[i] = list[i - 1];
    --i;
  }
  list[i] = v;
}

// (Args: csad.cu's, field for field the former kernel's)

// The v-step of cell `cell` at (r, c) of a box of ph x pw; b planes `nb`
// apart.  Shared by both forms.
__device__ __forceinline__ void ins_cell(const Args& a, long long cell,
                                          long long nb, int r, int c, int ph,
                                          int pw) {
  const float u1 = a.u1[cell], u2 = a.u2[cell];
  const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.denom[cell];
  const float dot = (gx * u1 + gy * u2) / den;
  const float lt = a.lt == nullptr ? a.lt_val : a.lt[a.lt_cells ? cell : 0];
  const float ltg = lt * den;

  // A: the n values of the neighbours inside, ascending (NaN last); the
  // 48 - n masked +inf entries come after them, before any NaN
  float A[kNd];
  int n = 0, nan_a = 0;
  if (r < ph && c < pw) {
#pragma unroll 1
    for (int j = 0; j < kNd; ++j) {
      const int k = j < kNd / 2 ? j : j + 1;   // skip the centre
      const int nr = r + k / kSide - kR, nc = c + k % kSide - kR;
      if (nr < 0 || nr >= ph || nc < 0 || nc >= pw) continue;
      const float v = -(a.b[j * nb + cell] - dot);
      nan_a += isnan(v);
      insert(A, n, v);
      ++n;
    }
  }
  // B: (n - 2j) ltg for j = 0..n and +inf for j > n, ascending (NaN last)
  float B[kNd + 1];
  const float inf = __int_as_float(0x7f800000);
  if (isfinite(ltg)) {
    const bool up = !(ltg < 0.0f);   // ascending in -j when ltg >= 0
#pragma unroll 1
    for (int i = 0; i <= n; ++i) {
      const int j = up ? n - i : i;
      B[i] = (float)(n - 2 * j) * ltg;
    }
#pragma unroll 1
    for (int i = n + 1; i <= kNd; ++i) B[i] = inf;
  } else {
#pragma unroll 1
    for (int j = 0; j <= kNd; ++j)
      insert(B, j, j <= n ? (float)(n - 2 * j) * ltg : inf);
  }

  // merge walk to rank n + 1; ties take A first (the twin's stable order)
  const int fin = n - nan_a;             // A's entries before its NaNs
  const float nan = __int_as_float(0x7fc00000);
  int ia = 0, ib = 0;
  float med = 0.0f;
#pragma unroll 1
  for (int t = 0; t <= n + 1; ++t) {
    const float x = ia < fin ? A[ia] : (ia < kNd - nan_a ? inf : nan);
    if (ia < kNd && (ib > kNd || !before(B[ib], x))) {
      med = x;
      ++ia;
    } else {
      med = B[ib];
      ++ib;
    }
  }
  a.v1[cell] = u1 - (gx * med) / den;
  a.v2[cell] = u2 - (gy * med) / den;
}

__global__ void __launch_bounds__(kThreads)
ins_global_kernel(Args a, int h, int w) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)h * w;
  if (cell >= n) return;
  ins_cell(a, cell, n, (int)(cell / w), (int)(cell % w), h, w);
}

__global__ void __launch_bounds__(kThreads)
ins_patch_kernel(Args a, int nb_canvas, int p) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pp = (long long)p * p;
  const long long n = pp * nb_canvas;
  if (cell >= n) return;
  const int canvas = (int)(cell / pp), rc = (int)(cell % pp);
  ins_cell(a, cell, n, rc / p, rc % p, a.ph[canvas], a.pw[canvas]);
}


}  // namespace insertion

namespace thread_cell {

// The selection of one cell: key[j] the keys of A_0..A_47 (kInfKey where
// masked).  Returns the index of the selected A entry, or -1 with the
// selected value in *bmed: a B entry, or +inf (an A entry that is +inf,
// masked or not: only its value is needed, and the caller would read b for
// a masked one).
__device__ __forceinline__ int select_entry(const int (&key)[kNd], int n,
                                            float ltg, float* bmed) {
  int pos[kNd];
#pragma unroll
  for (int k = 0; k < kNd; ++k) pos[k] = 0;
#pragma unroll
  for (int k = 1; k < kNd; ++k) {
#pragma unroll
    for (int m = 0; m < k; ++m) {
      const int c = key[m] <= key[k];   // A_m before A_k
      pos[k] += c;
      pos[m] += 1 - c;
    }
  }
  const bool fin = isfinite(ltg);
  if (fin) {
    const bool dec = !(ltg < 0.0f);
#pragma unroll
    for (int k = 0; k < kNd; ++k)
      pos[k] += key[k] == kNanKey ? kNd + 1 : b_below(key_value(key[k]), n, ltg, dec);
  } else {
#pragma unroll
    for (int k = 0; k < kNd; ++k) pos[k] += b_below_slow(key[k], n, ltg);
  }
  int win = -1, a = 0;
  bool inf_win = false;
#pragma unroll
  for (int k = 0; k < kNd; ++k) {
    const bool hit = pos[k] == n + 1;
    win = hit ? k : win;
    inf_win = hit ? key[k] == kInfKey : inf_win;
    a += pos[k] <= n;
  }
  if (inf_win) {
    *bmed = __int_as_float(kInfKey);
    return -1;
  }
  if (win < 0) {
    const int r = n + 1 - a;
    if (!fin)
      *bmed = b_rank_slow(r, n, ltg);
    else if (r > n)
      *bmed = __int_as_float(kInfKey);
    else
      *bmed = b_entry(n, ltg > 0.0f ? n - r : r, ltg);
  }
  return win;
}

// The v-step of cell `cell` at (r, c) of a box of ph x pw; b planes `nb`
// apart.  Shared by the global and patch forms.
__device__ __forceinline__ void cell_vstep(const Args& a, long long cell,
                                          long long nb, int r, int c, int ph,
                                          int pw) {
  const float u1 = a.u1[cell], u2 = a.u2[cell];
  const float gx = a.i1wx[cell], gy = a.i1wy[cell], den = a.denom[cell];
  const float dot = (gx * u1 + gy * u2) / den;
  const float lt = a.lt == nullptr ? a.lt_val : a.lt[a.lt_cells ? cell : 0];
  const float ltg = lt * den;
  const bool in = r < ph && c < pw;
  int key[kNd];
  int n = 0;
#pragma unroll
  for (int j = 0; j < kNd; ++j) {
    const int nr = r + off_dy(j), nc = c + off_dx(j);
    const bool inside = in && nr >= 0 && nr < ph && nc >= 0 && nc < pw;
    key[j] = inside ? order_key(-(a.b[j * nb + cell] - dot)) : kInfKey;
    n += inside;
  }
  float med = 0.0f;
  const int win = select_entry(key, n, ltg, &med);
  if (win >= 0) med = -(a.b[win * nb + cell] - dot);
  a.v1[cell] = u1 - (gx * med) / den;
  a.v2[cell] = u2 - (gy * med) / den;
}

__global__ void __launch_bounds__(kThreads)
cell_global_kernel(Args a, int h, int w) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)h * w;
  if (cell >= n) return;
  cell_vstep(a, cell, n, (int)(cell / w), (int)(cell % w), h, w);
}

__global__ void __launch_bounds__(kThreads)
cell_patch_kernel(Args a, int nb_canvas, int p) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pp = (long long)p * p;
  const long long n = pp * nb_canvas;
  if (cell >= n) return;
  const int canvas = (int)(cell / pp), rc = (int)(cell % pp);
  cell_vstep(a, cell, n, rc / p, rc % p, a.ph[canvas], a.pw[canvas]);
}

// threads a canvas: one a cell, on whole warps
__host__ __device__ constexpr int cell_canvas_threads(int p) {
  return (p * p + 31) / 32 * 32;
}

// The masked unroll of the inert-TV PD loop (the twin's
// csad_patch_loop_plain): a canvas runs while err > tol^2 and n <
// max_iters (err starts at +inf; a NaN err stops it).  P > 0: the patch
// side at compile time (a 128-thread block); P = 0: any side, p^2 <= 1024.
template <int P>
__global__ void __launch_bounds__(P > 0 ? kThreads : 1024)
    cell_loop_kernel(LoopArgs a, int nbc, int p_rt, int cpb, int lt_cells,
                     int max_iters) {
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int cs = cell_canvas_threads(p);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < nbc;
  const bool active = canvas && t < pp;
  float* ec = smem + (lc < cpb ? lc : 0) * (pp + 1);   // [pp] updates, flag
  float* flag = ec + pp;
  const int r = t / p, c = t - (t / p) * p;
  const long long plane = (long long)nbc * pp;
  const long long ci = (long long)k * pp + t;
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];
  const bool leader = canvas && t == 0;

  float u1 = 0.0f, u2 = 0.0f, v1 = 0.0f, v2 = 0.0f, gx = 0.0f, gy = 0.0f,
        den = 1.0f, lt = 0.0f, npx = 1.0f;
  float bv[kNd];
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
    for (int j = 0; j < kNd; ++j) bv[j] = a.b[j * plane + ci];
  } else {
#pragma unroll
    for (int j = 0; j < kNd; ++j) bv[j] = 0.0f;
  }
  const bool inb = r < bh && c < bw;
  unsigned long long inside = 0;
#pragma unroll
  for (int j = 0; j < kNd; ++j) {
    const int nr = r + off_dy(j), nc = c + off_dx(j);
    if (inb && nr >= 0 && nr < bh && nc >= 0 && nc < bw) inside |= 1ull << j;
  }
  const int n = __popcll(inside);
  const float ltg = lt * den;
  const float inf = __int_as_float(kInfKey);
  // err = +inf before the first step
  if (leader) flag[0] = inf > tol2 && max_iters > 0 ? 1.0f : 0.0f;
  int nit = 0;
  for (int it = 0; it < max_iters; ++it) {
    // publishes the run flags of the last step (and frees ec)
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    if (run) {
      const float dot = (gx * u1 + gy * u2) / den;
      int key[kNd];
#pragma unroll
      for (int j = 0; j < kNd; ++j)
        key[j] = (inside >> j) & 1ull ? order_key(-(bv[j] - dot)) : kInfKey;
      float med = 0.0f;
      const int win = select_entry(key, n, ltg, &med);
#pragma unroll
      for (int j = 0; j < kNd; ++j)
        if (win == j) med = -(bv[j] - dot);
      const float nv1 = u1 - (gx * med) / den;
      const float nv2 = u2 - (gy * med) / den;
      const float nu1 = u1 - tau * ((u1 - nv1) / theta);
      const float nu2 = u2 - tau * ((u2 - nv2) / theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      ec[t] = inb ? e1 * e1 + e2 * e2 : 0.0f;
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
  if (!active) return;
  a.u1o[ci] = u1;
  a.u2o[ci] = u2;
  a.v1o[ci] = v1;
  a.v2o[ci] = v2;
  if (t == 0) a.iters[k] = nit;
}

template <int P>
cudaError_t launch_cell_loop(const LoopArgs& a, int nbc, int p, int lt_cells,
                        int max_iters, cudaStream_t st) {
  const int cs = cell_canvas_threads(p);
  const int cpb = cs <= kThreads ? kThreads / cs : 1;
  const size_t smem = (size_t)cpb * (p * p + 1) * sizeof(float);
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  cell_loop_kernel<P><<<grid, cpb * cs, smem, st>>>(a, nbc, p, cpb, lt_cells,
                                                    max_iters);
  return cudaGetLastError();
}

}  // namespace thread_cell
#endif  // K8V_FORMER_ONLY

namespace former9 {

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

template <int P, int G, int T>
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

}  // namespace former9

namespace former19 {

// P > 0: the patch side at compile time; P = 0: any side with p^2 G <= T.
// G lanes a cell, at most T threads a block; WS: the weights in shared
// memory.
template <int P, int G, int T, bool WS>
__global__ void __launch_bounds__(T)
    nltvcsad_patch_kernel(NlArgs a, int nbc, int p_rt, int cpb, int lt_cells,
                          int max_iters) {
  constexpr int S = kNd / G;
  extern __shared__ float smem[];
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int cs = nl_canvas_threads(p, G);
  const int lc = threadIdx.x / cs;
  const int t = threadIdx.x - lc * cs;   // this thread in its canvas
  const int cell = t / G, g = t % G;
  const int k = blockIdx.x * cpb + lc;
  const bool canvas = lc < cpb && k < nbc;
  const bool active = canvas && cell < pp;   // whole groups
  float* sd = smem + (lc < cpb ? lc : 0) * nl_canvas_floats(p, WS);  // [48][pp]
  float* ub = sd + 2 * kNl * pp;                                     // [2][pp]
  float* ec = ub + 2 * pp;                                           // [pp]
  float* flag = ec + pp;                                             // [1]
  float* sw = flag + 1;                                              // [24][pp]
  const int r = cell / p, c = cell - (cell / p) * p;
  const long long plane = (long long)nbc * pp;
  const long long ci = (long long)k * pp + cell;
  const float* wg = a.wp + ci;   // read only where active and !WS
  const float theta = a.scal[0], tau = a.scal[1], tol2 = a.scal[2];
  const bool leader = canvas && t == 0;
  const unsigned gmask = group_mask<G>();

  float u1 = 0.0f, u2 = 0.0f, v1 = 0.0f, v2 = 0.0f, gx = 0.0f, gy = 0.0f,
        den = 1.0f, lt = 0.0f, wt = 1.0f, npx = 1.0f;
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
    wt = a.wt[ci];
    lt = lt_cells ? a.lt[ci] : a.lt[0];
#pragma unroll
    for (int s = 0; s < S; ++s) bv[s] = a.b[(g + G * s) * plane + ci];
    // this lane's share of the duals (and weights) in shared memory
    for (int q = g; q < 2 * kNl; q += G)
      sd[q * pp + cell] = a.duals_in ? a.duals_in[q * plane + ci] : 0.0f;
    if (WS)
      for (int j = g; j < kNl; j += G) sw[j * pp + cell] = a.wp[j * plane + ci];
    if (g == 0) {
      ub[cell] = u1;
      ub[pp + cell] = u2;
    }
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
    // publishes u_bar and the run flags of the last step
    if (!__syncthreads_or(leader && flag[0] != 0.0f)) break;
    const bool run = active && flag[0] != 0.0f;
    float nv1 = 0.0f, nv2 = 0.0f;
    if (run) {
      const float dot = (gx * u1 + gy * u2) / den;
      float av[S];
      int key[S];
      const int n = group_entries<G>(av, key, bv, r, c, bh, bw, dot, g);
      const float med = group_select<G>(av, key, n, ltg, g, gmask);
      nv1 = u1 - (gx * med) / den;
      nv2 = u2 - (gy * med) / den;
      // nltvl1_getD (nltv_model.cpp:211-273), this lane's dual steps; a
      // weight of 0 keeps its dual, so the step is skipped
      for (int q = g; q < 2 * kNl; q += G) {
        const int cc = q >= kNl, j = q - cc * kNl;
        const float w = WS ? sw[j * pp + cell] : wg[j * plane];
        if (!(w > 0.0f)) continue;
        const int rr = r + nl_dy(j), cx = c + nl_dx(j);
        const bool in = rr >= 0 && rr < p && cx >= 0 && cx < p;
        const float nb = in ? ub[cc * pp + rr * p + cx] : 0.0f;
        float* s = sd + q * pp + cell;
        *s = dual_step(*s, w, ub[cc * pp + cell], nb, wt, tau);
      }
    }
    __syncthreads();
    if (run) {
      float dv1 = 0.0f, dv2 = 0.0f;   // lane 0: component 1; lane 1 % G: 2
      if (g == 0)
        dv1 = nl_divergence<WS>(sd, sw, wg, plane, cell, r, c, p, pp);
      if (g == (G > 1 ? 1 : 0))
        dv2 = nl_divergence<WS>(sd + kNl * pp, sw, wg, plane, cell, r, c, p, pp);
      const float d1 = __shfl_sync(gmask, dv1, 0, G);
      const float d2 = __shfl_sync(gmask, dv2, G > 1 ? 1 : 0, G);
      const float nu1 = u1 - tau * (d1 + (u1 - nv1) / theta);
      const float nu2 = u2 - tau * (d2 + (u2 - nv2) / theta);
      const float e1 = nu1 - u1, e2 = nu2 - u2;
      if (g == 0) {
        ec[cell] = inb ? e1 * e1 + e2 * e2 : 0.0f;
        ub[cell] = 2.0f * nu1 - u1;
        ub[pp + cell] = 2.0f * nu2 - u2;
      }
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
  if (!active) return;
  // each lane writes the duals it stepped: final once its own last step is
  if (a.duals_out)
    for (int q = g; q < 2 * kNl; q += G) a.duals_out[q * plane + ci] = sd[q * pp + cell];
  if (g != 0) return;
  a.u1o[ci] = u1;
  a.u2o[ci] = u2;
  a.v1o[ci] = v1;
  a.v2o[ci] = v2;
  if (t == 0) a.iters[k] = nit;
}

template <int P, int G, int T, bool WS>
cudaError_t launch_nl(const NlArgs& a, int nbc, int p, int lt_cells,
                      int max_iters, cudaStream_t st) {
  const int cs = nl_canvas_threads(p, G);
  const int cpb = T / cs;
  const size_t smem = (size_t)cpb * nl_canvas_floats(p, WS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nltvcsad_patch_kernel<P, G, T, WS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((nbc + cpb - 1) / cpb);
  nltvcsad_patch_kernel<P, G, T, WS><<<grid, cpb * cs, smem, st>>>(
      a, nbc, p, cpb, lt_cells, max_iters);
  return cudaGetLastError();
}

}  // namespace former19

#ifndef K8V_FORMER_ONLY
namespace sel {

// One iteration's selection from the ranks, by the G lanes of the cell:
// i* = lo + #{i in [lo, hi): A[i] <= B[n + 1 - i]} A entries come among the
// first m = n + 2 of A u B (A first on equal keys); each lane tests the
// ranks it holds, 48 probes in all, so nothing is indexed dynamically.  The
// entry at position n + 1, the later of A[i* - 1] and B[n + 1 - i*], is
// returned on every lane of the group.  For finite dot, ltg and b (the
// caller checks them; see csad.cu).
template <int G>
__device__ __forceinline__ float ranked_select(const unsigned (&rk)[(kNd / G + 3) / 4],
                                               const float (&bv)[kNd / G], int n,
                                               float dot, float ltg, int g,
                                               unsigned gmask) {
  constexpr int S = kNd / G;
  const float inf = __int_as_float(kInfKey);
  const int m = n + 2, lo = max(m - (kNd + 1), 0), hi = min(m, kNd);
  const int sg = ltg > 0.0f ? 1 : -1;
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = rank_of(rk, s);
    const float a = i < n ? -(bv[s] - dot) : inf;
    cnt += i >= lo && i < hi && a <= merge_b(i, m, sg, ltg);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) cnt += __shfl_xor_sync(gmask, cnt, off, G);
  const int is = lo + cnt;
  float mine = 0.0f;
  bool has = false;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (rank_of(rk, s) == is - 1) {
      mine = -(bv[s] - dot);
      has = true;
    }
  const unsigned hb = __ballot_sync(gmask, has) & gmask;
  float a = __shfl_sync(gmask, mine, hb ? (__ffs(hb) - 1) % G : g, G);
  if (is - 1 >= n) a = inf;
  const float b = merge_b(is, m, sg, ltg);   // B[n + 1 - i*]
  return is == 0 ? b : (is == m ? a : (a > b ? a : b));
}

// The ranks in registers, each lane testing the ranks it holds
// (ranked_select); the counting path where an input is not finite.
template <int G>
struct RankedRegs {
  static constexpr int kSmem = 0;
  struct State {
    unsigned rk[(kNd / G + 3) / 4];
    bool ok;
    int n;
  };
  __device__ __forceinline__ static void setup(State& st, const float (&bv)[kNd / G],
                                               int r, int c, int ph, int pw,
                                               float ltg, int g, unsigned gmask,
                                               float* sb, int pp) {
    st.ok = rank_entries<G>(st.rk, bv, r, c, ph, pw, g, gmask) && isfinite(ltg);
    st.n = window_count(r, c, ph, pw);
  }
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    if (st.ok && isfinite(dot))
      return ranked_select<G>(st.rk, bv, st.n, dot, ltg, g, gmask);
    return counting_select<G>(bv, dot, ltg, r, c, ph, pw, g, gmask);
  }
};

// The zero rule: a found zero also takes the counting path (the rule the
// argument in csad.cu shows the library can do without).
template <class Base, int G, bool SMEM>
struct ZeroRule : Base {
  using typename Base::State;
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    if (st.ok && isfinite(dot)) {
      float x;
      if constexpr (SMEM)
        x = ranked_select_col<G>(sb, pp, st.n, dot, ltg, g, gmask);
      else
        x = ranked_select<G>(st.rk, bv, st.n, dot, ltg, g, gmask);
      if (x != 0.0f) return x;
    }
    return counting_select<G>(bv, dot, ltg, r, c, ph, pw, g, gmask);
  }
};
template <int G>
using RegsZero = ZeroRule<RankedRegs<G>, G, false>;
template <int G>
using SmemZero = ZeroRule<RankedSmem<G>, G, true>;

// The counting path out of line: its arrays do not raise the register
// count of the kernel's ranked path (bv reaches it through local memory).
template <int G>
__device__ __noinline__ float counting_select_ool(const float* bvp, float dot,
                                                  float ltg, int r, int c, int ph,
                                                  int pw, int g, unsigned gmask) {
  float bv[kNd / G];
#pragma unroll
  for (int s = 0; s < kNd / G; ++s) bv[s] = bvp[s];
  return counting_select<G>(bv, dot, ltg, r, c, ph, pw, g, gmask);
}

template <int G>
struct RankedOutOfLine : RankedRegs<G> {
  using typename RankedRegs<G>::State;
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    if (st.ok && isfinite(dot))
      return ranked_select<G>(st.rk, bv, st.n, dot, ltg, g, gmask);
    float copy[kNd / G];
#pragma unroll
    for (int s = 0; s < kNd / G; ++s) copy[s] = bv[s];
    return counting_select_ool<G>(copy, dot, ltg, r, c, ph, pw, g, gmask);
  }
};

// For the SASS counts only (not bit-equal in general): the ranked
// selections without their fallback ...
template <int G>
struct NoFallback : RankedRegs<G> {
  using typename RankedRegs<G>::State;
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    return ranked_select<G>(st.rk, bv, st.n, dot, ltg, g, gmask);
  }
};

template <int G>
struct NoFallbackSmem : RankedSmem<G> {
  using typename RankedSmem<G>::State;
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    return ranked_select_col<G>(sb, pp, st.n, dot, ltg, g, gmask);
  }
};

// ... and no selection at all: med = dot, the rest of a PD iteration.
template <int G>
struct Stub {
  static constexpr int kSmem = 0;
  struct State {};
  __device__ __forceinline__ static void setup(State&, const float (&)[kNd / G], int,
                                               int, int, int, float, int, unsigned,
                                               float*, int) {}
  __device__ __forceinline__ static float select(const State&, const float (&)[kNd / G],
                                                 float dot, float, int, int, int,
                                                 int, int, unsigned, const float*,
                                                 int) {
    return dot;
  }
};

}  // namespace sel
#endif  // K8V_FORMER_ONLY

#ifndef K8V_FORMER_ONLY
int launch_variant(int variant, const Args& a, int h, int w, int nbc, int p,
                   cudaStream_t st) {
  const long long cells = a.ph == nullptr ? (long long)h * w
                                          : (long long)p * p * nbc;
  if (cells <= 0) return 0;
  const bool glob = a.ph == nullptr;
  if (variant == 0) {
    if (glob)
      insertion::ins_global_kernel<<<blocks_for(cells), kThreads, 0, st>>>(a, h, w);
    else
      insertion::ins_patch_kernel<<<blocks_for(cells), kThreads, 0, st>>>(a, nbc, p);
  } else if (variant == 1) {
    if (glob)
      thread_cell::cell_global_kernel<<<blocks_for(cells), kThreads, 0, st>>>(a, h, w);
    else
      thread_cell::cell_patch_kernel<<<blocks_for(cells), kThreads, 0, st>>>(a, nbc, p);
  } else if (variant == 8) {
    if (glob)
      csad_global_kernel<8><<<blocks_for(cells * 8), kThreads, 0, st>>>(a, h, w);
    else
      csad_patch_kernel<8><<<blocks_for(cells * 8), kThreads, 0, st>>>(a, nbc, p);
  } else if (variant == 16) {
    if (glob)
      csad_global_kernel<16><<<blocks_for(cells * 16), kThreads, 0, st>>>(a, h, w);
    else
      csad_patch_kernel<16><<<blocks_for(cells * 16), kThreads, 0, st>>>(a, nbc, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif  // K8V_FORMER_ONLY

}  // namespace

#ifndef K8V_FORMER_ONLY
// the arguments of faldoi_csad_vstep_global / _patch, after the variant
extern "C" int faldoi_k8v_global(int variant, const float* u1, const float* u2,
                                 const float* b, const float* i1wx,
                                 const float* i1wy, const float* denom,
                                 const float* lt, float lt_val, int lt_cells,
                                 float* v1, float* v2, int h, int w,
                                 void* stream) {
  Args a{u1, u2, b, i1wx, i1wy, denom, lt, nullptr, nullptr, v1, v2, lt_val,
         lt_cells};
  return launch_variant(variant, a, h, w, 0, 0, (cudaStream_t)stream);
}

extern "C" int faldoi_k8v_patch(int variant, const float* u1, const float* u2,
                                const float* b, const float* i1wx,
                                const float* i1wy, const float* denom,
                                const float* lt, float lt_val, int lt_cells,
                                const int* ph, const int* pw, float* v1,
                                float* v2, int nb_canvas, int p, void* stream) {
  Args a{u1, u2, b, i1wx, i1wy, denom, lt, ph, pw, v1, v2, lt_val, lt_cells};
  return launch_variant(variant, a, 0, 0, nb_canvas, p, (cudaStream_t)stream);
}
#endif  // K8V_FORMER_ONLY

// faldoi_csad_patch_loop's arguments, after the variant (P 11; P 3 for
// variant 0); built with K8V_FORMER_ONLY, variant 0 alone
extern "C" int faldoi_k8v_loop(
    int variant, const float* u1, const float* u2, const float* v1,
    const float* v2, const float* b, const float* i1wx, const float* i1wy,
    const float* denom, const float* lt, const float* scal, const int* ph,
    const int* pw, float* u1o, float* u2o, float* v1o, float* v2o, int* iters,
    int nbc, int p, int lt_cells, int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  LoopArgs a{u1, u2, v1, v2, b, i1wx, i1wy, denom, lt, scal, ph, pw,
             u1o, u2o, v1o, v2o, iters};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0 && p == 3)
    return (int)former9::launch_loop<3, 4, 512>(a, nbc, p, lt_cells, max_iters, st);
  if (p != 11) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return (int)former9::launch_loop<11, 4, 512>(a, nbc, p, lt_cells, max_iters, st);
#ifndef K8V_FORMER_ONLY
    case 1:
      return (int)thread_cell::launch_cell_loop<11>(a, nbc, p, lt_cells, max_iters, st);
    case 2:
      return (int)launch_loop<11, 2, 256, 1, sel::RegsZero<2>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 4:
      return (int)launch_loop<11, 4, 1024, 1, sel::RegsZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 8:
      return (int)launch_loop<11, 8, 1024, 1, sel::RegsZero<8>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 10:
      return (int)launch_loop<11, 4, 512, 1, sel::RegsZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 11:
      return (int)launch_loop<11, 4, 512, 2, sel::RegsZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 12:
      return (int)launch_loop<11, 4, 512, 1, sel::SmemZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 13:
      return (int)launch_loop<11, 4, 512, 2, sel::SmemZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 14:
      return (int)launch_loop<11, 1, 128, 1, sel::RegsZero<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 15:
      return (int)launch_loop<11, 1, 512, 1, sel::RegsZero<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 16:
      return (int)launch_loop<11, 4, 512, 1, sel::RankedRegs<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 17:
      return (int)launch_loop<11, 4, 512, 2, sel::RankedRegs<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 18:
      return (int)launch_loop<11, 1, 128, 1, sel::RankedRegs<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 19:
      return (int)launch_loop<11, 4, 512, 2, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 20:
      return (int)launch_loop<11, 4, 512, 1, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 21:
      return (int)launch_loop<11, 4, 512, 2, RankedSmem<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 22:
      return (int)launch_loop<11, 4, 512, 3, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 30:   // SASS only
      return (int)launch_loop<11, 4, 512, 1, sel::NoFallback<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 32:   // SASS only
      return (int)launch_loop<11, 4, 512, 2, sel::NoFallbackSmem<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 31:   // SASS only
      return (int)launch_loop<11, 4, 512, 1, sel::Stub<4>>(
          a, nbc, p, lt_cells, max_iters, st);
#endif  // K8V_FORMER_ONLY
  }
  return (int)cudaErrorInvalidValue;
}

// faldoi_nltvcsad_patch_loop's arguments, after the variant (P 11; P 3 for
// variant 0); built with K8V_FORMER_ONLY, variant 0 alone
extern "C" int faldoi_k8v_nl(
    int variant, const float* u1, const float* u2, const float* v1,
    const float* v2, const float* b, const float* i1wx, const float* i1wy,
    const float* denom, const float* wp, const float* wt, const float* lt,
    const float* scal, const int* ph, const int* pw, const float* duals_in,
    float* u1o, float* u2o, float* v1o, float* v2o, int* iters,
    float* duals_out, int nbc, int p, int lt_cells, int max_iters,
    void* stream) {
  if (nbc <= 0) return 0;
  NlArgs a{u1, u2, v1, v2, b, i1wx, i1wy, denom, wp, wt, lt, scal, ph, pw,
           duals_in, u1o, u2o, v1o, v2o, iters, duals_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0 && p == 3)
    return (int)former19::launch_nl<3, 4, 512, true>(a, nbc, p, lt_cells, max_iters, st);
  if (p != 11) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      return (int)former19::launch_nl<11, 4, 512, true>(a, nbc, p, lt_cells,
                                                        max_iters, st);
#ifndef K8V_FORMER_ONLY
    case 2:
      return (int)launch_nl<11, 2, 256, true, 1, sel::RegsZero<2>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 10:
      return (int)launch_nl<11, 4, 512, true, 1, sel::RegsZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 11:
      return (int)launch_nl<11, 4, 512, true, 2, sel::RegsZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 12:
      return (int)launch_nl<11, 4, 512, true, 1, sel::SmemZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 13:
      return (int)launch_nl<11, 4, 512, true, 2, sel::SmemZero<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 14:
      return (int)launch_nl<11, 1, 128, true, 1, sel::RegsZero<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 15:
      return (int)launch_nl<11, 1, 512, true, 1, sel::RegsZero<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 16:
      return (int)launch_nl<11, 4, 512, true, 1, sel::RankedRegs<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 17:
      return (int)launch_nl<11, 4, 512, true, 2, sel::RankedRegs<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 18:
      return (int)launch_nl<11, 1, 128, true, 1, sel::RankedRegs<1>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 19:
      return (int)launch_nl<11, 4, 512, true, 2, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 20:
      return (int)launch_nl<11, 4, 512, true, 1, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 21:
      return (int)launch_nl<11, 4, 512, true, 2, RankedSmem<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 22:
      return (int)launch_nl<11, 4, 512, true, 3, sel::RankedOutOfLine<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 30:   // SASS only
      return (int)launch_nl<11, 4, 512, true, 1, sel::NoFallback<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 32:   // SASS only
      return (int)launch_nl<11, 4, 512, true, 2, sel::NoFallbackSmem<4>>(
          a, nbc, p, lt_cells, max_iters, st);
    case 31:   // SASS only
      return (int)launch_nl<11, 4, 512, true, 1, sel::Stub<4>>(
          a, nbc, p, lt_cells, max_iters, st);
#endif  // K8V_FORMER_ONLY
  }
  return (int)cudaErrorInvalidValue;
}
