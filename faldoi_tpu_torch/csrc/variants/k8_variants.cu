// K8's design variants, timed against each other and against the library's
// kernels (csad.cu, included below) by faldoi_tpu_torch/cli/k8_variants.py,
// which builds this file itself (kernels/build.py does not):
//   v-step variant 0: the former kernel, one thread a cell: the n values
//       insertion-sorted in local memory, the second list built in order, a
//       merge walk to the rank n + 1;
//   v-step variant 1: one thread a cell, selection by counting with the
//       1128 pair compares of the 48 keys unrolled in registers;
//   v-step variants 8, 16: csad.cu's kernels with 8 or 16 lanes a cell (the
//       library's have 4);
//   loop variant 1: the K8 loop with one thread a cell (variant 1's
//       selection, a cell's 48 b values in registers), 128-thread blocks;
//   loop variants 2, 4, 8: csad.cu's loop with 2 lanes a cell in 256-thread
//       blocks, 4 in 1024-thread blocks (two canvases) and 8 in 1024-thread
//       blocks (the library's: 4 lanes, a canvas a 512-thread block).
// Every variant is held bit for bit to its twin by the script.

#include "../csad.cu"

namespace {
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

}  // namespace

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

// faldoi_csad_patch_loop's arguments, after the variant (P 11 only)
extern "C" int faldoi_k8v_loop(
    int variant, const float* u1, const float* u2, const float* v1,
    const float* v2, const float* b, const float* i1wx, const float* i1wy,
    const float* denom, const float* lt, const float* scal, const int* ph,
    const int* pw, float* u1o, float* u2o, float* v1o, float* v2o, int* iters,
    int nbc, int p, int lt_cells, int max_iters, void* stream) {
  if (nbc <= 0) return 0;
  if (p != 11) return (int)cudaErrorInvalidValue;
  LoopArgs a{u1, u2, v1, v2, b, i1wx, i1wy, denom, lt, scal, ph, pw,
             u1o, u2o, v1o, v2o, iters};
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1)
    return (int)thread_cell::launch_cell_loop<11>(a, nbc, p, lt_cells, max_iters, st);
  if (variant == 2)
    return (int)launch_loop<11, 2, 256>(a, nbc, p, lt_cells, max_iters, st);
  if (variant == 4)
    return (int)launch_loop<11, 4, 1024>(a, nbc, p, lt_cells, max_iters, st);
  if (variant == 8)
    return (int)launch_loop<11, 8, 1024>(a, nbc, p, lt_cells, max_iters, st);
  return (int)cudaErrorInvalidValue;
}
