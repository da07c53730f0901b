// K8: the CSAD median-of-breakpoints prox (the v-step of methods 4-7).
//
// Replaces the XLA-lowered per-pixel sort of the JAX package:
//   global form: faldoi_tpu/core/global_step_csad.py::_csad_vstep (:68), the
//      v-step of the TV-CSAD and NLTV-CSAD global loops, on (h, w) planes;
//   patch form:  faldoi_tpu/core/functionals.py::_csad_vstep (:403), the
//      v-step of the CSAD patch solvers, on B canvases of P x P.
//
// Per cell, with n the number of the 48 neighbours (a 7x7 window without its
// centre, dy outer and dx inner) that lie inside the image (global) or inside
// the canvas's valid box [0, ph) x [0, pw) (patch; n = 0 outside the box):
//   dot   = (i1wx u1 + i1wy u2) / denom
//   A_j   = -(b_j - dot) for the n neighbours inside, +inf for the others
//   B_j   = (n - 2j) (l_t denom) for j = 0..n, +inf for j = n+1..48
//   med   = the entry of rank n + 1 (0-based) of the 97 entries in ascending
//           order, NaN after +inf (jnp.sort's and torch.sort's order); the
//           reference's it/2 + 1, one past the true median
//   v     = (u1 - (i1wx med) / denom, u2 - (i1wy med) / denom)
// The selected value is one of the computed entries, so with the twin's
// operation order and --fmad=false the kernel is bit-equal to the twin
// (faldoi_tpu_torch/ops/csad.py::csad_vstep_plain); equal entries may be
// taken in another order, which changes nothing but, at most, the sign of a
// zero.  No sort of the 97 entries is done: a thread a cell inserts its n
// values A_j in order into a local list (the masked ones are +inf and need
// no place), builds the B list in order (it is monotone in j when l_t denom
// is finite, and is sorted by insertion otherwise), and walks the two lists
// as a merge to the rank n + 1.
//
// Layout: b is (48, N) with N = h*w (global) or B*P*P (patch, the planes in
// (48, B, P, P)), so both forms read the b planes of consecutive cells at
// consecutive addresses; the other planes are (N,).  l_t is a value, one
// float on the device, or one float a cell (the weighted methods' window).

#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;                       // DT_R
constexpr int kSide = 2 * kR + 1;
constexpr int kNd = kSide * kSide - 1;      // 48 neighbours
constexpr int kThreads = 128;

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

// The v-step of cell `cell` at (r, c) of a box of ph x pw; b planes `nb`
// apart.  Shared by both forms.
__device__ __forceinline__ void csad_cell(const Args& a, long long cell,
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
csad_global_kernel(Args a, int h, int w) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = (long long)h * w;
  if (cell >= n) return;
  csad_cell(a, cell, n, (int)(cell / w), (int)(cell % w), h, w);
}

__global__ void __launch_bounds__(kThreads)
csad_patch_kernel(Args a, int nb_canvas, int p) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pp = (long long)p * p;
  const long long n = pp * nb_canvas;
  if (cell >= n) return;
  const int canvas = (int)(cell / pp), rc = (int)(cell % pp);
  csad_cell(a, cell, n, rc / p, rc % p, a.ph[canvas], a.pw[canvas]);
}

int blocks_for(long long cells) {
  return (int)((cells + kThreads - 1) / kThreads);
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
  csad_global_kernel<<<blocks_for((long long)h * w), kThreads, 0,
                       (cudaStream_t)stream>>>(a, h, w);
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
  csad_patch_kernel<<<blocks_for((long long)p * p * nb_canvas), kThreads, 0,
                      (cudaStream_t)stream>>>(a, nb_canvas, p);
  return (int)cudaGetLastError();
}
