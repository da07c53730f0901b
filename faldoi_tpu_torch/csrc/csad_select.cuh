// The CSAD selection shared by K8 and its loops (csad.cu), the CSAD patch
// loop K16 (csad_loops.cu) and the whole-image CSAD loops K14 and K15
// (csad_global.cu): the median-of-breakpoints prox of one cell by a group
// of G lanes, counting positions, nothing sorted, and the ranked forms of
// the loops.  The rule and its bit-equality with the twins' sort are set
// out at the top of csad.cu.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;                       // DT_R
constexpr int kSide = 2 * kR + 1;
constexpr int kNd = kSide * kSide - 1;      // 48 neighbours
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

// n: the neighbours of (r, c) inside the box ph x pw, 0 outside it.
__device__ __forceinline__ int window_count(int r, int c, int ph, int pw) {
  const int rows = min(r + kR, ph - 1) - max(r - kR, 0) + 1;
  const int cols = min(c + kR, pw - 1) - max(c - kR, 0) + 1;
  return r < ph && c < pw ? rows * cols - 1 : 0;
}

// The ranked selection of the loop kernels (the K8 loop, K16), whose b, n
// and l_t denom stay fixed over a call while dot moves; the argument is at
// the top of csad.cu.  rank_entries, once a call: the rank of each of this
// lane's b_(g + G s) among the cell's inside b in descending order (the
// ascending order of order_key(-b), ties by j: K8's counting among the 48
// entries, the masked ones keyed +inf, so the n inside ones rank 0..n-1),
// a byte each in rk; returns whether every inside b of the cell is finite.
template <int G>
__device__ __forceinline__ bool rank_entries(unsigned (&rk)[(kNd / G + 3) / 4],
                                             const float (&bv)[kNd / G], int r,
                                             int c, int ph, int pw, int g,
                                             unsigned gmask) {
  constexpr int S = kNd / G;
  const bool in = r < ph && c < pw;
  int key[S], pos[S];
  bool fin = true;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = g + G * s;
    const int nr = r + off_dy(j), nc = c + off_dx(j);
    const bool inside = in && nr >= 0 && nr < ph && nc >= 0 && nc < pw;
    key[s] = inside ? order_key(-bv[s]) : kInfKey;
    fin = fin && (!inside || isfinite(bv[s]));
    pos[s] = 0;
  }
#pragma unroll
  for (int m = 0; m < kNd; ++m) {
    const int km = __shfl_sync(gmask, key[m / G], m % G, G);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = g + G * s;   // b_m before b_k
      pos[s] += m < k ? km <= key[s] : (m > k && km < key[s]);
    }
  }
#pragma unroll
  for (int w = 0; w < (S + 3) / 4; ++w) rk[w] = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) rk[s / 4] |= (unsigned)pos[s] << (8 * (s % 4));
  return (__ballot_sync(gmask, !fin) & gmask) == 0u;
}

__device__ __forceinline__ int rank_of(const unsigned* rk, int s) {
  return (rk[s / 4] >> (8 * (s % 4))) & 0xff;
}

// Entry i of A in its sorted order (A[i] = -(b - dot) of the b of rank i,
// +inf for i >= n) and the B entry that the merge path sets against it,
// B[n + 1 - i] in B's stable order: (n + 2 - 2i) ltg for ltg > 0 (B_j, j =
// i - 1), (2i - n - 2) ltg else (j = n + 1 - i), +inf for i = 0; sg = +-1.
__device__ __forceinline__ float merge_b(int i, int m, int sg, float ltg) {
  return i >= 1 ? (float)(sg * (m - 2 * i)) * ltg : __int_as_float(kInfKey);
}

// One iteration's selection from the cell's ranked b, a column sb[i * pp],
// i < n, in shared memory (a [48][pp] array) or device memory (the
// whole-image loops' buffer): a merge-path binary search of six probes by
// the group's first lane (the others wait) for i*, the number of A entries
// among the first m = n + 2 of A u B (A first on equal keys), the first i
// in [lo, hi) with A[i] > B[n + 1 - i]; the entry at position n + 1, the
// later of A[i* - 1] and B[n + 1 - i*], is returned on every lane of the
// group.  For finite dot, ltg and b (the caller checks them; see csad.cu).
template <int G, typename I>
__device__ __forceinline__ float ranked_select_col(const float* sb, I pp, int n,
                                                   float dot, float ltg, int g,
                                                   unsigned gmask) {
  const float inf = __int_as_float(kInfKey);
  const int m = n + 2;
  const int sg = ltg > 0.0f ? 1 : -1;
  float x = 0.0f;
  if (g == 0) {
    int lo = max(m - (kNd + 1), 0), len = min(m, kNd) - lo;
#pragma unroll
    for (int step = 0; step < 6; ++step) {   // len <= 48 < 2^6
      const int half = len >> 1, mid = lo + half;
      const float a = mid < n ? -(sb[mid * pp] - dot) : inf;
      const bool q = a <= merge_b(mid, m, sg, ltg);
      if (len > 0) {
        lo = q ? mid + 1 : lo;
        len = q ? len - half - 1 : half;
      }
    }
    const float a = lo >= 1 && lo - 1 < n ? -(sb[(lo - 1) * pp] - dot) : inf;
    const float b = merge_b(lo, m, sg, ltg);
    x = lo == 0 ? b : (lo == m ? a : (a > b ? a : b));
  }
  return __shfl_sync(gmask, x, 0, G);
}

// The counting path (group_entries + group_select) from this lane's b, the
// ranked selections' fallback.
template <int G>
__device__ __forceinline__ float counting_select(const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r,
                                                 int c, int ph, int pw, int g,
                                                 unsigned gmask) {
  float av[kNd / G];
  int key[kNd / G];
  const int n = group_entries<G>(av, key, bv, r, c, ph, pw, dot, g);
  return group_select<G>(av, key, n, ltg, g, gmask);
}

// The selections as the loop kernels call them: setup once a call
// (State: what it found), select every PD iteration.  RankedSmem, the form
// at P 11 and 3: the ranks from rank_entries, the ranked b in shared
// memory, a column of 48 floats a cell (sb, pp apart), ranked_select_col
// every iteration, the counting path where dot, ltg or an inside b is not
// finite.  Counting, the form of the loops' runtime path (any other P <=
// 32, which no solver takes, and where a canvas's ranked b could fill the
// shared memory): the counting path every iteration.  csrc/variants/
// k8_variants.cu times these and other forms of the same face.
template <int G>
struct RankedSmem {
  static constexpr int kSmem = kNd;   // shared floats a cell
  struct State {
    bool ok;   // every inside b and ltg finite
    int n;
  };
  __device__ __forceinline__ static void setup(State& st, const float (&bv)[kNd / G],
                                               int r, int c, int ph, int pw,
                                               float ltg, int g, unsigned gmask,
                                               float* sb, int pp) {
    unsigned rk[(kNd / G + 3) / 4];
    st.ok = rank_entries<G>(rk, bv, r, c, ph, pw, g, gmask) && isfinite(ltg);
    st.n = window_count(r, c, ph, pw);
#pragma unroll
    for (int s = 0; s < kNd / G; ++s) {
      const int i = rank_of(rk, s);
      if (i < st.n) sb[i * pp] = bv[s];
    }
    __syncwarp(gmask);
  }
  __device__ __forceinline__ static float select(const State& st,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float* sb,
                                                 int pp) {
    if (st.ok && isfinite(dot))
      return ranked_select_col<G>(sb, pp, st.n, dot, ltg, g, gmask);
    return counting_select<G>(bv, dot, ltg, r, c, ph, pw, g, gmask);
  }
};

template <int G>
struct Counting {
  static constexpr int kSmem = 0;
  struct State {};
  __device__ __forceinline__ static void setup(State&, const float (&)[kNd / G], int,
                                               int, int, int, float, int, unsigned,
                                               float*, int) {}
  __device__ __forceinline__ static float select(const State&,
                                                 const float (&bv)[kNd / G],
                                                 float dot, float ltg, int r, int c,
                                                 int ph, int pw, int g,
                                                 unsigned gmask, const float*, int) {
    return counting_select<G>(bv, dot, ltg, r, c, ph, pw, g, gmask);
  }
};

// ---------------------------------------------------------------------------
// The ranked selection of the whole-image loops (K14 and K15,
// csad_global.cu), whose b, n and l_t denom also stay fixed over a warp's
// PD loop while dot moves.  Once a warp, csad_rank_image_kernel ranks each
// pixel's inside b (rank_entries, four lanes a pixel) and writes them in
// rank order to a column of 48 floats a pixel in device memory, and ok, a
// byte a pixel: every inside b and l_t denom finite.  Every PD iteration
// image_select takes the merge-path search over the column
// (ranked_select_col) where ok is set and dot finite, else the counting
// path on the pixel's 48 b planes, in line or out of line (its arrays then
// do not raise the register count of a kernel with a register cap).  Only the
// ranks i < n of a column are written and read.  A layout puts rank i of
// pixel `cell`'s column at col(cell) + i * stride.

struct PlaneMajor {   // (48, h, w)
  __host__ __device__ static long long col(long long cell, long long) { return cell; }
  __host__ __device__ static long long stride(long long hw) { return hw; }
};

constexpr int kRankThreads = 128;   // 32 pixels a block

// run: null, or a flag whose 0 skips the launch (K14's run flag)
template <class L>
__global__ void __launch_bounds__(kRankThreads)
    csad_rank_image_kernel(const float* __restrict__ b,
                           const float* __restrict__ denom, float lt,
                           float* __restrict__ rb, unsigned char* __restrict__ ok,
                           const int* __restrict__ run, int h, int w) {
  constexpr int G = 4, S = kNd / G;
  if (run != nullptr && run[0] == 0) return;
  const long long hw = (long long)h * w;
  const long long cell = ((long long)blockIdx.x * kRankThreads + threadIdx.x) / G;
  const int g = threadIdx.x % G;
  if (cell >= hw) return;   // the whole group
  const int r = (int)(cell / w), c = (int)(cell % w);
  float bv[S];
#pragma unroll
  for (int s = 0; s < S; ++s) bv[s] = b[(g + G * s) * hw + cell];
  unsigned rk[(S + 3) / 4];
  const bool fin = rank_entries<G>(rk, bv, r, c, h, w, g, group_mask<G>());
  const int n = window_count(r, c, h, w);
  float* col = rb + L::col(cell, hw);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = rank_of(rk, s);
    if (i < n) col[i * L::stride(hw)] = bv[s];
  }
  if (g == 0) ok[cell] = fin && isfinite(lt * denom[cell]);
}

template <class L>
cudaError_t launch_rank_image(const float* b, const float* denom, float lt, float* rb,
                              unsigned char* ok, const int* run, int h, int w,
                              cudaStream_t st) {
  const long long threads = (long long)h * w * 4;
  csad_rank_image_kernel<L><<<(unsigned)((threads + kRankThreads - 1) / kRankThreads),
                              kRankThreads, 0, st>>>(b, denom, lt, rb, ok, run, h, w);
  return cudaGetLastError();
}

// The counting path of pixel `cell` from its 48 b planes (b: (48, h, w)).
template <int G>
__device__ __forceinline__ float image_counting(const float* b, long long hw,
                                               long long cell, float dot, float ltg,
                                               int r, int c, int h, int w, int g,
                                               unsigned gmask) {
  float bv[kNd / G];
#pragma unroll
  for (int s = 0; s < kNd / G; ++s) bv[s] = b[(g + G * s) * hw + cell];
  return counting_select<G>(bv, dot, ltg, r, c, h, w, g, gmask);
}

template <int G>
__device__ __noinline__ float image_counting_ool(const float* b, long long hw,
                                                 long long cell, float dot,
                                                 float ltg, int r, int c, int h,
                                                 int w, int g, unsigned gmask) {
  return image_counting<G>(b, hw, cell, dot, ltg, r, c, h, w, g, gmask);
}

// Where image_select's counting path goes: in line, out of line, or
// nowhere (kNoFallback, for SASS counts of the ranked path alone: not
// exact where a pixel would need it).
constexpr int kInLine = 0, kOutOfLine = 1, kNoFallback = 2;

// One PD iteration's selection of pixel `cell` at (r, c) by its group of G
// lanes: med on every lane of the group.
template <int G, class L, int FB>
__device__ __forceinline__ float image_select(const float* rb, const unsigned char* ok,
                                             const float* b, long long hw,
                                             long long cell, int r, int c, int h,
                                             int w, float dot, float ltg, int g,
                                             unsigned gmask) {
  if (FB == kNoFallback || (ok[cell] && isfinite(dot)))
    return ranked_select_col<G>(rb + L::col(cell, hw), L::stride(hw),
                                window_count(r, c, h, w), dot, ltg, g, gmask);
  if constexpr (FB == kOutOfLine)
    return image_counting_ool<G>(b, hw, cell, dot, ltg, r, c, h, w, g, gmask);
  else
    return image_counting<G>(b, hw, cell, dot, ltg, r, c, h, w, g, gmask);
}

}  // namespace
