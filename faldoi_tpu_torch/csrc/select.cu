// K2: the candidate selection of the growing's sweep, in two entry points.
//
// Replaces the XLA-lowered selection of faldoi_tpu/core/local_step.py:302-405
// (_sweep_body: the eligibility, lax.top_k at :333, the delta band and the
// queue-adaptive rank floor, n_acc), which the port ran as a stable
// torch.sort of every lane's h*w keys (faldoi_tpu_torch/ops/select.py keeps
// that order as the plain twin).
//
// faldoi_select, per swept lane of L' (one grid row each):
//   * the key of pixel j: cand_e while j is unfixed, +inf otherwise; under
//     relax, cand_e (+ RECLAIM_BIAS where fixed) while cand_e < ene * margin
//     - 1e-6, else +inf; +inf outside ``owned``;
//   * the cap = min(bsz, h*w) smallest keys in lax.top_k(-key)'s order: the
//     ascending IEEE total order of the key's bits (-NaN < -inf < ... < -0 <
//     +0 < ... < +inf < +NaN), ties to the lower flat index.  A key is mapped
//     to an unsigned 32-bit word that orders so, and the composite
//     (word << ib) | j (ib index bits) is unique, so the cap-th smallest
//     composite is one number;
//   * it is found by a radix select: pass 0 writes the words and histograms
//     the composite's top 11 bits; each later pass histograms the next 11
//     bits of the composites that share the bits fixed so far.  The last
//     block of a pass (a ticket counter) picks the bucket that holds the
//     cap-th composite and stops the search once that bucket is wanted
//     whole.  Then every composite at or below the threshold is taken (a
//     warp-aggregated atomic slot: exactly cap of them), and each taken one
//     is ranked by counting the taken ones below it, so the output is in
//     order with no sort;
//   * queue, the count of finite keys.
// The launches: pass 0, up to 5 more passes (they return at once when the
// threshold is known), the take, the rank.  Bound by device-memory bytes:
// the key planes once, the words a few times (in L2 at 436x1024), and the
// rank's cap^2 compares of a lane (~0.14 G at cap 8192, L' 2).
//
// faldoi_accept, one block for all the lanes (any number of them, in
// chunks of 64): each lane's band e_min +
// max(delta, delta_rel * e_min) (e_min the lane's first key, or band_min),
// its floor min(floor, max(1, queue // fscale)) with the staged divisor,
// valid = finite & (key <= band | rank < floor) (or the given mask: the
// ordering modes build theirs with plain ops), and the accepted (lane,
// rank) pairs lane-major in rank order followed by the rest, with each
// lane's count and the total.  All of it stays on the card.
//
// Every float operation is the twin's, rounded once (the library is built
// with --fmad=false), so both entry points equal their twins bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kDigit = 11;
constexpr int kBins = 1 << kDigit;
constexpr int kMaxPasses = 6;    // 32 + 31 bits in digits of 11
constexpr int kRankThreads = 128;
constexpr int kAcceptThreads = 1024;
constexpr int kLaneChunk = 64;

typedef unsigned long long u64;

struct LaneState {
  u64 prefix;                     // the composite bits fixed so far
  u64 thresh;                     // the cap-th smallest composite, once done
  unsigned need;                  // rank still sought within the prefix
  unsigned done;
  unsigned taken;                 // the take's slot counter
  unsigned tickets[kMaxPasses];   // blocks finished, a pass
  unsigned pad;
  u64 queue;
};
// ops/select.py allocates the work buffer as WORK_BYTES_PER_LANE a lane
static_assert(sizeof(LaneState) == 64, "LaneState is 64 bytes");

struct Keys {
  const float* cand_e;
  const unsigned char* fixed;
  const float* ene;               // relax only
  const unsigned char* owned;     // (n,) or null
  const long long* lanes;         // (L',) or null: every lane in order
  long long stride;               // elements from one lane to the next
  int relax;
  float margin, bias;
};

__device__ __forceinline__ unsigned order_word(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float word_value(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float key_of(const Keys& k, int lane, long long j) {
  const long long ln = k.lanes != nullptr ? k.lanes[lane] : lane;
  const long long at = ln * k.stride + j;
  const float c = k.cand_e[at];
  const bool fx = k.fixed[at] != 0;
  float key;
  if (k.relax) {
    const float lim = __fsub_rn(__fmul_rn(k.ene[at], k.margin), 1e-6f);
    key = c < lim ? (fx ? __fadd_rn(c, k.bias) : c) : __int_as_float(0x7f800000);
  } else {
    key = fx ? __int_as_float(0x7f800000) : c;
  }
  if (k.owned != nullptr && k.owned[j] == 0) key = __int_as_float(0x7f800000);
  return key;
}

// The last block of a pass picks the bucket that holds the sought rank
// ``need`` (1-based among the composites under the prefix).  The other
// blocks' histogram adds are read from L2 (__ldcg), past this SM's L1.
__device__ void pick(LaneState* st, const unsigned* hist, int lo,
                     unsigned need) {
  __shared__ unsigned part[kThreads];
  constexpr int per = kBins / kThreads;
  unsigned c[per];
  unsigned s = 0;
  for (int i = 0; i < per; ++i) {
    c[i] = __ldcg(hist + threadIdx.x * per + i);
    s += c[i];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const unsigned v = part[t];
      part[t] = run;
      run += v;
    }
  }
  __syncthreads();
  unsigned run = part[threadIdx.x];
  for (int i = 0; i < per; ++i) {
    if (run < need && need <= run + c[i]) {
      const u64 prefix = st->prefix | ((u64)(threadIdx.x * per + i) << lo);
      const unsigned left = need - run;
      st->prefix = prefix;
      st->need = left;
      if (c[i] == left || lo == 0) {
        st->thresh = lo == 0 ? prefix : (prefix | ((1ull << lo) - 1));
        st->done = 1;
      }
    }
    run += c[i];
  }
}

// Pass 0: the words, the finite count and the top digit's histogram.
__global__ void __launch_bounds__(kThreads)
    select_first(Keys k, unsigned* words, unsigned* hist, LaneState* state,
                 long long n, int ib, int lo, unsigned cap) {
  __shared__ unsigned h[kBins];
  __shared__ unsigned finite;
  __shared__ bool last;
  const int lane = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  if (threadIdx.x == 0) finite = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kThreads * kPerThread;
  unsigned fin = 0;
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + (long long)i * kThreads + threadIdx.x;
    if (j < n) {
      const float key = key_of(k, lane, j);
      const unsigned o = order_word(key);
      words[(long long)lane * n + j] = o;
      fin += isfinite(key) ? 1u : 0u;
      const u64 comp = ((u64)o << ib) | (u64)j;
      atomicAdd(&h[(unsigned)(comp >> lo) & (kBins - 1)], 1u);
    }
  }
  atomicAdd(&finite, fin);
  __syncthreads();
  unsigned* gh = hist + (long long)lane * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (h[i] != 0) atomicAdd(&gh[i], h[i]);
  LaneState* st = state + lane;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&st->queue, (u64)finite);
    last = atomicAdd(&st->tickets[0], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    pick(st, gh, lo, cap);
  }
}

// Pass p > 0: the next digit's histogram among the composites under the
// prefix.
__global__ void __launch_bounds__(kThreads)
    select_pass(const unsigned* words, unsigned* hist, LaneState* state,
                long long n, int ib, int lo, int bits, int pass) {
  __shared__ unsigned h[kBins];
  __shared__ bool last;
  const int lane = blockIdx.y;
  LaneState* st = state + lane;
  if (st->done) return;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int hi = lo + bits;
  const u64 want = st->prefix >> hi;
  const unsigned mask = (1u << bits) - 1u;
  const long long base = (long long)blockIdx.x * kThreads * kPerThread;
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + (long long)i * kThreads + threadIdx.x;
    if (j < n) {
      const u64 comp = ((u64)words[(long long)lane * n + j] << ib) | (u64)j;
      if ((comp >> hi) == want) atomicAdd(&h[(unsigned)(comp >> lo) & mask], 1u);
    }
  }
  __syncthreads();
  unsigned* gh = hist + ((long long)pass * gridDim.y + lane) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (h[i] != 0) atomicAdd(&gh[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&st->tickets[pass], 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    pick(st, gh, lo, st->need);
  }
}

// Every composite at or below the threshold: cap of them a lane.
__global__ void __launch_bounds__(kThreads)
    select_take(const unsigned* words, u64* cand, LaneState* state,
                long long n, int ib, int cap) {
  const int lane = blockIdx.y;
  LaneState* st = state + lane;
  const u64 thresh = st->thresh;
  const long long base = (long long)blockIdx.x * kThreads * kPerThread;
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  for (int i = 0; i < kPerThread; ++i) {
    const long long j = base + (long long)i * kThreads + threadIdx.x;
    u64 comp = 0;
    bool take = false;
    if (j < n) {
      comp = ((u64)words[(long long)lane * n + j] << ib) | (u64)j;
      take = comp <= thresh;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (ballot == 0) continue;
    const int leader = __ffs(ballot) - 1;
    unsigned slot = 0;
    if ((int)(threadIdx.x & 31) == leader) slot = atomicAdd(&st->taken, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, leader);
    const unsigned at = slot + __popc(ballot & lt);
    if (take && at < (unsigned)cap) cand[(long long)lane * cap + at] = comp;
  }
}

// Rank each taken composite by counting the lane's taken ones below it.
__global__ void __launch_bounds__(kRankThreads)
    select_rank(const u64* cand, const LaneState* state, float* e_pop,
                long long* idx, long long* queue, int ib, int cap) {
  __shared__ u64 tile[kRankThreads];
  const int lane = blockIdx.y;
  const u64* c = cand + (long long)lane * cap;
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const u64 mine = i < cap ? c[i] : ~0ull;
  unsigned rank = 0;
  for (int t0 = 0; t0 < cap; t0 += kRankThreads) {
    __syncthreads();
    const int t = t0 + threadIdx.x;
    tile[threadIdx.x] = t < cap ? c[t] : ~0ull;
    __syncthreads();
    const int m = min(kRankThreads, cap - t0);
    for (int s = 0; s < m; ++s) rank += tile[s] < mine ? 1u : 0u;
  }
  if (i < cap) {
    const long long at = (long long)lane * cap + rank;
    idx[at] = (long long)(mine & ((1ull << ib) - 1));
    e_pop[at] = word_value((unsigned)(mine >> ib));
  }
  if (i == 0) queue[lane] = (long long)state[lane].queue;
}

struct AcceptArgs {
  const float* e_pop;
  const long long* queue;
  const float* band_min;         // (L',) or null
  const unsigned char* valid_in; // (L', cap) or null
  float* band;
  long long* floor_dyn;
  unsigned char* valid;
  long long* order;
  long long* counts;
  long long* total;
  float delta, delta_rel;
  long long floor_base, fs_lo, fs_hi, queue_hi;
  int lanes, cap;
};

__device__ unsigned block_exclusive_scan(unsigned v, unsigned* total_out) {
  __shared__ unsigned warp_sums[kAcceptThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kAcceptThreads / 32 ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kAcceptThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned before = (warp > 0 ? warp_sums[warp - 1] : 0u) + x - v;
  *total_out = warp_sums[kAcceptThreads / 32 - 1];
  __syncthreads();
  return before;
}

__global__ void __launch_bounds__(kAcceptThreads) accept_kernel(AcceptArgs a) {
  // the lanes go through in chunks of kLaneChunk, each chunk's band, floor
  // and counts in shared memory
  __shared__ float s_band[kLaneChunk];
  __shared__ long long s_floor[kLaneChunk];
  __shared__ unsigned s_counts[kLaneChunk];
  __shared__ unsigned long long s_total;
  const int cap = a.cap;
  const long long all = (long long)a.lanes * cap;
  if (threadIdx.x == 0) s_total = 0;
  for (int l0 = 0; l0 < a.lanes; l0 += kLaneChunk) {
    const int nc = min(kLaneChunk, a.lanes - l0);
    __syncthreads();  // the chunk before is counted
    for (int c = threadIdx.x; c < nc; c += kAcceptThreads) {
      const int l = l0 + c;
      const float e_min = a.band_min != nullptr ? a.band_min[l] : a.e_pop[(long long)l * cap];
      float x = __fmul_rn(a.delta_rel, e_min);
      if (!isnan(x)) x = fmaxf(x, a.delta);
      const float band = __fadd_rn(e_min, x);
      const long long q = a.queue[l];
      long long fs = a.fs_lo;
      if (a.fs_hi > 0 && q >= a.queue_hi) fs = a.fs_hi;
      long long fl = a.floor_base;
      if (fs > 1) fl = min(max(q / fs, 1ll), a.floor_base);
      s_band[c] = band;
      s_floor[c] = fl;
      s_counts[c] = 0;
      a.band[l] = band;
      a.floor_dyn[l] = fl;
    }
    __syncthreads();
    // pass 1: valid and the lanes' counts
    const long long f_end = (long long)(l0 + nc) * cap;
    for (long long f = (long long)l0 * cap + threadIdx.x; f < f_end; f += kAcceptThreads) {
      const int l = (int)(f / cap);
      const int r = (int)(f - (long long)l * cap);
      bool v;
      if (a.valid_in != nullptr) {
        v = a.valid_in[f] != 0;
      } else {
        const float e = a.e_pop[f];
        v = isfinite(e) && (e <= s_band[l - l0] || (long long)r < s_floor[l - l0]);
      }
      a.valid[f] = v ? 1 : 0;
      if (v) atomicAdd(&s_counts[l - l0], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < nc; ++c) {
        a.counts[l0 + c] = s_counts[c];
        s_total += s_counts[c];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) a.total[0] = (long long)s_total;
  // pass 2: the accepted pairs first, lane-major in rank order, then the rest
  const long long total = (long long)s_total;
  long long acc_run = 0;
  for (long long f0 = 0; f0 < all; f0 += kAcceptThreads) {
    const long long f = f0 + threadIdx.x;
    const bool v = f < all && a.valid[f] != 0;
    unsigned chunk;
    const unsigned before = block_exclusive_scan(v ? 1u : 0u, &chunk);
    if (f < all) {
      const long long acc = acc_run + before;
      a.order[v ? acc : total + (f - acc)] = f;
    }
    acc_run += chunk;
  }
}

}  // namespace

// cand_e, fixed (uint8), ene (relax only, else may be null): (L, stride)
// lane-stacked planes; owned (n,) uint8 or null; lanes (L',) int64 or null;
// words (L', n) uint32, cand (L', cap) uint64, work: zeroed here, 64 +
// 4 * 2048 * 6 bytes a lane; e_pop (L', cap) float, idx (L', cap)
// int64, queue (L',) int64.  n < 2^31.
extern "C" int faldoi_select(const float* cand_e, const unsigned char* fixed,
                             const float* ene, const unsigned char* owned,
                             const long long* lanes, long long stride,
                             int relax, float margin, float bias,
                             unsigned* words, u64* cand, void* work,
                             float* e_pop, long long* idx, long long* queue,
                             int nl, long long n, int cap, void* stream) {
  if (nl <= 0 || n <= 0 || cap <= 0) return 0;
  if (cap > n || n >= (1ll << 31) || nl > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LaneState* state = static_cast<LaneState*>(work);
  unsigned* hist = reinterpret_cast<unsigned*>(state + nl);
  const size_t zero = sizeof(LaneState) * nl + sizeof(unsigned) * kBins * kMaxPasses * nl;
  cudaError_t e = cudaMemsetAsync(work, 0, zero, st);
  if (e != cudaSuccess) return (int)e;
  int ib = 1;
  while ((1ll << ib) < n) ++ib;
  const int total_bits = 32 + ib;
  Keys k{cand_e, fixed, ene, owned, lanes, stride, relax, margin, bias};
  const long long per = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned)((n + per - 1) / per), (unsigned)nl);
  int hi = total_bits;
  int bits = hi < kDigit ? hi : kDigit;
  int lo = hi - bits;
  select_first<<<grid, kThreads, 0, st>>>(k, words, hist, state, n, ib, lo,
                                          (unsigned)cap);
  for (int pass = 1; pass < kMaxPasses && lo > 0; ++pass) {
    hi = lo;
    bits = hi < kDigit ? hi : kDigit;
    lo = hi - bits;
    select_pass<<<grid, kThreads, 0, st>>>(words, hist, state, n, ib, lo, bits, pass);
  }
  select_take<<<grid, kThreads, 0, st>>>(words, cand, state, n, ib, cap);
  const dim3 rgrid((unsigned)((cap + kRankThreads - 1) / kRankThreads), (unsigned)nl);
  select_rank<<<rgrid, kRankThreads, 0, st>>>(cand, state, e_pop, idx, queue, ib, cap);
  return (int)cudaGetLastError();
}

// e_pop (L', cap) float, queue (L',) int64, band_min (L',) or null,
// valid_in (L', cap) uint8 or null; out: band (L',) float, floor_dyn (L',)
// int64, valid (L', cap) uint8, order (L' * cap) int64, counts (L',) int64,
// total (1,) int64.
extern "C" int faldoi_accept(const float* e_pop, const long long* queue,
                             const float* band_min,
                             const unsigned char* valid_in, float delta,
                             float delta_rel, long long floor_base,
                             long long fs_lo, long long fs_hi,
                             long long queue_hi, float* band,
                             long long* floor_dyn, unsigned char* valid,
                             long long* order, long long* counts,
                             long long* total, int nl, int cap, void* stream) {
  if (nl <= 0 || cap <= 0) return 0;
  AcceptArgs a{e_pop, queue, band_min, valid_in, band, floor_dyn, valid,
               order, counts, total, delta, delta_rel, floor_base, fs_lo,
               fs_hi, queue_hi, nl, cap};
  accept_kernel<<<1, kAcceptThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
