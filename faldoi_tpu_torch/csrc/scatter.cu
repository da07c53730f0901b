// K3: the payload scatters of the growing's sweep.
//
// Replaces the XLA-lowered _scatter_min_payload (faldoi_tpu/core/
// local_step.py:174) and _scatter_max_payload in its exact form (:192) --
// the 4-neighbour candidates and the same-sweep donations (min), the
// centre update (a min whose updates already beat their target), the
// working flow (max over every in-box cell of every solved patch) and the
// seed insertion's candidates and working flow -- which the port ran as
// scatter_reduce + gather + a last-winner scatter_reduce + index_put a
// payload (faldoi_tpu_torch/ops/scatter.py keeps those as the plain twins).
//
// The rule, the twins' and XLA's sequential CPU scatter's: each slot keeps
// the minimum (maximum) key over its current key and its updates where ok;
// among the updates that equal it, the LAST in order (a position, or the
// update's index) writes the payload and the key; an update equal to the
// current key beats it; a NaN key, the slot's or an update's, makes the
// slot's key NaN and writes no payload (scatter_reduce's amin / amax and
// XLA's min / max propagate NaN, and no update then compares <= it); -0.0
// and +0.0 tie.  Masked updates write nothing (the twins send them to their
// lane's dump slot, whose content is unspecified).
//
// Design: a slot word of 64 bits, (an order word of the key) << 32 |
// priority, where the order word is the key's IEEE total-order word with
// -0.0 taken as +0.0 (inverted for min) and the priority is 0 for the
// slot's own key and position + 1 for an update; NaN is the all-ones word,
// above everything.  Three launches over the updates: seed each touched
// slot's word from its key (a benign race: every writer writes the same
// word), atomicMax every update's word, then each update whose word won
// writes its payload and key.  Bound by device-memory bytes (the updates
// read three times, a word a touched slot, the winners' writes) and by the
// atomics' contention where patches overlap (up to p*p updates a pixel).
//
// The generic form takes (q, key, payload, ok, pos) arrays; the working-
// flow form reads K patches' (p, p) canvases and forms each cell's slot,
// key (the patch energy), ok (the in-box mask) and position ((r*p+c)*K + b,
// JAX's cell-major order) itself, so the K*p*p updates are never stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 256;
constexpr u64 kNanWord = ~0ull;
constexpr int kMaxPayload = 3;

__device__ __forceinline__ u64 pack(float key, unsigned prio, bool is_min) {
  if (isnan(key)) return kNanWord;
  unsigned b = __float_as_uint(key);
  if (b == 0x80000000u) b = 0u;
  unsigned w = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (is_min) w = ~w;
  return ((u64)w << 32) | prio;
}

struct Generic {
  const long long* q;
  const float* key;
  const unsigned char* ok;
  const long long* pos;   // null: the update's index
  const float* val[kMaxPayload];
  __device__ bool get(long long i, long long& slot, float& k,
                      unsigned& prio) const {
    if (ok[i] == 0) return false;
    slot = q[i];
    k = key[i];
    prio = (unsigned)((pos != nullptr ? pos[i] : i) + 1);
    return true;
  }
};

struct Wflow {
  const float* ener;            // (K,)
  const long long* oy;          // (K,)
  const long long* ox;
  const unsigned char* inbox;   // (K, p, p)
  const long long* base;        // (K,) lane offsets, or null
  const float* val[kMaxPayload];  // (K, p, p) canvases
  long long w;
  int k, p;
  __device__ bool get(long long i, long long& slot, float& key,
                      unsigned& prio) const {
    if (inbox[i] == 0) return false;
    const int pp = p * p;
    const int b = (int)(i / pp);
    const int cell = (int)(i - (long long)b * pp);
    const int r = cell / p;
    slot = (base != nullptr ? base[b] : 0) + (oy[b] + r) * w + ox[b] + (cell - r * p);
    key = ener[b];
    prio = (unsigned)cell * (unsigned)k + (unsigned)b + 1u;
    return true;
  }
};

template <class F, bool MIN>
__global__ void __launch_bounds__(kThreads)
    scatter_seed(F f, const float* key_out, u64* words, long long m) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  long long s;
  float k;
  unsigned prio;
  if (f.get(i, s, k, prio)) words[s] = pack(key_out[s], 0u, MIN);
}

template <class F, bool MIN>
__global__ void __launch_bounds__(kThreads)
    scatter_race(F f, u64* words, long long m) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  long long s;
  float k;
  unsigned prio;
  if (f.get(i, s, k, prio)) atomicMax(&words[s], pack(k, prio, MIN));
}

template <class F, bool MIN>
__global__ void __launch_bounds__(kThreads)
    scatter_write(F f, const u64* words, float* key_out, float* t0, float* t1,
                  float* t2, long long m) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  long long s;
  float k;
  unsigned prio;
  if (!f.get(i, s, k, prio)) return;
  const u64 won = words[s];
  if (won == kNanWord) {
    key_out[s] = __int_as_float(0x7fffffff);
  } else if (won == pack(k, prio, MIN)) {
    key_out[s] = k;
    t0[s] = f.val[0][i];
    t1[s] = f.val[1][i];
    if (t2 != nullptr) t2[s] = f.val[2][i];
  }
}

template <class F>
int run(const F& f, int is_min, float* key_out, float* t0, float* t1,
        float* t2, u64* words, long long m, cudaStream_t st) {
  if (m <= 0) return 0;
  const unsigned grid = (unsigned)((m + kThreads - 1) / kThreads);
  if (is_min) {
    scatter_seed<F, true><<<grid, kThreads, 0, st>>>(f, key_out, words, m);
    scatter_race<F, true><<<grid, kThreads, 0, st>>>(f, words, m);
    scatter_write<F, true><<<grid, kThreads, 0, st>>>(f, words, key_out, t0, t1, t2, m);
  } else {
    scatter_seed<F, false><<<grid, kThreads, 0, st>>>(f, key_out, words, m);
    scatter_race<F, false><<<grid, kThreads, 0, st>>>(f, words, m);
    scatter_write<F, false><<<grid, kThreads, 0, st>>>(f, words, key_out, t0, t1, t2, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The generic form, in place on the outputs (the wrapper's copies of the
// targets): key_out the key plane, t0, t1 (t2: method 8's chi, or null) the
// payload planes; q (m,) int64 slots, key (m,), ok (m,) uint8, pos (m,)
// int64 or null, v0, v1 (v2 or null) the payloads; words: one uint64 a slot
// of the planes (scratch, not read before it is seeded).
extern "C" int faldoi_scatter_payload(int is_min, float* key_out, float* t0,
                                      float* t1, float* t2, const long long* q,
                                      const float* key, const unsigned char* ok,
                                      const long long* pos, const float* v0,
                                      const float* v1, const float* v2,
                                      u64* words, long long m, void* stream) {
  if (m >= (1ll << 32) - 2) return (int)cudaErrorInvalidValue;
  Generic f{q, key, ok, pos, {v0, v1, v2}};
  return run(f, is_min, key_out, t0, t1, t2, words, m,
             (cudaStream_t)stream);
}

// The working-flow form (max): key_out the key plane (the wrapper's plane of
// -inf), wu, wv (wchi or null) the payload planes; su, sv (schi or null)
// (K, p, p) canvases, ener (K,), oy, ox (K,) int64, inbox (K, p, p) uint8,
// base (K,) int64 or null; w the image width.
extern "C" int faldoi_wflow_scatter(float* key_out, float* wu, float* wv,
                                    float* wchi, const float* su,
                                    const float* sv, const float* schi,
                                    const float* ener, const long long* oy,
                                    const long long* ox,
                                    const unsigned char* inbox,
                                    const long long* base, u64* words,
                                    long long w, int k, int p, void* stream) {
  const long long m = (long long)k * p * p;
  if (m >= (1ll << 32) - 2) return (int)cudaErrorInvalidValue;
  Wflow f{ener, oy, ox, inbox, base, {su, sv, schi}, w, k, p};
  return run(f, 0, key_out, wu, wv, wchi, words, m, (cudaStream_t)stream);
}
