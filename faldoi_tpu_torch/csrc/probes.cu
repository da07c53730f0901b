// P1-P3: the Pallas probe kernels of scripts/, as Hopper kernels.
//
// P1 replaces scripts/tpu_pallas_probe.py:23 `f` (body `kernel` :18), the
// compile probe: out = 2x + y elementwise.
// P2 replaces scripts/tpu_pallas_probe.py:47 `g` (body `kernel2` :39), the
// "PD-kernel shape" probe: per (11, 11, 128) block, four times
// acc = acc + roll(acc, 1, axis=0) * 0.25.
// P3 replaces scripts/tpu_pallas_gather_probe.py:76 `run` (body `kernel`
// :42), the sweep's warp-window fetch probe: per lane, the (C, 40, 128)
// window of the planes at (oy8, cb), out[lane, :] = sum(window) * 1e-6.
//
// Each has a plain-C launcher that enqueues on the given stream and returns
// cudaGetLastError().  The build uses --fmad=false, so P1 and P2 round each
// multiply and each add as their PyTorch twins do (bit-exact); P3 sums in
// another order than its twin (a fixed one, so it is deterministic).

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// P1: out = 2x + y.  Bound by device-memory traffic (12 bytes per element,
// no reuse): one thread per 4 elements with 16-byte (float4) loads and
// stores when all three pointers are 16-byte aligned, a scalar loop for the
// tail or unaligned pointers.

__global__ void probe_axpy_vec(const float4* __restrict__ x,
                               const float4* __restrict__ y,
                               float4* __restrict__ out, long long n4) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    const float4 a = x[i];
    const float4 b = y[i];
    float4 r;
    r.x = a.x * 2.0f + b.x;
    r.y = a.y * 2.0f + b.y;
    r.z = a.z * 2.0f + b.z;
    r.w = a.w * 2.0f + b.w;
    out[i] = r;
  }
}

__global__ void probe_axpy_scalar(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ out, long long start,
                                  long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += step) {
    out[i] = x[i] * 2.0f + y[i];
  }
}

// ---------------------------------------------------------------------------
// P2: four roll-and-add steps along axis 0 of an (11, 11, L) array.
//
// This is the layout question of K1, the fused patch sweep: one patch per
// thread with its canvas in registers, against a block per patch with the
// canvas in shared memory.  Here one thread owns one (column, lane) pair and
// holds that column's 11 rows in registers, so a step is register moves and
// arithmetic only; the lane axis is contiguous, so a warp's loads and stores
// of one row are 128 contiguous bytes.  Each step reads only the old values
// (a copy of the column), as jnp.roll does.  Bound: traffic (8 bytes per
// element) and launch latency at the probe's 123,904 elements.

constexpr int kRollRows = 11;

__global__ void probe_roll4_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int cols,
                                   int lanes) {
  const long long total = (long long)cols * lanes;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const int lane = (int)(t % lanes);
    const int col = (int)(t / lanes);
    const long long stride = (long long)cols * lanes;  // one row
    const long long base = (long long)col * lanes + lane;
    float acc[kRollRows];
#pragma unroll
    for (int r = 0; r < kRollRows; ++r) acc[r] = x[base + r * stride];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float old[kRollRows];
#pragma unroll
      for (int r = 0; r < kRollRows; ++r) old[r] = acc[r];
#pragma unroll
      for (int r = 0; r < kRollRows; ++r)
        acc[r] = old[r] + old[(r + kRollRows - 1) % kRollRows] * 0.25f;
    }
#pragma unroll
    for (int r = 0; r < kRollRows; ++r) out[base + r * stride] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// P3: per lane, the sum of the (C, 40, 128) window at (oy8[k], cb[k]).
//
// One block of 256 threads per lane.  The window's rows are 128 floats =
// 32 float4 at a 16-byte aligned start (cb is a multiple of 128 and the
// wrapper requires W % 4 == 0), so a warp reads one 512-byte row segment per
// load.  Each thread sums its float4s in a fixed order, then a shared-memory
// tree reduces the 256 partial sums in a fixed order.
//
// Bound: bytes moved, 61,440 a lane for C = 3 (plus 512 written); the probe
// asks how close a per-lane window fetch comes to device-memory bandwidth.
// This kernel is the simple right form: plain loads, no overlap of one
// lane's fetch with the previous lane's reduction inside a block.  The TPU
// probe double-buffers its window DMAs; the Hopper counterpart, two
// 61,440-byte boxes in flight per block by cp.async or TMA with mbarriers
// (well within 227 KB of dynamic shared memory), is later work.

constexpr int kWinRows = 40;
constexpr int kWinCols = 128;
constexpr int kFetchThreads = 256;

__global__ void probe_window_fetch_kernel(const float* __restrict__ planes,
                                          const int* __restrict__ oy8,
                                          const int* __restrict__ cb,
                                          float* __restrict__ out, int c,
                                          int h, int w) {
  __shared__ float part[kFetchThreads];
  const int lane = blockIdx.x;
  const int oy = oy8[lane];
  const int x0 = cb[lane];
  constexpr int kVecPerRow = kWinCols / 4;
  const int nvec = c * kWinRows * kVecPerRow;
  float s = 0.0f;
  for (int v = threadIdx.x; v < nvec; v += kFetchThreads) {
    const int cv = v % kVecPerRow;
    const int rr = v / kVecPerRow;  // row of the (C * 40) stacked rows
    const int ch = rr / kWinRows;
    const int row = rr % kWinRows;
    const float4 q = *reinterpret_cast<const float4*>(
        planes + ((long long)ch * h + oy + row) * w + x0 + 4 * cv);
    s = s + ((q.x + q.y) + (q.z + q.w));
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kFetchThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  const float total = part[0] * 1e-6f;
  if (threadIdx.x < kWinCols) out[(long long)lane * kWinCols + threadIdx.x] = total;
}

unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loops cover the rest
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int faldoi_probe_axpy(const float* x, const float* y, float* out,
                                 long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (((unsigned long long)x | (unsigned long long)y |
                         (unsigned long long)out) & 15ull) == 0;
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    probe_axpy_vec<<<grid_for(n4, threads), threads, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
        reinterpret_cast<float4*>(out), n4);
    done = n4 * 4;
  }
  if (done < n)
    probe_axpy_scalar<<<grid_for(n - done, threads), threads, 0, st>>>(
        x, y, out, done, n);
  return (int)cudaGetLastError();
}

extern "C" int faldoi_probe_roll4(const float* x, float* out, int rows,
                                  int cols, int lanes, void* stream) {
  if (rows != kRollRows) return (int)cudaErrorInvalidValue;
  const long long total = (long long)cols * lanes;
  if (total <= 0) return 0;
  const int threads = 128;
  probe_roll4_kernel<<<grid_for(total, threads), threads, 0,
                       (cudaStream_t)stream>>>(x, out, cols, lanes);
  return (int)cudaGetLastError();
}

extern "C" int faldoi_probe_window_fetch(const float* planes, const int* oy8,
                                         const int* cb, float* out, int c,
                                         int h, int w, int b, void* stream) {
  if (b <= 0) return 0;
  probe_window_fetch_kernel<<<(unsigned)b, kFetchThreads, 0,
                              (cudaStream_t)stream>>>(planes, oy8, cb, out, c,
                                                      h, w);
  return (int)cudaGetLastError();
}
