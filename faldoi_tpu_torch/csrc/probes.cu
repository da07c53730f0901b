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
// no reuse) and, at the probe's (256, 256), by launch latency.  One launch
// whatever the size and alignment: blocks of 128 threads (the probe's 16,384
// float4s spread over 128 of the card's 132 SMs), a grid that covers the
// array so no thread loops, 32-bit indices below 2^31 elements, one 16-byte
// load of x and of y per thread (two or four in flight per thread measured
// level at (4096, 4096), where the kernel runs at its memory rate), and the
// ragged tail (n % 4 elements) done by the first threads of block 0 in the
// same launch.  Pointers that are not all 16-byte aligned take the scalar
// kernel, four independent elements a thread.

constexpr int kAxpyThreads = 128;

template <typename Index>
__global__ void __launch_bounds__(kAxpyThreads)
    probe_axpy_vec(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, Index n) {
  const Index n4 = n / 4;
  const Index i = (Index)blockIdx.x * kAxpyThreads + threadIdx.x;
  if (i < n4) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(y)[i];
    float4 r;
    r.x = a.x * 2.0f + b.x;
    r.y = a.y * 2.0f + b.y;
    r.z = a.z * 2.0f + b.z;
    r.w = a.w * 2.0f + b.w;
    reinterpret_cast<float4*>(out)[i] = r;
  }
  const Index t = n4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && t < n) out[t] = x[t] * 2.0f + y[t];
}

template <typename Index>
__global__ void __launch_bounds__(kAxpyThreads)
    probe_axpy_scalar(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, Index n) {
  const Index i0 = (Index)blockIdx.x * (kAxpyThreads * 4) + threadIdx.x;
  float a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Index i = i0 + j * kAxpyThreads;
    if (i < n) {
      a[j] = x[i];
      b[j] = y[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Index i = i0 + j * kAxpyThreads;
    if (i < n) out[i] = a[j] * 2.0f + b[j];
  }
}

template <typename Index>
void launch_axpy(const float* x, const float* y, float* out, long long n,
                 bool aligned, cudaStream_t st) {
  const long long per = kAxpyThreads * 4;   // elements a block, both kernels
  const unsigned grid = (unsigned)((n + per - 1) / per);
  if (aligned)
    probe_axpy_vec<Index><<<grid, kAxpyThreads, 0, st>>>(x, y, out, (Index)n);
  else
    probe_axpy_scalar<Index><<<grid, kAxpyThreads, 0, st>>>(x, y, out, (Index)n);
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
// Bound: bytes, each touched plane cell read once and 512 bytes written a
// lane.  A block that fetches its lane's private 61,440-byte window reads
// from L2 at the L2's rate (8.4 TB/s measured on the H100), which is 50 times
// the bytes the function needs at B = 8192: the origins are aligned (oy8 to
// 8 rows, cb to 128 columns), so the windows of one column block overlap in
// bands of 8 rows and there are only ceil(H / 8) x floor(W / 128) distinct
// bands.  The work is therefore shared between the lanes:
//   band table  table[by, bx] = the sum over the C planes of the aligned band
//               of 8 rows x 128 columns at (8 by, 128 bx) (a last partial band
//               sums the rows that exist).  One block of 256 threads a band;
//               every plane cell is read once, in float4s along the rows.
//   lane pass   out[k, :] = (t0 + t1 + t2 + t3 + t4) * 1e-6 with
//               tm = table[oy8[k] / 8 + m, cb[k] / 128], added top to bottom;
//               one warp a lane, one float4 a thread (512-byte aligned rows).
// Two launches, the second a programmatic dependent of the first, so that
// its launch and its origin loads overlap the table pass (0.5-0.8 us less
// than two plain launches on the H100; one cooperative launch with a grid
// barrier between the passes took 1.3-2 times as long as those).
// Summation order (fixed, so the result is deterministic; it differs from
// the twin's in the last bits): inside a band, thread t adds the float4s
// t, t + 256, ... of the band's (C x rows x 32) float4s in that order, each
// as (x + y) + (z + w); a butterfly (xor 16, 8, 4, 2, 1) sums a warp; the 8
// warp sums are added as ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)).

constexpr int kWinRows = 40;
constexpr int kWinCols = 128;
constexpr int kBandRows = 8;
constexpr int kFetchThreads = 256;
constexpr int kFetchWarps = kFetchThreads / 32;
constexpr int kVecPerRow = kWinCols / 4;

// The sum of band (by, bx), returned to every thread; ``part`` is shared.
__device__ __forceinline__ float band_sum(const float* __restrict__ planes,
                                          int c, int h, int w, int by, int bx,
                                          float* part) {
  const int rows = min(kBandRows, h - by * kBandRows);
  const int nvec = c * rows * kVecPerRow;
  const float* base = planes + (long long)by * kBandRows * w + bx * kWinCols;
  float s = 0.0f;
#pragma unroll 4
  for (int vi = threadIdx.x; vi < nvec; vi += kFetchThreads) {
    const int rr = vi / kVecPerRow;  // row of the (C * rows) stacked rows
    const int ch = rr / rows;
    const float4 q = *reinterpret_cast<const float4*>(
        base + ((long long)ch * h + (rr - ch * rows)) * w + 4 * (vi % kVecPerRow));
    s = s + ((q.x + q.y) + (q.z + q.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = s + __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  return ((part[0] + part[1]) + (part[2] + part[3])) +
         ((part[4] + part[5]) + (part[6] + part[7]));
}

__global__ void __launch_bounds__(kFetchThreads)
    probe_band_table_kernel(const float* __restrict__ planes,
                            float* __restrict__ table, int c, int h, int w,
                            int nbx) {
  __shared__ float part[kFetchWarps];
  cudaTriggerProgrammaticLaunchCompletion();  // a dependent grid may start
  const int band = blockIdx.x;
  const float s = band_sum(planes, c, h, w, band / nbx, band % nbx, part);
  if (threadIdx.x == 0) table[band] = s;
}

// Launched as a programmatic dependent of the table pass: its blocks start
// and fetch their origins while the table pass still runs, and wait for the
// table before they read it (plain loads: many lanes share a table entry, and
// served from L2 alone the table's few sectors become a hot spot).
__global__ void __launch_bounds__(kFetchThreads)
    probe_band_lanes_kernel(const float* table, const int* __restrict__ oy8,
                            const int* __restrict__ cb,
                            float* __restrict__ out, int b, int nbx) {
  const int k = blockIdx.x * kFetchWarps + (threadIdx.x >> 5);
  const int off =
      k < b ? (oy8[k] / kBandRows) * nbx + cb[k] / kWinCols : 0;
  cudaGridDependencySynchronize();  // the table is complete and visible
  if (k >= b) return;
  const float* t = table + off;
  float s = t[0];
#pragma unroll
  for (int m = 1; m < kWinRows / kBandRows; ++m) s = s + t[m * nbx];
  const float total = s * 1e-6f;
  reinterpret_cast<float4*>(out + (long long)k * kWinCols)[threadIdx.x & 31] =
      make_float4(total, total, total, total);
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
  if (n > (1LL << 40)) return (int)cudaErrorInvalidValue;  // the grid's reach
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (((unsigned long long)x | (unsigned long long)y |
                         (unsigned long long)out) & 15ull) == 0;
  if (n < (1LL << 31) - 4096)  // room for the last block's idle indices
    launch_axpy<int>(x, y, out, n, aligned, st);
  else
    launch_axpy<long long>(x, y, out, n, aligned, st);
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

// table: ceil(h / 8) * floor(w / 128) floats of scratch on the device.
extern "C" int faldoi_probe_window_fetch(const float* planes, const int* oy8,
                                         const int* cb, float* table,
                                         float* out, int c, int h, int w,
                                         int b, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int nbx = w / kWinCols;
  int nbands = ((h + kBandRows - 1) / kBandRows) * nbx;
  if (c < 1 || nbands < 1) return (int)cudaErrorInvalidValue;
  const int lane_blocks = (b + kFetchWarps - 1) / kFetchWarps;
  probe_band_table_kernel<<<(unsigned)nbands, kFetchThreads, 0, st>>>(
      planes, table, c, h, w, nbx);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lane_blocks);
  cfg.blockDim = dim3(kFetchThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* table_in = table;
  cudaError_t e = cudaLaunchKernelEx(&cfg, probe_band_lanes_kernel,
                                     table_in, oy8, cb, out, b, nbx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
