// K0: batched patch crop, in two forms.
//
// Replaces faldoi_tpu/ops/pallas_sweep.py::_pallas_gather_patches (the
// Pallas kernel Mosaic rejected) and its live XLA form, the vmapped
// lax.dynamic_slice of _xla_gather_patches, and for the sweep's state crop
// the jnp.stack + jnp.pad(mode="edge") + dynamic_slice of
// faldoi_tpu/core/local_step.py:564-577.
//
// Both forms take a window's start as lax.dynamic_slice takes it on the
// edge-padded array: a negative start counts from the padded end, then it is
// clamped so that the window fits.  Both are pure copies: bit-identical to
// their twins, NaN payloads included.  Both are bound by device-memory
// traffic (the output written once, the touched input read once) and, at the
// small shapes, by launch latency.
//
// Stack form (gather_patches): out[r, c, ch, k] = stack[y0(k) + r,
// x0(k) + c, ch] from a padded (H', W', C) stack into (p, p, C, B).  The
// output wants the lane index k fastest, so a warp's 32 threads are 32
// lanes and its stores are 128 contiguous bytes; the input is contiguous
// along a window row (p*C floats), so a thread copies one whole row of its
// lane's window: each 32-byte sector it touches comes from L2 once and
// serves the thread's next seven loads from L1.  (One thread an element, as
// the first version had it, fetched a sector for every float; its chain of
// 64-bit divisions was not what held it back.)  The origins are loaded once
// a thread and the row's offsets need no division.
//
// Planes form (gather_plane_patches): the C state planes are read where
// they lie, as separate (h, w) arrays with no stack and no pad; the edge pad
// is the clamp min(y, h - 1), min(x, w - 1) in the kernel.  The output is
// (C, B, p, p), lane-major, so every plane's canvases come out as one
// contiguous block and nothing is transposed.  A thread takes four cells of
// the flat (B, p, p) index space, 256 apart: a warp's loads run along window
// rows (p contiguous floats of a plane) and its stores are 128 contiguous,
// aligned bytes.  A cell's offset is computed once and shared by the C
// planes, and a thread's four loads of a plane are in flight together.  A
// plane may be int32 (the trust map after pruning): it is converted on the
// way.  The same form crops the 24 NLTV weight planes of the patch solver
// (zero-padded (h + P, w + P) planes, so no clamp applies) into the
// (24, B, p, p) layout that K7 (csrc/nltv.cu) reads coalesced.
//
// Lanes (both forms): with a per-window lane index, window k reads the
// lane[k]-th of L images stacked along a leading axis (the stack at
// lane[k] * H' * W' * C floats; plane ch at lane[k] * lane_stride[ch]
// elements), so the windows of N frame pairs' 2N growing lanes are one
// launch.  Each window clamps at its own lane's edge and reads nothing of
// another lane.  Without a lane index (a null pointer) both forms are the
// one-image kernels above, unchanged.

#include <cuda_runtime.h>

namespace {

// lax.dynamic_slice's start on an axis of n + p padded cells: a negative
// start counts from the end, then clamp into [0, n].
__device__ __forceinline__ int slice_start(long long o, int n, int p) {
  if (o < 0) o += n + p;
  return (int)min(max(o, 0LL), (long long)n);
}

// ---------------------------------------------------------------------------
// stack form

constexpr int kStackThreads = 128;

__global__ void __launch_bounds__(kStackThreads)
    gather_patches_kernel(const float* __restrict__ stack,
                          const int* __restrict__ oy,
                          const int* __restrict__ ox,
                          const int* __restrict__ lane, float* __restrict__ out,
                          int hp, int wp, int c, int b, int p) {
  const int k = blockIdx.x * kStackThreads + threadIdx.x;
  if (k >= b) return;
  const int pc = p * c;
  if (lane != nullptr) stack += (long long)lane[k] * hp * wp * c;
  const int y0 = slice_start(oy[k], hp - p, p);
  const int x0 = slice_start(ox[k], wp - p, p);
  for (int row = blockIdx.y; row < p; row += gridDim.y) {
    const float* src = stack + ((long long)(y0 + row) * wp + x0) * c;
    float* dst = out + (long long)row * pc * b + k;
    for (int j = 0; j < pc; ++j) dst[(long long)j * b] = src[j];
  }
}

// ---------------------------------------------------------------------------
// planes form

constexpr int kMaxPlanes = 24;  // the NLTV weights are 24 planes
constexpr int kPlaneThreads = 256;
constexpr int kPlaneCells = 4;  // cells a thread, kPlaneThreads apart

struct PlaneSet {
  const void* ptr[kMaxPlanes];
  long long lane_stride[kMaxPlanes];  // elements from one lane to the next
};

__device__ __forceinline__ float load_plane(const PlaneSet& planes, int ch,
                                            unsigned int_mask, long long off) {
  if ((int_mask >> ch) & 1u)
    return (float)static_cast<const int*>(planes.ptr[ch])[off];
  return static_cast<const float*>(planes.ptr[ch])[off];
}

// P > 0: the patch side at compile time (the divisions become multiplies).
// LANES: window k reads lane lane[k] of every plane.
template <int P, bool LANES>
__global__ void __launch_bounds__(kPlaneThreads)
    gather_plane_patches_kernel(PlaneSet planes, int nc, unsigned int_mask,
                                const long long* __restrict__ oy,
                                const long long* __restrict__ ox,
                                const long long* __restrict__ lane,
                                float* __restrict__ out, int h, int w, int b,
                                int p_rt) {
  const int p = P > 0 ? P : p_rt;
  const int pp = p * p;
  const int total = b * pp;
  const int e0 = blockIdx.x * (kPlaneThreads * kPlaneCells) + threadIdx.x;
  int off[kPlaneCells];
  long long ln[kPlaneCells];
#pragma unroll
  for (int i = 0; i < kPlaneCells; ++i) {
    const int e = e0 + kPlaneThreads * i;
    off[i] = 0;
    ln[i] = 0;
    if (e < total) {
      const int k = e / pp;
      const int cell = e - k * pp;
      const int r = cell / p;
      const int y0 = slice_start(oy[k], h, p);
      const int x0 = slice_start(ox[k], w, p);
      off[i] = min(y0 + r, h - 1) * w + min(x0 + (cell - r * p), w - 1);
      if (LANES) ln[i] = lane[k];
    }
  }
#pragma unroll
  for (int ch = 0; ch < kMaxPlanes; ++ch) {
    if (ch < nc) {
      float v[kPlaneCells];
#pragma unroll
      for (int i = 0; i < kPlaneCells; ++i)
        v[i] = load_plane(planes, ch, int_mask,
                          LANES ? ln[i] * planes.lane_stride[ch] + off[i]
                                : (long long)off[i]);
      float* dst = out + (long long)ch * total;
#pragma unroll
      for (int i = 0; i < kPlaneCells; ++i)
        if (e0 + kPlaneThreads * i < total) dst[e0 + kPlaneThreads * i] = v[i];
    }
  }
}

}  // namespace

// lane: null (one (H', W', C) stack) or (B,) lane indices into a
// (L, H', W', C) stack.
extern "C" int faldoi_gather_patches(const float* stack, const int* oy,
                                     const int* ox, const int* lane,
                                     float* out, int hp, int wp, int c, int b,
                                     int p, void* stream) {
  if (p <= 0 || c <= 0 || b <= 0) return 0;
  const dim3 grid((unsigned)((b + kStackThreads - 1) / kStackThreads),
                  (unsigned)(p < 65535 ? p : 65535));
  gather_patches_kernel<<<grid, kStackThreads, 0, (cudaStream_t)stream>>>(
      stack, oy, ox, lane, out, hp, wp, c, b, p);
  return (int)cudaGetLastError();
}

namespace {

template <bool LANES>
void launch_plane_patches(const PlaneSet& set, int nc, unsigned int_mask,
                          const long long* oy, const long long* ox,
                          const long long* lane, float* out, int h, int w,
                          int b, int p, unsigned grid, cudaStream_t st) {
  if (p == 11)
    gather_plane_patches_kernel<11, LANES><<<grid, kPlaneThreads, 0, st>>>(
        set, nc, int_mask, oy, ox, lane, out, h, w, b, p);
  else if (p == 3)
    gather_plane_patches_kernel<3, LANES><<<grid, kPlaneThreads, 0, st>>>(
        set, nc, int_mask, oy, ox, lane, out, h, w, b, p);
  else
    gather_plane_patches_kernel<0, LANES><<<grid, kPlaneThreads, 0, st>>>(
        set, nc, int_mask, oy, ox, lane, out, h, w, b, p);
}

}  // namespace

// planes: a host array of nc device pointers; bit ch of int_mask says that
// plane ch holds int32.  lane: null (one image a plane) or (B,) lane
// indices, and then lane_strides a host array of nc lane strides in
// elements.  b * p * p must be below 2^31 (the wrapper checks).
extern "C" int faldoi_gather_plane_patches(const void* const* planes,
                                           const long long* lane_strides,
                                           int nc, unsigned int_mask,
                                           const long long* oy,
                                           const long long* ox,
                                           const long long* lane, float* out,
                                           int h, int w, int b, int p,
                                           void* stream) {
  if (nc < 1 || nc > kMaxPlanes) return (int)cudaErrorInvalidValue;
  if (lane != nullptr && lane_strides == nullptr)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || p <= 0) return 0;
  PlaneSet set;
  for (int ch = 0; ch < kMaxPlanes; ++ch) {
    set.ptr[ch] = planes[ch < nc ? ch : 0];
    set.lane_stride[ch] = lane != nullptr ? lane_strides[ch < nc ? ch : 0] : 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long per = kPlaneThreads * kPlaneCells;
  const unsigned grid = (unsigned)(((long long)b * p * p + per - 1) / per);
  if (lane != nullptr)
    launch_plane_patches<true>(set, nc, int_mask, oy, ox, lane, out, h, w, b,
                               p, grid, st);
  else
    launch_plane_patches<false>(set, nc, int_mask, oy, ox, lane, out, h, w, b,
                                p, grid, st);
  return (int)cudaGetLastError();
}
