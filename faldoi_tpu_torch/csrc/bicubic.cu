// K4: bicubic sampling with the reference's C semantics.
//
// Replaces the XLA-lowered faldoi_tpu/ops/bicubic.py::bicubic_interp_at and
// its windowed one-hot forms (bicubic_window_sample*, the tiled
// bicubic_warp_stack), which clamp samples beyond their window; this kernel
// samples every point exactly.
//
// Semantics (src/bicubic_interpolation.c:146-163): C (int) truncation, sign
// steps sx = sign(uu), sy = sign(vv), the row stencil's first element
// stepping by sx (sic), Neumann clamping with an out-of-domain flag
// (border_out -> 0).  Each axis's 4 basis coefficients are accumulated onto
// their clamped offsets in one 4-window, then the window is contracted over
// rows, then over columns, with explicit fmaf (XLA's CPU dot rounds so in the
// JAX reference).  Operation order and rounding match the plain twin
// (faldoi_tpu_torch/ops/bicubic.py::bicubic_sample_plain); --fmad=false keeps
// nvcc from contracting anything else.
//
// Three forms, one thread per sample point each:
// * the point form (bicubic_sample_kernel) samples given points;
// * the patch form (bicubic_patches_kernel, the patch solver's warps of
//   faldoi_tpu/core/functionals.py::_warp3/_warp1) forms its cells' points
//   itself from the patch boxes and flow canvases, so the solver runs no
//   glue ops before it;
// * the flow form (bicubic_warp_planes_kernel, the whole-image warps of the
//   global step, the FB check and the uniformity test) forms its pixels'
//   points (j + u, i + v) itself from the flow where it lies, so the warp
//   runs no glue ops either.
// All share the weights across the C planes and are bound by the 16
// scattered reads per point and plane, which neighbouring threads mostly
// share through L1/L2.  A patch form staging each patch's source tile in
// shared memory was slower on the H100 than reading through L1 (PERF.md,
// Findings).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int trunc_int(float x) {
  // C (int) cast; NaN -> 0 and +-1e9 saturation, as the twin's _trunc
  float c = isnan(x) ? 0.0f : fminf(fmaxf(x, -1e9f), 1e9f);
  return (int)c;
}

__device__ __forceinline__ void basis(float t, float a[4]) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  a[0] = 0.5f * ((-t + 2.0f * t2) - t3);
  a[1] = (1.0f - 2.5f * t2) + 1.5f * t3;
  a[2] = 0.5f * ((t + 4.0f * t2) - 3.0f * t3);
  a[3] = 0.5f * (t3 - t2);
}

// Window start and the 4 window weights of one axis; returns the out flag.
// The start is ``given`` when has_given, else the minimum clamped element.
__device__ __forceinline__ bool axis_weights(const int el[4], int given,
                                             bool has_given, int n,
                                             float origin, int* start,
                                             float w[4]) {
  bool out = false;
  int cl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out = out || el[k] < 0 || el[k] >= n;
    cl[k] = min(max(el[k], 0), n - 1);
  }
  int st = has_given ? given : min(min(cl[0], cl[1]), min(cl[2], cl[3]));
  st = min(max(st, 0), max(n - 4, 0));
  float a[4];
  basis(origin - (float)cl[1], a);
  // every offset adds the coefficient or 0, as the twin does: a constant
  // index keeps w in registers (w[rel] += a[e] put it in local memory)
  w[0] = w[1] = w[2] = w[3] = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int rel = min(max(cl[e] - st, 0), 3);
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = w[r] + (rel == r ? a[e] : 0.0f);
  }
  *start = st;
  return out;
}

// The 4x4 window start (wx0, wy0), the per-axis window weights and the
// out-of-domain flag of one sample point (uu, vv).
__device__ __forceinline__ bool point_weights(float u, float v, int h, int w,
                                              int* wx0, int* wy0, float wx[4],
                                              float wy[4]) {
  const int sx = u < 0.0f ? -1 : 1;
  const int sy = v < 0.0f ? -1 : 1;
  const int iu = trunc_int(u);
  const int iv = trunc_int(v);
  const int ex[4] = {iu - sx, iu, iu + sx, iu + 2 * sx};
  const int ey[4] = {iv - sx, iv, iv + sy, iv + 2 * sy};  // sic: sx
  bool o = axis_weights(ex, sx > 0 ? iu - 1 : iu - 2, true, w, u, wx0, wx);
  o = axis_weights(ey, 0, false, h, v, wy0, wy) || o;
  return o;
}

// Contract the 4x4 window at ``win`` (rows ``stride`` floats apart; offsets
// up to 3 * stride + 3 fit an int for every image a 32-bit h * w admits)
// over rows, then over columns, with fmaf.
__device__ __forceinline__ float contract(const float* win, int stride,
                                          const float wy[4],
                                          const float wx[4]) {
  float r = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float col = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      col = fmaf(wy[k], win[k * stride + l], col);
    r = fmaf(col, wx[l], r);
  }
  return r;
}

__global__ void bicubic_sample_kernel(const float* __restrict__ planes,
                                      const float* __restrict__ uu,
                                      const float* __restrict__ vv,
                                      float* __restrict__ out, int c, int h,
                                      int w, long long npts, int border_out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < npts; idx += step) {
    int wx0, wy0;
    float wx[4], wy[4];
    const bool o = point_weights(uu[idx], vv[idx], h, w, &wx0, &wy0, wx, wy);
    const long long plane = (long long)h * w;
    for (int ch = 0; ch < c; ++ch) {
      float r = contract(planes + ch * plane + (long long)wy0 * w + wx0, w, wy,
                         wx);
      if (border_out && o) r = 0.0f;
      out[ch * npts + idx] = r;
    }
  }
}

// The patch form: one thread per canvas cell of the B patches.  Each
// thread forms its cell's point as the patch solver does (cell + flow inside
// the valid box, the bare cell outside it) and samples it exactly as
// bicubic_sample_kernel does with border_out off.
__global__ void bicubic_patches_kernel(
    const float* __restrict__ planes, const int* __restrict__ oy,
    const int* __restrict__ ox, const int* __restrict__ ph,
    const int* __restrict__ pw, const float* __restrict__ u1,
    const float* __restrict__ u2, float* __restrict__ out, int c, int h, int w,
    int b, int p) {
  const long long pp = (long long)p * p;
  const long long nout = (long long)b * pp;
  const long long plane = (long long)h * w;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < nout; idx += step) {
    const int k = (int)(idx / pp);
    const int cell = (int)(idx - k * pp);
    const int row = cell / p, col = cell - (cell / p) * p;
    const bool inbox = row < ph[k] && col < pw[k];
    const float uu = (float)(ox[k] + col) + (inbox ? u1[idx] : 0.0f);
    const float vv = (float)(oy[k] + row) + (inbox ? u2[idx] : 0.0f);
    int wx0, wy0;
    float wx[4], wy[4];
    point_weights(uu, vv, h, w, &wx0, &wy0, wx, wy);
    for (int ch = 0; ch < c; ++ch)
      out[ch * nout + idx] = contract(
          planes + ch * plane + (long long)wy0 * w + wx0, w, wy, wx);
  }
}

// The flow form: the whole-image warp out[ch, i, j] = planes[ch](j + u[i, j],
// i + v[i, j]).  One thread a pixel, a 16 x 16 pixel tile a block, so that
// the windows of neighbouring rows share their lines in the block's L1.
// Each thread forms its point with the float32 additions of the twin's
// warp_coords and then does what the point form does, so the two are equal
// bit for bit.  The flow is read where it lies through its element strides
// (a (h, w, 2) flow's halves need no copy), and the C outputs are contiguous
// planes.
//
// What bounds it on the H100 (PERF.md, Findings): not bytes.  With a constant
// flow it takes 2.3 times its byte bound, of which the planes' loads are a
// third: the rest is the per-point weights and two dependent memory round
// trips (flow, then windows) in each of the image's two waves of resident
// blocks.  Under a noisy flow each warp load touches many 128-byte lines and
// L1 wavefronts take over.  Staging each block's source box in shared memory
// (bounding box by warp reductions, cp.async row copies, a counter of staged
// blocks) was built and lost at every flow, a constant one included: it adds
// a third dependent round trip and two barriers to a kernel that waits on
// latency, and L1 already holds the windows.
constexpr int kWarpTile = 16;

__global__ void __launch_bounds__(kWarpTile * kWarpTile)
    bicubic_warp_planes_kernel(const float* __restrict__ planes,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               float* __restrict__ out, int c, int h, int w,
                               long long su0, long long su1, long long sv0,
                               long long sv1, int border_out) {
  const int j = blockIdx.x * kWarpTile + threadIdx.x;
  const int i = blockIdx.y * kWarpTile + threadIdx.y;
  if (i >= h || j >= w) return;
  const float uu = (float)j + u[i * su0 + j * su1];
  const float vv = (float)i + v[i * sv0 + j * sv1];
  int wx0, wy0;
  float wx[4], wy[4];
  const bool o = point_weights(uu, vv, h, w, &wx0, &wy0, wx, wy);
  const long long plane = (long long)h * w;
  const long long pix = (long long)i * w + j;
  for (int ch = 0; ch < c; ++ch) {
    float r =
        contract(planes + ch * plane + (long long)wy0 * w + wx0, w, wy, wx);
    if (border_out && o) r = 0.0f;
    out[ch * plane + pix] = r;
  }
}

}  // namespace

extern "C" int faldoi_bicubic_sample(const float* planes, const float* uu,
                                     const float* vv, float* out, int c,
                                     int h, int w, long long npts,
                                     int border_out, void* stream) {
  if (npts <= 0) return 0;
  const int threads = 256;
  long long blocks = (npts + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  bicubic_sample_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(planes, uu, vv, out, c, h, w,
                                                  npts, border_out);
  return (int)cudaGetLastError();
}

extern "C" int faldoi_bicubic_sample_patches(
    const float* planes, const int* oy, const int* ox, const int* ph,
    const int* pw, const float* u1, const float* u2, float* out, int c, int h,
    int w, int b, int p, void* stream) {
  if (b <= 0) return 0;
  if (c < 1 || p < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = ((long long)b * p * p + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  bicubic_patches_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(planes, oy, ox, ph, pw, u1,
                                                   u2, out, c, h, w, b, p);
  return (int)cudaGetLastError();
}

// su*, sv*: the strides of u and v in elements.
extern "C" int faldoi_bicubic_warp_planes(
    const float* planes, const float* u, const float* v, float* out, int c,
    int h, int w, long long su0, long long su1, long long sv0, long long sv1,
    int border_out, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 grid((unsigned)((w + kWarpTile - 1) / kWarpTile),
                  (unsigned)((h + kWarpTile - 1) / kWarpTile));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  bicubic_warp_planes_kernel<<<grid, dim3(kWarpTile, kWarpTile), 0,
                               (cudaStream_t)stream>>>(
      planes, u, v, out, c, h, w, su0, su1, sv0, sv1, border_out);
  return (int)cudaGetLastError();
}
