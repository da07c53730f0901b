// K4: per-point bicubic sampling with the reference's C semantics.
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
// One thread per sample point; the weights are computed once and shared by
// the C planes.  Bound by the 16 scattered reads per point and plane, which
// neighbouring threads mostly share through L1/L2.

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
  w[0] = w[1] = w[2] = w[3] = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int rel = min(max(cl[e] - st, 0), 3);
    w[rel] = w[rel] + a[e];
  }
  *start = st;
  return out;
}

__global__ void bicubic_sample_kernel(const float* __restrict__ planes,
                                      const float* __restrict__ uu,
                                      const float* __restrict__ vv,
                                      float* __restrict__ out, int c, int h,
                                      int w, long long npts, int border_out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < npts; idx += step) {
    const float u = uu[idx];
    const float v = vv[idx];
    const int sx = u < 0.0f ? -1 : 1;
    const int sy = v < 0.0f ? -1 : 1;
    const int iu = trunc_int(u);
    const int iv = trunc_int(v);
    const int ex[4] = {iu - sx, iu, iu + sx, iu + 2 * sx};
    const int ey[4] = {iv - sx, iv, iv + sy, iv + 2 * sy};  // sic: sx
    int wx0, wy0;
    float wx[4], wy[4];
    bool o = axis_weights(ex, sx > 0 ? iu - 1 : iu - 2, true, w, u, &wx0, wx);
    o = axis_weights(ey, 0, false, h, v, &wy0, wy) || o;
    const long long plane = (long long)h * w;
    for (int ch = 0; ch < c; ++ch) {
      const float* img = planes + ch * plane;
      const float* win = img + (long long)wy0 * w + wx0;
      float r = 0.0f;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float col = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) col = fmaf(wy[k], win[(long long)k * w + l], col);
        r = fmaf(col, wx[l], r);
      }
      if (border_out && o) r = 0.0f;
      out[ch * npts + idx] = r;
    }
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
