// K4's per-point device code, shared by K4's forms (bicubic.cu) and by the
// TV-L1 patch solve K12 (tvl1_patch.cu), which samples its canvases' cells
// exactly as K4's patch form does: one copy, so the two cannot drift.
//
// Semantics (src/bicubic_interpolation.c:146-163): C (int) truncation, sign
// steps sx = sign(uu), sy = sign(vv), the row stencil's first element
// stepping by sx (sic), Neumann clamping with an out-of-domain flag.  Each
// axis's 4 basis coefficients are accumulated onto their clamped offsets in
// one 4-window, then the window is contracted over rows, then over columns,
// with explicit fmaf (the twin's order: faldoi_tpu_torch/ops/bicubic.py).
// Every translation unit that includes this header gets its own internal
// copy (an anonymous namespace).

#pragma once

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

// The 4x4 window at ``win`` (rows ``stride`` floats apart; offsets up to
// 3 * stride + 3 fit an int for every image a 32-bit h * w admits) into
// registers: 16 independent loads, issued before any contraction.
__device__ __forceinline__ void load_window(const float* __restrict__ win,
                                            int stride, float r[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) r[k * 4 + l] = __ldg(win + k * stride + l);
}

// Contract a window held in registers over rows, then over columns, with
// fmaf: the one contraction order of every form and of the twin.
__device__ __forceinline__ float contract_regs(const float r[16],
                                               const float wy[4],
                                               const float wx[4]) {
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float col = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) col = fmaf(wy[k], r[k * 4 + l], col);
    s = fmaf(col, wx[l], s);
  }
  return s;
}

// The window at ``win`` loaded with plain loads and contracted (the flow
// and patch forms: with load_window's __ldg they took 1-9% longer, PERF.md).
__device__ __forceinline__ float contract(const float* win, int stride,
                                          const float wy[4],
                                          const float wx[4]) {
  float r[16];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) r[k * 4 + l] = win[k * stride + l];
  return contract_regs(r, wy, wx);
}

// The patch form's point of one canvas cell (row, col) of a patch whose
// canvas origin is (oy, ox): the cell plus the flow (du, dv) inside the
// valid box, the bare cell outside it (the caller passes 0 there); returns
// the window start and weights as point_weights does.
__device__ __forceinline__ void patch_cell_weights(int oy, int ox, int row,
                                                   int col, float du, float dv,
                                                   int h, int w, int* wx0,
                                                   int* wy0, float wx[4],
                                                   float wy[4]) {
  const float uu = (float)(ox + col) + du;
  const float vv = (float)(oy + row) + dv;
  point_weights(uu, vv, h, w, wx0, wy0, wx, wy);
}

}  // namespace
