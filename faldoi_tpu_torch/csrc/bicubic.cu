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
// The per-point helpers (truncation, weights, contraction, a patch cell's
// point) live in bicubic_common.cuh, which K12 (tvl1_patch.cu) includes too.
//
// Three forms, one thread per sample point each:
// * the point form (bicubic_sample_kernel, bicubic_sample_tiled_kernel)
//   samples given points: a wide 2-D grid of points in 32 x 4 tiles (a
//   warp a row's 32 points), other shapes in a 1-D loop; templated on C <=
//   4 so that a point's C x 16 window loads are in flight together, and at
//   C 1 two points a thread, whose weights then overlap (csrc/variants/
//   k4_variants.cu holds the former form, a 1-D loop that contracted a
//   plane's 16 loads before it issued the next plane's, and the variants
//   that lost; PERF.md the times and what bounds it: the window loads' L1
//   traffic at C 3, the weights at C 1);
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

#include "bicubic_common.cuh"

namespace {

// The point form's work for K points idx[k] of one thread (npts: no
// point): their (uu, vv), their weights, then per group of C planes all
// K x C x 16 window loads, then the contractions.  C is the plane count
// (1-4), or 1 for a run-time count above 4.
template <int C, int K>
__device__ __forceinline__ void sample_points(
    const float* __restrict__ planes, const float* __restrict__ uu,
    const float* __restrict__ vv, float* __restrict__ out, int c, int h,
    int w, long long npts, const long long (&idx)[K], int border_out) {
  float u[K], v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = idx[k] < npts;
    u[k] = ok ? uu[idx[k]] : 0.0f;
    v[k] = ok ? vv[idx[k]] : 0.0f;
  }
  int wx0[K], wy0[K];
  float wx[K][4], wy[K][4];
  bool o[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    o[k] = point_weights(u[k], v[k], h, w, &wx0[k], &wy0[k], wx[k], wy[k]);
  const long long plane = (long long)h * w;
  for (int c0 = 0; c0 < c; c0 += C) {
    float win[K][C][16];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        load_window(planes + (c0 + ch) * plane + (long long)wy0[k] * w + wx0[k],
                    w, win[k][ch]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (idx[k] >= npts) continue;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float r = contract_regs(win[k][ch], wy[k], wx[k]);
        if (border_out && o[k]) r = 0.0f;
        out[(c0 + ch) * npts + idx[k]] = r;
      }
    }
  }
}

// The point form on points without a wide 2-D shape (patch canvases, 1-D
// lists): a 1-D grid-stride loop of 256-thread blocks, K runs of 256 points
// a block step.
template <int C, int K>
__global__ void __launch_bounds__(256)
    bicubic_sample_kernel(const float* __restrict__ planes,
                          const float* __restrict__ uu,
                          const float* __restrict__ vv,
                          float* __restrict__ out, int c, int h, int w,
                          long long npts, int border_out) {
  const long long step = (long long)gridDim.x * blockDim.x * K;
  for (long long b0 = (long long)blockIdx.x * blockDim.x * K + threadIdx.x;
       b0 < npts; b0 += step) {
    long long idx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = b0 + (long long)k * blockDim.x;
      idx[k] = i < npts ? i : npts;
    }
    sample_points<C, K>(planes, uu, vv, out, c, h, w, npts, idx, border_out);
  }
}

// The patch form: one thread per canvas cell of the B patches.  Each
// thread forms its cell's point as the patch solver does (cell + flow inside
// the valid box, the bare cell outside it) and samples it exactly as
// bicubic_sample_kernel does with border_out off.  With a lane index, patch
// k samples the lane[k]-th of L stacks laid lane_stride floats apart (the
// frames of N pairs' 2N growing lanes); its clamp is its own lane's edge.
__global__ void bicubic_patches_kernel(
    const float* __restrict__ planes, const int* __restrict__ oy,
    const int* __restrict__ ox, const int* __restrict__ ph,
    const int* __restrict__ pw, const float* __restrict__ u1,
    const float* __restrict__ u2, const int* __restrict__ lane,
    long long lane_stride, float* __restrict__ out, int c, int h, int w,
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
    int wx0, wy0;
    float wx[4], wy[4];
    patch_cell_weights(oy[k], ox[k], row, col, inbox ? u1[idx] : 0.0f,
                       inbox ? u2[idx] : 0.0f, h, w, &wx0, &wy0, wx, wy);
    const float* src =
        lane != nullptr ? planes + lane[k] * lane_stride : planes;
    for (int ch = 0; ch < c; ++ch)
      out[ch * nout + idx] = contract(
          src + ch * plane + (long long)wy0 * w + wx0, w, wy, wx);
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

// The point form on points with a wide 2-D trailing shape (rows, cols),
// cols >= kPointTileX: a kPointTileX x (kPointTileY K) tile of the points a
// block, K rows kPointTileY apart a thread.  A warp takes 32 consecutive
// points of one row (its (uu, vv) loads one line each, its window loads
// few lines), and the block's rows share their windows' lines in L1; the
// 128-thread blocks spread a launch of less than one wave (a shard's band)
// over more SMs.  A grid-stride loop over the tile rows.
constexpr int kPointTileX = 32;
constexpr int kPointTileY = 4;

template <int C, int K>
__global__ void __launch_bounds__(kPointTileX * kPointTileY)
    bicubic_sample_tiled_kernel(const float* __restrict__ planes,
                                const float* __restrict__ uu,
                                const float* __restrict__ vv,
                                float* __restrict__ out, int c, int h, int w,
                                long long rows, int cols, int border_out) {
  const long long npts = rows * cols;
  const int j = blockIdx.x * kPointTileX + threadIdx.x;
  for (long long i0 = (long long)blockIdx.y * kPointTileY * K + threadIdx.y;
       i0 - threadIdx.y < rows; i0 += (long long)gridDim.y * kPointTileY * K) {
    long long idx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = i0 + (long long)k * kPointTileY;
      idx[k] = (i < rows && j < cols) ? i * cols + j : npts;
    }
    sample_points<C, K>(planes, uu, vv, out, c, h, w, npts, idx, border_out);
  }
}

template <int C, int K>
int launch_sample(const float* planes, const float* uu, const float* vv,
                  float* out, int c, int h, int w, long long rows, int cols,
                  int border_out, cudaStream_t stream) {
  if (rows > 1 && cols >= kPointTileX) {
    long long gy = (rows + kPointTileY * K - 1) / (kPointTileY * K);
    if (gy > 65535) gy = 65535;
    const dim3 grid((unsigned)((cols + kPointTileX - 1) / kPointTileX),
                    (unsigned)gy);
    bicubic_sample_tiled_kernel<C, K><<<grid, dim3(kPointTileX, kPointTileY),
                                        0, stream>>>(planes, uu, vv, out, c,
                                                     h, w, rows, cols,
                                                     border_out);
  } else {
    const long long npts = rows * cols;
    long long blocks = (npts + 256LL * K - 1) / (256LL * K);
    if (blocks > 1048576) blocks = 1048576;
    bicubic_sample_kernel<C, K><<<(unsigned)blocks, 256, 0, stream>>>(
        planes, uu, vv, out, c, h, w, npts, border_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The points are rows x cols, row-major (cols: their trailing extent); the
// launch is tiled when they are a wide 2-D grid, else 1-D.
extern "C" int faldoi_bicubic_sample(const float* planes, const float* uu,
                                     const float* vv, float* out, int c,
                                     int h, int w, long long rows, int cols,
                                     int border_out, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // one plane: the weights dominate, and two points a thread overlap them
  switch (c) {
    case 1:
      return launch_sample<1, 2>(planes, uu, vv, out, c, h, w, rows, cols,
                                 border_out, s);
    case 2:
      return launch_sample<2, 1>(planes, uu, vv, out, c, h, w, rows, cols,
                                 border_out, s);
    case 3:
      return launch_sample<3, 1>(planes, uu, vv, out, c, h, w, rows, cols,
                                 border_out, s);
    case 4:
      return launch_sample<4, 1>(planes, uu, vv, out, c, h, w, rows, cols,
                                 border_out, s);
  }
  return launch_sample<1, 1>(planes, uu, vv, out, c, h, w, rows, cols,
                             border_out, s);
}

// lane: null (one (C', H, W) stack) or (B,) lane indices into L stacks
// lane_stride floats apart.
extern "C" int faldoi_bicubic_sample_patches(
    const float* planes, const int* oy, const int* ox, const int* ph,
    const int* pw, const float* u1, const float* u2, const int* lane,
    long long lane_stride, float* out, int c, int h, int w, int b, int p,
    void* stream) {
  if (b <= 0) return 0;
  if (c < 1 || p < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = ((long long)b * p * p + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  bicubic_patches_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(planes, oy, ox, ph, pw, u1,
                                                   u2, lane, lane_stride, out,
                                                   c, h, w, b, p);
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
