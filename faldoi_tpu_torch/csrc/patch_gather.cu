// K0: batched patch crop.
//
// Replaces faldoi_tpu/ops/pallas_sweep.py::_pallas_gather_patches (the
// Pallas kernel Mosaic rejected) and its live XLA form, the vmapped
// lax.dynamic_slice of _xla_gather_patches.
//
// out[r, c, ch, k] = stack[y0(k) + r, x0(k) + c, ch], with the start taken
// as lax.dynamic_slice takes it: a negative start counts from the end, then
// y0 = clamp(oy[k], 0, hp - p), x0 = clamp(ox[k], 0, wp - p).  A pure copy:
// bit-identical to the twin.
//
// Bound: device-memory traffic and launch latency.  One thread per output
// element, the batch index fastest, so a warp writes 128 contiguous bytes;
// the reads of one window row are p*C contiguous floats of the stack.

#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ stack,
                                      const int* __restrict__ oy,
                                      const int* __restrict__ ox,
                                      float* __restrict__ out, int hp, int wp,
                                      int c, int b, int p) {
  const long long total = (long long)p * p * c * b;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const int lane = (int)(e % b);
    long long rest = e / b;
    const int ch = (int)(rest % c);
    rest /= c;
    const int col = (int)(rest % p);
    const int row = (int)(rest / p);
    const int sy = oy[lane] < 0 ? oy[lane] + hp : oy[lane];
    const int sx = ox[lane] < 0 ? ox[lane] + wp : ox[lane];
    const int y0 = min(max(sy, 0), hp - p);
    const int x0 = min(max(sx, 0), wp - p);
    out[e] = stack[((long long)(y0 + row) * wp + (x0 + col)) * c + ch];
  }
}

}  // namespace

extern "C" int faldoi_gather_patches(const float* stack, const int* oy,
                                     const int* ox, float* out, int hp,
                                     int wp, int c, int b, int p,
                                     void* stream) {
  const long long total = (long long)p * p * c * b;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  gather_patches_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(stack, oy, ox, out, hp, wp,
                                                  c, b, p);
  return (int)cudaGetLastError();
}
