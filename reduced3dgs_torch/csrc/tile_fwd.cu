// K2 — forward tile compositing (f32), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/tile_render.py:324 _fwd_kernel (built at
// :783 _build_fwd) in its f32 mode (fast=False).  The TPU kernel walks
// every tile in one grid step and turns the per-pixel recurrence into MXU
// work (a quadratic-basis matmul for the exponent, a log-space triangular
// matmul scan for T, a matmul for the colour sum).  On Hopper the plain
// per-pixel loop is the natural form, as in the original 3DGS renderCUDA:
// one 256-thread block per 16x16 tile, one thread per pixel, and the
// tile's depth-sorted instance range staged through shared memory in
// 128-instance batches (K = 128, the binning alignment, so a batch never
// crosses tiles).  Each pixel blends its batch sequentially in f32:
//
//   power = -0.5 (cxx dx^2 + cyy dy^2) - cxy dx dy,  d = mean - pixel
//   skip if power > POWER_EPS (1e-3); alpha = min(0.99, op e^min(power,0))
//   skip if alpha < 1/255; stop once T (1 - alpha) < 1e-4
//   C += c alpha T;  T *= 1 - alpha
//
// Pixels outside the image start done; the block leaves its range once
// every pixel is done (__syncthreads_count).  Empty tiles write colour 0
// and T 1; the background is added outside.  Instances at or past
// *limit (min(total_padded, B_pad)) are never read.
//
// Output (num_tiles, 8, 256) f32 rows [r, g, b, T_final, 0, 0, 0, 0].
// No fast-math: expf, so the exponent differs from the JAX kernel's by
// rounding only.
//
// What bounds it on the card: f32 arithmetic against 67 TFLOP/s, 26
// operations per walked (pixel, instance) pair and 10 more per blended
// one (counted in this loop's SASS, see chip_smoke.py K2_OPS_*); the
// feature bytes (36 B per instance, read once per tile) are far below the
// memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kBatch = 128;          // instances per shared-memory batch
constexpr int kRows = 9;             // x, y, cxx, cxy, cyy, op, r, g, b
constexpr int kOutRows = 8;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1.0e-4f;
constexpr float kPowerEps = 1.0e-3f;

__global__ void __launch_bounds__(kPix)
tile_fwd_kernel(const float* __restrict__ feat, long long stride,
                const int* __restrict__ ranges, int num_tiles,
                const int* __restrict__ limit, int grid_x, int width,
                int height, float* __restrict__ out) {
  __shared__ float sm[kRows][kBatch];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (t % grid_x) * kTile + (tid % kTile);
  const int py = (t / grid_x) * kTile + (tid / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[t];
  const int end = min(ranges[num_tiles + t], *limit);

  bool done = px >= width || py >= height;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;

  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier that keeps the previous batch alive until every
    // thread has finished reading it
    if (__syncthreads_count(done) == kPix) break;
    const int n = min(kBatch, end - b0);
    for (int k = tid; k < kRows * kBatch; k += kPix) {
      const int row = k / kBatch;
      const int lane = k % kBatch;
      if (lane < n) sm[row][lane] = feat[row * stride + b0 + lane];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float dx = sm[0][j] - fx;
        const float dy = sm[1][j] - fy;
        const float power =
            -0.5f * (sm[2][j] * dx * dx + sm[4][j] * dy * dy) -
            sm[3][j] * dx * dy;
        if (power > kPowerEps) continue;
        const float alpha =
            fminf(kAlphaClamp, sm[5][j] * expf(fminf(power, 0.0f)));
        if (alpha < kAlphaMin) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        c0 += sm[6][j] * w;
        c1 += sm[7][j] * w;
        c2 += sm[8][j] * w;
        T = test_t;
      }
    }
  }

  float* o = out + static_cast<size_t>(t) * kOutRows * kPix + tid;
  o[0 * kPix] = c0;
  o[1 * kPix] = c1;
  o[2 * kPix] = c2;
  o[3 * kPix] = T;
#pragma unroll
  for (int r = 4; r < kOutRows; ++r) o[r * kPix] = 0.0f;
}

}  // namespace

extern "C" int tile_fwd_launch(const void* feat, long long stride,
                               const void* ranges, int num_tiles,
                               const void* limit, int grid_x, int width,
                               int height, void* out, void* stream) {
  if (num_tiles > 0) {
    tile_fwd_kernel<<<num_tiles, kPix, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), stride,
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, width, height,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
