// K4 — per-instance transmittance statistics (f32), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/tile_render.py:674 _trans_kernel (built at
// :825 _build_trans): the inference-only walk that feeds adaptive SH-band
// culling.  For every instance slot it gives
//
//   trans_sum = sum over the tile's pixels that blend the instance of the
//               pixel's transmittance T *before* that blend
//   touched   = the number of those pixels
//
// The TPU kernel takes both as column sums of its (256, 128) chunk state
// on the vector unit.  Here the walk is K2's (csrc/tile_fwd.cu), line for
// line: one 256-thread block per 16x16 tile, one thread per pixel, the
// tile's depth-sorted instance range staged through shared memory in
// 128-instance batches, and per pixel
//
//   power = -0.5 (cxx dx^2 + cyy dy^2) - cxy dx dy,  d = mean - pixel
//   skip if power > POWER_EPS (1e-3); alpha = min(0.99, op e^min(power,0))
//   skip if alpha < 1/255; stop once T (1 - alpha) < 1e-4 (that pair adds
//   nothing); else the pair blends: it adds T to the instance's sum and 1
//   to its count, and T *= 1 - alpha.
//
// What is new is the reduction over the tile's pixels per instance.  Of
// the two values one is a count, so a warp needs one __ballot_sync: its
// __popc is the warp's count, and it says whether any lane blends at all —
// only then does the warp run the 5-step __shfl_xor_sync sum of T.  The 8
// warp partials meet in shared memory and are summed once per batch.
// Every instance belongs to one tile, so each slot is written once, with
// no atomics, and the result does not depend on scheduling.  Slots the
// walk never reaches (alignment slack, the tail after the block's early
// exit, everything at or past *limit) are not written and keep the zeros
// the wrapper allocated.
//
// Output (2, B_pad) f32 rows [trans_sum, touched]; a count is at most 256
// and exact in f32.  Only feature rows 0..5 are read (no colours).
//
// What bounds it on the card: f32 arithmetic against 67 TFLOP/s — K2's 26
// operations per walked (pixel, instance) pair, a few per blended pair
// and the shuffle adds of the warps that blend an instance (see
// chip_smoke.py K4_OPS_*).  Bytes (24 B of features read per instance,
// 8 B written per slot) are far below the memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 128;          // instances per shared-memory batch
constexpr int kRows = 6;             // x, y, cxx, cxy, cyy, op
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1.0e-4f;
constexpr float kPowerEps = 1.0e-3f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
tile_trans_kernel(const float* __restrict__ feat, long long stride,
                  const int* __restrict__ ranges, int num_tiles,
                  const int* __restrict__ limit, int grid_x, int width,
                  int height, float* __restrict__ out, long long ostride) {
  __shared__ float sm[kRows][kBatch];
  __shared__ float psum[kWarps][kBatch];
  __shared__ int pcnt[kWarps][kBatch];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = (t % grid_x) * kTile + (tid % kTile);
  const int py = (t / grid_x) * kTile + (tid / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[t];
  const int end = min(ranges[num_tiles + t], *limit);

  bool done = px >= width || py >= height;
  float T = 1.0f;

  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier that keeps the previous batch (features and warp
    // partials) alive until every thread has finished with it
    if (__syncthreads_count(done) == kPix) break;
    const int n = min(kBatch, end - b0);
    for (int k = tid; k < kRows * kBatch; k += kPix) {
      const int row = k / kBatch;
      const int j = k % kBatch;
      if (j < n) sm[row][j] = feat[row * stride + b0 + j];
    }
    for (int k = lane; k < kBatch; k += 32) {
      psum[warp][k] = 0.0f;
      pcnt[warp][k] = 0;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFull, done)) break;  // warp-uniform
      float v = 0.0f;
      bool contrib = false;
      if (!done) {
        const float dx = sm[0][j] - fx;
        const float dy = sm[1][j] - fy;
        const float power =
            -0.5f * (sm[2][j] * dx * dx + sm[4][j] * dy * dy) -
            sm[3][j] * dx * dy;
        if (power <= kPowerEps) {
          const float alpha =
              fminf(kAlphaClamp, sm[5][j] * expf(fminf(power, 0.0f)));
          if (alpha >= kAlphaMin) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < kTEps) {
              done = true;
            } else {
              contrib = true;
              v = T;
              T = test_t;
            }
          }
        }
      }
      const unsigned hit = __ballot_sync(kFull, contrib);
      if (hit != 0u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        if (lane == 0) {
          psum[warp][j] = v;
          pcnt[warp][j] = __popc(hit);
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < 2 * kBatch; k += kPix) {
      const int row = k / kBatch;
      const int j = k % kBatch;
      if (j < n) {
        float s = 0.0f;
        if (row == 0) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += psum[w][j];
        } else {
          int c = 0;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) c += pcnt[w][j];
          s = static_cast<float>(c);
        }
        out[row * ostride + b0 + j] = s;
      }
    }
  }
}

}  // namespace

extern "C" int tile_trans_launch(const void* feat, long long stride,
                                 const void* ranges, int num_tiles,
                                 const void* limit, int grid_x, int width,
                                 int height, void* out, long long ostride,
                                 void* stream) {
  if (num_tiles > 0) {
    tile_trans_kernel<<<num_tiles, kPix, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), stride,
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, width, height,
        static_cast<float*>(out), ostride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
