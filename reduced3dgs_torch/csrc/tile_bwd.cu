// K3 — backward tile walk (f32), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/tile_render.py:468 _bwd_kernel (built at
// :803 _build_bwd), in both feature-table modes: the fast (bf16x2) table
// is unpacked to the same f32 rows outside, and on this card an f32 FFMA
// costs what a bf16 one does, so the TPU kernel's one-pass bf16 MXU
// products (dcol, gc, the fast-mode moments) become plain f32 sums here.
//
// Layout as K2 (csrc/tile_fwd.cu): one 256-thread block per 16x16 tile,
// one thread per pixel, the tile's depth-sorted instance range staged
// through shared memory in 128-instance batches.  Each pixel re-walks its
// instances front to back, exactly as the forward did, carrying T before
// the instance and the running prefix `incl` of w * gc:
//
//   gc = g . rgb,  w = alpha T,  incl += w gc
//   dalpha = gc T - (q - incl) / (1 - alpha),  q = g . C + g_T T_final
//   dpower = op e dalpha   (e = exp(min(power, 0)))
//
// with C and T_final read from the forward's packed output, so no
// back-to-front division by T is needed.  Like the reference (and the TPU
// kernel), neither the 0.99 alpha clamp nor the min(power, 0) clamp is
// gated: dop = sum_p e dalpha.  Per pixel the nine gradients are
//
//   dx = -(cxx dx + cxy dy) dpower   dy = -(cyy dy + cxy dx) dpower
//   dcxx = -dx^2/2 dpower  dcxy = -dx dy dpower  dcyy = -dy^2/2 dpower
//   dop = e dalpha   drgb = w g
//
// (dx, dy = instance centre minus pixel), and each instance's nine sums
// over the tile's 256 pixels are reduced in the block: __shfl_xor_sync
// within a warp (skipped when no lane of the warp blends the instance,
// __any_sync), then the 8 warp partials in shared memory.  Every
// instance belongs to one tile, so each gradient is written once with no
// atomics.  The output is slot-major: slot b owns the record
// dfeat[b * rec .. b * rec + rec) (rec >= 9 floats, a multiple of 4; the
// nine gradients first, zeros after them), so that K5 / K6
// (csrc/seg_reduce.cu) fetch one instance's gradients with 16-byte loads
// from one or two sectors.  A batch's records are contiguous, and the
// store walks them in address order: neighbouring threads write
// neighbouring floats, whole sectors at a time.  Slots the walk never
// reaches (alignment slack, the early-exit tail, everything past *limit)
// are not written and keep the zeros the wrapper allocated.
//
// What bounds it on the card: f32 arithmetic against 67 TFLOP/s — the
// per-pixel re-walk (as K2 per walked pair, plus the gradient terms per
// blended pair) and the per-instance reduction (9 x 5 shuffle-adds per
// warp that blends the instance); see chip_smoke.py K3_OPS_*.  Bytes (the
// 36 B feature row read once, 36 B of gradients written once per
// instance inside its 4 * rec B record, 64 B of per-pixel inputs) are far
// below the memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per block
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 128;          // instances per shared-memory batch
constexpr int kRows = 9;             // x, y, cxx, cxy, cyy, op, r, g, b
constexpr int kPixRows = 8;          // packed per-pixel rows
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1.0e-4f;
constexpr float kPowerEps = 1.0e-3f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
tile_bwd_kernel(const float* __restrict__ feat, long long stride,
                const int* __restrict__ ranges, int num_tiles,
                const int* __restrict__ limit, int grid_x, int width,
                int height, const float* __restrict__ gpix,
                const float* __restrict__ spix, float* __restrict__ dfeat,
                int rec) {
  __shared__ float sm[kRows][kBatch];
  // warp partials, instance-major ([j][row]) so that the store below reads
  // consecutive words for consecutive output floats (no bank conflicts)
  __shared__ float part[kWarps][kBatch * kRows];
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

  const size_t pix = static_cast<size_t>(t) * kPixRows * kPix + tid;
  const float g0 = gpix[pix], g1 = gpix[pix + kPix], g2 = gpix[pix + 2 * kPix];
  const float gT = gpix[pix + 3 * kPix];
  const float q = g0 * spix[pix] + g1 * spix[pix + kPix] +
                  g2 * spix[pix + 2 * kPix] + gT * spix[pix + 3 * kPix];

  bool done = px >= width || py >= height;
  float T = 1.0f;
  float incl = 0.0f;
  float* mine = &part[warp][0];

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
    for (int k = lane; k < kRows * kBatch; k += 32) mine[k] = 0.0f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFull, done)) break;  // warp-uniform
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float dx = sm[0][j] - fx;
        const float dy = sm[1][j] - fy;
        const float cxx = sm[2][j], cxy = sm[3][j], cyy = sm[4][j];
        const float op = sm[5][j];
        const float power = -0.5f * (cxx * dx * dx + cyy * dy * dy) -
                            cxy * dx * dy;
        if (power <= kPowerEps) {
          const float e = expf(fminf(power, 0.0f));
          const float alpha = fminf(kAlphaClamp, op * e);
          if (alpha >= kAlphaMin) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < kTEps) {
              done = true;
            } else {
              contrib = true;
              const float w = alpha * T;
              const float gc = g0 * sm[6][j] + g1 * sm[7][j] + g2 * sm[8][j];
              incl += w * gc;
              const float dalpha = gc * T - (q - incl) / (1.0f - alpha);
              const float dpower = op * e * dalpha;
              v[0] = -(cxx * dx + cxy * dy) * dpower;
              v[1] = -(cyy * dy + cxy * dx) * dpower;
              v[2] = -0.5f * dx * dx * dpower;
              v[3] = -dx * dy * dpower;
              v[4] = -0.5f * dy * dy * dpower;
              v[5] = e * dalpha;
              v[6] = w * g0;
              v[7] = w * g1;
              v[8] = w * g2;
              T = test_t;
            }
          }
        }
      }
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[r] += __shfl_xor_sync(kFull, v[r], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) mine[j * kRows + r] = v[r];
        }
      }
    }
    __syncthreads();
    float* __restrict__ dst = dfeat + static_cast<size_t>(b0) * rec;
    for (int k = tid; k < n * rec; k += kPix) {
      const int j = k / rec;
      const int row = k - j * rec;
      float s = 0.0f;
      if (row < kRows) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][j * kRows + row];
      }
      dst[k] = s;
    }
  }
}

}  // namespace

extern "C" int tile_bwd_launch(const void* feat, long long stride,
                               const void* ranges, int num_tiles,
                               const void* limit, int grid_x, int width,
                               int height, const void* gpix, const void* spix,
                               void* dfeat, int rec, void* stream) {
  if (num_tiles > 0) {
    tile_bwd_kernel<<<num_tiles, kPix, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), stride,
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, width, height,
        static_cast<const float*>(gpix), static_cast<const float*>(spix),
        static_cast<float*>(dfeat), rec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
