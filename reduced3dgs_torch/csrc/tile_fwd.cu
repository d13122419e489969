// K2 — forward tile compositing (f32), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/tile_render.py:324 _fwd_kernel (built at
// :783 _build_fwd) in its f32 mode (fast=False).  The TPU kernel walks
// every tile in one grid step and turns the per-pixel recurrence into MXU
// work (a quadratic-basis matmul for the exponent, a log-space triangular
// matmul scan for T, a matmul for the colour sum).  On Hopper the plain
// per-pixel loop is the natural form, as in the original 3DGS renderCUDA:
// one block per 16x16 tile, one thread per pixel, and the tile's
// depth-sorted instance range staged through shared memory in batches
// (the range is a multiple of 128 instances, the binning alignment, so a
// batch never crosses tiles), each instance gathered from binning's
// depth-rank feature table through its slot's rank as it is staged.
// Each pixel blends its batch sequentially in f32:
//
//   power = -0.5 (cxx dx^2 + cyy dy^2) - cxy dx dy,  d = mean - pixel
//   skip if power > POWER_EPS (1e-3); alpha = min(0.99, op e^min(power,0))
//   skip if alpha < 1/255; stop once T (1 - alpha) < 1e-4
//   C += c alpha T;  T *= 1 - alpha
//
// Block t walks the tile base + t of the image (base = r0 * grid_x for a
// strip of tile rows from r0, 0 for the whole frame; the ranges and the
// output are the window's, indexed by t), as _tile_info(base + t) does in
// the TPU kernel.  Pixels outside the image start done; the block leaves
// its range once every pixel is done (__syncthreads_count).  Empty tiles write colour 0
// and T 1; the background is added outside.  Instances at or past
// *limit (min(total_padded, B_pad)) are never read.
//
// Output (num_tiles, 8, 256) f32 rows [r, g, b, T_final, 0, 0, 0, 0],
// indexed by the pixel.  Accumulation is f32 in both staging modes
// (exact, and quantised as the bf16x2 table: csrc/tile_walk.cuh).
//
// What bounds it on the card (measured on an H100, PERF.md): neither
// bytes (a 4 B rank and a 36 B row an instance, read once per tile) nor
// f32 arithmetic as such, but the SM's scheduler slots.  A warp dispatches
// every instruction of a (warp, instance) pair while any of its 32 pixels
// is alive, so the cost is warp pairs times instructions per pair; the
// operation bound in chip_smoke.py (K2_OPS_*: pixel pairs times the
// arithmetic of the walk) would be reached only with every lane live and
// nothing dispatched but arithmetic.  Lane utilisation is high already
// (86 % of the lanes of a dispatched pair are live with two-row warps,
// 90 % with 8x4), so what counts is the instructions: the loop below
// compiles to 21 per walked pair and 12 more per blending one
// (cuobjdump -sass), and runs at about three quarters of the schedulers'
// rate.  What the design does (csrc/tile_walk.cuh has the shared parts):
//   * a batch is staged instance-major as float4, so a walked pair costs
//     two shared-memory loads, not six;
//   * the conic is pre-scaled by log2(e) at staging and the exponent is
//     one ex2.approx, not expf's range reduction; the two skip tests fold
//     into one branch;
//   * a warp covers a compact 8x4 pixel block, so that its lanes stop
//     together and fewer warp pairs are dispatched;
//   * batches of 64, so that a block stops staging sooner after its last
//     pixel is done.
// Tried, measured slower and taken out again (PERF.md has the times): two
// or four pixels per thread (one load of an instance serves several
// pixels, but the lanes idle more and each pixel's blend is its own
// divergent branch), a second buffer filled with the next batch's loads
// while this one is walked, a grid of resident blocks that take tiles
// from an atomic counter, and unrolling; other blocks on the SM hide a
// block's loads already.

#include "tile_walk.cuh"

#ifndef TILE_FWD_BATCH
#define TILE_FWD_BATCH 64  // instances per shared-memory batch
#endif
#ifndef TILE_FWD_MIN_WARPS
#define TILE_FWD_MIN_WARPS 48  // warps per SM the register budget allows
#endif

namespace {

using namespace walk;

constexpr int kThreads = kPix;  // one pixel per thread
constexpr int kMinBlocks = TILE_FWD_MIN_WARPS * 32 / kThreads;
constexpr int kBatch = TILE_FWD_BATCH;
static_assert(128 % kBatch == 0, "a batch must not cross a 128-slot chunk");
using Stager = Stage<kBatch, kThreads>;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_fwd_kernel(const Rows rows, const int* __restrict__ ranges,
                int num_tiles, const int* __restrict__ limit, int grid_x,
                int base, int width, int height, float* __restrict__ out) {
  __shared__ float4 sm[3][kBatch];
  const int t = blockIdx.x;
  // the tile's place in the image, unsigned as blockIdx.x: the
  // division by grid_x below stays the unsigned one
  const unsigned tile = static_cast<unsigned>(base) + blockIdx.x;
  const int tid = threadIdx.x;
  const int p = pixel_of(tid >> 5, tid & 31);
  const int px = (tile % grid_x) * kTile + (p % kTile);
  const int py = (tile / grid_x) * kTile + (p / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[t];
  const int end = min(ranges[num_tiles + t], *limit);

  bool done = px >= width || py >= height;
  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  float4 regs[Stager::kIters];

  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier that keeps the previous batch alive until every
    // thread has finished reading it
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, end - b0);
    Stager::load(regs, rows, b0, n, tid);
    Stager::store(sm, regs, n, tid);
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float4 a = sm[0][j];
      const float2 b = *reinterpret_cast<const float2*>(&sm[1][j]);
      float alpha;
      if (!pair_alpha(a, b, fx, fy, alpha)) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTEps) {
        done = true;
        break;
      }
      const float4 c = sm[2][j];
      const float w = alpha * T;
      c0 = fmaf(c.x, w, c0);
      c1 = fmaf(c.y, w, c1);
      c2 = fmaf(c.z, w, c2);
      T = test_t;
    }
  }

  float* o = out + static_cast<size_t>(t) * kPixRows * kPix + p;
  o[0 * kPix] = c0;
  o[1 * kPix] = c1;
  o[2 * kPix] = c2;
  o[3 * kPix] = T;
#pragma unroll
  for (int r = 4; r < kPixRows; ++r) o[r * kPix] = 0.0f;
}

}  // namespace

extern "C" int tile_fwd_launch(const void* feat, const void* rank,
                               int num_p, int quantised,
                               const void* ranges, int num_tiles,
                               const void* limit, int grid_x, int base,
                               int width, int height, void* out,
                               void* stream) {
  if (num_tiles > 0) {
    tile_fwd_kernel<<<num_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        walk::Rows{static_cast<const float*>(feat),
                   static_cast<const int*>(rank), num_p, quantised},
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, base, width, height,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
