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
// on the vector unit.  Here the walk is K2's (csrc/tile_fwd.cu, on the
// shared csrc/tile_walk.cuh): one 256-thread block per 16x16 tile, one
// pixel per thread, 32 lanes on a compact 8x4 pixel block (walk::pixel_of),
// the tile's depth-sorted instance range staged through shared memory in
// batches, instance-major as two float4 per instance ((x, y, a, b) and
// (c, op, ...): no colours), the conic pre-scaled by log2(e), and per pixel
// the blend decision of K2 itself (walk::pair_alpha: the power, one
// ex2.approx under WALK_EXP2, the merged skip test), then
//
//   stop once T (1 - alpha) < 1e-4 (that pair adds nothing); else the
//   pair blends: it adds T to the instance's sum and 1 to its count, and
//   T *= 1 - alpha.
//
// So K4's touched counts exactly the blends K2 composites, whatever
// WALK_EXP2 says.
//
// The reduction over the tile's pixels per instance.  The loop over a
// batch is warp-uniform: it leaves once every lane of the warp is done
// (__all_sync, asked every TILE_TRANS_UNROLL instances), and every lane
// evaluates every pair, a done lane's result masked, so no branch splits
// the warp.  Of the two values one is a count, so a warp needs one
// __ballot_sync per instance: its __popc is the warp's count, and it says
// whether any lane blends at all.  Only then does the warp sum T, in fixed
// point: T in [0, 1] becomes the integer round(T 2^22) (one FFMA against a
// magic constant), and one __reduce_add_sync sums the 32 lanes exactly,
// in any order; lane 0 stores (sum, count) to the warp's partials in
// shared memory.  The 8 warps' partials are zeroed at the start of a batch
// and summed once at its end, again exactly (at most 256 2^22 = 2^30),
// and turned into f32 once (trans_sum is then within 256 2^-23 ~ 3e-5 of
// the exact sum of the f32 T values).  Every instance belongs to one tile,
// so each slot is written once, with no atomics, and two launches give the
// same bits.  Slots the walk never reaches (alignment slack, the batches
// after the block's early exit, everything at or past *limit) are not
// written and keep the zeros the wrapper allocated; within a walked batch
// the slots after a warp's exit get its zeroed partials.
//
// Output (2, B_pad) f32 rows [trans_sum, touched]; a count is at most 256
// and exact in f32.  Only feature rows 0..5 are read (no colours).
//
// What bounds it on the card (measured on an H100, PERF.md): as K2, the
// SM's scheduler slots, not bytes (24 B of features read per instance, 8 B
// written per slot) and not the f32 arithmetic the operation bound counts
// (chip_smoke.py K4_OPS_*: the walk's 14 operations per walked pair, 5 per
// blended pair).  A walked warp pair dispatches K2's decision plus the T
// update, the masks and the ballot; a warp that blends an instance adds
// the fixed-point sum and the partials' store (cuobjdump -sass: about 30
// and 11).  What the design does: the shared walk and staging (two float4
// an instance), no branch around a lane, the all-done vote once per four
// instances, the REDUX sum in place of a 5-step shuffle butterfly (5 SHFL
// and 5 FADD), batches of 128.  Tried and slower (PERF.md has the times):
// the f32 shuffle butterfly, a vote per instance, batches of 32 and 64,
// 16x2 and 4x8 blocks, 32 or 64 warps per SM.

#include "tile_walk.cuh"

#ifndef TILE_TRANS_BATCH
#define TILE_TRANS_BATCH 128  // instances per shared-memory batch
#endif
#ifndef TILE_TRANS_MIN_WARPS
#define TILE_TRANS_MIN_WARPS 48  // warps per SM the register budget allows
#endif
#ifndef TILE_TRANS_UNROLL
#define TILE_TRANS_UNROLL 4  // instances walked between two all-done votes
#endif

namespace {

using namespace walk;

constexpr int kThreads = kPix;  // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = TILE_TRANS_MIN_WARPS * 32 / kThreads;
constexpr int kBatch = TILE_TRANS_BATCH;
static_assert(128 % kBatch == 0, "a batch must not cross a 128-slot chunk");
static_assert(kBatch <= kThreads, "one thread sums one instance");
constexpr int kUnroll = TILE_TRANS_UNROLL;
static_assert(kBatch % kUnroll == 0, "the walk steps inside a batch");
using Stager = Stage<kBatch, kThreads, 2>;

// A warp's partial of one instance: the sum of T in units of 2^-22, and
// the count.
struct Part {
  unsigned t;
  int n;
};

// T in [0, 1]: fmaf(T, 2^22, 1.5 2^23) lands in [2^23, 2^24], where a
// float's ulp is 1, so its bits are kMagicBits + round(T 2^22) (also at
// T = 1: 2^24 is 0x4B800000).  The lanes' sum wraps modulo 2^32 and the
// 32 magic terms are taken off again.
constexpr float kFix = 4194304.0f;  // 2^22
constexpr float kMagic = 12582912.0f;  // 1.5 2^23
constexpr unsigned kMagicBits = 0x4B400000u;

__device__ __forceinline__ unsigned warp_sum(float v) {
  const unsigned q = __float_as_uint(fmaf(v, kFix, kMagic));
  return __reduce_add_sync(kFull, q) - 32u * kMagicBits;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_trans_kernel(const float* __restrict__ feat, long long stride,
                  const int* __restrict__ ranges, int num_tiles,
                  const int* __restrict__ limit, int grid_x, int base,
                  int width, int height, float* __restrict__ out,
                  long long ostride) {
  __shared__ float4 sm[2][kBatch];
  __shared__ Part part[kWarps][kBatch];
  const int t = blockIdx.x;
  const unsigned tile = static_cast<unsigned>(base) + blockIdx.x;  // K2's
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = pixel_of(warp, lane);
  const int px = (tile % grid_x) * kTile + (p % kTile);
  const int py = (tile / grid_x) * kTile + (p / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[t];
  const int end = min(ranges[num_tiles + t], *limit);

  bool done = px >= width || py >= height;
  float T = 1.0f;
  float4 regs[Stager::kIters];

  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier that keeps the previous batch (features and warp
    // partials) alive until every thread has finished with it
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, end - b0);
    Stager::load(regs, feat, stride, b0, n, tid);
    for (int k = lane; k < kBatch; k += 32) part[warp][k] = Part{0u, 0};
    Stager::store(sm, regs, n, tid);
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      if (__all_sync(kFull, done)) break;  // warp-uniform
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        // every lane evaluates the pair (no branch around a done lane, or
        // around a slot past n, whose stale features no lane blends);
        // K2's decision, then its stop test
        float alpha;
        const bool blend =
            pair_alpha(sm[0][j],
                       *reinterpret_cast<const float2*>(&sm[1][j]), fx, fy,
                       alpha) &&
            !done && (kUnroll == 1 || j < n);
        const float test_t = T * (1.0f - alpha);
        const bool stop = blend && test_t < kTEps;
        const bool contrib = blend && !stop;
        const float v = contrib ? T : 0.0f;
        T = contrib ? test_t : T;
        done = done || stop;
        const unsigned hit = __ballot_sync(kFull, contrib);
        if (hit != 0u) {
          const unsigned sum = warp_sum(v);
          if (lane == 0) part[warp][j] = Part{sum, __popc(hit)};
        }
      }
    }
    __syncthreads();
    if (tid < n) {
      Part s = part[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        s.t += part[w][tid].t;
        s.n += part[w][tid].n;
      }
      out[b0 + tid] = __uint2float_rn(s.t) * (1.0f / kFix);
      out[ostride + b0 + tid] = static_cast<float>(s.n);
    }
  }
}

}  // namespace

extern "C" int tile_trans_launch(const void* feat, long long stride,
                                 const void* ranges, int num_tiles,
                                 const void* limit, int grid_x, int base,
                                 int width, int height, void* out,
                                 long long ostride,
                                 void* stream) {
  if (num_tiles > 0) {
    tile_trans_kernel<<<num_tiles, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), stride,
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, base, width, height,
        static_cast<float*>(out), ostride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
