// The tile walk K2 (tile_fwd.cu), K3 (tile_bwd.cu) and K4 (tile_trans.cu)
// share, for Hopper (sm_90a): the pixel a thread owns, the staging of a
// batch of instances into shared memory, the exponent and the blend
// decision.
//
// Pixel to thread.  A block owns one 16x16 tile.  32 pixels that walk in
// lockstep (one per lane) cover a compact kWarpW x kWarpH block of the
// tile (8 x 4 by default) rather than two 16-pixel rows: they see nearly
// the same splats, so they saturate at nearly the same depth, leave the
// walk earlier and idle less on the way (the share of live lanes per
// dispatched (warp, instance) pair is what chip_smoke.py prints as lane
// utilisation).  A thread owns P pixels (K2 and K4 one; K3 1, 2 or 4), the
// same lane of P neighbouring such blocks, so a warp covers 32 P pixels
// and a tile takes 256 / P threads: one shared-memory load of an instance
// then serves P pixels.  Outputs and per-pixel inputs are indexed by the
// pixel (py * 16 + px), not by the thread.
//
// Staging.  An instance's features live in binning's depth-rank table
// ((P, 9) f32 rows x, y, cxx, cxy, cyy, op, r, g, b, `feat_rank`), and slot
// s of the aligned layout holds depth rank gauss_aligned[s]; no
// slot-ordered copy of the table is made.  The walk wants everything one
// instance needs in as few shared-memory loads as possible, so a batch is
// staged instance-major as up to three float4 per instance,
//
//   sm[0][j] = (x, y, a, b)       a = -L/2 cxx, b = -L cxy
//   sm[1][j] = (c, op, cxx, cxy)  c = -L/2 cyy
//   sm[2][j] = (r, g, b, cyy)
//
// so a walked pair costs one LDS.128 and one LDS.64 (all lanes of a warp
// read the same address: a broadcast) where six LDS.32 were dispatched before,
// and a blended pair of K2 / K3 one more LDS.128 (K4, which needs no
// colour, stages only the first two).  Each staging thread stages one
// float4 of one slot: it reads the slot's rank (neighbouring threads,
// neighbouring slots: one coalesced load a warp), then the four values
// from that row of the table (__ldg: the three float4 of a row come from
// the same sectors), and writes them with one conflict-free 16-byte store.
// A rank outside [0, P) (the pad sentinel 2^31 - 1) reads row 0, as
// BinningOut.gauss_id() does; a walk reads only slots inside the tiles'
// ranges, but under slack overflow (total_padded > B_pad, redone by the
// host) those may hold pads.  With `quantised` (grad_reduce bf16x2) the
// opacity and blue are staged as the packed table of the JAX package
// carries them: opacity as u16 fixed point, rint(op 65535) clamped to
// [0, 65535] times 1/65535, blue rounded to bf16 (nearest even) and
// widened; the other columns pass through.  L = log2(e) (kExp2) folds the
// exponent's change of base into the conic once per instance:
//
//   L power = dx (a dx + b dy) + c dy^2,   e^power = 2^(L power)
//
// and the exponent is one MUFU.EX2 (ex2.approx.ftz, 2 ulp) instead of
// expf's range reduction (about ten instructions).  The skip test
// power > POWER_EPS becomes L power > L POWER_EPS.  The raw conic rides
// along in the spare lanes for K3's per-instance epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WALK_WARP_W
#define WALK_WARP_W 8  // pixels per warp row: 16 (16x2), 8 (8x4) or 4 (4x8)
#endif
#ifndef WALK_EXP2
#define WALK_EXP2 1  // 1: pre-scaled conic + ex2.approx; 0: expf
#endif

namespace walk {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // pixels per tile
constexpr int kRows = 9;             // x, y, cxx, cxy, cyy, op, r, g, b
constexpr int kPixRows = 8;          // packed per-pixel rows
constexpr int kWarpW = WALK_WARP_W;
constexpr int kWarpH = 32 / kWarpW;
static_assert(kWarpW == 4 || kWarpW == 8 || kWarpW == 16,
              "a warp covers 4x8, 8x4 or 16x2 pixels");
constexpr bool kExp2 = WALK_EXP2 != 0;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = kExp2 ? kLog2e : 1.0f;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1.0e-4f;
constexpr float kPowerEps = 1.0e-3f * kScale;  // on the scaled power
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBlocksPerRow = kTile / kWarpW;  // pixel blocks side by side

// The tile pixel (py * 16 + px) of lane `lane` of 32-pixel block `block`
// (0 .. 7, row-major over the tile).
__device__ __forceinline__ int pixel_of(int block, int lane) {
  const int x = (block % kBlocksPerRow) * kWarpW + (lane % kWarpW);
  const int y = (block / kBlocksPerRow) * kWarpH + (lane / kWarpW);
  return y * kTile + x;
}

// A thread with P pixels owns lane `lane` of blocks warp * P + k, k < P;
// pixel k lies (pixel_dx(k), pixel_dy(k)) from pixel 0, whatever the
// warp: P and the blocks per row are powers of two.
__host__ __device__ constexpr int pixel_dx(int k) {
  return (k % kBlocksPerRow) * kWarpW;
}
__host__ __device__ constexpr int pixel_dy(int k) {
  return (k / kBlocksPerRow) * kWarpH;
}

// 2^x for x <= 0 (kExp2) or e^x.
__device__ __forceinline__ float exp_scaled(float x) {
  if constexpr (kExp2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return expf(x);
  }
}

// 1 / x for a normal x (one MUFU.RCP, no range handling).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The scaled power of one (pixel, instance) pair from sm[0][j] and c.
__device__ __forceinline__ float scaled_power(const float4 a, float c,
                                              float dx, float dy) {
  return fmaf(dx, fmaf(a.z, dx, a.w * dy), (c * dy) * dy);
}

// The blend decision of one (pixel, instance) pair, K2's and K4's: from
// sm[0][j] = a and the first half of sm[1][j] = b, the pair's alpha, and
// false where the pair is skipped (the power above POWER_EPS or alpha
// below 1/255).  Both walks take it, so K4 counts the blends K2 composites.
__device__ __forceinline__ bool pair_alpha(const float4 a, const float2 b,
                                           float fx, float fy,
                                           float& alpha) {
  const float dx = a.x - fx;
  const float dy = a.y - fy;
  const float power = scaled_power(a, b.x, dx, dy);
  alpha = fminf(kAlphaClamp, b.y * exp_scaled(fminf(power, 0.0f)));
  return !(power > kPowerEps || alpha < kAlphaMin);
}

// Where a walk stages its instances from: row rank[slot] of the
// depth-rank table feat (num_p rows of kRows f32), quantised or not.
struct Rows {
  const float* feat;
  const int* rank;
  int num_p;
  int quantised;
};

// The table row of slot `slot`: its rank, or 0 for a rank outside [0, P).
__device__ __forceinline__ int row_of(const Rows& rows, int slot) {
  const int r = __ldg(rows.rank + slot);
  return static_cast<unsigned>(r) < static_cast<unsigned>(rows.num_p) ? r
                                                                     : 0;
}

// The opacity the bf16x2 table carries: u16 fixed point, through the
// integer (so -0.0 becomes 0), with no FMA contraction, as the torch ops
// of the table's plain twin.
__device__ __forceinline__ float quantised_opacity(float op) {
  const float r =
      fminf(fmaxf(rintf(__fmul_rn(op, 65535.0f)), 0.0f), 65535.0f);
  return __fmul_rn(static_cast<float>(static_cast<int>(r)),
                   static_cast<float>(1.0 / 65535.0));
}

// Blue as the bf16x2 table carries it: rounded to bf16, widened.
__device__ __forceinline__ float quantised_blue(float b) {
  return __bfloat162float(__float2bfloat16_rn(b));
}

// One of the three float4 of the instance in table row `row`.
__device__ __forceinline__ float4 stage_load(const Rows& rows, int row,
                                             int which) {
  const float* p = rows.feat + static_cast<size_t>(row) * kRows;
  float4 v;
  if (which == 0) {
    v.x = __ldg(p);
    v.y = __ldg(p + 1);
    v.z = (-0.5f * kScale) * __ldg(p + 2);
    v.w = -kScale * __ldg(p + 3);
  } else if (which == 1) {
    v.x = (-0.5f * kScale) * __ldg(p + 4);
    const float op = __ldg(p + 5);
    v.y = rows.quantised ? quantised_opacity(op) : op;
    v.z = __ldg(p + 2);
    v.w = __ldg(p + 3);
  } else {
    v.x = __ldg(p + 6);
    v.y = __ldg(p + 7);
    const float b = __ldg(p + 8);
    v.z = rows.quantised ? quantised_blue(b) : b;
    v.w = __ldg(p + 4);
  }
  return v;
}

// Staging of the first kVecs float4 of each of a batch of kBatch instances
// by a block of kThreads: first every rank load of a thread, then every
// feature load (into registers, each group in flight together), then its
// shared-memory stores.
template <int kBatch, int kThreads, int kVecs = 3>
struct Stage {
  static_assert(kBatch % 32 == 0, "a warp stages one kind of float4");
  static_assert(kVecs >= 1 && kVecs <= 3, "one to three float4");
  static constexpr int kItems = kVecs * kBatch;
  static constexpr int kIters = (kItems + kThreads - 1) / kThreads;

  // slots [b0, b0 + n) of the aligned layout, n <= kBatch
  static __device__ __forceinline__ void load(float4 (&regs)[kIters],
                                              const Rows& rows, int b0,
                                              int n, int tid) {
    int row[kIters];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = tid + i * kThreads;
      const int j = k % kBatch;
      if (k < kItems && j < n) row[i] = row_of(rows, b0 + j);
    }
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = tid + i * kThreads;
      const int which = k / kBatch;
      const int j = k - which * kBatch;
      if (k < kItems && j < n) regs[i] = stage_load(rows, row[i], which);
    }
  }

  static __device__ __forceinline__ void store(
      float4 (*sm)[kBatch], const float4 (&regs)[kIters], int n, int tid) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int k = tid + i * kThreads;
      const int which = k / kBatch;
      const int j = k - which * kBatch;
      if (k < kItems && j < n) sm[which][j] = regs[i];
    }
  }
};

}  // namespace walk
