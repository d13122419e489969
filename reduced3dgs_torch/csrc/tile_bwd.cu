// K3 — backward tile walk (f32), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/tile_render.py:468 _bwd_kernel (built at
// :803 _build_bwd), in both feature-table modes: the fast (bf16x2) table
// is unpacked to the same f32 rows outside, and on this card an f32 FFMA
// costs what a bf16 one does, so the TPU kernel's one-pass bf16 MXU
// products (dcol, gc, the fast-mode moments) become plain f32 sums here.
//
// Layout as K2 (csrc/tile_fwd.cu, csrc/tile_walk.cuh): one block per
// 16x16 tile, P pixels per thread, 32 lanes on a compact 8x4 pixel
// block, the tile's depth-sorted instance range staged through
// shared memory in batches, instance-major as float4 with the conic
// pre-scaled by log2(e).  Each pixel re-walks its instances front to back,
// exactly as the forward did, carrying T before the instance and the
// running prefix `incl` of w * gc:
//
//   gc = g . rgb,  w = alpha T,  incl += w gc
//   dalpha = gc T - (q - incl) / (1 - alpha),  q = g . C + g_T T_final
//   ge = e dalpha   (e = exp(min(power, 0))),  dpower = op ge
//
// with C and T_final read from the forward's packed output, so no
// back-to-front division by T is needed.  Like the reference (and the TPU
// kernel), neither the 0.99 alpha clamp nor the min(power, 0) clamp is
// gated: dop = sum_p ge.  The nine gradients of an instance are
//
//   dx = -op (cxx Sx + cxy Sy)    dy = -op (cyy Sy + cxy Sx)
//   dcxx = -op Sxx / 2   dcxy = -op Sxy   dcyy = -op Syy / 2
//   dop = S   drgb = sum_p w g
//
// in the moments S, Sx, Sy, Sxx, Sxy, Syy = sum_p ge {1, dx, dy, dx^2,
// dx dy, dy^2} (dx, dy = instance centre minus pixel): a pixel only forms
// its nine terms of the sums (what the TPU kernel's moment matmul
// computes), and the factors that belong to the instance (op, the conic,
// -1/2) are applied once per instance when the record is written.
//
// Each instance's nine sums run over the tile's 256 pixels.  Within a
// warp they are reduced by one exchanging ("transposing") butterfly over
// all nine values at once: at lane offset 16 a lane keeps four of the
// first eight values, sends the other four and adds the four it receives;
// the ninth value takes a plain step.  Five values are left, then three,
// two, one: 5 + 3 + 2 + 1 + 1 = 12 __shfl_xor_sync where nine separate
// trees took 45, with selects that run at full rate.  The order of the
// adds is fixed by lane number, so two launches give the same bits.  The
// nine lanes that end up owning a complete sum (lanes 0, 4, ..., 28 and
// lane 2) each store one word to the warp's partials, without bank
// conflicts.  A warp in which no lane blends the instance skips all of it
// (__any_sync).  A thread that owns several pixels (TILE_BWD_PPT) adds
// their terms first, so one butterfly serves 32 P pixels.  The warp
// partials meet in shared memory, per batch.
//
// Every instance belongs to one tile, so each gradient is written once
// with no atomics.  The output is slot-major: slot b owns the record
// dfeat[b * rec .. b * rec + rec) (rec >= 9 floats, a multiple of 4; the
// nine gradients first, zeros after them), so that K5 / K6
// (csrc/seg_reduce.cu) fetch one instance's gradients with 16-byte loads
// from one or two sectors.  A batch's records are contiguous, and the
// store walks them in address order: neighbouring threads write
// neighbouring floats, whole sectors at a time.  Slots the walk never
// reaches (alignment slack, the early-exit tail, everything past *limit)
// are not written and keep the zeros the wrapper allocated.
//
// What bounds it on the card (measured on an H100, PERF.md).  Neither
// bytes (36 B read and 36 B written per instance, 64 B per pixel) nor f32
// arithmetic as the operation bound counts it (chip_smoke.py K3_OPS_*),
// and not the shuffle unit either (with one pixel per thread nine
// separate trees, 45 shuffles, cost 0.5 ms more than the butterfly, not
// the 1 ms a rate of one shuffle per SM and clock would predict): the
// SM's scheduler slots, spent per (warp, instance) pair whether all or a
// few lanes are live.  Lane utilisation is high (with one pixel per
// thread 90 % of the lanes of a walked pair and 73 % of a blending one;
// with two 85 % and 61 %), so the lever is instructions per pair
// (cuobjdump -sass).  With one pixel per thread: about 27 per walked
// pair, 21 more for a blending pair's terms and 57 for its reduction (12
// SHFL, 12 FADD, 16 FSEL, 8 FMUL, the store), where nine separate trees
// took about 100.  With two: about 100 for the walk and terms of both
// pixels and 75 for the one reduction they share.  What the design does:
// the butterfly, the per-instance factors hoisted out of the per-pixel
// terms, K2's compact pixel blocks and float4 staging, one ex2.approx
// for the exponent and one rcp.approx for 1 / (1 - alpha), the
// lane-dependent constants pinned in registers (left alone the compiler
// recomputes them, some thirty integer instructions per pair), and two
// pixels per thread (TILE_BWD_PPT), so that a tile's 256 pixels need four
// butterflies per instance, not eight, and its partials (18 KB for a
// batch of 128) leave room for eight blocks per SM at 62 registers a
// thread.  Four pixels per thread are no more than 1 % faster on a dense
// frame (0.897 against 0.903 ms at 1080p) and slower on a sparse one
// (0.257 against 0.213 ms at 512p), and are not the default.

#include "tile_walk.cuh"

#ifndef TILE_BWD_PPT
#define TILE_BWD_PPT 2  // pixels per thread: 1, 2 or 4
#endif
#ifndef TILE_BWD_BATCH
#define TILE_BWD_BATCH 128  // instances per shared-memory batch
#endif
#ifndef TILE_BWD_MIN_WARPS
#define TILE_BWD_MIN_WARPS 32  // warps per SM the register budget allows
#endif

namespace {

using namespace walk;

constexpr int kPpt = TILE_BWD_PPT;
static_assert(kPpt == 1 || kPpt == 2 || kPpt == 4, "pixels per thread");
constexpr int kThreads = kPix / kPpt;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = TILE_BWD_MIN_WARPS / kWarps;
constexpr int kBatch = TILE_BWD_BATCH;
constexpr int kVals = kRows;  // values in one butterfly
static_assert(128 % kBatch == 0, "a batch must not cross a 128-slot chunk");
using Stager = Stage<kBatch, kThreads>;

// The exchanging butterfly.  On entry every lane holds N values a[0..N);
// one step pairs lanes that differ in bit OFF: each keeps one half of the
// values, sends the other half and adds what it receives, and an odd value
// left over is summed in both.  After the last step a[0] of every lane is
// the sum over the warp of one of the N values.
template <int N, int OFF>
struct Butterfly {
  static constexpr int H = N / 2;
  static constexpr int kNext = H + (N & 1);

  static __device__ __forceinline__ void sum(float (&a)[kVals], int lane) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? a[H + i] : a[i];
      const float send = up ? a[i] : a[H + i];
      a[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    if constexpr ((N & 1) != 0)
      a[H] = a[N - 1] + __shfl_xor_sync(kFull, a[N - 1], OFF);
    if constexpr (OFF > 1) Butterfly<kNext, OFF / 2>::sum(a, lane);
  }

  // The same network on the values' indices: idx[0] ends as the index of
  // the value this lane's a[0] sums, own[0] as whether this lane is the
  // one of its duplicates that stores it (the lower lane of every plain
  // step).
  static __device__ __forceinline__ void route(int (&idx)[kVals],
                                               bool (&own)[kVals], int lane) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      idx[i] = up ? idx[H + i] : idx[i];
      own[i] = up ? own[H + i] : own[i];
    }
    if constexpr ((N & 1) != 0) {
      idx[H] = idx[N - 1];
      own[H] = own[N - 1] && !up;
    }
    if constexpr (OFF > 1) Butterfly<kNext, OFF / 2>::route(idx, own, lane);
  }
};

// The value (0 .. kVals - 1) whose warp sum this lane stores, or -1.
__device__ __forceinline__ int owned_value(int lane) {
  int idx[kVals];
  bool own[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    idx[i] = i;
    own[i] = true;
  }
  Butterfly<kVals, 16>::route(idx, own, lane);
  return own[0] ? idx[0] : -1;
}

__device__ __forceinline__ bool all_done(const bool (&done)[kPpt]) {
  bool all = true;
#pragma unroll
  for (int k = 0; k < kPpt; ++k) all = all && done[k];
  return all;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_bwd_kernel(const float* __restrict__ feat, long long stride,
                const int* __restrict__ ranges, int num_tiles,
                const int* __restrict__ limit, int grid_x, int base,
                int width, int height, const float* __restrict__ gpix,
                const float* __restrict__ spix, float* __restrict__ dfeat,
                int rec) {
  __shared__ float4 sm[3][kBatch];
  // warp partials, instance-major ([j][value]) so that the store below
  // reads consecutive words for consecutive output floats
  __shared__ float part[kWarps][kBatch * kRows];
  const int t = blockIdx.x;
  const unsigned tile = static_cast<unsigned>(base) + blockIdx.x;  // K2's
  const int tid = threadIdx.x;
  int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = pixel_of(warp * kPpt, lane);
  const int x0 = (tile % grid_x) * kTile + (p0 % kTile);
  const int y0 = (tile / grid_x) * kTile + (p0 / kTile);
  const int start = ranges[t];
  const int end = min(ranges[num_tiles + t], *limit);

  // per pixel: position, cotangent g of (r, g, b), q = g . C + g_T T_final,
  // T before the next instance and the running prefix of w gc
  float fx[kPpt], fy[kPpt], g0[kPpt], g1[kPpt], g2[kPpt], q[kPpt];
  float T[kPpt], incl[kPpt];
  bool done[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int px = x0 + pixel_dx(k);
    const int py = y0 + pixel_dy(k);
    const size_t pix = static_cast<size_t>(t) * kPixRows * kPix + p0 +
                       pixel_dy(k) * kTile + pixel_dx(k);
    fx[k] = static_cast<float>(px);
    fy[k] = static_cast<float>(py);
    g0[k] = gpix[pix];
    g1[k] = gpix[pix + kPix];
    g2[k] = gpix[pix + 2 * kPix];
    q[k] = g0[k] * spix[pix] + g1[k] * spix[pix + kPix] +
           g2[k] * spix[pix + 2 * kPix] +
           gpix[pix + 3 * kPix] * spix[pix + 3 * kPix];
    T[k] = 1.0f;
    incl[k] = 0.0f;
    done[k] = px >= width || py >= height;
  }

  float* mine = &part[warp][0];
  // where this lane stores the warp sum it ends up owning: the
  // shared-memory address of a word of part[warp][0 .. 9), or -1.  Both
  // this and the lane number are made opaque to the compiler, which
  // otherwise recomputes them (some thirty integer instructions) in every
  // turn of the inner loop to save two registers.
  const int owned = owned_value(lane);
  int slot = owned >= 0 ? static_cast<int>(__cvta_generic_to_shared(
                              &part[warp][owned]))
                        : -1;
  asm volatile("" : "+r"(slot), "+r"(lane));
  float4 regs[Stager::kIters];

  for (int b0 = start; b0 < end; b0 += kBatch) {
    // also the barrier that keeps the previous batch (features and warp
    // partials) alive until every thread has finished with it
    if (__syncthreads_count(all_done(done)) == kThreads) break;
    const int n = min(kBatch, end - b0);
    Stager::load(regs, feat, stride, b0, n, tid);
    for (int k = lane; k < kRows * kBatch; k += 32) mine[k] = 0.0f;
    Stager::store(sm, regs, n, tid);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (__all_sync(kFull, all_done(done))) break;  // warp-uniform
      const float4 a = sm[0][j];
      const float2 b = *reinterpret_cast<const float2*>(&sm[1][j]);
      float4 c;
      if (kPpt > 1) c = sm[2][j];  // several pixels: most turns need it
      // what pixel k adds to instance j: ge {dx, dy, dx^2, dx dy, dy^2, 1}
      // and wt g; all zero unless the pixel blends it
      float ge[kPpt], wt[kPpt], ex[kPpt], ey[kPpt];
      bool contrib = false;
#pragma unroll
      for (int k = 0; k < kPpt; ++k) {
        ge[k] = wt[k] = ex[k] = ey[k] = 0.0f;
        if (done[k]) continue;
        const float dx = a.x - fx[k];
        const float dy = a.y - fy[k];
        const float power = scaled_power(a, b.x, dx, dy);
        const float e = exp_scaled(fminf(power, 0.0f));
        const float alpha = fminf(kAlphaClamp, b.y * e);
        if (power > kPowerEps || alpha < kAlphaMin) continue;
        const float one_m = 1.0f - alpha;
        const float test_t = T[k] * one_m;
        if (test_t < kTEps) {
          done[k] = true;
          continue;
        }
        contrib = true;
        if (kPpt == 1) c = sm[2][j];
        const float w = alpha * T[k];
        const float gc = fmaf(g0[k], c.x, fmaf(g1[k], c.y, g2[k] * c.z));
        incl[k] = fmaf(w, gc, incl[k]);
        // 1 - alpha is in [0.01, 1]: the approximate reciprocal is good
        // to 1 ulp there
        const float dalpha =
            fmaf(gc, T[k], -(q[k] - incl[k]) * rcp_approx(one_m));
        ge[k] = e * dalpha;
        wt[k] = w;
        ex[k] = dx;
        ey[k] = dy;
        T[k] = test_t;
      }
      if (__any_sync(kFull, contrib)) {
        // the thread's own sum over its pixels first
        float v[kVals];
        v[0] = ge[0] * ex[0];
        v[1] = ge[0] * ey[0];
        v[2] = v[0] * ex[0];
        v[3] = v[0] * ey[0];
        v[4] = v[1] * ey[0];
        v[5] = ge[0];
        v[6] = wt[0] * g0[0];
        v[7] = wt[0] * g1[0];
        v[8] = wt[0] * g2[0];
#pragma unroll
        for (int k = 1; k < kPpt; ++k) {
          const float mx = ge[k] * ex[k];
          const float my = ge[k] * ey[k];
          v[0] += mx;
          v[1] += my;
          v[2] = fmaf(mx, ex[k], v[2]);
          v[3] = fmaf(mx, ey[k], v[3]);
          v[4] = fmaf(my, ey[k], v[4]);
          v[5] += ge[k];
          v[6] = fmaf(wt[k], g0[k], v[6]);
          v[7] = fmaf(wt[k], g1[k], v[7]);
          v[8] = fmaf(wt[k], g2[k], v[8]);
        }
        Butterfly<kVals, 16>::sum(v, lane);
        if (slot >= 0)
          asm volatile("st.shared.f32 [%0], %1;"
                       :
                       : "r"(slot + j * (kRows * 4)), "f"(v[0])
                       : "memory");
      }
    }
    __syncthreads();
    float* __restrict__ dst = dfeat + static_cast<size_t>(b0) * rec;
    for (int k = tid; k < n * rec; k += kThreads) {
      const int j = k / rec;
      const int row = k - j * rec;
      float out = 0.0f;
      if (row < kRows) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][j * kRows + row];
        if (row < 2) {  // dx, dy: both first moments
          float o = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) o += part[w][j * kRows + 1 - row];
          const float4 b = sm[1][j];  // (c, op, cxx, cxy)
          const float cself = row == 0 ? b.z : sm[2][j].w;  // cxx | cyy
          out = -b.y * fmaf(cself, s, b.w * o);
        } else if (row < 5) {
          const float op = sm[1][j].y;
          out = (row == 3 ? -op : -0.5f * op) * s;
        } else {
          out = s;
        }
      }
      dst[k] = out;
    }
  }
}

}  // namespace

extern "C" int tile_bwd_launch(const void* feat, long long stride,
                               const void* ranges, int num_tiles,
                               const void* limit, int grid_x, int base,
                               int width, int height, const void* gpix,
                               const void* spix,
                               void* dfeat, int rec, void* stream) {
  if (num_tiles > 0) {
    tile_bwd_kernel<<<num_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), stride,
        static_cast<const int*>(ranges), num_tiles,
        static_cast<const int*>(limit), grid_x, base, width, height,
        static_cast<const float*>(gpix), static_cast<const float*>(spix),
        static_cast<float*>(dfeat), rec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
