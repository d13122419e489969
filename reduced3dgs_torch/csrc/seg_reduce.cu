// K5 / K6 — per-primitive sums of per-instance gradient records, for Hopper
// (sm_90a).  One segmented sum with two entry points:
//
//   seg_reduce_f32_launch     replaces reduced3dgs_tpu/ops/tile_render.py
//                             :1083 _cumsum9_kernel (with :964 _pick_step),
//                             grad_reduce="f32": the nine f32 values
//   seg_reduce_packed_launch  replaces :1117 _cumsum_packed_kernel (fed by
//                             :1236 _pack_bf16x2), grad_reduce="bf16x2"
//                             (the training default): each value rounded to
//                             bf16, to nearest even, before it is added in
//                             f32 — bit for bit what packing two bf16 into
//                             an int32 and unpacking them gives, done in
//                             registers (__float2bfloat16_rn, then widened
//                             by 16 zero bits)
//
// The TPU kernels take exclusive prefix sums of the key-sorted rows and
// pick them at the segment bounds (a TPU has no cheap segmented reduction,
// docs/DESIGN.md section 1); per-primitive sums are then adjacent
// differences.  Here each segment is summed directly, which is more exact
// (no difference of two large running sums).  The key sort stays outside,
// as in the JAX package: `order` is the index output of torch.sort on
// key = where(pad, P, depth rank), so segment r (depth rank r) is
// order[bounds[r] .. bounds[r+1]).  The nine sums of rank r go to
// out[:, r] (depth-rank order; the reorder to primitive ids is tensor
// code).
//
// What bounds it on the card: bytes, and in practice sectors.  One
// primitive's instances lie in different tiles, so its gradients are
// gathered through `order` from slots at least 128 apart, and the card
// moves 32-byte sectors whatever part of one is wanted.  Feature-major
// rows (the TPU's layout) cost nine sectors, 288 B, for the 36 B of one
// instance.  So the input is slot-major: K3 (csrc/tile_bwd.cu) writes slot
// b's nine gradients as one 16-byte-aligned record of `rec` floats, and
// this kernel reads a record as three 16-byte loads from one or two
// sectors.  The bf16x2 mode reads the same f32 records (the rows never
// ride the sort here, so packing them first would cost passes and save
// nothing) and rounds in registers.
//
// Balance and order of summation.  A group of kLanes (4) neighbouring lanes
// owns one segment; lane q of the group loads float4 q of each record (the
// group's loads are one contiguous 48 B request) and keeps its four sums,
// so no value ever crosses lanes in the common case, and a warp waits for
// the longest of 8 segments, not of 32.  Three tiers by segment length:
//   <= kGroupMax   the group walks its segment in sorted order;
//   <= kWarpMax    found by __ballot_sync; the warp's 8 groups stride over
//                  the segment (group g takes positions g, g + 8, ...),
//                  then a 3-step __shfl_xor_sync tree over the groups;
//   longer         found by __syncthreads_or; the block's 64 groups stride
//                  over it, the shuffle tree per warp, then the 8 warp
//                  partials are added from shared memory in warp order.
// Every lane keeps kUnroll (4) record loads in flight, and the next round's
// index loads go out before the adds wait for them.  The limits (32, 256)
// and the group width were chosen by measurement, see PERF.md.  There are
// no atomics: which lane adds which record, and every order of addition, is
// fixed by `bounds` alone, so two launches on the same inputs give the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// tunables; experiments/torch_seg_reduce_variants.py rebuilds this file
// with other values to compare them on the card
#ifndef SEG_LANES
#define SEG_LANES 4
#endif
#ifndef SEG_GROUP_MAX
#define SEG_GROUP_MAX 32
#endif
#ifndef SEG_WARP_MAX
#define SEG_WARP_MAX 256
#endif
#ifndef SEG_UNROLL
#define SEG_UNROLL 4
#endif

namespace {

constexpr int kOut = 9;
constexpr int kQuads = 3;  // float4 of a record that hold the nine values
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = SEG_LANES;  // lanes per group: 1, 2 or 4
constexpr int kMine = (kQuads + kLanes - 1) / kLanes;  // float4 per lane
constexpr int kWarpGroups = 32 / kLanes;
constexpr int kBlockGroups = kThreads / kLanes;  // segments per block
constexpr int kGroupMax = SEG_GROUP_MAX;
constexpr int kWarpMax = SEG_WARP_MAX;
constexpr int kUnroll = SEG_UNROLL;
constexpr unsigned kFull = 0xffffffffu;

struct Acc {
  float4 v[kMine];  // lane q: float4 q, q + kLanes, ... of the record
};

__device__ __forceinline__ Acc zero_acc() {
  Acc a;
#pragma unroll
  for (int m = 0; m < kMine; ++m) a.v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  return a;
}

template <bool kRound>
__device__ __forceinline__ float term(float x) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kRound>
__device__ __forceinline__ void add(float4& a, const float4 v) {
  a.x += term<kRound>(v.x);
  a.y += term<kRound>(v.y);
  a.z += term<kRound>(v.z);
  a.w += term<kRound>(v.w);
}

// acc += the records at sorted positions first, first + step, ... (< last),
// in that order; lane q of a group takes its own float4 of each record.
template <bool kRound>
__device__ __forceinline__ void accumulate(
    Acc& acc, const float4* __restrict__ rec, long long recq,
    const long long* __restrict__ order, int first, int last, int step,
    int q) {
  // a round: kUnroll record loads in flight per lane, then the next
  // round's index loads (so that they overlap the records' latency), then
  // the adds; the tail round is predicated, not peeled
  long long idx[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (first + u * step < last) idx[u] = __ldg(order + first + u * step);
  for (int s = first; s < last; s += kUnroll * step) {
    float4 v[kUnroll][kMine];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int m = 0; m < kMine; ++m)
        if (s + u * step < last && q + m * kLanes < kQuads)
          v[u][m] = __ldg(rec + idx[u] * recq + q + m * kLanes);
    }
    const int t = s + kUnroll * step;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t + u * step < last) idx[u] = __ldg(order + t + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int m = 0; m < kMine; ++m)
        if (s + u * step < last && q + m * kLanes < kQuads)
          add<kRound>(acc.v[m], v[u][m]);
    }
  }
}

// every group of the warp ends with the sum over the warp's groups
__device__ __forceinline__ void sum_over_groups(Acc& a) {
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) {
      a.v[m].x += __shfl_xor_sync(kFull, a.v[m].x, off);
      a.v[m].y += __shfl_xor_sync(kFull, a.v[m].y, off);
      a.v[m].z += __shfl_xor_sync(kFull, a.v[m].z, off);
      a.v[m].w += __shfl_xor_sync(kFull, a.v[m].w, off);
    }
  }
}

__device__ __forceinline__ void store_quad(float* __restrict__ out,
                                           long long ostride, int r, int quad,
                                           const float4 v) {
  float* o = out + 4 * quad * ostride + r;
  o[0] = v.x;
  if (4 * quad + 1 < kOut) o[ostride] = v.y;
  if (4 * quad + 2 < kOut) o[2 * ostride] = v.z;
  if (4 * quad + 3 < kOut) o[3 * ostride] = v.w;
}

__device__ __forceinline__ void store(float* __restrict__ out,
                                      long long ostride, int r, int q,
                                      const Acc& a) {
#pragma unroll
  for (int m = 0; m < kMine; ++m)
    if (q + m * kLanes < kQuads)
      store_quad(out, ostride, r, q + m * kLanes, a.v[m]);
}

template <bool kRound>
__global__ void __launch_bounds__(kThreads)
seg_reduce_kernel(const float4* __restrict__ rec, long long recq,
                  const long long* __restrict__ order,
                  const int* __restrict__ bounds, int num_p,
                  float* __restrict__ out, long long ostride) {
  __shared__ int seg_lo[kBlockGroups];
  __shared__ int seg_hi[kBlockGroups];
  __shared__ float4 partial[kWarps][kQuads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = lane % kLanes;
  const int g = lane / kLanes;
  const int mine = warp * kWarpGroups + g;  // the group's segment in the block
  const int r = blockIdx.x * kBlockGroups + mine;
  int s0 = 0, s1 = 0;  // ranks past the end: an empty segment, never stored
  if (r < num_p) {
    s0 = __ldg(bounds + r);
    s1 = __ldg(bounds + r + 1);
  }
  const int len = s1 - s0;

  // tier 1: the group sums its own segment
  if (len <= kGroupMax && r < num_p) {
    Acc a = zero_acc();
    accumulate<kRound>(a, rec, recq, order, s0, s1, 1, q);
    store(out, ostride, r, q, a);
  }

  // tier 2: the warp sums each of its longer segments together
  unsigned todo = __ballot_sync(kFull, len > kGroupMax && len <= kWarpMax);
  while (todo) {
    const int src = __ffs(todo) - 1;  // first lane of the segment's group
    todo &= ~(((1u << kLanes) - 1u) << src);
    const int w0 = __shfl_sync(kFull, s0, src);
    const int w1 = __shfl_sync(kFull, s1, src);
    const int wr = __shfl_sync(kFull, r, src);
    Acc a = zero_acc();
    accumulate<kRound>(a, rec, recq, order, w0 + g, w1, kWarpGroups, q);
    sum_over_groups(a);
    if (g == 0) store(out, ostride, wr, q, a);
  }

  // tier 3: the block sums each of its longest segments together
  if (__syncthreads_or(len > kWarpMax)) {
    if (q == 0) {
      seg_lo[mine] = s0;
      seg_hi[mine] = s1;
    }
    __syncthreads();
    for (int i = 0; i < kBlockGroups; ++i) {
      const int b0 = seg_lo[i];
      const int b1 = seg_hi[i];
      if (b1 - b0 <= kWarpMax) continue;  // the same for every thread
      Acc a = zero_acc();
      accumulate<kRound>(a, rec, recq, order, b0 + mine, b1, kBlockGroups, q);
      sum_over_groups(a);
      if (g == 0) {
#pragma unroll
        for (int m = 0; m < kMine; ++m)
          if (q + m * kLanes < kQuads) partial[warp][q + m * kLanes] = a.v[m];
      }
      __syncthreads();
      if (tid < kQuads) {
        float4 t = partial[0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float4 p = partial[w][tid];
          t.x += p.x;
          t.y += p.y;
          t.z += p.z;
          t.w += p.w;
        }
        store_quad(out, ostride, blockIdx.x * kBlockGroups + i, tid, t);
      }
      __syncthreads();  // partial is reused by the next long segment
    }
  }
}

template <bool kRound>
int launch(const void* rows, long long rec, const void* order,
           const void* bounds, int num_p, void* out, long long ostride,
           void* stream) {
  if (num_p > 0) {
    const int blocks = (num_p + kBlockGroups - 1) / kBlockGroups;
    seg_reduce_kernel<kRound><<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), rec / 4,
        static_cast<const long long*>(order),
        static_cast<const int*>(bounds), num_p, static_cast<float*>(out),
        ostride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: slot b's nine values at rows[b * rec .. b * rec + 9), rec a multiple
// of 4 and rows 16-byte aligned; order: (B,) int64; bounds: (num_p + 1,)
// int32; out: (9, num_p) f32 with row stride ostride.
extern "C" int seg_reduce_f32_launch(const void* rows, long long rec,
                                     const void* order, const void* bounds,
                                     int num_p, void* out, long long ostride,
                                     void* stream) {
  return launch<false>(rows, rec, order, bounds, num_p, out, ostride, stream);
}

extern "C" int seg_reduce_packed_launch(const void* rows, long long rec,
                                        const void* order, const void* bounds,
                                        int num_p, void* out,
                                        long long ostride, void* stream) {
  return launch<true>(rows, rec, order, bounds, num_p, out, ostride, stream);
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
