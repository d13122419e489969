// K5 / K6 — per-primitive sums of per-instance gradient rows, for Hopper
// (sm_90a).  One segmented sum with two entry points:
//
//   seg_reduce_f32_launch     replaces reduced3dgs_tpu/ops/tile_render.py
//                             :1083 _cumsum9_kernel (with :964 _pick_step),
//                             grad_reduce="f32": 9 f32 rows
//   seg_reduce_packed_launch  replaces :1117 _cumsum_packed_kernel,
//                             grad_reduce="bf16x2" (the training default):
//                             5 int32 rows, each a bf16 pair unpacked in
//                             registers (hi = bits & 0xFFFF0000,
//                             lo = bits << 16); the 10th value is padding
//
// The TPU kernels take exclusive prefix sums of the key-sorted rows and
// pick them at the segment bounds (a TPU has no cheap segmented reduction,
// docs/DESIGN.md section 1); per-primitive sums are then adjacent
// differences.  Here each segment is summed directly, which is more exact
// (no difference of two large running sums).  The key sort stays outside,
// as in the JAX package: `order` is the index output of torch.sort on
// key = where(pad, P, depth rank), so segment r (depth rank r) is
// order[bounds[r] .. bounds[r+1]).  The kernel reads the rows through that
// index rather than payload moved by the sort: one pass over the rows
// instead of a gather pass plus a read pass.  One thread per segment sums
// its instances in sorted order (deterministic) and writes the nine sums
// of rank r to out[:, r] (depth-rank order; the reorder to primitive ids
// is tensor code).
//
// What bounds it on the card: bytes.  Each real instance's rows (36 B f32
// or 20 B packed) and its 8 B index are read once, the bounds and the
// (9, P) f32 sums once; the row reads are gathers (one 32 B sector per
// 4 B value), which is what this simple design pays over the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 9;
constexpr int kPackedRows = 5;
constexpr int kThreads = 256;

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
seg_reduce_kernel(const void* __restrict__ rows, long long stride,
                  const long long* __restrict__ order,
                  const int* __restrict__ bounds, int num_p,
                  float* __restrict__ out, long long ostride) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_p) return;
  const int s0 = bounds[r];
  const int s1 = bounds[r + 1];
  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;
  for (int s = s0; s < s1; ++s) {
    const long long slot = order[s];
    if (kPacked) {
      const int* p = static_cast<const int*>(rows);
#pragma unroll
      for (int k = 0; k < kPackedRows; ++k) {
        const unsigned bits = static_cast<unsigned>(p[k * stride + slot]);
        acc[2 * k] += __uint_as_float(bits & 0xFFFF0000u);
        if (2 * k + 1 < kOut) acc[2 * k + 1] += __uint_as_float(bits << 16);
      }
    } else {
      const float* p = static_cast<const float*>(rows);
#pragma unroll
      for (int k = 0; k < kOut; ++k) acc[k] += p[k * stride + slot];
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[k * ostride + r] = acc[k];
}

template <bool kPacked>
int launch(const void* rows, long long stride, const void* order,
           const void* bounds, int num_p, void* out, long long ostride,
           void* stream) {
  if (num_p > 0) {
    const int blocks = (num_p + kThreads - 1) / kThreads;
    seg_reduce_kernel<kPacked><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        rows, stride, static_cast<const long long*>(order),
        static_cast<const int*>(bounds), num_p, static_cast<float*>(out),
        ostride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int seg_reduce_f32_launch(const void* rows, long long stride,
                                     const void* order, const void* bounds,
                                     int num_p, void* out, long long ostride,
                                     void* stream) {
  return launch<false>(rows, stride, order, bounds, num_p, out, ostride,
                       stream);
}

extern "C" int seg_reduce_packed_launch(const void* rows, long long stride,
                                        const void* order, const void* bounds,
                                        int num_p, void* out,
                                        long long ostride, void* stream) {
  return launch<true>(rows, stride, order, bounds, num_p, out, ostride,
                      stream);
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
