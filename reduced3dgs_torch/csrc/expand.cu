// K1 — instance slot -> owning primitive ("expand"), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/binning.py:164 _expand_kernel (built at
// :307 _build_expand, driven by :337 _expand_stream).  The TPU kernel
// streams windowed base-256 limb-delta matmuls against the sorted mark
// positions because the TPU has no cheap per-lane search; here each
// thread owns one slot and binary-searches the marks directly.
//
// Semantics, bit-exact with _expand_stream on every one of the `budget`
// slots: the caller compacts the marked primitives (count > 0 and start
// < budget) to the front in rank order, so pos[] is nondecreasing and
// every unmarked row holds INT32_MAX.  For slot s, let i be the last
// index with pos[i] <= s (an upper-bound search over all n rows, so
// trailing zero-count primitives that share the last start never win
// and a run with no marks at all gives i = -1).  The outputs are
//   gauss[s] = rank1[i] - 1,  rect[s] = rect[i],  start[s] = pos[i]
// and (-1, 0, 0) when i = -1.  There is no 2^24 cap on n or budget (the
// JAX limb scheme has one): indices are 32-bit ints throughout.
//
// What bounds it on the card: the 3 x 4 B x budget output write (about
// 50 MB at the 1080p budget of 2^22, ~15 us at 3.35 TB/s).  The search
// reads ~log2(n) words per slot, but neighbouring slots walk the same
// path, so the reads hit L1/L2; outputs are written coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_kernel(const int* __restrict__ pos,
                              const int* __restrict__ rank1,
                              const int* __restrict__ rect, int n,
                              int budget, int* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= budget) return;
  int lo = 0;
  int hi = n;
  while (lo < hi) {  // first index with pos > s
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(pos + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = lo - 1;
  int g = -1;
  int r = 0;
  int st = 0;
  if (i >= 0) {
    g = __ldg(rank1 + i) - 1;
    r = __ldg(rect + i);
    st = __ldg(pos + i);
  }
  const size_t b = static_cast<size_t>(budget);
  out[s] = g;
  out[b + s] = r;
  out[2 * b + s] = st;
}

}  // namespace

extern "C" int expand_launch(const void* pos, const void* rank1,
                             const void* rect, int n, int budget, void* out,
                             void* stream) {
  if (budget > 0) {
    const int threads = 256;
    const int blocks = (budget + threads - 1) / threads;
    expand_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pos), static_cast<const int*>(rank1),
        static_cast<const int*>(rect), n, budget, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
