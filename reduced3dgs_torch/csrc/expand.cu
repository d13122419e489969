// K1 — binning's slot keys ("expand"), for Hopper (sm_90a).
//
// Replaces reduced3dgs_tpu/ops/binning.py:164 _expand_kernel (built at
// :304 _build_expand, driven by :337 _expand_stream).  The TPU kernel
// gives, per instance slot below the budget, the (rank, rect word, start)
// of the last "mark" (a primitive's start offset) at or before the slot,
// by windowed base-256 limb-delta matmuls against the sorted marks, since
// the TPU has no cheap per-lane search.  Binning then turns those rows
// into each slot's sort key and, for the alignment padding after the
// budget, runs a second "last marker at or before the slot" pass (a
// scatter and a running max).  Here one launch writes the final int64
// sort key of every one of the B_pad slots, straight into the buffer the
// sort reads; each thread owns one slot and binary-searches its owner.
//
// Inputs, all in depth-rank order: offsets (P, inclusive prefix sums of
// the instance counts, nondecreasing), counts (P), rectpack (P, the word
// x0 << 20 | y0 << 10 | (w - 1) of the primitive's tile rect), pad_start
// (T + 1, the exclusive prefix sums of each tile's padding need, last
// entry the total) and nv (the instances that fit: min(num_rendered,
// budget)), a device scalar read through its pointer, so the host never
// waits and the shapes stay static.  With pp1 = P + 1:
//
//   real slot s < budget, s >= nv:  key = T pp1 + P  (truncated or unused)
//   real slot s < nv:  i = the first rank with offsets[i] > s (an
//       upper-bound search over all P ranks), start = offsets[i] -
//       counts[i], r = s - start, w = (rect & 1023) + 1,
//       tile = ((rect >> 10 & 1023) + r / w) grid_x + (rect >> 20) + r % w,
//       key = tile pp1 + i
//   pad slot s = budget + k:  t = (the first index with pad_start[t] > k)
//       - 1, an upper-bound search over the T + 1 entries;
//       key = t pp1 + P
//
// Why the searches equal the TPU kernel's streams, slot for slot.  Real
// slots: s < nv <= offsets[P - 1], so i exists, offsets[i - 1] <= s <
// offsets[i] and counts[i] > 0: i is the one primitive whose instances
// [start, offsets[i]) hold s.  A zero-count rank shares its offset with
// the next rank, so the search never lands on it, and no compaction of the
// marks is needed.  The marks are the starts of the primitives with count
// > 0, strictly increasing in rank, and the next such start after i's is
// offsets[i] > s: the last mark at or before s is i's own start, which is
// what _expand_stream returns (rank i + 1, rect[i], start).  Pad slots:
// binning puts a marker at pad_start[t] for every tile t that pads and at
// pad_start[T] for the sentinel T, clamps the markers at n_extra, and
// takes for slot k the largest tile whose marker is <= k.  For k <
// n_extra the clamp changes nothing, and the last index L with
// pad_start[L] <= k is either T or a tile with pad_start[L + 1] > k >=
// pad_start[L], i.e. one that pads: the largest marked tile at or before
// k.  pad_start[0] = 0, so L >= 0.  Every key is bit-exact with
// bin_keys_plain (binning.py), which computes it the TPU's way; there is
// no 2^24 cap (the JAX limb scheme has one): indices are 32-bit ints.
//
// What bounds it on the card: the 8 B key written per slot (B_pad, about
// 39 MB at the 1080p budget of 2^22, ~12 us at 3.35 TB/s).  A search reads
// ~log2 P words, but neighbouring slots walk the same path, so the reads
// hit L1 / L2; keys are written coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The first index in [0, n) whose value is > x, or n.
__device__ __forceinline__ int upper_bound(const int* __restrict__ v, int n,
                                           int x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(v + mid) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void bin_keys_kernel(const int* __restrict__ offsets,
                                const int* __restrict__ counts,
                                const int* __restrict__ rectpack, int p,
                                const int* __restrict__ pad_start,
                                int num_tiles, const int* __restrict__ nv,
                                int grid_x, int budget, int b_pad,
                                long long* __restrict__ keys) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= b_pad) return;
  const long long pp1 = static_cast<long long>(p) + 1;
  long long key;
  if (s >= budget) {  // alignment padding
    const int t = upper_bound(pad_start, num_tiles + 1, s - budget) - 1;
    key = t * pp1 + p;
  } else if (s >= __ldg(nv)) {  // truncated or unused
    key = num_tiles * pp1 + p;
  } else {
    const int i = upper_bound(offsets, p, s);
    const int r = s - (__ldg(offsets + i) - __ldg(counts + i));
    const int rect = __ldg(rectpack + i);
    const int w = (rect & 1023) + 1;
    const int ty = ((rect >> 10) & 1023) + r / w;
    const int tx = (rect >> 20) + r % w;
    key = static_cast<long long>(ty * grid_x + tx) * pp1 + i;
  }
  keys[s] = key;
}

}  // namespace

extern "C" int bin_keys_launch(const void* offsets, const void* counts,
                               const void* rectpack, int p,
                               const void* pad_start, int num_tiles,
                               const void* nv, int grid_x, int budget,
                               int b_pad, void* keys, void* stream) {
  if (b_pad > 0) {
    const int threads = 256;
    const int blocks = (b_pad + threads - 1) / threads;
    bin_keys_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(offsets), static_cast<const int*>(counts),
        static_cast<const int*>(rectpack), p,
        static_cast<const int*>(pad_start), num_tiles,
        static_cast<const int*>(nv), grid_x, budget, b_pad,
        static_cast<long long*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
