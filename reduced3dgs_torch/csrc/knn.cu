// Exact k-nearest-neighbour search over Morton-ordered blocks, for Hopper
// (sm_90a).
//
// Replaces the JAX package's certified blocked search on the card
// (reduced3dgs_tpu/ops/knn.py:_blocked_knn, ported as ops/knn.py's
// torch ladder).  That search scores every query against every block's
// box, (P x P / 256 x 3) floats a rung, and certifies all queries at once
// or reruns: at 2^22 pool rows (2.94M alive, the Mip-NeRF 360 scene at its
// published size) no rung of its ladder certified and each took 3.5-10 s
// on an H100 before the O(P^2) fallback.  Here the search is exact by
// construction, in one launch.
//
// Inputs (the wrapper, ops/knn.py:_knn_cuda, makes them with torch ops):
// the points sorted by their 30-bit Morton code, padded with +inf rows to
// a multiple of 32; each sorted point's original row (-1 on the pads);
// the box (min xyz, max xyz) of every block of 32 consecutive sorted
// points, and of every super-block of 32 blocks.
//
// One warp takes one block of 32 queries, a lane each, and keeps each
// lane's k best (distance, original row) pairs sorted in registers.
//   1. It scans its own block and the blocks before and after it in the
//      Morton order: every lane then holds k candidates (where P > k), so
//      its k-th distance bounds its true k-th from above.
//   2. It walks the super-blocks 32 at a time; one whose box is within the
//      warp's bound (the largest k-th distance of its lanes) of the
//      warp's own box is opened, and each of its blocks within that bound
//      is scanned where some lane's own k-th distance reaches the block's
//      box.  The bound shrinks after every scan.
// A point outside every opened box is farther from each query than that
// query's k-th candidate, so the lists are exact.  Distances are
// (dx dx + dy dy) + dz dz with dx = q.x - p.x in float32, rounded after
// every operation (no contraction into FMAs), as the plain version
// (ops/knn.py:knn_sorted_plain) and the benchmark's reference compute
// them; the same rounding makes a box's distance a lower bound of each of
// its points'.  Ties go to the lower original row, and a query is never
// its own neighbour.  The result does not depend on the order in which
// blocks are scanned: it is the k smallest (distance, row) pairs.
//
// Outputs, by original row: (P, k) float32 squared distances and int64
// rows, ascending; where fewer than k other points exist, +inf and -1.
// `scanned` gains the blocks the warps scanned (one atomicAdd a warp): the
// device counter "knn_scanned_blocks".
//
// What bounds it on the card: each query's distance to its candidates.
// The least work (splatbench's roofline) reads each point once and writes
// k rows a query; the scans cost ~3 shuffles, 8 float operations and a
// compare per candidate pair, ~60 blocks of 32 candidates a query in the
// dense part of a scene.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;  // warps (query blocks) a CUDA block
constexpr int kBox = 32;   // points a block, blocks a super-block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// squared distance from a point to a box (0 inside); an empty box (min
// +inf, max -inf) is infinitely far
__device__ __forceinline__ float point_box(float x, float y, float z,
                                           const float* b) {
  const float gx = fmaxf(fmaxf(__fsub_rn(b[0], x), __fsub_rn(x, b[3])), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(b[1], y), __fsub_rn(y, b[4])), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(b[2], z), __fsub_rn(z, b[5])), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// squared distance between two boxes: a lower bound of point_box for every
// point of the first
__device__ __forceinline__ float box_box(const float* a, const float* b) {
  const float gx = fmaxf(fmaxf(__fsub_rn(b[0], a[3]), __fsub_rn(a[0], b[3])),
                         0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(b[1], a[4]), __fsub_rn(a[1], b[4])),
                         0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(b[2], a[5]), __fsub_rn(a[2], b[5])),
                         0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int K>
struct Best {
  float d[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      d[t] = __int_as_float(0x7f800000);  // +inf
      i[t] = INT_MAX;
    }
  }

  // (dist, row) into the sorted list, its last pair dropped
  __device__ __forceinline__ void insert(float dist, int row) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const bool sw = before(dist, row, d[t], i[t]);
      const float td = d[t];
      const int ti = i[t];
      d[t] = sw ? dist : td;
      i[t] = sw ? row : ti;
      dist = sw ? td : dist;
      row = sw ? ti : row;
    }
  }
};

// every lane's distances to the 32 points of block b (all lanes call it)
template <int K>
__device__ __forceinline__ void scan(const float* __restrict__ sp,
                                     const int* __restrict__ orig, int b,
                                     int lane, bool valid, float qx, float qy,
                                     float qz, int me, Best<K>& best) {
  const int r = b * kBox + lane;
  const float px = sp[3 * r];
  const float py = sp[3 * r + 1];
  const float pz = sp[3 * r + 2];
  const int po = orig[r];
#pragma unroll 4
  for (int t = 0; t < kBox; ++t) {
    const float x = __shfl_sync(kFull, px, t);
    const float y = __shfl_sync(kFull, py, t);
    const float z = __shfl_sync(kFull, pz, t);
    const int o = __shfl_sync(kFull, po, t);
    const float d = sq_dist(qx, qy, qz, x, y, z);
    if (valid && o >= 0 && o != me && before(d, o, best.d[K - 1],
                                             best.i[K - 1])) {
      best.insert(d, o);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ sp, const int* __restrict__ orig,
               const float* __restrict__ box, const float* __restrict__ sbox,
               int nb, int ns, float* __restrict__ out_d2,
               long long* __restrict__ out_idx, int* __restrict__ scanned) {
  const int lane = threadIdx.x & 31;
  const int qb = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qb >= nb) return;  // the whole warp
  const int row = qb * kBox + lane;
  const float qx = sp[3 * row];
  const float qy = sp[3 * row + 1];
  const float qz = sp[3 * row + 2];
  const int me = orig[row];
  const bool valid = me >= 0;
  float own[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) own[c] = box[6 * qb + c];

  Best<K> best;
  best.clear();
  int blocks = 0;
  const int first = max(qb - 1, 0);
  const int last = min(qb + 1, nb - 1);
  for (int b = first; b <= last; ++b, ++blocks) {
    scan<K>(sp, orig, b, lane, valid, qx, qy, qz, me, best);
  }
  const float neg_inf = __int_as_float(0xff800000);
  float bound = warp_max(valid ? best.d[K - 1] : neg_inf);

  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int s = s0 + lane;
    unsigned open = __ballot_sync(
        kFull, s < ns && box_box(own, sbox + 6 * s) <= bound);
    while (open) {
      const int sb = s0 + __ffs(open) - 1;
      open &= open - 1;
      const int b = sb * kBox + lane;
      unsigned todo = __ballot_sync(
          kFull, b < nb && (b < first || b > last) &&
                     box_box(own, box + 6 * b) <= bound);
      while (todo) {
        const int bj = sb * kBox + __ffs(todo) - 1;
        todo &= todo - 1;
        const bool need =
            valid && point_box(qx, qy, qz, box + 6 * bj) <= best.d[K - 1];
        if (__any_sync(kFull, need)) {
          scan<K>(sp, orig, bj, lane, valid, qx, qy, qz, me, best);
          ++blocks;
          bound = warp_max(valid ? best.d[K - 1] : neg_inf);
        }
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_d2[static_cast<long long>(me) * K + t] = best.d[t];
      out_idx[static_cast<long long>(me) * K + t] =
          best.i[t] == INT_MAX ? -1LL : static_cast<long long>(best.i[t]);
    }
  }
  if (lane == 0) atomicAdd(scanned, blocks);
}

}  // namespace

// k: 3 (the scale initialisation's distCUDA2) or 30 (the redundancy
// metric's neighbours); any other k is refused (cudaErrorInvalidValue).
extern "C" int knn_launch(const void* sp, const void* orig, const void* box,
                          const void* sbox, int nb, int ns, int k,
                          void* out_d2, void* out_idx, void* scanned,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = (nb + kWarps - 1) / kWarps;
  const auto* p = static_cast<const float*>(sp);
  const auto* o = static_cast<const int*>(orig);
  const auto* b = static_cast<const float*>(box);
  const auto* sb = static_cast<const float*>(sbox);
  auto* d = static_cast<float*>(out_d2);
  auto* i = static_cast<long long*>(out_idx);
  auto* c = static_cast<int*>(scanned);
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  if (k == 30) {
    knn_kernel<30><<<grid, kWarps * 32, 0, s>>>(p, o, b, sb, nb, ns, d, i, c);
  } else if (k == 3) {
    knn_kernel<3><<<grid, kWarps * 32, 0, s>>>(p, o, b, sb, nb, ns, d, i, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
