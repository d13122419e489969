// Binning's per-tile instance counts, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package counts with a plain jnp
// scatter-add (reduced3dgs_tpu/ops/binning.py, a 2-D difference array).
// It replaces the torch ops that did the same on the card (ops/binning.py
// before this kernel: four int64 index_add_ of every row's rect corners,
// dead and culled rows adding zeros, and the budget-split primitive's
// correction by outer products), in one launch on the current stream.
//
// Inputs, in depth-rank order: offsets (P, inclusive prefix sums of the
// counts), counts (P) and rectpack (P, the word x0 << 20 | y0 << 10 |
// (w - 1) of the row's tile rect), and nv (the instances that fit:
// min(num_rendered, budget)), a device scalar read through its pointer,
// so the host never waits and the launch is capturable.  Output: the
// (grid_y, grid_x) int32 counts, row-major.
//
//   A row adds nothing when its count is 0 or its first instance, start
//   = offset - count, is at or past nv: it is skipped.  With q = min(count,
//   nv - start) instances that fit and fr = q / w, every other row adds
//   the rect [y0, y0 + fr) x [x0, x0 + w) to a (grid_y + 1) x (grid_x +
//   1) difference array (+1, -1, -1, +1 at its corners); a row that fits
//   whole has q = count = w h, so fr = h.  The one row the budget splits
//   (q < count) also adds its partial tile row, row y0 + fr x [x0, x0 +
//   q - fr w).  The counts are the array's 2-D prefix sums.  Integer and
//   independent of order: the same bits as tile_counts_plain (binning.py)
//   and as the four index_add_ it replaces.
//
// What bounds it on the card: the bytes the work needs, each row's offset
// (a count is the difference of two offsets), the rect word of each row
// that adds and the counts written, 4 B a row and 4 B a row that adds
// (~26 MB, ~8 us at 2^22 rows of which 2.4M add, at 3.35 TB/s; the kernel
// also reads the counts, 4 B a row more).  The adds themselves would be
// the limit if they went to device memory: each goes to one of a few
// thousand addresses (53 x 79 at 1237 x 822), so device atomics serialise
// in L2.
// Here each block privatises the difference array in shared memory
// (16.7 KB at 1237 x 822, 9.1 KB at 979 x 546, 33 KB at 1920 x 1080),
// adds into it with shared-memory atomics, and flushes only its nonzero
// entries into a zeroed array in device memory, one atomic each.  The
// grid is sized to the SMs (kBlocksPerSm each) and to P, with rows
// walked in a grid-stride loop, kUnroll rows a thread per step so that
// several loads are in flight; a small pool takes few blocks, so the
// flush follows P.  The last block to finish (a ticket counter after a
// fence) takes the prefix sums, column by column then row by row, in
// its own shared memory.
//
// An array larger than kSmemBytes takes the same kernel with the
// difference array in device memory (kShared false): its adds skip the
// rows that add nothing, and the lanes of a warp that hit one address
// add once, the leader adding their number (__match_any_sync).  The
// limit is 48 KB, the most a block takes without the opt-in attribute
// (which a launch would have to set before any graph capture), less 256 B
// for the block's own variables; every benchmark frame and 1080p fit, 4K
// frames (241 x 136 tiles) take the device-memory path.
//
// `scratch` (zeroed by the caller): the difference array, then the
// ticket counter, then `rows`, which gains the rows that added (one
// atomicAdd a block): the device counter "tile_counts_rows".

#include <cuda_runtime.h>

namespace {

// 1024 threads, 4 rows a thread a step, 2 blocks an SM: the fastest of
// 256-1024 threads x 2-8 rows x 1-4 blocks (up to 2048 threads an SM) on
// an H100 at the m360_full binning (0.0328 ms; 1 block 0.0350, 256
// threads x 2 rows x 1 block 0.0899), all bit for bit.
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kSmemBytes = 48896;

constexpr unsigned kFull = 0xffffffffu;

// d[addr] += v from every lane whose addr >= 0; all 32 lanes call it.  In
// shared memory one atomic a lane; in device memory the lanes that share
// an address add once, through their lowest lane.
template <bool kShared>
__device__ __forceinline__ void add(int* d, int addr, int v) {
  if constexpr (kShared) {
    if (addr >= 0) atomicAdd(d + addr, v);
  } else {
    const unsigned peers = __match_any_sync(kFull, addr);
    if (addr >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(d + addr, v * __popc(peers));
    }
  }
}

template <bool kShared>
__device__ __forceinline__ int load(const int* d) {
  if constexpr (kShared) {
    return *d;
  } else {
    return __ldcg(d);  // L2: other blocks' atomics landed there
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    tile_counts_kernel(const int* __restrict__ offsets,
                       const int* __restrict__ counts,
                       const int* __restrict__ rectpack, int p,
                       const int* __restrict__ nv, int grid_x, int grid_y,
                       int* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ int sdiff[];
  __shared__ int block_rows;
  __shared__ bool last;
  const int stride = grid_x + 1;
  const int n_diff = (grid_y + 1) * stride;
  int* const acc = kShared ? sdiff : scratch;
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < n_diff; k += kThreads) sdiff[k] = 0;
  }
  if (threadIdx.x == 0) block_rows = 0;
  __syncthreads();

  const int n = __ldg(nv);
  int rows = 0;
  // warp-uniform trip count (the device-memory adds need every lane)
  for (int b0 = blockIdx.x * kThreads * kUnroll; b0 < p;
       b0 += gridDim.x * kThreads * kUnroll) {
    int cnt[kUnroll], start[kUnroll], rect[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = b0 + u * kThreads + threadIdx.x;
      cnt[u] = i < p ? __ldg(counts + i) : 0;
      start[u] = i < p ? __ldg(offsets + i) - cnt[u] : n;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = b0 + u * kThreads + threadIdx.x;
      rect[u] = cnt[u] > 0 && start[u] < n ? __ldg(rectpack + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool adds = rect[u] >= 0;
      rows += adds;
      int top = -1, mid = -1, w = 0, q = 0, fr = 0;
      if (adds) {
        const int x0 = rect[u] >> 20;
        const int y0 = (rect[u] >> 10) & 1023;
        w = (rect[u] & 1023) + 1;
        q = min(cnt[u], n - start[u]);
        fr = q / w;
        top = y0 * stride + x0;
        mid = (y0 + fr) * stride + x0;
      }
      add<kShared>(acc, top, 1);
      add<kShared>(acc, adds ? top + w : -1, -1);
      add<kShared>(acc, mid, -1);
      add<kShared>(acc, adds ? mid + w : -1, 1);
      if (adds && q < cnt[u]) {  // the split row: one lane in the grid
        const int rem = q - fr * w;
        atomicAdd(acc + mid, 1);
        atomicAdd(acc + mid + rem, -1);
        atomicAdd(acc + mid + stride, -1);
        atomicAdd(acc + mid + stride + rem, 1);
      }
    }
  }

  rows = __reduce_add_sync(kFull, rows);
  if ((threadIdx.x & 31) == 0 && rows > 0) atomicAdd(&block_rows, rows);
  __syncthreads();
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < n_diff; k += kThreads) {
      const int v = sdiff[k];
      if (v != 0) atomicAdd(scratch + k, v);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(scratch + n_diff + 1, block_rows);
    last = atomicAdd(scratch + n_diff, 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: 2-D prefix sums of rows [0, grid_y) of the array
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < grid_y * stride; k += kThreads) {
      sdiff[k] = __ldcg(scratch + k);
    }
    __syncthreads();
  }
  for (int x = threadIdx.x; x < grid_x; x += kThreads) {
    int s = 0;
    for (int y = 0; y < grid_y; ++y) {
      s += load<kShared>(acc + y * stride + x);
      acc[y * stride + x] = s;
    }
  }
  __syncthreads();
  for (int y = threadIdx.x; y < grid_y; y += kThreads) {
    int s = 0;
    for (int x = 0; x < grid_x; ++x) {
      s += load<kShared>(acc + y * stride + x);
      out[y * grid_x + x] = s;
    }
  }
}

}  // namespace

extern "C" int tile_counts_launch(const void* offsets, const void* counts,
                                  const void* rectpack, int p, const void* nv,
                                  int grid_x, int grid_y, void* scratch,
                                  void* out, void* stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads * kUnroll;
  const int blocks = max(1, min(sms * kBlocksPerSm,
                                (p + per_block - 1) / per_block));
  const size_t bytes = sizeof(int) * static_cast<size_t>(grid_y + 1) *
                       static_cast<size_t>(grid_x + 1);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(offsets);
  const auto* c = static_cast<const int*>(counts);
  const auto* r = static_cast<const int*>(rectpack);
  const auto* v = static_cast<const int*>(nv);
  auto* d = static_cast<int*>(scratch);
  auto* t = static_cast<int*>(out);
  if (bytes <= kSmemBytes) {
    tile_counts_kernel<true><<<blocks, kThreads, bytes, s>>>(
        o, c, r, p, v, grid_x, grid_y, d, t);
  } else {
    tile_counts_kernel<false><<<blocks, kThreads, 0, s>>>(
        o, c, r, p, v, grid_x, grid_y, d, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most bytes of difference array the shared-memory variant takes.
extern "C" int tile_counts_smem_limit() { return kSmemBytes; }

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
