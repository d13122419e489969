// The stage clock and the device counters of utils/profiling.py, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package times its stages from the host.
// A CUDA graph replays its kernels with no Python between them, so a
// stage boundary inside a graph can only be timed by the device itself.
// One launch is one thread: it reads the tracing flag and, when the flag
// is set, takes the next slot of a ring in device memory with an
// atomicAdd and writes two int64 words there: the entry's tag (its id,
// and what the host gave with it) and its value, %globaltimer (ns) for
// a stage boundary and the int32 at `value` for a counter.  When the
// flag is clear the thread returns at once: a graph captured with
// tracing off holds these nodes and costs one early exit each until
// tracing is turned on.
// A slot past the ring's end is not written; the host counts those from
// the cursor (stamps_dropped).  Bound by launch latency, not by bytes or
// operations: 16 bytes a stamp.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(const int* __restrict__ flag,
                             unsigned long long* __restrict__ cursor,
                             long long* __restrict__ ring, long long capacity,
                             long long tag, const int* __restrict__ value) {
  if (*flag == 0) return;
  long long v;
  if (value == nullptr) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  } else {
    v = *value;
  }
  const unsigned long long slot = atomicAdd(cursor, 1ULL);
  if (slot < static_cast<unsigned long long>(capacity)) {
    ring[2 * slot] = tag;
    ring[2 * slot + 1] = v;
  }
}

}  // namespace

extern "C" int stamp_launch(const void* flag, void* cursor, void* ring,
                            long long capacity, long long tag,
                            const void* value, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flag),
      static_cast<unsigned long long*>(cursor), static_cast<long long*>(ring),
      capacity, tag, static_cast<const int*>(value));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3dgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
