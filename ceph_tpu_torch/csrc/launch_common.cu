// A check of launch_common.cuh at the edge of its shared-memory opt-in: a
// kernel with static shared memory launched with exactly 48 KiB of dynamic
// shared memory. The two together pass the default 48 KiB, so the launch
// runs only if resident_blocks counts the static part when it decides to
// raise the kernel's limit (a launch of exactly this shape was refused with
// cudaErrorCooperativeLaunchTooLarge while it counted the dynamic part
// alone). Wrapper: ops/launch_check.py; run by tests/test_torch_gpu.py and
// chip_smoke.py's setup phase.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStaticWords = 256;  // 1 KiB of static shared memory

// Fills both buffers and sums them into sums[block]: word i of the static
// buffer holds i, word i of the dynamic one i * 2654435761 (mod 2^32).
__global__ void smem_edge_kernel(long long words, unsigned long long* sums) {
  __shared__ uint32_t fixed[kStaticWords];
  extern __shared__ uint32_t dyn[];
  for (int i = threadIdx.x; i < kStaticWords; i += blockDim.x) fixed[i] = i;
  for (long long i = threadIdx.x; i < words; i += blockDim.x)
    dyn[i] = (uint32_t)i * 2654435761u;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int i = 0; i < kStaticWords; ++i) s += fixed[i];
    for (long long i = 0; i < words; ++i) s += dyn[i];
    sums[blockIdx.x] = s;
  }
}

}  // namespace

// Launches `blocks` blocks with `dynamic_bytes` (a multiple of 4) of dynamic
// shared memory through launch_common::resident_blocks; *static_bytes gets
// the kernel's static shared memory. Returns 0 or a cudaError_t.
extern "C" int launch_smem_edge(long long dynamic_bytes, int blocks,
                                unsigned long long* sums, void* stream,
                                long long* static_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, smem_edge_kernel);
  if (err != cudaSuccess) return err;
  *static_bytes = (long long)attr.sharedSizeBytes;
  int dev = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = launch_common::resident_blocks(smem_edge_kernel, kThreads, dev,
                                       (size_t)dynamic_bytes, &per_sm);
  if (err != cudaSuccess) return err;
  smem_edge_kernel<<<blocks, kThreads, (size_t)dynamic_bytes,
                     static_cast<cudaStream_t>(stream)>>>(dynamic_bytes / 4,
                                                          sums);
  return cudaGetLastError();
}
