// Launch policy shared by the port's kernels: the packing of bitmatrix rows
// into uint32 masks, the card's opt-in shared-memory limit, and a
// grid-stride grid clamped to the blocks the card holds at once. Every
// csrc/*.cu includes it and builds into its own library, so the one
// non-inline definition below (launch_common_error) is one per library.
#pragma once

#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include <cuda_runtime.h>

namespace launch_common {

// Shared memory, static and dynamic together, that a block takes without
// raising its kernel's limit.
constexpr size_t kDefaultSmem = 48 * 1024;

// Text of this thread's last shared-memory refusal, naming the sizes.
inline char* failure_text() {
  static thread_local char text[192];
  return text;
}

// Packs bitmat [rows, cols] of 0/1 bytes into masks [rows, nw] (nw >=
// ceil(cols/32)): bit t of word q of row r is bitmat[r][q*32 + t], columns
// past cols read as 0. Called by every thread of a block, which then
// synchronises. All 32 byte loads of a word are in flight at once.
__device__ inline void pack_masks(const uint8_t* __restrict__ bitmat,
                                  int rows, int cols, int nw,
                                  uint32_t* masks) {
  for (int idx = threadIdx.x; idx < rows * nw; idx += blockDim.x) {
    const int r = idx / nw;
    const int q = idx - r * nw;
    const uint8_t* src = bitmat + (long long)r * cols + q * 32;
    uint32_t word = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if (q * 32 + t < cols) word |= (uint32_t)(src[t] & 1u) << t;
    masks[idx] = word;
  }
}

// The current device's opt-in shared memory per block, in bytes.
inline cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) *bytes = (size_t)optin;
  return err;
}

// Blocks of `kernel` that an SM holds with `threads` threads and `smem`
// bytes of dynamic shared memory on device `dev`. The occupancy query costs
// the host about as much as a short kernel's run, so it is made once per
// (kernel, device, smem), under a mutex. Where the kernel's static shared
// memory and `smem` together pass 48 KiB, the kernel's dynamic limit is
// first raised on the device, and never lowered, so that a launch with less
// still fits; a size past the card's opt-in limit is refused with
// cudaErrorInvalidValue and its sizes in failure_text().
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int dev, size_t smem,
                            int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> blocks;
  static std::map<std::pair<const void*, int>, size_t> smem_limit;
  static std::map<const void*, size_t> static_smem;
  const void* fn = reinterpret_cast<const void*>(kernel);
  failure_text()[0] = '\0';
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(fn, dev, smem);
  const auto hit = blocks.find(key);
  if (hit != blocks.end()) {
    *per_sm = hit->second;
    return cudaSuccess;
  }
  auto fixed = static_smem.find(fn);
  if (fixed == static_smem.end()) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    fixed = static_smem.emplace(fn, attr.sharedSizeBytes).first;
  }
  size_t& limit = smem_limit[std::make_pair(fn, dev)];
  if (fixed->second + smem > kDefaultSmem && smem > limit) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (fixed->second + smem > (size_t)optin) {
      snprintf(failure_text(), 192,
               "a block needs %zu bytes of static and %zu of dynamic shared "
               "memory, past the card's %d",
               fixed->second, smem, optin);
      return cudaErrorInvalidValue;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      snprintf(failure_text(), 192,
               "raising the dynamic shared memory to %zu bytes (static %zu) "
               "failed",
               smem, fixed->second);
      return err;
    }
    limit = smem;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, threads, smem);
  if (err == cudaSuccess) blocks[key] = *per_sm;
  return err;
}

// Grid of a grid-stride launch of `kernel` over `units` threads' work:
// one thread per unit, at most the blocks the card holds at once.
template <typename Kernel>
cudaError_t grid_blocks(Kernel kernel, int threads, size_t smem,
                        long long units, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = resident_blocks(kernel, threads, dev, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long blocks = (units + threads - 1) / threads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(blocks < resident ? blocks : resident);
  return cudaSuccess;
}

}  // namespace launch_common

// This thread's last shared-memory refusal ("" if none), for the wrapper's
// error message.
extern "C" const char* launch_common_error() {
  return launch_common::failure_text();
}
