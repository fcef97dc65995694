// Chunk digest of the HBM chunk tier, for sm_90a.
//
// Replaces the XLA program of ceph_tpu/osd/hbm_tier.py:60-78
// (_device_digest), which deep scrub runs over every resident chunk:
//
//   s[r]  = sum_i x[r, i]                          mod 2^32
//   ws[r] = sum_i x[r, i] * ((i mod 65535) + 1)    mod 2^32
//
// for rows x [rows, n] of bytes. Addition mod 2^32 is exact in any order,
// so the rows may be cut anywhere and the pieces summed with atomics. The
// rows are one contiguous [rows, n] array, or rows of n bytes anywhere,
// named by a table of their device addresses: deep scrub digests the
// objects it names where the tier holds them, in their upload batches,
// without gathering them into one array first.
//
// Bound. The function reads each byte once and writes 8 bytes a row; at
// the tier's shapes (11 to 11,264 rows of 128 KiB to 512 KiB) that is
// bytes at 3.35 TB/s. Its integer work is counted from the SASS of the
// 16-byte step below (utils/cuda_timing.py DIGEST_VECTOR_OPS) at 64
// INT32 lanes an SM a clock, well under the bytes' time.
//
// Design: one launch over rows * spans blocks' work, a span being 32 KiB
// of one row (the last one of a row shorter), so that a few long rows
// still fill the 132 SMs; the grid is the blocks the card holds at once,
// each taking spans in turn.
//  * With rows on 16 bytes (n % 16 == 0 and an aligned pointer) a thread
//    reads 16-byte vectors 4096 bytes apart. Its weight w0 = (i mod
//    65535) + 1 is computed once and stepped by 4096 with one wrap test.
//    A vector's byte sum and its sum of j * x_j (j = 0..15) are four
//    __dp4a each (the weights 0..15 fit a byte), so it adds
//    s += vs, ws += w0 * vs + vj. A vector that straddles the weight's
//    wrap (w0 > 65520, 15 of the 65535 weights) takes the byte loop.
//  * Otherwise a thread reads bytes 256 apart, its weight stepped by 256.
//  * A warp reduces with shuffles, the block through shared memory; a row
//    of one span is written at once. Longer rows add into a scratch
//    triple (s, ws, count) with atomics; the block that brings the count
//    to the row's spans, after a fence, swaps the sums out into the
//    result and zeroes the triple. The scratch is all zeros between calls
//    (kept per stream by the wrapper), so no memset precedes a launch.
//
// Rows of 0 bytes get one block each and digest to (0, 0).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecsPerThread = 8;
constexpr long long kSpan = 16LL * kThreads * kVecsPerThread;  // 32 KiB
constexpr uint32_t kPeriod = 0xFFFF;                            // 65535

// Kernel launches, counted where the kernel is launched.
std::atomic<long long> g_launches;

long long spans_of(long long n) {
  return n <= kSpan ? 1 : (n + kSpan - 1) / kSpan;
}

// Adds the 16 bytes of x, whose first byte has weight w0, into (s, ws).
__device__ __forceinline__ void add_vector(const uint4 x, const uint32_t w0,
                                           uint32_t& s, uint32_t& ws) {
  if (w0 <= kPeriod - 15) {
    uint32_t vs = __dp4a(x.x, 0x01010101u, 0u);
    vs = __dp4a(x.y, 0x01010101u, vs);
    vs = __dp4a(x.z, 0x01010101u, vs);
    vs = __dp4a(x.w, 0x01010101u, vs);
    uint32_t vj = __dp4a(x.x, 0x03020100u, 0u);
    vj = __dp4a(x.y, 0x07060504u, vj);
    vj = __dp4a(x.z, 0x0B0A0908u, vj);
    vj = __dp4a(x.w, 0x0F0E0D0Cu, vj);
    s += vs;
    ws += w0 * vs + vj;
    return;
  }
  // the weight wraps from 65535 to 1 inside this vector
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
  uint32_t w = w0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uint32_t v = (words[b / 4] >> (8 * (b % 4))) & 0xFFu;
    s += v;
    ws += v * w;
    w = w == kPeriod ? 1u : w + 1u;
  }
}

__global__ void __launch_bounds__(kThreads)
digest_kernel(const uint8_t* __restrict__ data,
              const unsigned long long* __restrict__ row_addrs,
              long long rows, long long n, long long spans, bool vec_ok,
              uint32_t* __restrict__ scratch, uint32_t* __restrict__ out_s,
              uint32_t* __restrict__ out_ws) {
  __shared__ uint32_t part_s[kWarps];
  __shared__ uint32_t part_ws[kWarps];
  const long long work = rows * spans;
  for (long long item = blockIdx.x; item < work; item += gridDim.x) {
    const long long row = item / spans;
    const long long start = (item - row * spans) * kSpan;
    const long long end = start + kSpan < n ? start + kSpan : n;
    const uint8_t* base =
        row_addrs ? reinterpret_cast<const uint8_t*>(row_addrs[row])
                  : data + row * n;
    uint32_t s = 0, ws = 0;
    if (vec_ok) {
      long long i = start + 16LL * threadIdx.x;
      uint32_t w = (uint32_t)(i % kPeriod) + 1u;
#pragma unroll 4
      for (; i < end; i += 16LL * kThreads) {
        add_vector(__ldcs(reinterpret_cast<const uint4*>(base + i)), w, s,
                   ws);
        w += 16u * kThreads;
        if (w > kPeriod) w -= kPeriod;
      }
    } else {
      long long i = start + threadIdx.x;
      uint32_t w = (uint32_t)(i % kPeriod) + 1u;
      for (; i < end; i += kThreads) {
        const uint32_t v = base[i];
        s += v;
        ws += v * w;
        w += kThreads;
        if (w > kPeriod) w -= kPeriod;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
      ws += __shfl_xor_sync(0xFFFFFFFFu, ws, o);
    }
    if (threadIdx.x % 32 == 0) {
      part_s[threadIdx.x / 32] = s;
      part_ws[threadIdx.x / 32] = ws;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s = 0;
      ws = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += part_s[w];
        ws += part_ws[w];
      }
      if (spans == 1) {
        out_s[row] = s;
        out_ws[row] = ws;
      } else {
        uint32_t* acc = scratch + 3 * row;
        atomicAdd(acc, s);
        atomicAdd(acc + 1, ws);
        __threadfence();
        if (atomicAdd(acc + 2, 1u) == (uint32_t)(spans - 1)) {
          out_s[row] = atomicExch(acc, 0u);
          out_ws[row] = atomicExch(acc + 1, 0u);
          atomicExch(acc + 2, 0u);
        }
      }
    }
    __syncthreads();  // part_* are written again by the next item
  }
}

}  // namespace

// uint32 words of scratch a call over [rows, n] needs (all zeros).
extern "C" long long hbm_digest_scratch_words(long long rows, long long n) {
  return spans_of(n) > 1 ? 3 * rows : 0;
}

// Kernel launches since the last reset.
extern "C" long long hbm_digest_launches() { return g_launches.load(); }

extern "C" void hbm_digest_reset_launches() { g_launches.store(0); }

// data [rows, n] uint8 contiguous, or, when row_addrs is not null, the
// rows at the device addresses row_addrs [rows] (uint64 on the device;
// rows_aligned: every address is a multiple of 16); out_s, out_ws [rows]
// uint32; scratch hbm_digest_scratch_words(rows, n) uint32 of zeros, which
// the launch leaves zero. Returns 0, a cudaError_t code, or -1 for a bad
// argument. Launches on `stream` and does not synchronise.
extern "C" int hbm_digest(const void* data, const void* row_addrs,
                          int rows_aligned, long long rows, long long n,
                          void* scratch, void* out_s, void* out_ws,
                          void* stream) {
  if (rows < 0 || n < 0 || (n >= (1LL << 40))) return -1;
  if (rows == 0) return 0;
  // the rows' bytes come from one of the two; rows of 0 bytes need neither
  if (data != nullptr && row_addrs != nullptr) return -1;
  if (data == nullptr && row_addrs == nullptr && n > 0) return -1;
  const long long spans = spans_of(n);
  if (spans > 1 && scratch == nullptr) return -1;
  unsigned grid = 0;
  cudaError_t err = launch_common::grid_blocks(
      digest_kernel, kThreads, 0, rows * spans * kThreads, &grid);
  if (err != cudaSuccess) return (int)err;
  const bool vec_ok =
      n % 16 == 0 && (row_addrs ? rows_aligned != 0
                                : reinterpret_cast<uintptr_t>(data) % 16 == 0);
  digest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<const unsigned long long*>(row_addrs), rows, n, spans,
      vec_ok,
      static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(out_s),
      static_cast<uint32_t*>(out_ws));
  err = cudaGetLastError();
  if (err == cudaSuccess) g_launches.fetch_add(1);
  return (int)err;
}
