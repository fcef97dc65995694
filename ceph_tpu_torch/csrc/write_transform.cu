// The OSD's fused write transform, for sm_90a: the digests and the
// bit-plane compressor that surround the GF encode of a whole-object write.
//
// Replaces the XLA steps of ceph_tpu/osd/fused_transform.py:_build_program
// (:485) other than the encode, which runs csrc/gf_bitmatrix.cu:
//
//  K1 crc32_rows   _crc_raw_tree (:354), _crc32_full (:373) and
//                  _crc_unshift (:381); device_crc32 (:579). The standard
//                  reflected CRC-32 (init 0xFFFFFFFF, xor-out 0xFFFFFFFF)
//                  of every row of a strided byte array, for either
//                  polynomial (crc32c 0x82F63B78 over the raw chunks, zlib
//                  0xEDB88320 over the shard streams), optionally
//                  un-shifted by a pad length read from device memory.
//  K2 xxh32_rows   _xxh32_dev (:392): xxh32, seed 0, of every row.
//  K3 bitplane     the histogram, entropy probe and decision (:515-535)
//                  and _bitplane_dev (:442): the 64-byte-block bit-plane
//                  container, the compress-or-store decision and the
//                  stored stream [cap2].
//
// Bounds on an H100 SXM (3.35 TB/s; utils/cuda_timing.py computes them):
//  K1 and K3 are bound by bytes: each input byte read once, each output
//  byte written once (K1 of the 11 shard streams of a 4 MiB object moves
//  5.8 MB: 1.7 us; K3 reads N and writes cap2 ~ 1.03 N: 2.5 us at 4 MiB).
//  K2 is bound by the larger of its bytes and its chain: a row's xxh32 is
//  chunk/16 dependent rounds, each a multiply-add, a rotate and a multiply
//  on one of 4 independent lanes, 12 cycles of latency a round (IMAD 4,
//  funnel-shift rotate 4, IMUL 4). At the highest SM clock, 1.98 GHz, a
//  4096-byte chunk is 256 rounds, 1.55 us, and a 65536-byte chunk 4096
//  rounds, 24.8 us, however many rows run beside it.
//
// Design (simple; speed is later work):
//  * K1 is one launch. A row is cut into 64-byte units (128-byte units
//    for an aligned row of 2049 to 4096 bytes, so that one warp takes
//    it whole) and front-padded with zero bytes to whole spans of 32
//    units, so that a warp never straddles two rows (leading zero bytes
//    leave a CRC register of 0 at 0). A warp takes one span, a lane one
//    unit: the lane's raw CRC runs 16 bytes a step by slicing-by-16 (16
//    tables of 256 words in shared memory, 16 independent lookups a
//    step, so a 64-byte unit is 4 dependent steps on the aligned path;
//    the byte path steps a byte at a time through the first table). A
//    block loads the tables and matrices 16 bytes a load, all of a
//    thread's loads in flight at once. The init register enters
//    where the row's first byte does (the register is XORed with
//    0xFFFFFFFF there), so no shift_len(0xFFFFFFFF) is computed at all.
//    The warp then combines its 32 units in a 5-level shuffle tree, level
//    l applying the "append 2^l units" matrix to the left half
//    (crc(A|B) = shift_|B|(crc(A)) ^ crc(B)). A row of one span is done
//    there. Otherwise each warp carries its span's word past the spans
//    after it (the "append 2^l bytes" matrices of the set bits of that
//    byte count), stores it and counts its arrival on the row; the last
//    warp of the row XORs the row's span words, un-shifts the pad with
//    the inverse matrices, applies the xor-out and writes the CRC. It
//    then zeroes the counter and the span words it read, so the scratch
//    is all zeros again for the next call on the stream.
//  * K2 runs one thread per row, a warp per block, so that the few rows of
//    a write spread over the SMs. Aligned rows stream through shared
//    memory in 256-byte tiles with cp.async, several tiles in flight, so
//    the loads overlap the chain; ragged rows load bytes directly.
//  * K3 is three launches. (A) one thread per 64-byte block: the
//    histogram (per-warp bins in shared memory, then global atomics), the
//    8x8 bit transposes, flags and consts, and each tile's count of
//    stored planes. (B) one block: the entropy in a fixed summation
//    order, the exclusive scan of the tile counts, comp_len, the probe,
//    the ratio test in 64-bit integers and the decision. (C) one thread
//    per block again: a block scan places each stored plane, and the
//    selected stream (container or raw bytes) and its zero tail are
//    written into stored.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kLevels = 31;       // shift matrices for 2^0 .. 2^30 bytes
constexpr int kRunLog2 = 6;       // bytes of a K1 unit: 64, or 128 where
constexpr int kWideRunLog2 = 7;   // that makes an aligned row one span
constexpr int kSlices = 16;       // slicing-by-16 tables
constexpr int kShiftAt = 256;     // consts: table, shifts, inverses, T_1..T_15
constexpr int kInvAt = kShiftAt + kLevels * 32;
constexpr int kSliceAt = kInvAt + kLevels * 32;
constexpr int kCrcThreads = 256;
constexpr int kBlock = 64;        // bytes of one bit-plane block
constexpr int kBpThreads = 256;   // 64-byte blocks per K3 tile
constexpr int kXxhTile = 256;     // bytes of a row per K2 stage
constexpr int kXxhPitch = kXxhTile + 16;  // conflict-free 16-byte reads
constexpr int kXxhStages = 6;
constexpr size_t kXxhSmem = (size_t)kXxhStages * 32 * kXxhPitch;

enum Launch {
  kCrcRows = 0,
  kXxh,
  kBpCount,
  kBpDecide,
  kBpScatter,
  kNumLaunch
};

// Kernel launches of each kind, counted where each kernel is launched.
std::atomic<long long> g_launches[kNumLaunch];

constexpr uint32_t kP1 = 2654435761u, kP2 = 2246822519u, kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u, kP5 = 374761393u;

// M . x for a 32x32 GF(2) matrix stored as 32 column masks; four
// independent sums keep the dependent chain at 8 + 2 XORs.
__device__ __forceinline__ uint32_t mat_apply(const uint32_t* m, uint32_t x) {
  uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) r[j & 3] ^= m[j] & (0u - ((x >> j) & 1u));
  return (r[0] ^ r[1]) ^ (r[2] ^ r[3]);
}

// The register after appending n zero bytes (n < 2^31).
__device__ uint32_t shift_bytes(const uint32_t* shift, uint32_t c,
                                unsigned long long n, int lvl) {
  while (n) {
    if (n & 1ull) c = mat_apply(shift + lvl * 32, c);
    n >>= 1;
    ++lvl;
  }
  return c;
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shuffle tree of a warp: lane l holds the raw CRC of the l-th of 32
// consecutive pieces of 2^level0 bytes; every lane returns the raw CRC
// of their concatenation. Level i applies the "append 2^(level0 + i)
// bytes" matrix to the left half of each pair of groups.
__device__ __forceinline__ uint32_t warp_tree(const uint32_t* shift,
                                              uint32_t v, int level0,
                                              int lane) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, v, 1 << l);
    const bool right = (lane >> l) & 1;
    v = mat_apply(shift + (level0 + l) * 32, right ? o : v) ^ (right ? v : o);
  }
  return v;
}

// ---- K1: CRC of strided rows ------------------------------------------

// One slicing-by-16 step: the register after the 16 bytes of v.
__device__ __forceinline__ uint32_t slice16(const uint32_t* tab, uint32_t c,
                                            uint4 v) {
  const uint32_t x = v.x ^ c;
  return tab[15 * 256 + (x & 0xffu)] ^ tab[14 * 256 + ((x >> 8) & 0xffu)] ^
         tab[13 * 256 + ((x >> 16) & 0xffu)] ^ tab[12 * 256 + (x >> 24)] ^
         tab[11 * 256 + (v.y & 0xffu)] ^ tab[10 * 256 + ((v.y >> 8) & 0xffu)] ^
         tab[9 * 256 + ((v.y >> 16) & 0xffu)] ^ tab[8 * 256 + (v.y >> 24)] ^
         tab[7 * 256 + (v.z & 0xffu)] ^ tab[6 * 256 + ((v.z >> 8) & 0xffu)] ^
         tab[5 * 256 + ((v.z >> 16) & 0xffu)] ^ tab[4 * 256 + (v.z >> 24)] ^
         tab[3 * 256 + (v.w & 0xffu)] ^ tab[2 * 256 + ((v.w >> 8) & 0xffu)] ^
         tab[256 + ((v.w >> 16) & 0xffu)] ^ tab[v.w >> 24];
}

// The standard CRC from a row's register (init included): a row of no
// bytes has the init register, the pad is undone, then the xor-out.
__device__ uint32_t crc_out(uint32_t reg, long long len,
                            const uint32_t* __restrict__ consts,
                            const long long* __restrict__ pad) {
  if (len == 0) reg = 0xffffffffu;
  if (pad != nullptr)  // undo the zero tail: inverse shifts
    reg = shift_bytes(consts + kInvAt, reg, (unsigned long long)*pad, 0);
  return reg ^ 0xffffffffu;
}

// At least 2 blocks an SM: 128 registers a thread, so that the last
// warp's 32 loads in flight do not spill.
template <int VEC, int RUN_LOG2>
__global__ void __launch_bounds__(kCrcThreads, 2)
crc_rows_kernel(const uint8_t* __restrict__ src, long long nrows,
                long long row_stride, long long seg_stride, long long seglen,
                long long len, long long spans,
                const uint32_t* __restrict__ consts,
                const long long* __restrict__ pad,
                uint32_t* __restrict__ scratch, uint32_t* __restrict__ out) {
  constexpr int kTab = VEC == 16 ? kSlices * 256 : 256;
  __shared__ __align__(16) uint32_t tab[kTab];  // T_0, then T_1..T_15
  __shared__ __align__(16) uint32_t shift[kLevels * 32];
  {  // all of a thread's 16-byte loads in flight at once
    constexpr int kTab4 = kTab / 4, kAll4 = kTab4 + kLevels * 8;
    constexpr int kPer = (kAll4 + kCrcThreads - 1) / kCrcThreads;
    const uint4* c4 = reinterpret_cast<const uint4*>(consts);
    uint4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kCrcThreads;
      if (i < kAll4)
        v[j] = __ldg(c4 + (i < 64      ? i
                           : i < kTab4 ? kSliceAt / 4 + i - 64
                                       : kShiftAt / 4 + i - kTab4));
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kCrcThreads;
      if (i < kTab4)
        reinterpret_cast<uint4*>(tab)[i] = v[j];
      else if (i < kAll4)
        reinterpret_cast<uint4*>(shift)[i - kTab4] = v[j];
    }
  }
  __syncthreads();

  constexpr int kRun = 1 << RUN_LOG2;       // bytes of a unit
  constexpr int kSpanLog2 = RUN_LOG2 + 5;   // a warp's 32 units
  const int lane = threadIdx.x & 31;
  const long long lead = (spans << kSpanLog2) - len;  // leading zero bytes
  const long long total = nrows * spans;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  unsigned* count = reinterpret_cast<unsigned*>(scratch);  // [nrows]
  uint32_t* words = scratch + nrows;                       // [nrows, spans]
  for (long long g = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       g < total; g += warps) {
    const long long row = g / spans;
    const long long unit = (g - row * spans) * 32 + lane;
    long long p = unit * kRun - lead;  // logical bytes [p, end)
    const long long end = p + kRun;
    uint32_t c = 0;
    if (end > 0) {
      if (p < 0) p = 0;
      const bool first = p == 0;  // the row's first byte: the init register
      const uint8_t* rowp = src + row * row_stride;
      long long seg = p / seglen;
      long long off = p - seg * seglen;
      if constexpr (VEC == 16) {
        const int nq = (int)((end - p) >> 4);
        uint4 v[kRun / 16];
#pragma unroll
        for (int q = 0; q < kRun / 16; ++q) {
          if (q < nq) {
            v[q] = __ldg(reinterpret_cast<const uint4*>(rowp + seg * seg_stride +
                                                        off));
            off += 16;
            if (off == seglen) {
              off = 0;
              ++seg;
            }
          }
        }
        if (first) c = 0xffffffffu;
#pragma unroll
        for (int q = 0; q < kRun / 16; ++q)
          if (q < nq) c = slice16(tab, c, v[q]);
      } else {
        if (first) c = 0xffffffffu;
        for (; p < end; ++p) {
          c = tab[(c ^ __ldg(rowp + seg * seg_stride + off)) & 0xffu] ^ (c >> 8);
          if (++off == seglen) {
            off = 0;
            ++seg;
          }
        }
      }
    }
    c = warp_tree(shift, c, RUN_LOG2, lane);
    if (spans == 1) {
      if (lane == 0) out[row] = crc_out(c, len, consts, pad);
      continue;
    }
    // this span's word carried past the spans after it, so that the
    // row's register is the XOR of its spans' words
    c = shift_bytes(shift, c,
                    (unsigned long long)(spans - 1 - (g - row * spans)),
                    kSpanLog2);
    unsigned last = 0;
    if (lane == 0) {
      words[g] = c;
      __threadfence();  // the word before the arrival
      last = atomicAdd(&count[row], 1u) == (unsigned)(spans - 1);
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    __threadfence();  // every span's word is visible
    uint32_t acc = 0;
    uint32_t* row_words = words + row * spans;
    for (long long i0 = 0; i0 < spans; i0 += 32 * 32) {  // 32 loads in flight
      uint32_t w32[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const long long i = i0 + j * 32 + lane;
        w32[j] = i < spans ? __ldcg(row_words + i) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const long long i = i0 + j * 32 + lane;
        if (i < spans) row_words[i] = 0;  // scratch back to zeros
        acc ^= w32[j];
      }
    }
    acc = warp_xor(acc);
    if (lane == 0) {
      out[row] = crc_out(acc, len, consts, pad);
      count[row] = 0;
    }
  }
}

// ---- K2: xxh32 of rows ------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t xxh_round(uint32_t acc, uint32_t w) {
  return rotl(acc + w * kP2, 13) * kP1;
}

__device__ __forceinline__ uint32_t load_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__device__ uint32_t xxh_finish(uint32_t h, const uint8_t* p, long long i,
                               long long len) {
  h += (uint32_t)len;
  for (; i + 4 <= len; i += 4) h = rotl(h + load_le32(p + i) * kP3, 17) * kP4;
  for (; i < len; ++i) h = rotl(h + (uint32_t)p[i] * kP5, 11) * kP1;
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  return h ^ (h >> 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Aligned rows (len % 16 == 0, 16-byte aligned base): a warp per block,
// one row per lane, tiles of kXxhTile bytes of 32 rows staged through
// shared memory, kXxhStages - 1 tiles in flight ahead of the chain.
__global__ void __launch_bounds__(32)
xxh32_staged_kernel(const uint8_t* __restrict__ src, long long nrows,
                    long long len, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t xsmem[];
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * 32;
  const int rows = (int)(nrows - r0 < 32 ? nrows - r0 : 32);
  const long long tiles = (len + kXxhTile - 1) / kXxhTile;

  auto stage_tile = [&](long long t) {
    if (t < tiles) {
      const long long base = t * kXxhTile;
      const int tb = (int)(len - base < kXxhTile ? len - base : kXxhTile);
      const int per_row = tb / 16;
      uint8_t* stage = xsmem + (size_t)(t % kXxhStages) * 32 * kXxhPitch;
      for (int idx = lane; idx < rows * per_row; idx += 32) {
        const int r = idx / per_row;
        const int q = idx - r * per_row;
        cp_async16(stage + r * kXxhPitch + q * 16,
                   src + (r0 + r) * len + base + q * 16);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  for (int s = 0; s < kXxhStages - 1; ++s) stage_tile(s);
  uint32_t a1 = kP1 + kP2, a2 = kP2, a3 = 0, a4 = 0u - kP1;
  for (long long t = 0; t < tiles; ++t) {
    stage_tile(t + kXxhStages - 1);
    cp_async_wait<kXxhStages - 1>();
    __syncwarp();
    if (lane < rows) {
      const long long base = t * kXxhTile;
      const int tb = (int)(len - base < kXxhTile ? len - base : kXxhTile);
      const uint4* q = reinterpret_cast<const uint4*>(
          xsmem + (size_t)(t % kXxhStages) * 32 * kXxhPitch +
          lane * kXxhPitch);
      for (int i = 0; i < tb / 16; ++i) {
        const uint4 v = q[i];
        a1 = xxh_round(a1, v.x);
        a2 = xxh_round(a2, v.y);
        a3 = xxh_round(a3, v.z);
        a4 = xxh_round(a4, v.w);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  if (lane < rows) {
    const uint32_t h = len >= 16 ? rotl(a1, 1) + rotl(a2, 7) + rotl(a3, 12) +
                                       rotl(a4, 18)
                                 : kP5;
    out[r0 + lane] = xxh_finish(h, src + (r0 + lane) * len, (len / 16) * 16,
                                len);
  }
}

// Any rows: one thread per row, bytes loaded directly.
__global__ void __launch_bounds__(32)
xxh32_bytes_kernel(const uint8_t* __restrict__ src, long long nrows,
                   long long len, uint32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x;
  if (row >= nrows) return;
  const uint8_t* p = src + row * len;
  const long long nblk = len / 16;
  uint32_t h = kP5;
  if (nblk) {
    uint32_t a1 = kP1 + kP2, a2 = kP2, a3 = 0, a4 = 0u - kP1;
    for (long long i = 0; i < nblk; ++i) {
      const uint8_t* b = p + i * 16;
      a1 = xxh_round(a1, load_le32(b));
      a2 = xxh_round(a2, load_le32(b + 4));
      a3 = xxh_round(a3, load_le32(b + 8));
      a4 = xxh_round(a4, load_le32(b + 12));
    }
    h = rotl(a1, 1) + rotl(a2, 7) + rotl(a3, 12) + rotl(a4, 18);
  }
  out[row] = xxh_finish(h, p, nblk * 16, len);
}

// ---- K3: bit-plane compress, probe and decision -----------------------

// The 64 bytes of block b (zeros past n), as 8 little-endian words.
__device__ __forceinline__ void load_block(const uint8_t* __restrict__ flat,
                                           long long n, long long b,
                                           bool aligned, uint64_t g[8]) {
  const long long start = b * kBlock;
  if (aligned && start + kBlock <= n) {
    const uint4* q = reinterpret_cast<const uint4*>(flat + start);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = __ldg(q + i);
      g[2 * i] = (uint64_t)v.x | ((uint64_t)v.y << 32);
      g[2 * i + 1] = (uint64_t)v.z | ((uint64_t)v.w << 32);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t w = 0;
    for (int t = 0; t < 8; ++t) {
      const long long at = start + i * 8 + t;
      if (at < n) w |= (uint64_t)__ldg(flat + at) << (8 * t);
    }
    g[i] = w;
  }
}

// 8x8 bit transpose: byte p, bit t of the result = byte t, bit p of x.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// planes[p] holds plane p's 8 bytes (group g in byte g); flags and consts
// as in the container header.
__device__ __forceinline__ void block_planes(const uint64_t g[8],
                                             uint64_t planes[8],
                                             uint32_t* flags,
                                             uint32_t* consts) {
  uint64_t y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = transpose8(g[i]);
  uint32_t f = 0, c = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint64_t v = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) v |= ((y[i] >> (8 * p)) & 0xffull) << (8 * i);
    planes[p] = v;
    const bool all0 = v == 0ull;
    const bool all1 = v == ~0ull;
    f |= (uint32_t)(!(all0 || all1)) << p;
    c |= (uint32_t)all1 << p;
  }
  *flags = f;
  *consts = c;
}

// Exclusive block-wide scan of v over kBpThreads threads; *total gets the
// sum. Called by every thread of the block.
__device__ uint32_t block_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sum[kBpThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  uint32_t before = 0, sum = 0;
  for (int w = 0; w < kBpThreads / 32; ++w) {
    if (w < warp) before += warp_sum[w];
    sum += warp_sum[w];
  }
  __syncthreads();  // warp_sum is reused by the next call
  *total = sum;
  return before + x - v;
}

// (A) histogram, and the stored planes of each tile of kBpThreads blocks.
__global__ void __launch_bounds__(kBpThreads)
bp_count_kernel(const uint8_t* __restrict__ flat, long long n, long long nb,
                bool aligned, uint32_t* __restrict__ hist,
                uint32_t* __restrict__ tile_count) {
  __shared__ uint32_t bins[kBpThreads / 32][256];
  for (int i = threadIdx.x; i < (kBpThreads / 32) * 256; i += blockDim.x)
    (&bins[0][0])[i] = 0;
  __syncthreads();
  const long long b = (long long)blockIdx.x * kBpThreads + threadIdx.x;
  uint32_t stored = 0;
  if (b < nb) {
    uint64_t g[8], planes[8];
    load_block(flat, n, b, aligned, g);
    uint32_t* mine = bins[threadIdx.x >> 5];
    const long long real = n - b * kBlock;  // bytes of this block in n
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (i * 8 + t < real) atomicAdd(&mine[(g[i] >> (8 * t)) & 0xffu], 1u);
    uint32_t flags, consts;
    block_planes(g, planes, &flags, &consts);
    stored = __popc(flags);
  }
  uint32_t total;
  block_scan(stored, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
  for (int bin = threadIdx.x; bin < 256; bin += blockDim.x) {
    uint32_t s = 0;
    for (int w = 0; w < kBpThreads / 32; ++w) s += bins[w][bin];
    if (s) atomicAdd(&hist[bin], s);
  }
}

// (B) one block of 1024 threads: entropy, probe, scan of the tile counts
// (in place: tile_count becomes each tile's first stored plane), comp_len
// and the decision. dec = [comp_len, do_compress, probe_ok,
// entropy_milli, used_stripes, pad_bytes].
__global__ void __launch_bounds__(1024)
bp_decide_kernel(const uint32_t* __restrict__ hist, long long n,
                 long long nb, long long tiles, long long cap2, long long sw,
                 long long chunk, int required_milli, int entropy_max_milli,
                 uint32_t* __restrict__ tile_count,
                 long long* __restrict__ dec) {
  __shared__ float terms[256];
  __shared__ uint32_t warp_sum[32];
  __shared__ long long carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 256) {
    const uint32_t cnt = hist[tid];
    const float p = (float)cnt / (float)n;
    terms[tid] = cnt ? p * log2f(fmaxf(p, 1e-12f)) : 0.0f;
  }
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int s = 128; s; s >>= 1) {  // fixed pairwise order
    if (tid < s) terms[tid] += terms[tid + s];
    __syncthreads();
  }
  for (long long base = 0; base < tiles; base += 1024) {
    const long long i = base + tid;
    const uint32_t v = i < tiles ? tile_count[i] : 0u;
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    long long before = carry;
    long long sum = 0;
    for (int w = 0; w < 32; ++w) {
      if (w < warp) before += warp_sum[w];
      sum += warp_sum[w];
    }
    if (i < tiles) tile_count[i] = (uint32_t)(before + x - v);
    __syncthreads();
    if (tid == 0) carry += sum;
    __syncthreads();
  }
  if (tid == 0) {
    const float ent = -terms[0];
    const int milli = (int)(ent * 1000.0f);
    const bool probe_ok = milli <= entropy_max_milli;
    const long long comp_len = 2 * nb + 8 * carry;
    const bool ratio_ok = comp_len * 1000 <= n * (long long)required_milli;
    const bool do_compress = probe_ok && ratio_ok;
    const long long stored_len = do_compress ? comp_len : n;
    const long long used = (stored_len + sw - 1) / sw;
    dec[0] = comp_len;
    dec[1] = do_compress;
    dec[2] = probe_ok;
    dec[3] = milli;
    dec[4] = used;
    dec[5] = (cap2 / sw - used) * chunk;
  }
}

// (C) the stored stream: the container (header, stored planes) or the raw
// bytes, then zeros up to cap2.
__global__ void __launch_bounds__(kBpThreads)
bp_scatter_kernel(const uint8_t* __restrict__ flat, long long n, long long nb,
                  bool aligned, long long cap2,
                  const uint32_t* __restrict__ tile_first,
                  const long long* __restrict__ dec,
                  uint8_t* __restrict__ stored) {
  const bool compress = dec[1] != 0;
  const long long b = (long long)blockIdx.x * kBpThreads + threadIdx.x;
  uint64_t g[8], planes[8];
  uint32_t flags = 0, consts = 0;
  if (b < nb) load_block(flat, n, b, aligned, g);
  if (compress) {
    if (b < nb) block_planes(g, planes, &flags, &consts);
    uint32_t total;
    const uint32_t rank = block_scan(__popc(flags), &total);
    if (b < nb) {
      stored[2 * b] = (uint8_t)flags;
      stored[2 * b + 1] = (uint8_t)consts;
      uint8_t* dst = stored + 2 * nb + 8 * ((long long)tile_first[blockIdx.x] +
                                            rank);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (flags >> p & 1u) {
#pragma unroll
          for (int t = 0; t < 8; ++t) dst[t] = (uint8_t)(planes[p] >> (8 * t));
          dst += 8;
        }
      }
    }
  } else if (b < nb) {
    const long long start = b * kBlock;
    if (start + kBlock <= n) {
      uint4* q = reinterpret_cast<uint4*>(stored + start);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = make_uint4((uint32_t)g[2 * i], (uint32_t)(g[2 * i] >> 32),
                          (uint32_t)g[2 * i + 1],
                          (uint32_t)(g[2 * i + 1] >> 32));
    } else {
      for (long long at = start; at < n; ++at)
        stored[at] = (uint8_t)(g[(at - start) >> 3] >> (8 * ((at - start) & 7)));
    }
  }
  // zeros from the end of the selected stream to cap2
  const long long zfrom = compress ? dec[0] : n;
  const long long a16 = (zfrom + 15) / 16 * 16 < cap2 ? (zfrom + 15) / 16 * 16
                                                       : cap2;
  const long long e16 = cap2 / 16 * 16 > a16 ? cap2 / 16 * 16 : a16;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long at = zfrom + tid; at < a16; at += nthreads) stored[at] = 0;
  for (long long at = a16 / 16 + tid; at < e16 / 16; at += nthreads)
    reinterpret_cast<uint4*>(stored)[at] = make_uint4(0u, 0u, 0u, 0u);
  for (long long at = e16 + tid; at < cap2; at += nthreads) stored[at] = 0;
}

cudaError_t counted(Launch kind) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[kind].fetch_add(1);
  return err;
}

// Spans of 32 units of 2^run_log2 bytes K1 cuts a row of `len` bytes
// into (at least one).
long long crc_spans(long long len, int run_log2) {
  const long long span = 1ll << (run_log2 + 5);
  const long long spans = (len + span - 1) / span;
  return spans > 0 ? spans : 1;
}

}  // namespace

// Launches of kernel `kind` (0 crc_rows, 1 xxh32, 2 bp_count,
// 3 bp_decide, 4 bp_scatter) since the last reset, or -1.
extern "C" long long wt_launches(int kind) {
  return kind >= 0 && kind < kNumLaunch ? g_launches[kind].load() : -1;
}

extern "C" void wt_reset_launches() {
  for (auto& count : g_launches) count.store(0);
}

// uint32 words of scratch K1 needs for nrows rows of `len` bytes: a
// counter per row and a word per span of a row, none for rows of one
// span.
extern "C" long long wt_crc_scratch_words(long long nrows, long long len) {
  const long long spans = crc_spans(len, kRunLog2);  // the most of any path
  return spans > 1 ? nrows * (1 + spans) : 0;
}

// Launches crc_rows_kernel<VEC, RUN_LOG2> on a grid sized from its
// occupancy, one warp per span of every row.
template <int VEC, int RUN_LOG2>
cudaError_t launch_crc(const uint8_t* in, long long nrows, long long row_stride,
                       long long seg_stride, long long seglen, long long len,
                       long long spans, const uint32_t* cst,
                       const long long* pd, uint32_t* scr, uint32_t* o,
                       cudaStream_t s) {
  auto kernel = crc_rows_kernel<VEC, RUN_LOG2>;
  unsigned blocks = 0;
  const cudaError_t err = launch_common::grid_blocks(
      kernel, kCrcThreads, 0, nrows * spans * 32, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kCrcThreads, 0, s>>>(in, nrows, row_stride, seg_stride,
                                        seglen, len, spans, cst, pd, scr, o);
  return cudaSuccess;
}

// K1. Row r is nseg segments of seglen bytes, segment s at src + r *
// row_stride + s * seg_stride; len = nseg * seglen < 2^30. consts: the
// polynomial's table, shift and inverse matrices and slicing tables
// (256 + 2 * 31 * 32 + 15 * 256 uint32 on the device, 16-byte aligned);
// pad: an int64 on the device or null; scratch:
// wt_crc_scratch_words(nrows, len) uint32, all zeros at entry and left
// all zeros (a buffer kept for the stream);
// out: nrows uint32. One launch. Returns 0, a cudaError_t code, or -1 for
// arguments the kernel does not take.
extern "C" int wt_crc32_rows(const void* src, long long nrows,
                             long long row_stride, long long nseg,
                             long long seg_stride, long long seglen,
                             const void* consts, const void* pad,
                             void* scratch, void* out, void* stream) {
  const long long len = nseg * seglen;
  if (nrows < 0 || nseg < 0 || seglen < 0 || len >= (1ll << 30) ||
      (len > 0 && seglen == 0) || reinterpret_cast<uintptr_t>(consts) % 16)
    return -1;
  if (nrows == 0) return 0;
  if (seglen == 0) seglen = 1;  // no bytes: the walk never reads
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cst = static_cast<const uint32_t*>(consts);
  const auto* pd = static_cast<const long long*>(pad);
  auto* scr = static_cast<uint32_t*>(scratch);
  auto* o = static_cast<uint32_t*>(out);
  const auto* in = static_cast<const uint8_t*>(src);
  const bool vec = len % 16 == 0 && seglen % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   row_stride % 16 == 0 && seg_stride % 16 == 0;
  // an aligned row of 2049..4096 bytes takes 128-byte units: one warp,
  // no cross-warp combine
  const int run_log2 = vec && len > (32ll << kRunLog2) &&
                               len <= (32ll << kWideRunLog2)
                           ? kWideRunLog2
                           : kRunLog2;
  const long long spans = crc_spans(len, run_log2);
  cudaError_t err;
  if (vec && run_log2 == kWideRunLog2)
    err = launch_crc<16, kWideRunLog2>(in, nrows, row_stride, seg_stride,
                                       seglen, len, spans, cst, pd, scr, o, s);
  else if (vec)
    err = launch_crc<16, kRunLog2>(in, nrows, row_stride, seg_stride, seglen,
                                   len, spans, cst, pd, scr, o, s);
  else
    err = launch_crc<1, kRunLog2>(in, nrows, row_stride, seg_stride, seglen,
                                  len, spans, cst, pd, scr, o, s);
  if (err != cudaSuccess) return (int)err;
  return (int)counted(kCrcRows);
}

// K2. rows [nrows, len] contiguous uint8 -> out [nrows] uint32.
extern "C" int wt_xxh32_rows(const void* src, long long nrows, long long len,
                             void* out, void* stream) {
  if (nrows < 0 || len < 0) return -1;
  if (nrows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint32_t*>(out);
  const unsigned blocks = (unsigned)((nrows + 31) / 32);
  if (len % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) {
    int dev = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    // raises the kernel's shared-memory limit past 48 KiB, once per device
    err = launch_common::resident_blocks(xxh32_staged_kernel, 32, dev,
                                         kXxhSmem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    xxh32_staged_kernel<<<blocks, 32, kXxhSmem, s>>>(in, nrows, len, o);
  } else {
    xxh32_bytes_kernel<<<blocks, 32, 0, s>>>(in, nrows, len, o);
  }
  return (int)counted(kXxh);
}

// Bytes of scratch K3 needs: 256 uint32 of histogram (zeroed by the
// caller) and one uint32 per tile of kBpThreads blocks.
extern "C" long long wt_bitplane_tiles(long long n) {
  const long long nb = (n + kBlock - 1) / kBlock;
  return (nb + kBpThreads - 1) / kBpThreads;
}

// K3. flat [n] uint8 -> stored [cap2] uint8 and dec [6] int64, with
// hist [256] uint32 zeroed and tile_count [wt_bitplane_tiles(n)] uint32
// of scratch. cap2 must hold the worst-case container (66 bytes per
// block) and n, and be a multiple of sw.
extern "C" int wt_bitplane(const void* flat, long long n, long long cap2,
                           long long sw, long long chunk, int required_milli,
                           int entropy_max_milli, void* hist,
                           void* tile_count, void* dec, void* stored,
                           void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  if (n < 1 || sw < 1 || chunk < 1 || cap2 % sw != 0 || cap2 < n ||
      cap2 < 66 * nb)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(flat);
  auto* h = static_cast<uint32_t*>(hist);
  auto* tc = static_cast<uint32_t*>(tile_count);
  auto* d = static_cast<long long*>(dec);
  const long long tiles = wt_bitplane_tiles(n);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  bp_count_kernel<<<(unsigned)tiles, kBpThreads, 0, s>>>(in, n, nb, aligned,
                                                         h, tc);
  cudaError_t err = counted(kBpCount);
  if (err != cudaSuccess) return (int)err;
  bp_decide_kernel<<<1, 1024, 0, s>>>(h, n, nb, tiles, cap2, sw, chunk,
                                      required_milli, entropy_max_milli, tc,
                                      d);
  err = counted(kBpDecide);
  if (err != cudaSuccess) return (int)err;
  bp_scatter_kernel<<<(unsigned)tiles, kBpThreads, 0, s>>>(
      in, n, nb, aligned, cap2, tc, d, static_cast<uint8_t*>(stored));
  return (int)counted(kBpScatter);
}
