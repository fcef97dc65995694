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
//  chunk/16 dependent rounds on each of 4 independent lanes, each round a
//  rotate and one multiply-add once the word's product with P2 is made
//  off the chain. That chain measures 10.25 cycles a round on an H100
//  (xxh_chain_kernel). At the highest SM clock, 1.98 GHz, a 4096-byte
//  chunk is 256 rounds, 1.33 us, and a 65536-byte chunk 4096 rounds, 21.2
//  us, however many rows run beside it.
//
// Design:
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
//  * K2 puts a row's four accumulators on four lanes (lane 4r + j runs
//    accumulator j of row r), so a warp holds 8 rows and a lane's chain
//    is its own; the four lanes combine with shuffles at the end. A block
//    takes 8 rows, so the rows of a write spread over the SMs ([128,
//    65536] is 16 blocks). Aligned rows stream through a ring of 8 stages
//    of 1 KiB a row in shared memory, three warps around it: one issues a
//    TMA bulk copy per row tile, whose stage's mbarrier counts its bytes
//    in; one multiplies the landed words by P2 in place; one runs the
//    chain on the products, a rotate and a fused multiply-add a round.
//    Other rows load their words directly.
//  * K3 is one cooperative launch on the blocks the card holds at once.
//    Each thread loads its 64-byte block once, counts its bytes into
//    per-lane copies of the histogram (no two lanes of a warp on one
//    word), and transposes it into 8 planes kept in registers; each block
//    publishes its bins and its tiles' counts of stored planes. After one
//    grid-wide barrier every block reads them and computes the same
//    decision: the entropy in a fixed summation order, comp_len, the probe,
//    the ratio test in 64-bit integers, and its tiles' first stored
//    planes. Each tile's container planes or raw bytes are staged in shared
//    memory and stored coalesced; the grid writes the zero tail. A tile
//    past the resident grid is loaded and transposed again after the
//    barrier (counted). The scratch is left all zeros, so no memset
//    precedes a call.

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
constexpr int kBpMinBlocks = 4;   // K3 blocks an SM: 64 registers, and
                                  // the shared memory of 4
constexpr int kBinCopies = 32;    // K3 histogram copies, one per lane
constexpr int kBpBinBytes = kBinCopies * 256 * 4;
constexpr int kBpParkBytes = kBpThreads * 64;  // a tile's planes
constexpr size_t kBpSmem = kBpBinBytes + kBpParkBytes + 256 * 4;
constexpr int kBpHist = 0;        // K3 scratch words: the histogram,
constexpr int kBpArrive = 256;    // the barrier's arrivals,
constexpr int kBpDepart = 257;    // the blocks done,
constexpr int kBpTileCounts = 258;  // each tile's stored planes
constexpr int kXxhRows = 8;       // K2 rows of a warp: 4 lanes a row
constexpr int kXxhTile = 1024;    // bytes of a row per K2 stage
constexpr int kXxhPitch = kXxhTile + 16;  // row r's words start on bank 4r
constexpr int kXxhStages = 8;     // tiles in flight ahead of the chain
constexpr int kXxhThreads = 96;   // K2 warps: chain, copies, products
constexpr size_t kXxhSmem = (size_t)kXxhStages * kXxhRows * kXxhPitch;

enum Launch {
  kCrcRows = 0,
  kXxh,
  kBitplane,
  kNumLaunch
};

// Kernel launches of each kind, counted where each kernel is launched.
std::atomic<long long> g_launches[kNumLaunch];
// K3 tiles loaded and transposed a second time (past the resident grid).
std::atomic<long long> g_recomputed_tiles;

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

// A round on the product p = w * P2, computed ahead.
__device__ __forceinline__ uint32_t xxh_step(uint32_t acc, uint32_t p) {
  return rotl(acc + p, 13) * kP1;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrives on the barrier and adds `bytes` to the transfers it waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives on the barrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Lane j of a row's four lanes: accumulator j's seed (seed 0).
__device__ __forceinline__ uint32_t xxh_seed(int j) {
  return j == 0 ? kP1 + kP2 : j == 1 ? kP2 : j == 2 ? 0u : 0u - kP1;
}

// The row's four lanes (lanes 4r..4r+3 of the warp) combine their
// accumulators, rotated by 1, 7, 12 and 18, into the row's first lane,
// which finishes the row: the tail after its 16-byte stripes, the length
// and the avalanche. Called by every lane of the warp.
__device__ __forceinline__ void xxh_combine(uint32_t acc, int j, bool live,
                                            const uint8_t* row, long long len,
                                            uint32_t* out) {
  const int rot = j == 0 ? 1 : j == 1 ? 7 : j == 2 ? 12 : 18;
  uint32_t v = rotl(acc, rot);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (live && j == 0) *out = xxh_finish(len >= 16 ? v : kP5, row,
                                        (len / 16) * 16, len);
}

// Aligned rows (len a multiple of 16, at least 16; 16-byte aligned
// base): 8 rows a block of three warps around a ring of kXxhStages stages
// of kXxhTile bytes a row. Warp 1 copies: one TMA bulk copy per row tile
// from lane r, the stage's `full` mbarrier counting its bytes in. Warp 2
// multiplies the landed tile's words by P2 in place and hands the stage
// on through its `ready` mbarrier. Warp 0 computes, lane 4r + j running
// accumulator j of row r on the products, so that each round's chain is
// a rotate and one multiply-add (the multiply by P1 and the next
// product's add fuse); it frees the stage through its `empty` mbarrier
// for warp 1's next copy. The lanes of a stripe read 32 banks (row pitch
// kXxhPitch). CLOCKS (timing only, no caller of the write path): warp 2's
// lane 0 records its time, warp 0's lane 0 the cycles waiting for a stage
// and running the chain and its total, into clocks[4 * block ...].
template <bool CLOCKS>
__global__ void __launch_bounds__(kXxhThreads)
xxh32_tma_kernel(const uint8_t* __restrict__ src, long long nrows,
                 long long len, uint32_t* __restrict__ out,
                 long long* __restrict__ clocks) {
  // the ring: kXxhSmem bytes, [kXxhStages][kXxhRows][kXxhPitch]
  extern __shared__ __align__(128) uint8_t xring[];
  auto ring = reinterpret_cast<uint8_t(*)[kXxhRows][kXxhPitch]>(xring);
  __shared__ __align__(8) uint64_t full[kXxhStages], ready[kXxhStages],
      empty[kXxhStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * kXxhRows;
  const int rows = (int)(nrows - r0 < kXxhRows ? nrows - r0 : kXxhRows);
  const long long tiles = (len + kXxhTile - 1) / kXxhTile;
  long long c_start = 0;
  if constexpr (CLOCKS) c_start = clock64();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kXxhStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto tile_bytes = [&](long long t) {
    const long long rest = len - t * kXxhTile;
    return (unsigned)(rest < kXxhTile ? rest : kXxhTile);
  };
  if (warp == 1) {  // the copies
    for (long long t = 0; t < tiles; ++t) {
      const int s = (int)(t % kXxhStages);
      if (t >= kXxhStages)  // warp 0 is done with the stage's last tile
        mbar_wait(&empty[s], (unsigned)((t / kXxhStages + 1) & 1));
      const unsigned tb = tile_bytes(t);
      // the other warps' accesses of the stage before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_expect(&full[s], tb * (unsigned)rows);
      __syncwarp();
      if (lane < rows)
        bulk_load(ring[s][lane], src + (r0 + lane) * len + t * kXxhTile, tb,
                  &full[s]);
    }
    return;
  }
  if (warp == 2) {  // the products
    for (long long t = 0; t < tiles; ++t) {
      const int s = (int)(t % kXxhStages);
      mbar_wait(&full[s], (unsigned)((t / kXxhStages) & 1));
      const int quads = (int)(tile_bytes(t) / 16);  // of each row
      if (quads == kXxhTile / 16) {  // whole tiles: every load, then stores
        constexpr int kPer = kXxhTile / 16 / 32;
        uint4 v[kXxhRows][kPer];
#pragma unroll
        for (int q = 0; q < kXxhRows; ++q)
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            if (q < rows)
              v[q][i] = reinterpret_cast<const uint4*>(ring[s][q])[lane +
                                                                   32 * i];
#pragma unroll
        for (int q = 0; q < kXxhRows; ++q)
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            if (q < rows)
              reinterpret_cast<uint4*>(ring[s][q])[lane + 32 * i] =
                  make_uint4(v[q][i].x * kP2, v[q][i].y * kP2,
                             v[q][i].z * kP2, v[q][i].w * kP2);
      } else {
        for (int q = 0; q < rows; ++q) {
          uint4* w = reinterpret_cast<uint4*>(ring[s][q]);
          for (int k = lane; k < quads; k += 32) {
            const uint4 x = w[k];
            w[k] = make_uint4(x.x * kP2, x.y * kP2, x.z * kP2, x.w * kP2);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ready[s]);
    }
    if constexpr (CLOCKS)
      if (lane == 0) clocks[4 * blockIdx.x] = clock64() - c_start;
    return;
  }
  const int r = lane >> 2, j = lane & 3;
  long long c_wait = 0, c_chain = 0, c0 = 0;
  uint32_t acc = xxh_seed(j);
  for (long long t = 0; t < tiles; ++t) {
    const int s = (int)(t % kXxhStages);
    if constexpr (CLOCKS) c0 = clock64();
    mbar_wait(&ready[s], (unsigned)((t / kXxhStages) & 1));
    if constexpr (CLOCKS) {
      const long long c1 = clock64();
      c_wait += c1 - c0;
      c0 = c1;
    }
    const int n16 = (int)(tile_bytes(t) / 16);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(ring[s][r]) + j;
    if (n16 == kXxhTile / 16) {  // a whole tile: its loads ahead of the chain
      uint32_t w[kXxhTile / 16];
#pragma unroll
      for (int u = 0; u < kXxhTile / 16; ++u) w[u] = q[4 * u];
#pragma unroll
      for (int u = 0; u < kXxhTile / 16; ++u) acc = xxh_step(acc, w[u]);
    } else {
      for (int u = 0; u < n16; ++u) acc = xxh_step(acc, q[4 * u]);
    }
    __syncwarp();  // every lane is done with stage s
    if (lane == 0) mbar_arrive(&empty[s]);
    if constexpr (CLOCKS) c_chain += clock64() - c0;
  }
  const long long row = r0 + r;
  xxh_combine(acc, j, r < rows, src + (r < rows ? row : r0) * len, len,
              out + row);
  if constexpr (CLOCKS) {
    if (lane == 0) {
      long long* c = clocks + 4 * blockIdx.x;
      c[1] = c_wait;
      c[2] = c_chain;
      c[3] = clock64() - c_start;
    }
  }
}

// Any rows: the same lanes, words loaded from global memory a byte at a
// time.
__global__ void __launch_bounds__(32)
xxh32_direct_kernel(const uint8_t* __restrict__ src, long long nrows,
                    long long len, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x, r = lane >> 2, j = lane & 3;
  const long long row = (long long)blockIdx.x * kXxhRows + r;
  const bool live = row < nrows;
  const uint8_t* p = src + (live ? row : 0) * len;
  uint32_t acc = xxh_seed(j);
  if (live) {
    const long long nblk = len / 16;
#pragma unroll 4
    for (long long i = 0; i < nblk; ++i)
      acc = xxh_round(acc, load_le32(p + 16 * i + 4 * j));
  }
  xxh_combine(acc, j, live, p, len, out + row);
}

// Timing only: one lane chain of `rounds` dependent xxh32 rounds per
// thread of one warp, 64 to a loop trip; cycles[0] gets lane 0's
// clock64() difference.
__global__ void __launch_bounds__(32)
xxh_chain_kernel(const uint32_t* __restrict__ words, int rounds,
                 uint32_t* __restrict__ out, long long* __restrict__ cycles) {
  uint32_t acc = words[threadIdx.x];
  const uint32_t w = words[32 + threadIdx.x];
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < rounds; i += 64) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc = xxh_round(acc, w);
  }
  out[threadIdx.x] = acc;
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
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
  // a word at a time (8 byte loads in flight, not 64), shifted in so that
  // g is indexed statically
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    uint64_t w = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const long long at = start + i * 8 + t;
      if (at < n) w |= (uint64_t)__ldg(flat + at) << (8 * t);
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) g[k] = g[k + 1];
    g[7] = w;
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

// Word i of a block from its planes (block_planes inverted: the same
// byte transpose, then the same bit transpose).
__device__ __forceinline__ uint64_t block_word(const uint64_t planes[8],
                                               int i) {
  uint64_t y = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p)
    y |= ((planes[p] >> (8 * i)) & 0xffull) << (8 * p);
  return transpose8(y);
}

// Sum of v over the block (kBpThreads threads); every thread gets it.
__device__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long part[kBpThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  unsigned long long sum = 0;
#pragma unroll
  for (int w = 0; w < kBpThreads / 32; ++w) sum += part[w];
  __syncthreads();  // part is reused by the next call
  return sum;
}

// The bytes of block g (real of them in n) counted into the block's
// histogram copies: lane l adds to copy l, so the 32 lanes of a warp hit
// 32 distinct words in 32 distinct banks whatever the bytes.
__device__ __forceinline__ void count_block(uint32_t* bins, const uint64_t g[8],
                                            long long real, int lane) {
  if (real >= kBlock) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        atomicAdd(&bins[((g[i] >> (8 * t)) & 0xffu) * kBinCopies + lane], 1u);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)  // the input's last, partial block
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (i * 8 + t < real)
        atomicAdd(&bins[((g[i] >> (8 * t)) & 0xffu) * kBinCopies + lane], 1u);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The grid-wide barrier of the cooperative launch: each block counts its
// arrival and waits for all of them. A grid that cannot all be resident
// traps rather than waits for ever (the launch refuses such a grid).
__device__ void grid_barrier(unsigned* arrive, unsigned blocks) {
  __threadfence();  // every thread's histogram adds and tile counts first
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(arrive, 1u);
    long long spins = 0;
    while (ld_acquire(arrive) < blocks) {
      __nanosleep(32);
      if (++spins > (1ll << 28)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Block tid of tile t (thread tid's 64-byte block): its planes, and its
// flags | consts << 8 (0 past the input); with `count`, its bytes counted
// into the block's histogram copies.
__device__ __forceinline__ uint32_t tile_planes(
    const uint8_t* __restrict__ flat, long long n, long long nb, long long t,
    bool aligned, bool count, uint32_t* bins, uint64_t planes[8]) {
  const long long b = t * kBpThreads + threadIdx.x;
  if (b >= nb) return 0;
  uint64_t g[8];
  load_block(flat, n, b, aligned, g);
  if (count) count_block(bins, g, n - b * kBlock, threadIdx.x & 31);
  uint32_t f, c;
  block_planes(g, planes, &f, &c);
  return f | (c << 8);
}

// Tile t's output, staged in sh and stored coalesced: its header and its
// container planes from plane `first` on (rank: this thread's first
// stored plane in the tile, total: the tile's), or its raw bytes.
__device__ __forceinline__ void write_tile(bool compress, long long t,
                                           long long nb,
                                           unsigned long long first,
                                           const uint64_t planes[8],
                                           uint32_t fc, uint32_t rank,
                                           uint32_t total, uint32_t* sh,
                                           uint8_t* __restrict__ stored) {
  const int tid = threadIdx.x;
  const long long b0 = t * kBpThreads, b = b0 + tid;
  __syncthreads();  // sh is free
  if (compress) {
    if (b < nb) reinterpret_cast<uint16_t*>(stored)[b] = (uint16_t)fc;
    uint64_t* st = reinterpret_cast<uint64_t*>(sh);
    uint32_t k = rank;
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (fc >> p & 1u) st[k++] = planes[p];
    __syncthreads();
    uint8_t* dst = stored + 2 * nb + 8 * (long long)first;
    if ((2 * nb) % 8 == 0) {  // the planes start on 8 bytes
      for (uint32_t i = tid; i < total; i += kBpThreads)
        reinterpret_cast<uint64_t*>(dst)[i] = st[i];
    } else {
      const uint16_t* st16 = reinterpret_cast<const uint16_t*>(st);
      for (uint32_t i = tid; i < 4 * total; i += kBpThreads)
        reinterpret_cast<uint16_t*>(dst)[i] = st16[i];
    }
  } else {
    // the raw bytes (zeros past n up to the whole block), a word at a
    // time into sh, in pairs swizzled so that a half warp's stores hit at
    // most 2 words a bank; then 16 bytes a store
    uint64_t* st8 = reinterpret_cast<uint64_t*>(sh);
    const int swz = ((tid >> 1) & 3) << 1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st8[tid * 8 + (i ^ swz)] = block_word(planes, i);
    const uint4* st4 = reinterpret_cast<const uint4*>(sh);
    __syncthreads();
    const long long blocks = nb - b0 < kBpThreads ? nb - b0 : kBpThreads;
    uint4* dst = reinterpret_cast<uint4*>(stored + b0 * kBlock);
    for (int m = tid; m < blocks * 4; m += kBpThreads) {
      const int bb = m >> 2;
      dst[m] = st4[bb * 4 + ((m & 3) ^ ((bb >> 1) & 3))];
    }
  }
}

// CLOCKS: block 0's thread 0 records the cycles since c_start.
template <bool CLOCKS>
__device__ __forceinline__ void mark_clock(long long* clocks, int i,
                                           long long c_start) {
  if constexpr (CLOCKS)
    if (blockIdx.x == 0 && threadIdx.x == 0) clocks[i] = clock64() - c_start;
}

// K3 in one cooperative launch; every block resident. Block x takes the
// tiles x, x + G, ... of kBpThreads 64-byte blocks (G the grid), one
// 64-byte block a thread.
//  Before the barrier: each thread loads its block once, counts its bytes
//  (`count`; timing only without), transposes it into its 8 planes and
//  parks those of its first tile in shared memory; each block adds its
//  histogram to the scratch's and stores each tile's count of stored
//  planes.
//  After the one barrier: every block reads the 256 bins and the tile
//  counts, computes the entropy in a fixed pairwise order,
//  comp_len, the probe, the ratio test in int64 and the decision, and its
//  tiles' first stored planes from the tiles before them; block 0 writes
//  dec. Each tile's output is staged in shared memory and stored
//  coalesced: the header and the container's planes, or the raw bytes;
//  the grid writes the zero tail. A tile past the first of its block is
//  loaded and transposed again. The last block to finish zeroes the
//  scratch for the next call on the stream.
// scratch (uint32): [0, 256) histogram, 256 arrivals, 257 departures,
// [258, 258 + tiles) tile counts; all zeros at entry and at exit.
// CLOCKS (timing only): block 0's thread 0 writes the cycles from its
// start to the end of its counting, the barrier, the decision, its tiles'
// writes and its end into clocks[0..4].
template <bool CLOCKS>
__global__ void __launch_bounds__(kBpThreads, kBpMinBlocks)
bitplane_kernel(const uint8_t* __restrict__ flat, long long n, long long nb,
                long long tiles, bool aligned, bool count, long long cap2,
                long long sw,
                long long chunk, int required_milli, int entropy_max_milli,
                uint32_t* __restrict__ scratch, long long* __restrict__ dec,
                uint8_t* __restrict__ stored, long long* __restrict__ clocks) {
  // kBpSmem bytes: the histogram's copies (then each tile's output), the
  // first tile's planes across the barrier, the entropy's terms
  extern __shared__ __align__(16) uint8_t bp_smem[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(bp_smem);
  uint64_t* parked = reinterpret_cast<uint64_t*>(bp_smem + kBpBinBytes);
  float* terms = reinterpret_cast<float*>(bp_smem + kBpBinBytes +
                                          kBpParkBytes);
  __shared__ unsigned last_out;
  static_assert(kBpThreads == 256, "a thread per bin");
  const int tid = threadIdx.x;
  const long long grid = gridDim.x;
  uint32_t* hist = scratch + kBpHist;
  uint32_t* tile_count = scratch + kBpTileCounts;
  const long long c_start = CLOCKS ? clock64() : 0;

  if (count) {
    for (int i = tid; i < kBinCopies * 256; i += kBpThreads) sh[i] = 0;
    __syncthreads();
  }
  // the first tile's planes wait in shared memory; the others are counted
  uint64_t planes[8];
  uint32_t fc =
      tile_planes(flat, n, nb, blockIdx.x, aligned, count, sh, planes);
#pragma unroll
  for (int p = 0; p < 8; ++p) parked[p * kBpThreads + tid] = planes[p];
  uint32_t tile_total;
  uint32_t rank = block_scan(__popc(fc & 0xffu), &tile_total);
  if (tid == 0) tile_count[blockIdx.x] = tile_total;
  for (long long t = blockIdx.x + grid; t < tiles; t += grid) {
    uint64_t other[8];
    const uint32_t f = tile_planes(flat, n, nb, t, aligned, count, sh, other);
    const unsigned long long total = block_sum(__popc(f & 0xffu));
    if (tid == 0) tile_count[t] = (uint32_t)total;
  }
  if (count) {
    __syncthreads();
    const int lane = tid & 31;
    uint32_t sum = 0;
    for (int c = 0; c < kBinCopies; ++c)  // rotated: 32 banks a step
      sum += sh[tid * kBinCopies + ((c + lane) & (kBinCopies - 1))];
    if (sum) atomicAdd(hist + tid, sum);
  }
  mark_clock<CLOCKS>(clocks, 0, c_start);
  grid_barrier(scratch + kBpArrive, (unsigned)grid);
  mark_clock<CLOCKS>(clocks, 1, c_start);

  // -- the decision, the same in every block
  {
    const uint32_t cnt = __ldcg(hist + tid);
    const float p = (float)cnt / (float)n;
    terms[tid] = cnt ? p * log2f(fmaxf(p, 1e-12f)) : 0.0f;
  }
  unsigned long long before = 0, all = 0;
  for (long long i = tid; i < tiles; i += kBpThreads) {
    const unsigned long long c = __ldcg(tile_count + i);
    all += c;
    if (i < blockIdx.x) before += c;
  }
  __syncthreads();
  for (int st = 128; st; st >>= 1) {  // a fixed pairwise order
    if (tid < st) terms[tid] += terms[tid + st];
    __syncthreads();
  }
  before = block_sum(before);
  all = block_sum(all);
  const int milli = (int)(-terms[0] * 1000.0f);
  const bool probe_ok = milli <= entropy_max_milli;
  const long long comp_len = 2 * nb + 8 * (long long)all;
  const bool ratio_ok = comp_len * 1000 <= n * (long long)required_milli;
  const bool compress = probe_ok && ratio_ok;
  if (blockIdx.x == 0 && tid == 0) {
    const long long stored_len = compress ? comp_len : n;
    const long long used = (stored_len + sw - 1) / sw;
    dec[0] = comp_len;
    dec[1] = compress;
    dec[2] = probe_ok;
    dec[3] = milli;
    dec[4] = used;
    dec[5] = (cap2 / sw - used) * chunk;
  }
  mark_clock<CLOCKS>(clocks, 2, c_start);

  // -- each tile's output; a tile past the first is loaded again
#pragma unroll
  for (int p = 0; p < 8; ++p) planes[p] = parked[p * kBpThreads + tid];
  write_tile(compress, blockIdx.x, nb, before, planes, fc, rank, tile_total,
             sh, stored);
  long long prev = blockIdx.x;
  unsigned long long first = before;
  for (long long t = blockIdx.x + grid; t < tiles; t += grid) {
    unsigned long long mid = 0;  // the planes of the tiles from prev to t
    for (long long i = prev + tid; i < t; i += kBpThreads)
      mid += __ldcg(tile_count + i);
    first += block_sum(mid);
    fc = tile_planes(flat, n, nb, t, aligned, false, sh, planes);
    rank = block_scan(__popc(fc & 0xffu), &tile_total);
    write_tile(compress, t, nb, first, planes, fc, rank, tile_total, sh,
               stored);
    prev = t;
  }
  mark_clock<CLOCKS>(clocks, 3, c_start);

  // zeros from the end of the selected stream to cap2
  const long long zfrom = compress ? comp_len : n;
  const long long a16 = (zfrom + 15) / 16 * 16 < cap2 ? (zfrom + 15) / 16 * 16
                                                       : cap2;
  const long long e16 = cap2 / 16 * 16 > a16 ? cap2 / 16 * 16 : a16;
  const long long gtid = (long long)blockIdx.x * kBpThreads + tid;
  const long long nthreads = grid * kBpThreads;
  for (long long at = zfrom + gtid; at < a16; at += nthreads) stored[at] = 0;
  for (long long at = a16 / 16 + gtid; at < e16 / 16; at += nthreads)
    reinterpret_cast<uint4*>(stored)[at] = make_uint4(0u, 0u, 0u, 0u);
  for (long long at = e16 + gtid; at < cap2; at += nthreads) stored[at] = 0;

  // the last block out zeroes the scratch: every block has read it
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_out = atomicAdd(scratch + kBpDepart, 1u) == (unsigned)(grid - 1);
  }
  __syncthreads();
  if (last_out) {
    __threadfence();
    hist[tid] = 0;
    for (long long i = tid; i < tiles; i += kBpThreads) tile_count[i] = 0;
    if (tid == 0) {
      scratch[kBpArrive] = 0;
      scratch[kBpDepart] = 0;
    }
  }
  mark_clock<CLOCKS>(clocks, 4, c_start);
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

// Launches of kernel `kind` (0 crc_rows, 1 xxh32, 2 bitplane) since the
// last reset, or -1.
extern "C" long long wt_launches(int kind) {
  return kind >= 0 && kind < kNumLaunch ? g_launches[kind].load() : -1;
}

extern "C" void wt_reset_launches() {
  for (auto& count : g_launches) count.store(0);
  g_recomputed_tiles.store(0);
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

// Raises K2's ring past 48 KiB of shared memory, once per kernel and
// device.
template <typename Kernel>
cudaError_t raise_xxh_smem(Kernel kernel) {
  int dev = 0, per_sm = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return launch_common::resident_blocks(kernel, kXxhThreads, dev, kXxhSmem,
                                        &per_sm);
}

// K2. rows [nrows, len] contiguous uint8 -> out [nrows] uint32. One
// launch, a warp of 8 rows a block: the TMA ring for 16-byte aligned rows
// of a multiple of 16 bytes, direct loads for any other rows.
extern "C" int wt_xxh32_rows(const void* src, long long nrows, long long len,
                             void* out, void* stream) {
  if (nrows < 0 || len < 0) return -1;
  if (nrows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint32_t*>(out);
  const unsigned blocks = (unsigned)((nrows + kXxhRows - 1) / kXxhRows);
  if (len >= 16 && len % 16 == 0 &&
      reinterpret_cast<uintptr_t>(in) % 16 == 0) {
    const cudaError_t err = raise_xxh_smem(xxh32_tma_kernel<false>);
    if (err != cudaSuccess) return (int)err;
    xxh32_tma_kernel<false><<<blocks, kXxhThreads, kXxhSmem, s>>>(
        in, nrows, len, o, nullptr);
  } else {
    xxh32_direct_kernel<<<blocks, 32, 0, s>>>(in, nrows, len, o);
  }
  return (int)counted(kXxh);
}

// Words of scratch K3 needs for n bytes: the histogram, the barrier's two
// counters and a count per tile of kBpThreads 64-byte blocks.
extern "C" long long wt_bitplane_scratch_words(long long n) {
  const long long nb = (n + kBlock - 1) / kBlock;
  return kBpTileCounts + (nb + kBpThreads - 1) / kBpThreads;
}

// Launches bitplane_kernel<CLOCKS> cooperatively on the
// blocks the card holds at once, at most one per tile; *grid gets the
// blocks. A card that cannot hold a block gets
// cudaErrorCooperativeLaunchTooLarge, and so does a grid the launch
// cannot make resident: neither waits.
template <bool CLOCKS>
cudaError_t launch_bitplane(const uint8_t* in, long long n, bool count,
                            long long cap2,
                            long long sw, long long chunk, int required_milli,
                            int entropy_max_milli, uint32_t* scr,
                            long long* d, uint8_t* st, long long* clk,
                            cudaStream_t s, long long* grid) {
  auto kernel = bitplane_kernel<CLOCKS>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = launch_common::resident_blocks(kernel, kBpThreads, dev, kBpSmem,
                                         &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long nb = (n + kBlock - 1) / kBlock;
  long long tiles = (nb + kBpThreads - 1) / kBpThreads;
  const long long resident = (long long)sms * per_sm;
  *grid = tiles < resident ? tiles : resident;
  bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  void* args[] = {&in,    &n,     &nb,  &tiles,          &aligned,
                  &count, &cap2,  &sw,  &chunk,          &required_milli,
                  &entropy_max_milli, &scr, &d, &st, &clk};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3((unsigned)*grid), dim3(kBpThreads),
                                     args, kBpSmem, s);
}

// K3. flat [n] uint8 -> stored [cap2] uint8 (16-byte aligned) and dec [6]
// int64, with scratch: wt_bitplane_scratch_words(n) uint32, all zeros at
// entry and left all zeros (a buffer kept for the stream). cap2 must hold
// the worst-case container (66 bytes per block) and n, and be a multiple
// of sw. One cooperative launch.
extern "C" int wt_bitplane(const void* flat, long long n, long long cap2,
                           long long sw, long long chunk, int required_milli,
                           int entropy_max_milli, void* scratch, void* dec,
                           void* stored, void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  if (n < 1 || sw < 1 || chunk < 1 || cap2 % sw != 0 || cap2 < n ||
      cap2 < 66 * nb || reinterpret_cast<uintptr_t>(stored) % 16)
    return -1;
  long long grid = 0;
  const cudaError_t err = launch_bitplane<false>(
      static_cast<const uint8_t*>(flat), n, true, cap2, sw, chunk,
      required_milli,
      entropy_max_milli, static_cast<uint32_t*>(scratch),
      static_cast<long long*>(dec), static_cast<uint8_t*>(stored), nullptr,
      static_cast<cudaStream_t>(stream), &grid);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (nb + kBpThreads - 1) / kBpThreads;
  g_recomputed_tiles.fetch_add(tiles - grid);
  return (int)counted(kBitplane);
}

// K3 tiles loaded and transposed twice (past the resident grid) since the
// last reset.
extern "C" long long wt_bitplane_recomputed_tiles() {
  return g_recomputed_tiles.load();
}

// Timing only (no caller of the write path). K2's TMA kernel with its
// clock readings: clocks [ceil(nrows / 8), 4] int64 of (the product
// warp's time, the computing warp's waits for a stage, its chain, its
// total) in cycles per block; rows as the TMA path takes them.
extern "C" int wt_timing_xxh32_clocks(const void* src, long long nrows,
                                      long long len, void* out, void* clocks,
                                      void* stream) {
  if (nrows < 1 || len < 16 || len % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16)
    return -1;
  const cudaError_t err = raise_xxh_smem(xxh32_tma_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  xxh32_tma_kernel<true>
      <<<(unsigned)((nrows + kXxhRows - 1) / kXxhRows), kXxhThreads, kXxhSmem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(src), nrows, len,
          static_cast<uint32_t*>(out), static_cast<long long*>(clocks));
  return (int)cudaGetLastError();
}

// Timing only: the cycles of `rounds` (a multiple of 64) dependent xxh32
// rounds on one lane (words: 64 uint32, out: 32 uint32, cycles: one
// int64).
extern "C" int wt_timing_xxh_chain(const void* words, int rounds, void* out,
                                   void* cycles, void* stream) {
  if (rounds < 64 || rounds % 64) return -1;
  xxh_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), rounds,
      static_cast<uint32_t*>(out), static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}

// Timing only: K3 with wt_bitplane's arguments as `variant` 0 (the
// kernel of wt_bitplane, uncounted), 1 (without the histogram: the
// decision then sees no bytes) or 2 (block 0's phase clocks into
// clocks[5]); *grid gets the blocks.
extern "C" int wt_timing_bitplane(int variant, const void* flat, long long n,
                                  long long cap2, long long sw,
                                  long long chunk, void* scratch, void* dec,
                                  void* stored, void* clocks, long long* grid,
                                  void* stream) {
  const long long nb = (n + kBlock - 1) / kBlock;
  if (n < 1 || sw < 1 || chunk < 1 || cap2 % sw != 0 || cap2 < n ||
      cap2 < 66 * nb || reinterpret_cast<uintptr_t>(stored) % 16 ||
      variant < 0 || variant > 2)
    return -1;
  const auto* in = static_cast<const uint8_t*>(flat);
  auto* scr = static_cast<uint32_t*>(scratch);
  auto* d = static_cast<long long*>(dec);
  auto* st = static_cast<uint8_t*>(stored);
  auto* clk = static_cast<long long*>(clocks);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 0)
    err = launch_bitplane<false>(in, n, true, cap2, sw, chunk, 875, 7000,
                                 scr, d, st, nullptr, s, grid);
  else if (variant == 1)
    err = launch_bitplane<false>(in, n, false, cap2, sw, chunk, 875, 7000,
                                 scr, d, st, nullptr, s, grid);
  else
    err = launch_bitplane<true>(in, n, true, cap2, sw, chunk, 875, 7000,
                                scr, d, st, clk, s, grid);
  return (int)err;
}
