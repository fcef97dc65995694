// GF(2) packet-layout bitmatrix product, for sm_90a.
//
// Replaces ceph_tpu/ops/xor_mm.py:bitmatrix_encode, the XLA program of the
// Cauchy and Liberation bitmatrix techniques (jerasure_schedule_encode
// semantics). data [B, k, N] uint8 with N = S*w*P is read as
// [B, k, S, w, P]: superblock s of chunk j holds w packets of P bytes. For
// a bitmatrix bitmat [R, k*w] of 0/1 bytes, R = r*w,
//
//   out packet (b, i, s, t) = XOR over (j, u) with bitmat[i*w + t, j*w + u]
//                             = 1 of data packet (b, j, s, u)
//
// and out is [B, r, N]. No bit moves between bytes: the product selects
// whole packets and XORs them byte by byte, with no bit transposition.
// Any w in 2..32 and any packetsize P >= 1 are taken.
//
// Bound. The function reads each input byte once and writes each output
// byte once. At the Cauchy k=10, m=4 encode shape ([16, 10, 131072],
// P = 2048) that is 21.0 MB read + 8.4 MB written, 8.8 us at the H100
// SXM's 3.35 TB/s; the XORs it needs are one byte XOR per set bit of the
// bitmatrix per byte of a packet row, 888 * 262144 = 0.23 G, 0.12 us even
// at the int8 rate of 1979 TOP/s, so bytes bound it.
//
// Three designs, picked by the C entry point (pick()) from the geometry,
// the bitmatrix's count of set entries where the caller gives it, and
// the pointers' alignment, each counted where it is launched:
//  * staged (packetsize a multiple of 16, both pointers 16-byte aligned,
//    a tile of at least min(P, 128) bytes of every input packet fitting
//    kStageBytes): a block takes one (batch, superblock, tile) at a time
//    and copies the tile of all k*w input packets into shared memory with
//    16-byte cp.async, so each input byte is read from device memory once
//    per launch. Two tile buffers alternate: the next tile's copy is in
//    flight while the block computes this one. A thread owns one 16-byte
//    column of one output packet and XORs the shared-memory words its row
//    selects, eight independent loads a step, from a list of the row's
//    set columns that the block builds once (from uint32 row masks,
//    launch_common.cuh) while its first copy is in flight; then it
//    stores 16 bytes. The tile is the largest power of two (>= 16 bytes)
//    up to the packetsize that keeps k*w tiles within kStageBytes; the
//    last tile of a packet may be partial. The blocks are persistent (a
//    grid-stride loop over tiles).
//  * vector (aligned, and past the staged design's budget or where it was
//    faster than the staged design: at most 3 selects per input packet on
//    average; see pick()): a thread
//    takes one 16-byte column of one output packet and XORs a 16-byte
//    __ldg load per set bit of its row straight from device memory; L1
//    and L2 serve the re-reads (about k*w/2 per input packet of a dense
//    Cauchy row block). Each block packs the masks and a table of byte
//    offsets j*N + u*P of the input packets.
//  * byte (a packetsize not a multiple of 16, or a data or output pointer
//    not 16-byte aligned): the vector design's kernel with one thread per
//    byte column.
// The vector and byte kernels run a grid-stride loop with 64-bit offsets;
// every grid is sized from the occupancy the kernel reaches, queried once
// per device, kernel and shared-memory size (launch_common.cuh, shared
// with gf_bitmatrix.cu).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 128;          // vector and byte designs
constexpr int kStagedThreads = 256;
constexpr long long kStageBytes = 32 * 1024;  // one buffer of tiles
constexpr long long kMinTile = 128;    // bytes of a packet per tile

enum Design { kStaged = 0, kVector = 1, kByte = 2, kNumDesign };

// Kernel launches of each design, counted where the kernel is launched.
std::atomic<long long> g_launches[kNumDesign];

__host__ __device__ inline int mask_words(int cols) { return (cols + 31) / 32; }

// Vector and byte designs: one offset per input packet, then the masks.
size_t packet_smem(int rows, int cols) {
  return (size_t)cols * sizeof(long long) +
         (size_t)rows * mask_words(cols) * sizeof(uint32_t);
}

// Bytes of each input packet a staged tile holds: the largest power of
// two from 16 up to the packetsize with cols tiles within kStageBytes;
// 0 where that is under min(packet, kMinTile), and the staged design
// does not take the geometry.
long long stage_tile(int cols, long long packet) {
  const long long cap = kStageBytes / cols;
  if (cap < 16) return 0;
  long long tile = 16;
  while (tile < packet && 2 * tile <= cap) tile *= 2;
  return tile >= packet || tile >= kMinTile ? tile : 0;
}

// Entries of a row's list of set columns: cols rounded up to 8, so that
// every row starts on 16 bytes and 8 entries load as one word.
__host__ __device__ inline int list_stride(int cols) { return (cols + 7) / 8 * 8; }

// Staged design: two buffers of tiles, the lists of each row's set
// columns (as byte offsets into a buffer), the masks, the list lengths.
size_t staged_smem(int rows, int cols, long long tile) {
  return 2 * (size_t)cols * tile +
         (size_t)rows * list_stride(cols) * sizeof(uint16_t) +
         (size_t)rows * mask_words(cols) * sizeof(uint32_t) +
         (size_t)rows * sizeof(uint16_t);
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void xor4(uint4& acc, uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// Copies tile `item` (batch b, superblock s, tile t of each packet) of
// all cols input packets into stage [cols][tile]; bytes past the packet's
// end are not copied.
__device__ __forceinline__ void stage_copy(
    const uint8_t* __restrict__ data, uint8_t* stage, long long item, int k,
    int w, long long packet, long long tile, long long n, long long supers,
    long long tiles) {
  const int cols = k * w;
  const int vcols = (int)(tile / 16);
  const long long b = item / (supers * tiles);
  const long long rem = item - b * supers * tiles;
  const long long s = rem / tiles;
  const long long t0 = (rem - s * tiles) * tile;
  const uint8_t* base = data + b * k * n + s * w * packet + t0;
  for (int idx = threadIdx.x; idx < cols * vcols; idx += blockDim.x) {
    const int c = idx / vcols;
    const int x = (idx - c * vcols) * 16;
    if (t0 + x < packet) {
      const int j = c / w;
      cp_async16(stage + (size_t)c * tile + x,
                 base + (long long)j * n + (long long)(c - j * w) * packet + x);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kStagedThreads)
gf_packet_staged_kernel(const uint8_t* __restrict__ bitmat, int rows, int k,
                        int w, long long packet, long long tile,
                        const uint8_t* __restrict__ data,
                        uint8_t* __restrict__ out, long long batch,
                        long long n) {
  extern __shared__ __align__(16) uint8_t st_smem[];
  const int cols = k * w;
  const int nw = mask_words(cols);
  const size_t buf_bytes = (size_t)cols * tile;
  const int lstride = list_stride(cols);
  uint8_t* bufs = st_smem;                                     // [2][cols][tile]
  uint16_t* lists =
      reinterpret_cast<uint16_t*>(st_smem + 2 * buf_bytes);    // [rows][lstride]
  uint32_t* masks =
      reinterpret_cast<uint32_t*>(lists + rows * lstride);     // [rows][nw]
  uint16_t* counts = reinterpret_cast<uint16_t*>(masks + rows * nw);  // [rows]
  const long long super = (long long)w * packet;
  const long long supers = n / super;
  const long long tiles = (packet + tile - 1) / tile;
  const long long items = batch * supers * tiles;
  const int vcols = (int)(tile / 16);
  const int out_rows = rows / w;

  if (blockIdx.x < items)
    stage_copy(data, bufs, blockIdx.x, k, w, packet, tile, n, supers, tiles);
  // the lists of set columns, built while the first copy is in flight
  launch_common::pack_masks(bitmat, rows, cols, nw, masks);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    int cnt = 0;
    for (int q = 0; q < nw; ++q) {
      uint32_t word = masks[r * nw + q];
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1;
        lists[r * lstride + cnt++] = (uint16_t)((q * 32 + bit) * tile);
      }
    }
    counts[r] = (uint16_t)cnt;
  }

  int it = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const long long next = item + gridDim.x;
    if (next < items) {  // the next tile into the other buffer
      stage_copy(data, bufs + ((it + 1) & 1) * buf_bytes, next, k, w, packet,
                 tile, n, supers, tiles);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* stage = bufs + (it & 1) * buf_bytes;
    const long long b = item / (supers * tiles);
    const long long rem = item - b * supers * tiles;
    const long long s = rem / tiles;
    const long long t0 = (rem - s * tiles) * tile;
    for (int idx = threadIdx.x; idx < rows * vcols; idx += blockDim.x) {
      const int r = idx / vcols;
      const int x = (idx - r * vcols) * 16;
      if (t0 + x >= packet) continue;
      const uint16_t* lst = lists + r * lstride;
      const int cnt = counts[r];
      const uint8_t* col = stage + x;
      uint4 a0 = make_uint4(0u, 0u, 0u, 0u), a1 = a0;
      int i = 0;
      for (; i + 8 <= cnt; i += 8) {  // 8 offsets in one load
        const uint4 o = *reinterpret_cast<const uint4*>(lst + i);
        const uint32_t h[4] = {o.x, o.y, o.z, o.w};
        uint4 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = *reinterpret_cast<const uint4*>(
              col + ((h[e >> 1] >> (16 * (e & 1))) & 0xffffu));
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          xor4(a0, v[e]);
          xor4(a1, v[e + 1]);
        }
      }
      for (; i < cnt; ++i)
        xor4(a0, *reinterpret_cast<const uint4*>(col + lst[i]));
      xor4(a0, a1);
      const int i_out = r / w;
      uint8_t* dst = out + (b * out_rows + i_out) * n + s * super +
                     (long long)(r - i_out * w) * packet + t0 + x;
      __stcs(reinterpret_cast<uint4*>(dst), a0);
    }
    __syncthreads();  // this buffer is free for the copy after next
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
gf_packet_kernel(const uint8_t* __restrict__ bitmat, int rows, int k, int w,
                 long long packet, const uint8_t* __restrict__ data,
                 uint8_t* __restrict__ out, long long batch, long long n) {
  extern __shared__ long long pk_smem[];
  const int cols = k * w;
  const int nw = mask_words(cols);
  long long* offs = pk_smem;                                      // [cols]
  uint32_t* masks = reinterpret_cast<uint32_t*>(pk_smem + cols);  // [rows][nw]

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int j = c / w;
    offs[c] = (long long)j * n + (long long)(c - j * w) * packet;
  }
  launch_common::pack_masks(bitmat, rows, cols, nw, masks);
  __syncthreads();

  const long long super = (long long)w * packet;  // bytes of a superblock
  const long long per_packet = packet / VEC;      // columns of a packet
  const long long per_super = (long long)rows * per_packet;
  const long long per_lane = (n / super) * per_super;
  const long long units = batch * per_lane;
  const int out_rows = rows / w;

  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += (long long)gridDim.x * blockDim.x) {
    const long long b = u / per_lane;
    long long rem = u - b * per_lane;
    const long long s = rem / per_super;
    rem -= s * per_super;
    const int r = (int)(rem / per_packet);
    const long long col = (rem - (long long)r * per_packet) * VEC;
    const int i = r / w;
    const int t = r - i * w;
    const uint8_t* in = data + b * k * n + s * super + col;
    uint8_t* dst = out + (b * out_rows + i) * n + s * super + t * packet + col;
    const uint32_t* mr = masks + r * nw;
    if constexpr (VEC == 16) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int q = 0; q < nw; ++q) {
        uint32_t word = mr[q];
        while (word) {
          const int bit = __ffs(word) - 1;
          word &= word - 1;
          const uint4 v =
              __ldg(reinterpret_cast<const uint4*>(in + offs[q * 32 + bit]));
          acc.x ^= v.x;
          acc.y ^= v.y;
          acc.z ^= v.z;
          acc.w ^= v.w;
        }
      }
      __stcs(reinterpret_cast<uint4*>(dst), acc);
    } else {
      uint32_t acc = 0;
      for (int q = 0; q < nw; ++q) {
        uint32_t word = mr[q];
        while (word) {
          const int bit = __ffs(word) - 1;
          word &= word - 1;
          acc ^= __ldg(in + offs[q * 32 + bit]);
        }
      }
      *dst = (uint8_t)acc;
    }
  }
}

template <int VEC>
cudaError_t launch(const uint8_t* bitmat, int rows, int k, int w,
                   long long packet, const uint8_t* data, uint8_t* out,
                   long long batch, long long n, size_t smem,
                   cudaStream_t stream) {
  const long long units = batch * (n / ((long long)w * packet)) * rows *
                          (packet / VEC);
  if (units == 0) return cudaSuccess;
  auto kernel = gf_packet_kernel<VEC>;
  unsigned blocks = 0;
  cudaError_t err =
      launch_common::grid_blocks(kernel, kThreads, smem, units, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(bitmat, rows, k, w, packet, data,
                                             out, batch, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[VEC == 16 ? kVector : kByte].fetch_add(1);
  return err;
}

cudaError_t launch_staged(const uint8_t* bitmat, int rows, int k, int w,
                          long long packet, long long tile,
                          const uint8_t* data, uint8_t* out, long long batch,
                          long long n, size_t smem, cudaStream_t stream) {
  const long long items = batch * (n / ((long long)w * packet)) *
                          ((packet + tile - 1) / tile);
  if (items == 0) return cudaSuccess;
  unsigned blocks = 0;
  cudaError_t err = launch_common::grid_blocks(
      gf_packet_staged_kernel, kStagedThreads, smem, items * kStagedThreads,
      &blocks);
  if (err != cudaSuccess) return err;
  gf_packet_staged_kernel<<<blocks, kStagedThreads, smem, stream>>>(
      bitmat, rows, k, w, packet, tile, data, out, batch, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[kStaged].fetch_add(1);
  return err;
}

bool valid(int rows, int k, int w, long long packetsize) {
  return rows >= 0 && k >= 1 && w >= 2 && w <= 32 && packetsize >= 1 &&
         rows % w == 0;
}

// The staged design's tile for a [rows, k*w] bitmatrix at `packetsize`
// with 16-byte aligned pointers or not, given the card's opt-in shared
// memory; 0 where the staged design does not take the geometry.
long long staged_tile(int rows, int k, int w, long long packetsize,
                      bool aligned, size_t optin) {
  if (!aligned || packetsize % 16 != 0) return 0;
  const long long t = stage_tile(k * w, packetsize);
  return t > 0 && staged_smem(rows, k * w, t) <= optin ? t : 0;
}

// The design of a [rows, k*w] bitmatrix with set_bits set entries (-1:
// not known) at `packetsize`, with 16-byte aligned pointers or not. The
// vector design is kept where the bitmatrix selects each input packet at
// most 3 times on average (set_bits <= 3*k*w): its re-reads are then few
// and L2 serves them, while the staged design pays a copy through shared
// memory and its list prologue. On an H100 (tools/gf_kernel_sweep.py
// --kernel packet) the liberation and blaum_roth encodes (2.1 and 2.7
// selects) ran 6-9% faster on the vector design at 16 objects of 1 MiB,
// and liber8tion's encode (3.3) and every denser bitmatrix ran faster
// staged.
Design pick(int rows, int k, int w, long long packetsize, bool aligned,
            size_t optin, long long set_bits) {
  if (!aligned || packetsize % 16 != 0) return kByte;
  if (set_bits >= 0 && set_bits <= 3ll * k * w) return kVector;
  return staged_tile(rows, k, w, packetsize, aligned, optin) > 0 ? kStaged
                                                                 : kVector;
}

// The product on design `want`, or on the design pick() takes where
// want < 0; -1 where the design does not take the geometry.
int encode_as(int want, const void* bitmat, int rows, int k, int w,
              long long packetsize, const void* data, void* out,
              long long batch, long long n, long long set_bits, void* stream) {
  if (!valid(rows, k, w, packetsize) || batch < 0 || n < 0 ||
      n % ((long long)w * packetsize) != 0)
    return -1;
  size_t optin = 0;
  const cudaError_t err = launch_common::smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  const auto* bm = static_cast<const uint8_t*>(bitmat);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const Design d = want >= 0 ? (Design)want
                             : pick(rows, k, w, packetsize, aligned, optin,
                                    set_bits);
  if (d == kStaged) {
    const long long tile = staged_tile(rows, k, w, packetsize, aligned, optin);
    if (tile == 0) return -1;
    return (int)launch_staged(bm, rows, k, w, packetsize, tile, in, o, batch,
                              n, staged_smem(rows, k * w, tile), s);
  }
  const size_t smem = packet_smem(rows, k * w);
  if (smem > optin) return -1;
  if (d == kVector) {
    if (!aligned || packetsize % 16 != 0) return -1;
    return (int)launch<16>(bm, rows, k, w, packetsize, in, o, batch, n, smem,
                           s);
  }
  return (int)launch<1>(bm, rows, k, w, packetsize, in, o, batch, n, smem, s);
}

}  // namespace

// Launches of design `design` (0 staged, 1 vector, 2 byte) since the last
// reset, or -1 for another number.
extern "C" long long gf_packet_launches(int design) {
  return design >= 0 && design < kNumDesign ? g_launches[design].load() : -1;
}

extern "C" void gf_packet_reset_launches() {
  for (auto& count : g_launches) count.store(0);
}

// The design (0 staged, 1 vector, 2 byte) that gf_packet_encode takes on
// the current device for a [rows, k*w] bitmatrix with set_bits set
// entries (-1: not known) at `packetsize`, with both pointers 16-byte
// aligned (aligned != 0) or not; -1 for a geometry it refuses, -2 a
// failed device query.
extern "C" int gf_packet_design(int rows, int k, int w, long long packetsize,
                                int aligned, long long set_bits) {
  if (!valid(rows, k, w, packetsize)) return -1;
  size_t optin = 0;
  if (launch_common::smem_optin(&optin) != cudaSuccess) return -2;
  return (int)pick(rows, k, w, packetsize, aligned != 0, optin, set_bits);
}

// bitmat [rows, k*w] 0/1 uint8 with set_bits set entries (-1: not known;
// it only steers the design), data [batch, k, n] uint8, out
// [batch, rows/w, n] uint8, all contiguous on the current device, n a
// multiple of w*packetsize. Returns 0, a cudaError_t code from a device
// query or the launch, or -1 for a geometry the kernel does not take
// (its shared memory included). Launches on `stream` and does not
// synchronise.
extern "C" int gf_packet_encode(const void* bitmat, int rows, int k, int w,
                                long long packetsize, const void* data,
                                void* out, long long batch, long long n,
                                long long set_bits, void* stream) {
  return encode_as(-1, bitmat, rows, k, w, packetsize, data, out, batch, n,
                   set_bits, stream);
}

// gf_packet_encode on design `design` (0 staged, 1 vector, 2 byte) in
// place of the one pick() takes, so that two designs can be timed on one
// geometry; -1 where that design does not take the geometry or the
// pointers' alignment.
extern "C" int gf_packet_encode_design(int design, const void* bitmat,
                                       int rows, int k, int w,
                                       long long packetsize, const void* data,
                                       void* out, long long batch, long long n,
                                       void* stream) {
  if (design < 0 || design >= kNumDesign) return -1;
  return encode_as(design, bitmat, rows, k, w, packetsize, data, out, batch,
                   n, -1, stream);
}
