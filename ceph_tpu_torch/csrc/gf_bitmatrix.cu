// GF(2^w) element-layout encode as a GF(2) bitmatrix product, for sm_90a.
//
// Replaces the TPU kernel ceph_tpu/ops/pallas_gf.py:_encode_kernel (launched
// by matrix_encode8 through pl.pallas_call), and also covers w=16 and w=32,
// the element layout that ceph_tpu/ops/xor_mm.py:matrix_encode computes with
// XLA. One entry point serves the encode bitmatrix ([m*w, k*w]) and every
// decode bitmatrix ([(k+m)*w, k*w]) of the Reed-Solomon codecs, and the
// MSR code's products on sub-symbol rows.
//
//   out[b, i, e] = element whose bit t is
//                  XOR_c bitmat[i*w + t, c] & bit c of v(b, e)
//
// where v(b, e) is the k*w-bit little-endian concatenation of the k input
// elements in column e of batch lane b: bit j*w + t of v is bit t of
// element e of data row j. That is row j*w + t of unpack_element_bits,
// the layout contract of ceph_tpu/ops/xor_mm.py and pallas_gf.py. In
// bytes: bit c of v is bit c % 8 of byte c / 8 of the column, byte
// j*(w/8) + s being byte s of element e of row j; output bitmatrix row
// 8*r + t is bit t of output byte row r (byte r % (w/8) of element row
// r / (w/8)).
//
// Bound. The function reads each input byte once and writes each output
// byte once. At the bench shape (B=16, k=8, m=3, N=131072, w=8) that is
// 16 MiB read + 6 MiB written = 23.07 MB, about 6.9 us at the H100 SXM's
// 3.35 TB/s; counted as int8 multiply-adds ([24, 64] @ [64, 2^21]) it is
// 6.4 GOP, 3.3 us at 1979 TOP/s, so bytes bound it. An MSR k=8 decode
// ([840, 448] on [8, 56, 18736]) is 113 GOP against 15.7 MB: operations
// bound it (PERF.md).
//
// Three designs; the C entry point picks one from the geometry alone.
//
// Bit-sliced (gf_bitsliced_kernel), for w = 8 with k*8 <= 128 (the main
// path's geometry) when the expanded bitmatrix fits in shared memory:
//  * A thread takes 32 consecutive columns of one batch lane: 32 bytes of
//    each data row, two 16-byte streaming loads a row. An 8x8 bit
//    transpose of each 8-byte group (three delta swaps, Hacker's Delight
//    7-3) and a 4x4 byte transpose (__byte_perm) turn a row's 32 bytes
//    into 8 plane words: bit e of plane (j, s) is bit s of column e's byte
//    of row j. The k*8 planes stay in registers (KMAX*8 of them; rows
//    j >= k are zero).
//  * Each block expands the bitmatrix once into shared memory, one word
//    per entry, 0 or 0xffffffff (E[R][KMAX*8]), one thread per 8x8 block
//    so that all its loads are in flight at once, and two masks per
//    output row: a bit per block equal to the identity, and per other
//    block that has a one.
//  * Out plane (i, t) = XOR over the masked blocks (i, j) and s < 8 of
//    plane (j, s) & E[i*8+t][j*8+s]: one LOP3 per bitmatrix entry per 32
//    columns; an identity block is 8 XORs of plane (j, t). The E words
//    are warp-uniform broadcast loads, 16 bytes at a time; the mask tests
//    are warp-uniform too, so skipping a zero block (most of a decode
//    bitmatrix) costs no divergence.
//  * The 8 out planes go back to 32 bytes through the same two transposes
//    and two 16-byte streaming stores.
//  * The grid is sized from the occupancy the kernel reaches; each thread
//    issues its first loads before the block expands the bitmatrix.
//
// Popcount (gf_bitmatrix_kernel), the first design, for w = 16 and 32
// with k*w <= 128 (the RS w=16 profiles up to k = 8, w=32 up to k = 4),
// where it runs faster than the mma design (w=16: 0.036 against
// 0.046-0.050 ms at [16, 8, 131072] on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md): the bitmatrix packed
// once per block into shared memory as NW = 1, 2 or 4 uint32 masks a
// row; a thread loads 16 bytes of each of the k rows of one batch lane,
// transposes them in registers into the per-column k*w-bit vectors, and
// computes each output bit as popc(XOR_q mask[r][q] & v[e][q]) & 1,
// stored 16 bytes at a time.
//
// Mma (gf_mma_kernel), for every other geometry (k*w > 128, or a w=8
// expansion past shared memory): the product on the int8 tensor cores,
// mma.sync m16n8k32 (s8 x s8 -> s32), with M = 16 element columns,
// N = 8 bitmatrix rows (one output byte row), K = 32 input bits. The sum
// of 0/1 products is at most k*w; its low bit is the parity.
//  * K order. Within a K-tile (input bytes 4*kt .. 4*kt+3 of a column) the
//    PTX positions 4t'..4t'+3 and 16+4t'..16+4t'+3 of lane t' (= lane % 4)
//    hold bits 0-3 and 4-7 of byte 4*kt + t'. So an A register is one
//    nibble of one data byte, (nib * 0x00204081) & 0x01010101, and a B
//    fragment (two registers) is the 8 consecutive 0/1 bytes of the
//    bitmatrix row at columns 32*kt + 8t' .. 32*kt + 8t' + 7.
//  * M order. A warp takes 32 consecutive element columns as two M-tiles;
//    lane group g (= lane / 4) holds columns 4g .. 4g+3 as A-rows g, g+8
//    of M-tile 0 and g, g+8 of M-tile 1. One 32-bit shared-memory load of
//    byte row 4*kt + t' (w = 8; w = 16/32 load 8 or 16 bytes and pick
//    byte s of each element with __byte_perm) gives all four columns'
//    bytes, so a K-tile's 8 A registers cost one load and 24 integer
//    instructions, and four lanes' loads of 8 groups are conflict-free.
//  * Data. Each warp stages its unit (k rows x 32 elements of one batch
//    lane) in its own shared-memory tile with 16-byte cp.async, two tiles
//    in turn, so the next unit's copy overlaps this unit's products; a
//    ragged unit or a data pointer off 16 bytes is copied byte by byte
//    with bytes past N zero. No block barrier: a warp's tile is its own.
//  * Bitmatrix. Each block stages a group of bitmatrix rows once in shared
//    memory, 0/1 bytes (& 1) in fragment order ([N-tile][K-tile pair]
//    [lane][16 bytes], zero past the rows and past k*w), so that a
//    lane's B fragments of two K-tiles are one conflict-free 16-byte
//    load. Groups are a multiple of 4 N-tiles (8 past 16 K-tiles), one
//    group a gridDim.y row, as few and as even as the card's opt-in shared
//    memory allows beside the warps' tiles, 256*(2*ceil(KT/2)*N-tiles +
//    8*KT) bytes (mma_group_tiles; gf_bitmatrix_group_rows reads it).
//  * Products. Up to 16 K-tiles (k*w <= 512) a warp builds its A once per
//    unit (8 registers a K-tile) and runs every N-tile of the group
//    against it, 4 N-tiles at a time: each B fragment feeds the two
//    M-tiles, 8 independent accumulator chains. Past 16 K-tiles (the MSR
//    code from k = 10) a warp takes 8 N-tiles at a time and rebuilds A
//    4 K-tiles at a time from its tile for each of them. A lane's B
//    fragments of two K-tiles lie side by side and come in one 16-byte
//    load: what bounds the design is the bytes of B loaded a product
//    (on an NVIDIA H100 80GB HBM3 at 700 W, mma.sync with B in registers
//    reaches 63% of the dense int8 peak, with 8 bytes a lane loaded for
//    every two products 38-42%, with 16 bytes for four 45-47%: PERF.md,
//    tools/gf_kernel_sweep.py --kernel mma_rate). Up to 4 K-tiles two
//    blocks share an SM.
//  * Epilogue, once per 4 N-tiles after the K loop: a lane holds D for
//    A-rows g, g+8 at N columns 2t', 2t'+1; (d & 1) << bit, then two
//    __shfl_xor_sync over the four lanes of a group give every lane the
//    output word of columns 4g..4g+3 for each of the 4 byte rows, and
//    lane t' stores one 32-bit word (w = 8: byte row t'; w = 16/32: the
//    words interleaved by __byte_perm into element bytes).
//
// Every design takes any N that is a multiple of w/8. k*w is limited only
// by the mma design's shared memory: a group of 4 (8) N-tiles beside the
// warps' tiles, k*w <= 1,792 bits on an H100 (the MSR code up to k = 15;
// gf_bitmatrix_max_k). The codecs' entry point (ops/xor_mm.py
// matrix_encode) runs a wider product as one launch per block of input
// rows and XORs the partial products.
//
// Per-lane bitmatrices (gf_bitmatrix_encode_multi). Replaces the XLA
// program of ceph_tpu/ops/xor_mm.py:91 (matrix_encode_multi, the vmap of
// matrix_encode with a different bitmatrix per lane), which the HBM chunk
// tier's reconstruct_batch runs with one decode bitmatrix per object.
// bitmats [P, R, k*w], data [P, L, k, N], out [P, L, R/w, N], in ONE
// launch whatever P is: the kernels loop over lanes (bit-sliced and
// popcount: lane = blockIdx.y, blockIdx.y + gridDim.y, ...; mma:
// blockIdx.z, its row group being blockIdx.y), stage that lane's
// bitmatrix in shared memory and stride over its L*N columns exactly as
// the single-matrix launch does over its batch; a block synchronises
// before it stages the next lane's
// bitmatrix. The single-matrix entry point is the same kernel with P = 1
// and a bitmatrix stride of 0. The grid takes the blocks the card holds
// at once (as a single matrix does), split over min(P, 65535) lanes.
// Bound: gf_bound summed over the lanes (utils/cuda_timing.py
// gf_multi_bound).
//
// Survivors where they lie (gf_bitmatrix_encode_multi_rows): the same
// kernels with lane p's k data rows named by a device table of row
// addresses, entries p*k ... p*k + k - 1, each row n bytes (batch 1), so
// the HBM chunk tier's rebuild reads each object's survivors in its upload
// batch instead of gathering them into a [P, k, n] copy first (at 1024
// objects of 4 MiB a 4 GiB temporary, written and read again), as the
// chunk digest (hbm_digest.cu) reads a scrub's rows. A thread loads the
// address of each row it reads (read-only path, the same address across
// the block) beside the row's bytes. Every row must start on 16 bytes,
// which the wrapper checks.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Design { kBitsliced = 0, kMma = 1, kPopcount = 2, kDesigns = 3 };

// Kernel launches of each design, counted where the kernel is launched:
// [0] from the single-matrix entry point, [1] from the per-lane one.
std::atomic<long long> g_launches[2][kDesigns];

cudaError_t count_launch(Design design, bool multi) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[multi][design].fetch_add(1);
  return err;
}

// Row j of batch lane b of per-lane lane `lane`: in the dense array
// [lanes, batch, k, n], or (TABLE, batch 1) at the table's address
// lane * k + j.
template <bool TABLE>
__device__ __forceinline__ const uint8_t* data_row(
    const uint8_t* __restrict__ data_all, const uint8_t* const* table,
    int lane, long long batch, int k, long long n, long long b, int j) {
  if constexpr (TABLE)
    return reinterpret_cast<const uint8_t*>(
        __ldg(reinterpret_cast<const unsigned long long*>(table) +
              (long long)lane * k + j));
  else return data_all + ((lane * batch + b) * k + j) * n;
}

// Grid of a per-lane launch: `lanes` rows of blocks (at most 65535, the
// kernels loop over the rest) and, in each, the blocks one lane's units
// need, together at most `resident` blocks (at least one a row).
dim3 lane_grid(long long lane_units, int lanes, long long resident) {
  const unsigned gy = lanes < 65535 ? (unsigned)lanes : 65535u;
  long long gx = (lane_units + kThreads - 1) / kThreads;
  const long long share = (resident + gy - 1) / gy;
  if (gx > share) gx = share;
  return dim3((unsigned)(gx > 0 ? gx : 1), gy);
}

// ---- popcount design (w = 16 and 32, k*w <= 128) ----------------------------

template <int W, int NW>
struct Geometry {
  static constexpr int KMAX = NW * 32 / W;         // data rows NW words hold
  static constexpr int VEC = 16;                   // bytes per row per thread
  static constexpr int VW = VEC / 4;               // uint32 words per row
  static constexpr int COLS = VEC * 8 / W;         // element columns per thread
};

template <int W, int NW, bool TABLE>
__global__ void __launch_bounds__(kThreads)
gf_bitmatrix_kernel(const uint8_t* __restrict__ bitmats,
                    long long bm_stride, int rows, int k,
                    const uint8_t* __restrict__ data_all,
                    const uint8_t* const* __restrict__ table,
                    uint8_t* __restrict__ out_all, int lanes,
                    long long batch, long long n, bool vec_ok) {
  using G = Geometry<W, NW>;
  extern __shared__ uint32_t masks[];  // [rows][NW]

  const int out_rows = rows / W;
  const long long chunks = (n + G::VEC - 1) / G::VEC;
  const long long units = batch * chunks;
  const uint32_t elem_mask = W == 32 ? 0xffffffffu : (1u << W) - 1u;

  for (int lane = blockIdx.y; lane < lanes; lane += gridDim.y) {
    uint8_t* __restrict__ out = out_all + lane * batch * out_rows * n;
    launch_common::pack_masks(bitmats + lane * bm_stride, rows, k * W, NW,
                              masks);
    __syncthreads();

    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < units; u += (long long)gridDim.x * blockDim.x) {
      const long long b = u / chunks;
      const long long off = (u - b * chunks) * G::VEC;
      const bool full = vec_ok && off + G::VEC <= n;

      // v[c][q]: word q of the k*w-bit vector of element column c
      uint32_t v[G::COLS][NW];
#pragma unroll
      for (int c = 0; c < G::COLS; ++c)
#pragma unroll
        for (int q = 0; q < NW; ++q) v[c][q] = 0;

#pragma unroll
      for (int j = 0; j < G::KMAX; ++j) {
        if (j < k) {
          const uint8_t* row =
              data_row<TABLE>(data_all, table, lane, batch, k, n, b, j) + off;
          uint32_t d[G::VW];
          if (full) {
            const uint4 x = __ldcs(reinterpret_cast<const uint4*>(row));
            d[0] = x.x;
            d[1] = x.y;
            d[2] = x.z;
            d[3] = x.w;
          } else {
#pragma unroll
            for (int t = 0; t < G::VW; ++t) d[t] = 0;
#pragma unroll
            for (int i = 0; i < G::VEC; ++i)
              if (off + i < n) d[i / 4] |= (uint32_t)row[i] << (8 * (i % 4));
          }
#pragma unroll
          for (int c = 0; c < G::COLS; ++c) {
            const uint32_t e = (d[(c * W) / 32] >> ((c * W) % 32)) & elem_mask;
            v[c][(j * W) / 32] |= e << ((j * W) % 32);
          }
        }
      }

      uint8_t* orow = out + b * out_rows * n + off;
      for (int i = 0; i < out_rows; ++i, orow += n) {
        uint32_t o[G::VW];
#pragma unroll
        for (int t = 0; t < G::VW; ++t) o[t] = 0;
#pragma unroll
        for (int t = 0; t < W; ++t) {
          const uint32_t* mk = masks + (i * W + t) * NW;
          uint32_t mw[NW];
#pragma unroll
          for (int q = 0; q < NW; ++q) mw[q] = mk[q];
#pragma unroll
          for (int c = 0; c < G::COLS; ++c) {
            uint32_t acc = 0;
#pragma unroll
            for (int q = 0; q < NW; ++q) acc ^= mw[q] & v[c][q];
            const int pos = c * W + t;  // bit t of element c within the chunk
            o[pos / 32] |= (__popc(acc) & 1u) << (pos % 32);
          }
        }
        if (full) {
          __stcs(reinterpret_cast<uint4*>(orow),
                 make_uint4(o[0], o[1], o[2], o[3]));
        } else {
#pragma unroll
          for (int x = 0; x < G::VEC; ++x)
            if (off + x < n) orow[x] = (uint8_t)(o[x / 4] >> (8 * (x % 4)));
        }
      }
    }
    // every thread has read this lane's masks before the next lane's land
    if (lane + gridDim.y < lanes) __syncthreads();
  }
}

template <int W, int NW, bool TABLE>
cudaError_t launch_popcount(const uint8_t* bitmat, long long bm_stride,
                            int rows, int k, const uint8_t* data,
                            const uint8_t* const* table, uint8_t* out,
                            int lanes, long long batch, long long n,
                            bool multi, cudaStream_t stream) {
  using G = Geometry<W, NW>;
  const long long units = batch * ((n + G::VEC - 1) / G::VEC);
  if (units == 0 || rows == 0 || lanes == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid = lane_grid(units, lanes, (long long)sms * 8);
  // a table's rows start on 16 bytes (the wrapper checks)
  const bool vec_ok = n % G::VEC == 0 &&
                      reinterpret_cast<uintptr_t>(data) % G::VEC == 0 &&
                      reinterpret_cast<uintptr_t>(out) % G::VEC == 0;
  const size_t smem = (size_t)rows * NW * sizeof(uint32_t);
  auto kernel = gf_bitmatrix_kernel<W, NW, TABLE>;
  // masks past 48 KiB: the kernel's dynamic limit is raised first, up to
  // the card's opt-in
  int per_sm = 0;
  err = launch_common::resident_blocks(kernel, kThreads, dev, smem, &per_sm);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      bitmat, bm_stride, rows, k, data, table, out, lanes, batch, n, vec_ok);
  return count_launch(kPopcount, multi);
}

constexpr int kPopcountMaxBits = 128;  // k*w the popcount design takes

int mask_words(int bits) { return bits <= 32 ? 1 : bits <= 64 ? 2 : 4; }

// ---- bit-sliced design (w = 8, k <= 16) -----------------------------------

constexpr int kCols = 32;                 // columns (row bytes) per thread
constexpr int kBitslicedMaxBits = 128;    // k*8 the design takes

// 8x8 bit transpose of 8 bytes (lo = bytes 0-3, hi = bytes 4-7): bit 8r + c
// goes to bit 8c + r. The 64-bit delta swaps of Hacker's Delight 7-3; the
// first two stay within each half, the third trades nibbles between them.
__device__ __forceinline__ void bit_transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// 4x4 byte transpose: byte g of o_s is byte s of w_g.
__device__ __forceinline__ void byte_transpose4(
    uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, uint32_t& o0,
    uint32_t& o1, uint32_t& o2, uint32_t& o3) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140);
  const uint32_t b = __byte_perm(w0, w1, 0x7362);
  const uint32_t c = __byte_perm(w2, w3, 0x5140);
  const uint32_t d = __byte_perm(w2, w3, 0x7362);
  o0 = __byte_perm(a, c, 0x5410);
  o1 = __byte_perm(a, c, 0x7632);
  o2 = __byte_perm(b, d, 0x5410);
  o3 = __byte_perm(b, d, 0x7632);
}

// q: the 8 little-endian words of 32 column bytes, in place into 8 planes
// (bit e of q[s] = bit s of byte e).
__device__ __forceinline__ void to_planes(uint32_t* q) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = q[i];
#pragma unroll
  for (int g = 0; g < 4; ++g) bit_transpose8(w[2 * g], w[2 * g + 1]);
  byte_transpose4(w[0], w[2], w[4], w[6], q[0], q[1], q[2], q[3]);
  byte_transpose4(w[1], w[3], w[5], w[7], q[4], q[5], q[6], q[7]);
}

// Inverse of to_planes: both transposes are involutions.
__device__ __forceinline__ void from_planes(uint32_t* q) {
  uint32_t w[8];
  byte_transpose4(q[0], q[1], q[2], q[3], w[0], w[2], w[4], w[6]);
  byte_transpose4(q[4], q[5], q[6], q[7], w[1], w[3], w[5], w[7]);
#pragma unroll
  for (int g = 0; g < 4; ++g) bit_transpose8(w[2 * g], w[2 * g + 1]);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = w[i];
}

// Loads unit u (batch lane, 32 columns) of the KMAX data rows into p as
// 8 words a row; rows j >= k and bytes past N are zero.
template <int KMAX, bool TABLE>
__device__ __forceinline__ void load_unit(
    const uint8_t* __restrict__ data_all, const uint8_t* const* table,
    int lane, long long batch, int k, long long n, long long chunks,
    long long u, bool vec_ok, uint32_t* p) {
  const long long b = u / chunks;
  const long long off = (u - b * chunks) * kCols;
  const bool full = vec_ok && off + kCols <= n;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    uint32_t* q = p + 8 * j;
#pragma unroll
    for (int x = 0; x < 8; ++x) q[x] = 0;
    if (j < k) {
      const uint8_t* row =
          data_row<TABLE>(data_all, table, lane, batch, k, n, b, j) + off;
      if (full) {
        const uint4 x0 = __ldcs(reinterpret_cast<const uint4*>(row));
        const uint4 x1 = __ldcs(reinterpret_cast<const uint4*>(row) + 1);
        q[0] = x0.x;
        q[1] = x0.y;
        q[2] = x0.z;
        q[3] = x0.w;
        q[4] = x1.x;
        q[5] = x1.y;
        q[6] = x1.z;
        q[7] = x1.w;
      } else {
#pragma unroll
        for (int x = 0; x < kCols; ++x)
          if (off + x < n) q[x / 4] |= (uint32_t)row[x] << (8 * (x % 4));
      }
    }
  }
}

template <int KMAX>
size_t bitsliced_smem(int rows) {
  // E [rows][KMAX*8] words, then two block masks per output row
  return ((size_t)rows * KMAX * 8 + 2 * (size_t)(rows / 8)) *
         sizeof(uint32_t);
}

template <int KMAX, bool TABLE>
__global__ void __launch_bounds__(kThreads)
gf_bitsliced_kernel(const uint8_t* __restrict__ bitmats,
                    long long bm_stride, int rows, int k,
                    const uint8_t* __restrict__ data_all,
                    const uint8_t* const* __restrict__ table,
                    uint8_t* __restrict__ out_all, int lanes,
                    long long batch, long long n, bool vec_ok) {
  constexpr int STRIDE = KMAX * 8;  // E words per bitmatrix row
  extern __shared__ uint4 bs_smem[];
  uint32_t* E = reinterpret_cast<uint32_t*>(bs_smem);
  uint32_t* nz = E + (size_t)rows * STRIDE;  // [rows/8] general blocks
  uint32_t* id = nz + rows / 8;              // [rows/8] identity blocks

  const int bits = k * 8;
  const int out_rows = rows / 8;
  const long long chunks = (n + kCols - 1) / kCols;
  const long long units = batch * chunks;
  const long long step = (long long)gridDim.x * blockDim.x;

  for (int lane = blockIdx.y; lane < lanes; lane += gridDim.y) {
    const uint8_t* __restrict__ bitmat = bitmats + lane * bm_stride;
    uint8_t* __restrict__ out = out_all + lane * batch * out_rows * n;
    long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;

    // p: the words, then the planes, of the unit's KMAX data rows
    uint32_t p[STRIDE];
    if (u < units)
      load_unit<KMAX, TABLE>(data_all, table, lane, batch, k, n, chunks, u,
                             vec_ok, p);

    // One thread per 8x8 block (i, j): its 64 loads are all in flight at
    // once, so the expansion costs one memory latency, not one per entry.
    // Blocks j >= k are never read (their mask bits are 0). KMAX divides
    // 32, so a warp's vote holds whole output rows. Bit j of id[i]: block
    // (i, j) is the identity; of nz[i]: it has a one and is not the
    // identity.
    const int pairs = out_rows * KMAX;
    for (int base = 0; base < pairs; base += blockDim.x) {
      const int idx = base + threadIdx.x;
      const int i = idx / KMAX;
      const int j = idx - i * KMAX;
      uint32_t any = 0, ident = 0;
      if (idx < pairs && j < k) {
        const uint8_t* blk = bitmat + (long long)i * 8 * bits + j * 8;
        uint32_t bt[8][8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int s = 0; s < 8; ++s) bt[t][s] = blk[(long long)t * bits + s] & 1u;
        ident = 1;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          uint4* e = reinterpret_cast<uint4*>(E + (i * 8 + t) * STRIDE + j * 8);
          e[0] = make_uint4(0u - bt[t][0], 0u - bt[t][1], 0u - bt[t][2], 0u - bt[t][3]);
          e[1] = make_uint4(0u - bt[t][4], 0u - bt[t][5], 0u - bt[t][6], 0u - bt[t][7]);
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            any |= bt[t][s];
            ident &= bt[t][s] == (t == s ? 1u : 0u);
          }
        }
      }
      const uint32_t vote = __ballot_sync(0xffffffffu, any);
      const uint32_t vote_id = __ballot_sync(0xffffffffu, ident);
      if (idx < pairs && j == 0) {
        const uint32_t low = 0xffffffffu >> (32 - KMAX);
        const int bit = threadIdx.x % 32;
        nz[i] = ((vote & ~vote_id) >> bit) & low;
        id[i] = (vote_id >> bit) & low;
      }
    }
    __syncthreads();

    while (u < units) {
      const long long b = u / chunks;
      const long long off = (u - b * chunks) * kCols;
      const bool full = vec_ok && off + kCols <= n;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) to_planes(p + 8 * j);

      uint8_t* orow = out + b * out_rows * n + off;
      for (int i = 0; i < out_rows; ++i, orow += n) {
        const uint32_t mask = nz[i];
        const uint32_t imask = id[i];
        uint32_t acc[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t] = 0;
        const uint32_t* Ei = E + (size_t)i * 8 * STRIDE;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const uint32_t* pj = p + 8 * j;
          if ((imask >> j) & 1u) {
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[t] ^= pj[t];
          } else if ((mask >> j) & 1u) {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const uint4* e = reinterpret_cast<const uint4*>(Ei + t * STRIDE + 8 * j);
              const uint4 e0 = e[0];
              const uint4 e1 = e[1];
              acc[t] ^= pj[0] & e0.x;
              acc[t] ^= pj[1] & e0.y;
              acc[t] ^= pj[2] & e0.z;
              acc[t] ^= pj[3] & e0.w;
              acc[t] ^= pj[4] & e1.x;
              acc[t] ^= pj[5] & e1.y;
              acc[t] ^= pj[6] & e1.z;
              acc[t] ^= pj[7] & e1.w;
            }
          }
        }
        from_planes(acc);
        if (full) {
          __stcs(reinterpret_cast<uint4*>(orow),
                 make_uint4(acc[0], acc[1], acc[2], acc[3]));
          __stcs(reinterpret_cast<uint4*>(orow) + 1,
                 make_uint4(acc[4], acc[5], acc[6], acc[7]));
        } else {
#pragma unroll
          for (int x = 0; x < kCols; ++x)
            if (off + x < n) orow[x] = (uint8_t)(acc[x / 4] >> (8 * (x % 4)));
        }
      }

      u += step;
      if (u < units)
        load_unit<KMAX, TABLE>(data_all, table, lane, batch, k, n, chunks, u,
                               vec_ok, p);
    }
    // every thread has read this lane's E before the next lane's lands
    if (lane + gridDim.y < lanes) __syncthreads();
  }
}

template <int KMAX, bool TABLE>
cudaError_t launch_bitsliced(const uint8_t* bitmat, long long bm_stride,
                             int rows, int k, const uint8_t* data,
                             const uint8_t* const* table, uint8_t* out,
                             int lanes, long long batch, long long n,
                             bool multi, cudaStream_t stream) {
  const long long units = batch * ((n + kCols - 1) / kCols);
  if (units == 0 || rows == 0 || lanes == 0) return cudaSuccess;
  auto kernel = gf_bitsliced_kernel<KMAX, TABLE>;
  const size_t smem = bitsliced_smem<KMAX>(rows);
  unsigned resident = 0;
  const cudaError_t err = launch_common::grid_blocks(
      kernel, kThreads, smem, units * lanes, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid = lane_grid(units, lanes, resident);
  // a table's rows start on 16 bytes (the wrapper checks)
  const bool vec_ok = n % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<grid, kThreads, smem, stream>>>(bitmat, bm_stride, rows, k, data,
                                           table, out, lanes, batch, n,
                                           vec_ok);
  return count_launch(kBitsliced, multi);
}

// ---- mma design (int8 tensor cores) ----------------------------------------

constexpr int kMmaWarps = 8;                    // warps a block
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaCols = 32;                    // element columns a warp unit
constexpr int kMmaRegTiles = 16;                // K-tiles held for a whole unit
constexpr int kMmaChunk = 4;                    // K-tiles a chunk past that

// N-tiles a warp accumulates at once, and the multiple a row group's
// N-tiles are: 4 up to kMmaRegTiles K-tiles, 8 past them.
int mma_step(int k_tiles) { return k_tiles <= kMmaRegTiles ? 4 : 8; }

// Dynamic shared memory of a block: the bitmatrix group (256 bytes an
// N-tile and K-tile, K-tiles in pairs) and two data tiles a warp (128
// bytes a K-tile each).
size_t mma_smem(int k_tiles, int group_tiles) {
  return (size_t)256 * ((k_tiles + 1) / 2 * 2 * group_tiles +
                        k_tiles * kMmaWarps);
}

// The row-group plan: the N-tiles (8 bitmatrix rows each) a group of an
// [rows, k_tiles*32] product stages, as few groups as `optin` bytes of
// shared memory allow beside the warps' data tiles, balanced, each a
// multiple of mma_step; 0 where even one smallest group does not fit or
// the groups would pass gridDim.y's 65535.
int mma_group_tiles(int rows, int k_tiles, size_t optin) {
  const int step = mma_step(k_tiles);
  const size_t fixed = mma_smem(k_tiles, 0);
  if (optin < fixed) return 0;
  const long long most =
      (long long)((optin - fixed) / (mma_smem(k_tiles, 1) - fixed)) / step *
      step;
  if (most < step) return 0;
  const long long tiles = rows / 8 > 0 ? rows / 8 : 1;
  const long long groups = (tiles + most - 1) / most;
  if (groups > 65535) return 0;
  const long long per_group = (tiles + groups - 1) / groups;
  return (int)((per_group + step - 1) / step * step);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += popc(a & b) on the tensor cores' binary path: A 16x256 bits
// (row), B 256x8 bits (col); timing only (mma_rate_kernel).
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// d += a * b on the int8 tensor cores: A 16x32 (row), B 32x8 (col).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Four bits to four 0/1 bytes: bit q of x to byte q.
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// Byte 4*kt + t of the k*w-bit vectors of columns 4g .. 4g+3 of a warp's
// tile (byte c of the result: column 4g + c). Tile row j holds the 32
// elements of data row j, 32*w/8 bytes.
template <int W>
__device__ __forceinline__ uint32_t column_bytes(const uint8_t* tile, int kt,
                                                 int g, int t) {
  constexpr int WB = W / 8;
  const int beta = 4 * kt + t;
  const uint8_t* p = tile + (beta / WB) * (kMmaCols * WB) + g * 4 * WB;
  const int s = beta % WB;
  if constexpr (W == 8) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (W == 16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return __byte_perm(v.x, v.y, 0x6420 + 0x1111 * s);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned sel = s | (s + 4) << 4;
    return __byte_perm(__byte_perm(v.x, v.y, sel),
                       __byte_perm(v.z, v.w, sel), 0x5410);
  }
}

// The 8 A registers of K-tile kt: a[mt] is M-tile mt's fragment.
template <int W>
__device__ __forceinline__ void build_a(const uint8_t* tile, int kt, int g,
                                        int t, uint32_t (&a)[2][4]) {
  const uint32_t p = column_bytes<W>(tile, kt, g, t);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t byte = p >> (8 * c);
    a[c / 2][c % 2] = spread_nibble(byte & 0xfu);
    a[c / 2][2 + c % 2] = spread_nibble((byte >> 4) & 0xfu);
  }
}

// Packs the low bits of 4 N-tiles' accumulators acc[q0 .. q0+3] into
// output words and stores lane t's word: byte row rho0 + q holds N-tile
// q0 + q. obase: the batch lane's first output row; e0: the unit's first
// element column.
template <int W, int NB>
__device__ __forceinline__ void store_tiles(const int (&acc)[NB][2][4],
                                            int q0, uint8_t* obase,
                                            int rho0, int out_rows,
                                            long long n, long long e0, int g,
                                            int t, bool out_vec) {
  constexpr int WB = W / 8;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t x = 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int* d = acc[q0 + q][mt];
      x |= ((uint32_t)d[0] & 1u) << (16 * mt) |
           ((uint32_t)d[1] & 1u) << (16 * mt + 1) |
           ((uint32_t)d[2] & 1u) << (16 * mt + 8) |
           ((uint32_t)d[3] & 1u) << (16 * mt + 9);
    }
    x <<= 2 * t;
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    v[q] = x;  // byte c: output byte row rho0 + q of column 4g + c
  }
  uint32_t word;
  if constexpr (W == 8) {
    word = t == 0 ? v[0] : t == 1 ? v[1] : t == 2 ? v[2] : v[3];
  } else if constexpr (W == 16) {
    const uint32_t lo = t < 2 ? v[0] : v[2];
    const uint32_t hi = t < 2 ? v[1] : v[3];
    word = __byte_perm(lo, hi, (t & 1) ? 0x7362 : 0x5140);
  } else {
    const unsigned sel = t | (t + 4) << 4;
    word = __byte_perm(__byte_perm(v[0], v[1], sel),
                       __byte_perm(v[2], v[3], sel), 0x5410);
  }
  const int i = rho0 / WB + t / WB;  // element row
  if (i >= out_rows) return;         // a group's padding
  const long long ob = e0 * WB + 4LL * g * WB + 4 * (t % WB);
  uint8_t* dst = obase + (long long)i * n + ob;
  if (out_vec && ob + 4 <= n) {
    __stcs(reinterpret_cast<unsigned int*>(dst), word);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (ob + x < n) dst[x] = (uint8_t)(word >> (8 * x));
  }
}

// Copies unit u (batch lane b, elements e0 .. e0+31) of data rows 0 .. k-1
// into a warp's tile, 16-byte cp.async where the unit is whole and
// aligned, else byte by byte with bytes past N zero.
template <int W, bool TABLE>
__device__ __forceinline__ void load_tile(
    const uint8_t* __restrict__ data_all, const uint8_t* const* table,
    int lane, long long batch, int k, long long n, long long chunks,
    long long u, bool in_vec, uint8_t* tile, int l) {
  constexpr int RB = kMmaCols * (W / 8);  // bytes of a tile row
  const long long b = u / chunks;
  const long long off = (u - b * chunks) * RB;
  if (in_vec && off + RB <= n) {
    for (int idx = l; idx < k * (RB / 16); idx += 32) {
      const int j = idx / (RB / 16);
      const int p = idx - j * (RB / 16);
      cp_async16(tile + j * RB + 16 * p,
                 data_row<TABLE>(data_all, table, lane, batch, k, n, b, j) +
                     off + 16 * p);
    }
  } else {
    for (int idx = l; idx < k * RB; idx += 32) {
      const int j = idx / RB;
      const int x = idx - j * RB;
      tile[idx] =
          off + x < n
              ? data_row<TABLE>(data_all, table, lane, batch, k, n, b, j)
                    [off + x]
              : (uint8_t)0;
    }
  }
}

// KC: K-tiles of A held in registers; CHUNKED: KC at a time for each 8
// N-tiles (k*w past KC*32), else all of them once per unit. Up to 4
// K-tiles two blocks an SM (at most 128 registers), else one.
template <int W, int KC, bool CHUNKED, bool TABLE>
__global__ void __launch_bounds__(kMmaThreads, !CHUNKED && KC <= 4 ? 2 : 1)
gf_mma_kernel(const uint8_t* __restrict__ bitmats, long long bm_stride,
              int rows, int k, const uint8_t* __restrict__ data_all,
              const uint8_t* const* __restrict__ table,
              uint8_t* __restrict__ out_all, int lanes, long long batch,
              long long n, int group_tiles, bool in_vec, bool out_vec,
              bool bm_vec) {
  constexpr int WB = W / 8;
  constexpr int NB = CHUNKED ? 8 : 4;  // N-tiles accumulated at once
  extern __shared__ uint4 mma_smem_buf[];
  const int kw = k * W;
  const int KT = (kw + 31) / 32;
  const int KP = (KT + 1) / 2;                   // K-tile pairs
  uint8_t* bs = reinterpret_cast<uint8_t*>(mma_smem_buf);
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4;
  const int tile_bytes = 128 * KT;
  uint8_t* tiles = bs + (size_t)group_tiles * KP * 512 +
                   (size_t)warp * 2 * tile_bytes;

  const int out_rows = rows / W;
  const int row_tiles = rows / 8;               // output byte rows
  const int tile0 = blockIdx.y * group_tiles;   // the group's first N-tile
  int here = row_tiles - tile0;                 // its N-tiles, padded to NB
  here = (here + NB - 1) / NB * NB;
  if (here > group_tiles) here = group_tiles;
  const long long ne = n / WB;
  const long long chunks = (ne + kMmaCols - 1) / kMmaCols;
  const long long units = batch * chunks;
  const long long ustep = (long long)gridDim.x * kMmaWarps;

  for (int lane = blockIdx.z; lane < lanes; lane += gridDim.z) {
    // the group's rows in fragment order, 8 bytes a lane and K-tile, the
    // two K-tiles of a pair side by side ([N-tile][pair][lane][16 bytes])
    const uint8_t* bm = bitmats + lane * bm_stride;
    const int words = group_tiles * KP * 2 * 32;
    for (int idx = threadIdx.x; idx < words; idx += blockDim.x) {
      const int nt = idx / (KP * 64);
      const int rem = idx - nt * KP * 64;
      const int kt = rem / 32, ll = rem % 32;
      const int row = (tile0 + nt) * 8 + ll / 4;
      const int col = kt * 32 + (ll % 4) * 8;
      uint2 v = make_uint2(0u, 0u);
      if (row < rows && col < kw) {
        const uint8_t* src = bm + (long long)row * kw + col;
        if (bm_vec) {
          v = __ldg(reinterpret_cast<const uint2*>(src));
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            v.x |= (uint32_t)src[x] << (8 * x);
            v.y |= (uint32_t)src[4 + x] << (8 * x);
          }
        }
        v.x &= 0x01010101u;
        v.y &= 0x01010101u;
      }
      reinterpret_cast<uint2*>(bs)[((nt * KP + kt / 2) * 32 + ll) * 2 +
                                   (kt & 1)] = v;
    }
    __syncthreads();

    uint8_t* out = out_all + lane * batch * out_rows * n;
    const uint8_t* bl = bs + (size_t)l * 16;  // this lane's B bytes
    long long u = (long long)blockIdx.x * kMmaWarps + warp;
    int buf = 0;
    if (u < units)
      load_tile<W, TABLE>(data_all, table, lane, batch, k, n, chunks, u,
                          in_vec, tiles, l);
    cp_async_commit();
    for (; u < units; u += ustep) {
      if (u + ustep < units)
        load_tile<W, TABLE>(data_all, table, lane, batch, k, n, chunks,
                            u + ustep, in_vec, tiles + (buf ^ 1) * tile_bytes,
                            l);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const uint8_t* tile = tiles + buf * tile_bytes;
      const long long b = u / chunks;
      const long long e0 = (u - b * chunks) * kMmaCols;
      uint8_t* obase = out + b * out_rows * n;

      if constexpr (!CHUNKED) {
        uint32_t a[KC][2][4];
#pragma unroll
        for (int kt = 0; kt < KC; ++kt)
          if (kt < KT) build_a<W>(tile, kt, g, t, a[kt]);
        for (int nt0 = 0; nt0 < here; nt0 += NB) {
          int acc[NB][2][4] = {};
          const uint8_t* bp = bl + (size_t)nt0 * KP * 512;
#pragma unroll
          for (int kp = 0; kp < KC / 2; ++kp) {
            if (2 * kp < KT) {
#pragma unroll
              for (int q = 0; q < NB; ++q) {
                // one 16-byte load: the fragments of K-tiles 2kp, 2kp + 1
                const uint4 v = *reinterpret_cast<const uint4*>(
                    bp + ((size_t)q * KP + kp) * 512);
                mma_s8(acc[q][0], a[2 * kp][0], make_uint2(v.x, v.y));
                mma_s8(acc[q][1], a[2 * kp][1], make_uint2(v.x, v.y));
                if (2 * kp + 1 < KT) {
                  mma_s8(acc[q][0], a[2 * kp + 1][0], make_uint2(v.z, v.w));
                  mma_s8(acc[q][1], a[2 * kp + 1][1], make_uint2(v.z, v.w));
                }
              }
            }
          }
          store_tiles<W, NB>(acc, 0, obase, tile0 + nt0, out_rows, n, e0, g,
                             t, out_vec);
        }
      } else {
        for (int nt0 = 0; nt0 < here; nt0 += NB) {
          int acc[NB][2][4] = {};
          const uint8_t* bp = bl + (size_t)nt0 * KP * 512;
          for (int c0 = 0; c0 < KT; c0 += KC) {
            uint32_t a[KC][2][4];
#pragma unroll
            for (int i = 0; i < KC; ++i)
              if (c0 + i < KT) build_a<W>(tile, c0 + i, g, t, a[i]);
#pragma unroll
            for (int i = 0; i < KC; i += 2) {
              if (c0 + i < KT) {
#pragma unroll
                for (int q = 0; q < NB; ++q) {
                  const uint4 v = *reinterpret_cast<const uint4*>(
                      bp + ((size_t)q * KP + (c0 + i) / 2) * 512);
                  mma_s8(acc[q][0], a[i][0], make_uint2(v.x, v.y));
                  mma_s8(acc[q][1], a[i][1], make_uint2(v.x, v.y));
                  if (c0 + i + 1 < KT) {
                    mma_s8(acc[q][0], a[i + 1][0], make_uint2(v.z, v.w));
                    mma_s8(acc[q][1], a[i + 1][1], make_uint2(v.z, v.w));
                  }
                }
              }
            }
          }
#pragma unroll
          for (int h = 0; h < NB; h += 4)
            store_tiles<W, NB>(acc, h, obase, tile0 + nt0 + h, out_rows, n,
                               e0, g, t, out_vec);
        }
      }
      // every lane has read this tile before the next copy into it
      __syncwarp();
      buf ^= 1;
    }
    // every thread has read this lane's group before the next lane's lands
    if (lane + gridDim.z < lanes) __syncthreads();
  }
}

template <int W, int KC, bool CHUNKED, bool TABLE>
cudaError_t launch_mma(const uint8_t* bitmat, long long bm_stride, int rows,
                       int k, const uint8_t* data,
                       const uint8_t* const* table, uint8_t* out, int lanes,
                       long long batch, long long n, int group_tiles,
                       bool multi, cudaStream_t stream) {
  const long long ne = n / (W / 8);
  const long long units = batch * ((ne + kMmaCols - 1) / kMmaCols);
  if (units == 0 || rows == 0 || lanes == 0) return cudaSuccess;
  const int k_tiles = (k * W + 31) / 32;
  const long long groups = (rows / 8 + group_tiles - 1) / group_tiles;
  auto kernel = gf_mma_kernel<W, KC, CHUNKED, TABLE>;
  const size_t smem = mma_smem(k_tiles, group_tiles);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = launch_common::resident_blocks(kernel, kMmaThreads, dev, smem,
                                       &per_sm);
  if (err != cudaSuccess) return err;
  // the blocks the card holds at once, over the groups and lanes
  const unsigned gz = lanes < 65535 ? (unsigned)lanes : 65535u;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long share = (resident + groups * gz - 1) / (groups * gz);
  long long gx = (units + kMmaWarps - 1) / kMmaWarps;
  if (gx > share) gx = share;
  const dim3 grid((unsigned)(gx > 0 ? gx : 1), (unsigned)groups, gz);
  // a table's rows start on 16 bytes (the wrapper checks)
  const bool in_vec = TABLE || (n % 16 == 0 &&
                                reinterpret_cast<uintptr_t>(data) % 16 == 0);
  const bool out_vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const bool bm_vec = reinterpret_cast<uintptr_t>(bitmat) % 8 == 0;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      bitmat, bm_stride, rows, k, data, table, out, lanes, batch, n,
      group_tiles, in_vec, out_vec, bm_vec);
  return count_launch(kMma, multi);
}

// ---- design choice ---------------------------------------------------------

// Validates the geometry and picks its design: bit-sliced for w = 8 with
// k*8 <= 128 when its shared memory fits the card's per-block opt-in
// limit, popcount for w = 16 and 32 with k*w <= 128 when its masks fit
// it, mma otherwise, whose row-group plan (mma_group_tiles, set in
// `group_tiles`) must fit the same limit. Returns 0 (design set), -1 for
// a geometry no design takes, or the cudaError_t of a failed device
// query.
int pick_design(int rows, int k, int w, int* design, int* group_tiles) {
  if (k < 1 || rows < 0) return -1;
  if (w != 8 && w != 16 && w != 32) return -1;
  const int bits = k * w;
  if (rows % w != 0) return -1;
  size_t optin = 0;
  const cudaError_t err = launch_common::smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  if (w == 8 && bits <= kBitslicedMaxBits) {
    const size_t smem = k <= 4   ? bitsliced_smem<4>(rows)
                        : k <= 8 ? bitsliced_smem<8>(rows)
                                 : bitsliced_smem<16>(rows);
    if (smem <= optin) {
      *design = kBitsliced;
      return 0;
    }
  }
  if (w != 8 && bits <= kPopcountMaxBits &&
      (size_t)rows * mask_words(bits) * sizeof(uint32_t) <= optin) {
    *design = kPopcount;
    return 0;
  }
  const int tiles = mma_group_tiles(rows, (bits + 31) / 32, optin);
  if (tiles == 0) return -1;
  *design = kMma;
  *group_tiles = tiles;
  return 0;
}

}  // namespace

// The design gf_bitmatrix_encode takes for this geometry on the current
// device: 0 bit-sliced, 1 mma, 2 popcount, -1 a geometry it refuses, -2 a
// failed device query.
extern "C" int gf_bitmatrix_design(int rows, int k, int w) {
  int design = kMma, group_tiles = 0;
  const int rc = pick_design(rows, k, w, &design, &group_tiles);
  return rc == 0 ? design : rc < 0 ? -1 : -2;
}

// The bitmatrix rows a row group of the mma design spans for this
// geometry on the current device (a group of the last may hold fewer), 0
// for another design, -1 a geometry it refuses, -2 a failed device query.
extern "C" int gf_bitmatrix_group_rows(int rows, int k, int w) {
  int design = kMma, group_tiles = 0;
  const int rc = pick_design(rows, k, w, &design, &group_tiles);
  if (rc != 0) return rc < 0 ? -1 : -2;
  return design == kMma ? 8 * group_tiles : 0;
}

// The largest k one launch takes at this w on the current device (the
// mma design's smallest row group beside its data tiles within the
// opt-in shared memory), -1 for a w it refuses, -2 a failed device query.
extern "C" int gf_bitmatrix_max_k(int w) {
  if (w != 8 && w != 16 && w != 32) return -1;
  size_t optin = 0;
  if (launch_common::smem_optin(&optin) != cudaSuccess) return -2;
  int k = 0;
  while (mma_group_tiles(8, ((k + 1) * w + 31) / 32, optin) != 0) ++k;
  return k;
}

// Launches of `design` (0 bit-sliced, 1 mma, 2 popcount) since the last
// reset: from
// gf_bitmatrix_encode with multi = 0, from gf_bitmatrix_encode_multi and
// _multi_rows with multi = 1.
extern "C" long long gf_bitmatrix_launches(int design, int multi) {
  return design >= 0 && design < kDesigns && (multi == 0 || multi == 1)
             ? g_launches[multi][design].load()
             : -1;
}

extern "C" void gf_bitmatrix_reset_launches() {
  for (auto& by_design : g_launches)
    for (auto& count : by_design) count.store(0);
}

namespace {

template <int W, bool TABLE>
cudaError_t launch_popcount_w(const uint8_t* bm, long long bm_stride,
                              int rows, int k, const uint8_t* in,
                              const uint8_t* const* table, uint8_t* o,
                              int lanes, long long batch, long long n,
                              bool multi, cudaStream_t s) {
  switch (mask_words(k * W)) {
    case 1:
      return launch_popcount<W, 1, TABLE>(bm, bm_stride, rows, k, in, table,
                                          o, lanes, batch, n, multi, s);
    case 2:
      return launch_popcount<W, 2, TABLE>(bm, bm_stride, rows, k, in, table,
                                          o, lanes, batch, n, multi, s);
    default:
      return launch_popcount<W, 4, TABLE>(bm, bm_stride, rows, k, in, table,
                                          o, lanes, batch, n, multi, s);
  }
}

template <int W, bool TABLE>
cudaError_t launch_mma_w(const uint8_t* bm, long long bm_stride, int rows,
                         int k, const uint8_t* in,
                         const uint8_t* const* table, uint8_t* o, int lanes,
                         long long batch, long long n, int group_tiles,
                         bool multi, cudaStream_t s) {
  const int k_tiles = (k * W + 31) / 32;
  if (k_tiles <= 4)
    return launch_mma<W, 4, false, TABLE>(bm, bm_stride, rows, k, in, table,
                                          o, lanes, batch, n, group_tiles,
                                          multi, s);
  if (k_tiles <= 8)
    return launch_mma<W, 8, false, TABLE>(bm, bm_stride, rows, k, in, table,
                                          o, lanes, batch, n, group_tiles,
                                          multi, s);
  if (k_tiles <= kMmaRegTiles)
    return launch_mma<W, kMmaRegTiles, false, TABLE>(
        bm, bm_stride, rows, k, in, table, o, lanes, batch, n, group_tiles,
        multi, s);
  return launch_mma<W, kMmaChunk, true, TABLE>(bm, bm_stride, rows, k, in,
                                               table, o, lanes, batch, n,
                                               group_tiles, multi, s);
}

template <bool TABLE>
int encode_lanes(const void* bitmats, long long bm_stride, int lanes,
                 int rows, int k, int w, const void* data,
                 const uint8_t* const* table, void* out, long long batch,
                 long long n, bool multi, void* stream) {
  if (batch < 0 || n < 0 || lanes < 0) return -1;
  int design = kMma, group_tiles = 0;
  const int rc = pick_design(rows, k, w, &design, &group_tiles);
  if (rc != 0) return rc;
  if (n % (w / 8) != 0) return -1;
  const auto* bm = static_cast<const uint8_t*>(bitmats);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (design == kBitsliced) {
    if (k <= 4)
      err = launch_bitsliced<4, TABLE>(bm, bm_stride, rows, k, in, table, o,
                                       lanes, batch, n, multi, s);
    else if (k <= 8)
      err = launch_bitsliced<8, TABLE>(bm, bm_stride, rows, k, in, table, o,
                                       lanes, batch, n, multi, s);
    else
      err = launch_bitsliced<16, TABLE>(bm, bm_stride, rows, k, in, table, o,
                                        lanes, batch, n, multi, s);
    return (int)err;
  }
  if (design == kPopcount) {
    if (w == 16)
      return (int)launch_popcount_w<16, TABLE>(bm, bm_stride, rows, k, in,
                                               table, o, lanes, batch, n,
                                               multi, s);
    return (int)launch_popcount_w<32, TABLE>(bm, bm_stride, rows, k, in,
                                             table, o, lanes, batch, n, multi,
                                             s);
  }
  if (w == 8)
    err = launch_mma_w<8, TABLE>(bm, bm_stride, rows, k, in, table, o, lanes,
                                 batch, n, group_tiles, multi, s);
  else if (w == 16)
    err = launch_mma_w<16, TABLE>(bm, bm_stride, rows, k, in, table, o,
                                  lanes, batch, n, group_tiles, multi, s);
  else
    err = launch_mma_w<32, TABLE>(bm, bm_stride, rows, k, in, table, o,
                                  lanes, batch, n, group_tiles, multi, s);
  return (int)err;
}

}  // namespace

// bitmat [rows, k*w] 0/1 uint8, data [batch, k, n] uint8, out
// [batch, rows/w, n] uint8, all contiguous on the current device. Returns
// 0, a cudaError_t code from the launch, or -1 for a geometry the kernel
// does not take. Launches on `stream` and does not synchronise.
extern "C" int gf_bitmatrix_encode(const void* bitmat, int rows, int k, int w,
                                   const void* data, void* out,
                                   long long batch, long long n,
                                   void* stream) {
  return encode_lanes<false>(bitmat, 0, 1, rows, k, w, data, nullptr, out,
                             batch, n, false, stream);
}

// A different bitmatrix per lane, in one launch: bitmats [lanes, rows,
// k*w] 0/1 uint8, data [lanes, batch, k, n] uint8, out [lanes, batch,
// rows/w, n] uint8, all contiguous on the current device. Returns as
// gf_bitmatrix_encode does.
extern "C" int gf_bitmatrix_encode_multi(const void* bitmats, int lanes,
                                         int rows, int k, int w,
                                         const void* data, void* out,
                                         long long batch, long long n,
                                         void* stream) {
  return encode_lanes<false>(bitmats, (long long)rows * k * w, lanes, rows,
                             k, w, data, nullptr, out, batch, n, true,
                             stream);
}

// The per-lane product with lane p's k data rows at the device addresses
// table[p*k ... p*k + k - 1] (uint64, each row n bytes on 16 bytes):
// bitmats [lanes, rows, k*w] 0/1 uint8, out [lanes, rows/w, n] uint8.
// Returns and counts as gf_bitmatrix_encode_multi does.
extern "C" int gf_bitmatrix_encode_multi_rows(const void* bitmats, int lanes,
                                              int rows, int k, int w,
                                              const void* table, void* out,
                                              long long n, void* stream) {
  return encode_lanes<true>(bitmats, (long long)rows * k * w, lanes, rows, k,
                            w, nullptr,
                            static_cast<const uint8_t* const*>(table), out,
                            1, n, true, stream);
}

// ---- timing only ---------------------------------------------------------

namespace {

// The tensor cores' instruction rate as the mma design issues it: each warp
// runs `iters` steps of 8 independent accumulator chains (4 N-tiles x 2
// M-tiles) on constant A and B registers. B1 false: mma.sync m16n8k32 s8
// (the design's product); true: m16n8k256 b1 with AND and POPC, the binary
// path, which computes the same GF(2) sums with 8 times the K a product.
template <bool B1>
__global__ void mma_rate_kernel(int iters, int* sink) {
  const int l = threadIdx.x % 32;
  uint32_t a[2][4];
  uint2 b[4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[mt][r] = (uint32_t)(l + mt + r) & 0x01010101u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    b[q] = make_uint2((uint32_t)(l + q) & 0x01010101u,
                      (uint32_t)(l >> q) & 0x01010101u);
  int acc[4][2][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (B1) mma_b1(acc[q][mt], a[mt], b[q]);
        else mma_s8(acc[q][mt], a[mt], b[q]);
      }
  }
  int s = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s += acc[q][mt][i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Timing only: `blocks` blocks of `threads` threads (a multiple of 32)
// each run mma_rate_kernel for `iters` steps of 8 mma.sync a warp: mode 0
// m16n8k32 s8, mode 1 m16n8k256 b1 AND-POPC; sink: blocks * threads int32.
extern "C" int gf_timing_mma_rate(int mode, int blocks, int threads,
                                  int iters, void* sink, void* stream) {
  if (blocks < 1 || threads < 32 || threads > 1024 || threads % 32 ||
      iters < 1 || mode < 0 || mode > 1)
    return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<int*>(sink);
  if (mode == 0)
    mma_rate_kernel<false><<<blocks, threads, 0, s>>>(iters, out);
  else
    mma_rate_kernel<true><<<blocks, threads, 0, s>>>(iters, out);
  return (int)cudaGetLastError();
}
