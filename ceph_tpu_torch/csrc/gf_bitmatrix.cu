// GF(2^w) element-layout encode as a GF(2) bitmatrix product, for sm_90a.
//
// Replaces the TPU kernel ceph_tpu/ops/pallas_gf.py:_encode_kernel (launched
// by matrix_encode8 through pl.pallas_call), and also covers w=16 and w=32,
// the element layout that ceph_tpu/ops/xor_mm.py:matrix_encode computes with
// XLA. One entry point serves the encode bitmatrix ([m*w, k*w]) and every
// decode bitmatrix ([(k+m)*w, k*w]) of the Reed-Solomon codecs.
//
//   out[b, i, e] = element whose bit t is
//                  XOR_c bitmat[i*w + t, c] & bit c of v(b, e)
//
// where v(b, e) is the k*w-bit little-endian concatenation of the k input
// elements in column e of batch lane b: bit j*w + t of v is bit t of
// element e of data row j. That is row j*w + t of unpack_element_bits,
// the layout contract of ceph_tpu/ops/xor_mm.py and pallas_gf.py.
//
// Bound. The function reads each input byte once and writes each output
// byte once. At the bench shape (B=16, k=8, m=3, N=131072, w=8) that is
// 16 MiB read + 6 MiB written = 23.07 MB, about 6.9 us at the H100 SXM's
// 3.35 TB/s; counted as int8 multiply-adds ([24, 64] @ [64, 2^21]) it is
// 6.4 GOP, 3.3 us at 1979 TOP/s, so bytes bound it. Neither design below
// reaches memory's limit: on an H100 at that shape the bit-sliced kernel
// runs at about 27% of its bound on the encode, and a single batch lane
// (32 blocks) already takes about half the time of sixteen, so the
// latency of one thread's 32 columns, not the card's throughput, sets
// it (PERF.md).
//
// Two designs; the C entry point picks one from the geometry alone.
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
//    columns, against 32 popcounts in the other design; an identity
//    block is 8 XORs of plane (j, t). The E words are warp-uniform
//    broadcast loads, 16 bytes at a time; the mask tests are warp-uniform
//    too, so skipping a zero block (most of a decode bitmatrix) costs no
//    divergence.
//  * The 8 out planes go back to 32 bytes through the same two transposes
//    and two 16-byte streaming stores.
//  * The grid is sized from the occupancy the kernel reaches; each thread
//    issues its first loads before the block expands the bitmatrix.
//
// Popcount (gf_bitmatrix_kernel), for every other geometry (w = 16, 32,
// or k*w > 128):
//  * The bitmatrix is packed once per block into shared memory as
//    NW = ceil(k*w/32) (rounded to a power of two) uint32 masks per row.
//  * A thread takes VEC consecutive bytes of every one of the k rows of
//    one batch lane (16-byte loads when NW <= 4, else 4-byte loads, so a
//    warp reads neighbouring addresses) and transposes them in registers
//    into the per-column vectors v.
//  * Output bit (row r, column e) = popc(XOR_q mask[r][q] & v[e][q]) & 1,
//    packed straight into the VEC output bytes of the element row and
//    written with one 16-byte (or 4-byte) store. That is one population
//    count per output bit per column, and the popcount pipe limits it.
//
// Both take any N that is a multiple of w/8: the ragged edge (and any
// pointer not 16-byte aligned) is loaded and stored byte by byte under a
// bounds mask, bytes past N reading as zero. k*w <= 512; the popcount
// design needs R * NW * 4 bytes of masks within the card's opt-in shared
// memory (232,448 bytes on an H100: 3,632 rows at 16 words), raising its
// kernel's dynamic limit past 48 KiB through launch_common as the
// bit-sliced design does, and the entry point refuses a geometry that
// neither design takes. Wider products (the MSR code past k = 9) are split
// into column blocks by the caller (ops/xor_mm.py matrix_encode).
//
// Per-lane bitmatrices (gf_bitmatrix_encode_multi). Replaces the XLA
// program of ceph_tpu/ops/xor_mm.py:91 (matrix_encode_multi, the vmap of
// matrix_encode with a different bitmatrix per lane), which the HBM chunk
// tier's reconstruct_batch runs with one decode bitmatrix per object.
// bitmats [P, R, k*w], data [P, L, k, N], out [P, L, R/w, N], in ONE
// launch whatever P is: both kernels loop over lanes lane = blockIdx.y,
// blockIdx.y + gridDim.y, ... (gridDim.y <= 65535), stage that lane's
// bitmatrix in shared memory (masks, or the 8x8 expansion) and stride
// over its L*N/VEC units with the blockIdx.x threads, exactly as the
// single-matrix launch does over its batch; a block synchronises before
// it stages the next lane's bitmatrix. The single-matrix entry point is
// the same kernel with P = 1 and a bitmatrix stride of 0. The grid takes
// the blocks the card holds at once (as a single matrix does), split
// over min(P, 65535) rows of blocks. Bound: gf_bound summed over the
// lanes (utils/cuda_timing.py gf_multi_bound).
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
constexpr int kMaxBits = 512;

enum Design { kPopcount = 0, kBitsliced = 1 };

// Kernel launches of each design, counted where the kernel is launched:
// [0] from the single-matrix entry point, [1] from the per-lane one.
std::atomic<long long> g_launches[2][2];

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

// ---- popcount design ------------------------------------------------------

template <int W, int NW>
struct Geometry {
  static constexpr int KMAX = NW * 32 / W;         // data rows NW words hold
  static constexpr int VEC = NW <= 4 ? 16 : 4;     // bytes per row per thread
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
            if constexpr (G::VEC == 16) {
              const uint4 x = __ldcs(reinterpret_cast<const uint4*>(row));
              d[0] = x.x;
              d[1] = x.y;
              d[2] = x.z;
              d[3] = x.w;
            } else {
              d[0] = __ldcs(reinterpret_cast<const unsigned int*>(row));
            }
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
          if constexpr (G::VEC == 16) {
            __stcs(reinterpret_cast<uint4*>(orow), make_uint4(o[0], o[1], o[2], o[3]));
          } else {
            __stcs(reinterpret_cast<unsigned int*>(orow), o[0]);
          }
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
  // masks past 48 KiB (an MSR decode's [840, 448] takes 53,760 bytes):
  // the kernel's dynamic limit is raised first, up to the card's opt-in
  int per_sm = 0;
  err = launch_common::resident_blocks(kernel, kThreads, dev, smem, &per_sm);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      bitmat, bm_stride, rows, k, data, table, out, lanes, batch, n, vec_ok);
  return count_launch(kPopcount, multi);
}

int mask_words(int bits) {
  return bits <= 32 ? 1 : bits <= 64 ? 2 : bits <= 128 ? 4 : bits <= 256 ? 8
                                                                          : 16;
}

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

// ---- design choice ---------------------------------------------------------

// Validates the geometry and picks its design: bit-sliced for w = 8 with
// k*8 <= 128 when its shared memory fits the card's per-block opt-in
// limit, popcount otherwise, whose masks must fit the same limit. Returns
// 0 (design set), -1 for a geometry neither design takes, or the
// cudaError_t of a failed device query.
int pick_design(int rows, int k, int w, int* design) {
  if (k < 1 || rows < 0) return -1;
  if (w != 8 && w != 16 && w != 32) return -1;
  const int bits = k * w;
  if (bits > kMaxBits || rows % w != 0) return -1;
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
  if ((size_t)rows * mask_words(bits) * sizeof(uint32_t) > optin) return -1;
  *design = kPopcount;
  return 0;
}

}  // namespace

// The design gf_bitmatrix_encode takes for this geometry on the current
// device: 1 bit-sliced, 0 popcount, -1 a geometry it refuses, -2 a failed
// device query.
extern "C" int gf_bitmatrix_design(int rows, int k, int w) {
  int design = kPopcount;
  const int rc = pick_design(rows, k, w, &design);
  return rc == 0 ? design : rc < 0 ? -1 : -2;
}

// Launches of `design` (0 popcount, 1 bit-sliced) since the last reset:
// from gf_bitmatrix_encode with multi = 0, from gf_bitmatrix_encode_multi
// with multi = 1.
extern "C" long long gf_bitmatrix_launches(int design, int multi) {
  return (design == kPopcount || design == kBitsliced) &&
                 (multi == 0 || multi == 1)
             ? g_launches[multi][design].load()
             : -1;
}

extern "C" void gf_bitmatrix_reset_launches() {
  for (auto& by_design : g_launches)
    for (auto& count : by_design) count.store(0);
}

namespace {

template <bool TABLE>
int encode_lanes(const void* bitmats, long long bm_stride, int lanes,
                 int rows, int k, int w, const void* data,
                 const uint8_t* const* table, void* out, long long batch,
                 long long n, bool multi, void* stream) {
  if (batch < 0 || n < 0 || lanes < 0) return -1;
  int design = kPopcount;
  const int rc = pick_design(rows, k, w, &design);
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
#define GF_CASE(W_, NW_)                                                  \
  case W_ * 100 + NW_:                                                    \
    err = launch_popcount<W_, NW_, TABLE>(bm, bm_stride, rows, k, in,     \
                                          table, o, lanes, batch, n,      \
                                          multi, s);                      \
    break;
  switch (w * 100 + mask_words(k * w)) {
    GF_CASE(8, 1) GF_CASE(8, 2) GF_CASE(8, 4) GF_CASE(8, 8) GF_CASE(8, 16)
    GF_CASE(16, 1) GF_CASE(16, 2) GF_CASE(16, 4) GF_CASE(16, 8) GF_CASE(16, 16)
    GF_CASE(32, 1) GF_CASE(32, 2) GF_CASE(32, 4) GF_CASE(32, 8) GF_CASE(32, 16)
    default:
      return -1;
  }
#undef GF_CASE
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
