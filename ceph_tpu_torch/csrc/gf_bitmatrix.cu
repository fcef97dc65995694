// GF(2^w) element-layout encode as a GF(2) bitmatrix product, for sm_90a.
//
// Replaces the TPU kernel ceph_tpu/ops/pallas_gf.py:_encode_kernel (launched
// by matrix_encode8 through pl.pallas_call), and also covers w=16 and w=32,
// the element layout that ceph_tpu/ops/xor_mm.py:matrix_encode computes with
// XLA. One kernel serves the encode bitmatrix ([m*w, k*w]) and every decode
// bitmatrix ([(k+m)*w, k*w]) of the Reed-Solomon codecs.
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
// 6.4 GOP, 3.3 us at 1979 TOP/s, so bytes bound it. This kernel does one
// 32-bit population count per output bit per column: R per column (24 for
// the encode, 88 for a k=8,m=3 decode), plus ceil(k*w/32) AND-XORs each.
// At that count the popcount pipe, not memory, limits it; a bit-sliced XOR
// schedule, TMA loads and persistent blocks are later work.
//
// Design.
//  * The bitmatrix is packed once per block into shared memory as
//    NW = ceil(k*w/32) (rounded to a power of two) uint32 masks per row.
//  * A thread takes VEC consecutive bytes of every one of the k rows of
//    one batch lane (16-byte loads when NW <= 4, else 4-byte loads, so a
//    warp reads neighbouring addresses) and transposes them in registers
//    into the per-column vectors v.
//  * Output bit (row r, column e) = popc(XOR_q mask[r][q] & v[e][q]) & 1,
//    packed straight into the VEC output bytes of the element row and
//    written with one 16-byte (or 4-byte) store.
//  * Any N that is a multiple of w/8 is taken: the ragged edge is loaded
//    and stored byte by byte under a bounds mask. k*w <= 512 and
//    R * NW * 4 <= 48 KiB; the C entry point refuses anything else.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBits = 512;
constexpr size_t kMaxSmem = 48 * 1024;

template <int W, int NW>
struct Geometry {
  static constexpr int KMAX = NW * 32 / W;         // data rows NW words hold
  static constexpr int VEC = NW <= 4 ? 16 : 4;     // bytes per row per thread
  static constexpr int VW = VEC / 4;               // uint32 words per row
  static constexpr int COLS = VEC * 8 / W;         // element columns per thread
};

template <int W, int NW>
__global__ void __launch_bounds__(kThreads)
gf_bitmatrix_kernel(const uint8_t* __restrict__ bitmat, int rows, int k,
                    const uint8_t* __restrict__ data,
                    uint8_t* __restrict__ out, long long batch, long long n,
                    bool vec_ok) {
  using G = Geometry<W, NW>;
  extern __shared__ uint32_t masks[];  // [rows][NW]

  const int bits = k * W;
  for (int idx = threadIdx.x; idx < rows * NW; idx += blockDim.x) {
    const int r = idx / NW;
    const int q = idx - r * NW;
    const uint8_t* src = bitmat + (long long)r * bits + q * 32;
    uint32_t word = 0;
#pragma unroll 8
    for (int t = 0; t < 32; ++t)
      if (q * 32 + t < bits) word |= (uint32_t)(src[t] & 1u) << t;
    masks[idx] = word;
  }
  __syncthreads();

  const int out_rows = rows / W;
  const long long chunks = (n + G::VEC - 1) / G::VEC;
  const long long units = batch * chunks;
  const uint32_t elem_mask = W == 32 ? 0xffffffffu : (1u << W) - 1u;

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
        const uint8_t* row = data + (b * k + j) * n + off;
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
}

template <int W, int NW>
cudaError_t launch(const uint8_t* bitmat, int rows, int k,
                   const uint8_t* data, uint8_t* out, long long batch,
                   long long n, cudaStream_t stream) {
  using G = Geometry<W, NW>;
  const long long units = batch * ((n + G::VEC - 1) / G::VEC);
  if (units == 0 || rows == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
  const bool vec_ok = n % G::VEC == 0 &&
                      reinterpret_cast<uintptr_t>(data) % G::VEC == 0 &&
                      reinterpret_cast<uintptr_t>(out) % G::VEC == 0;
  const size_t smem = (size_t)rows * NW * sizeof(uint32_t);
  gf_bitmatrix_kernel<W, NW><<<(unsigned)blocks, kThreads, smem, stream>>>(
      bitmat, rows, k, data, out, batch, n, vec_ok);
  return cudaGetLastError();
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
  if (k < 1 || rows < 0 || batch < 0 || n < 0) return -1;
  if (w != 8 && w != 16 && w != 32) return -1;
  const int bits = k * w;
  if (bits > kMaxBits || rows % w != 0 || n % (w / 8) != 0) return -1;
  const int nw = bits <= 32 ? 1 : bits <= 64 ? 2 : bits <= 128 ? 4
               : bits <= 256 ? 8 : 16;
  if ((size_t)rows * nw * sizeof(uint32_t) > kMaxSmem) return -1;
  const auto* bm = static_cast<const uint8_t*>(bitmat);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define GF_CASE(W_, NW_)                                             \
  case W_ * 100 + NW_:                                               \
    err = launch<W_, NW_>(bm, rows, k, in, o, batch, n, s);          \
    break;
  switch (w * 100 + nw) {
    GF_CASE(8, 1) GF_CASE(8, 2) GF_CASE(8, 4) GF_CASE(8, 8) GF_CASE(8, 16)
    GF_CASE(16, 1) GF_CASE(16, 2) GF_CASE(16, 4) GF_CASE(16, 8) GF_CASE(16, 16)
    GF_CASE(32, 1) GF_CASE(32, 2) GF_CASE(32, 4) GF_CASE(32, 8) GF_CASE(32, 16)
    default:
      return -1;
  }
#undef GF_CASE
  return (int)err;
}
