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
// at the int8 rate of 1979 TOP/s, so bytes bound it. The kernel
// re-reads each input packet once per output row that selects it (about
// k*w/2 rows of a dense Cauchy row block); L1 and L2 serve those re-reads.
//
// Design (simple; making it fast is later work):
//  * Each block packs the bitmatrix once into shared memory as
//    ceil(k*w/32) uint32 masks per row, with the popcount design's code
//    (launch_common.cuh), beside the byte offset j*N + u*P of every input
//    packet (j, u) from the start of its superblock.
//  * A thread takes one 16-byte column of one output packet (b, i, s, t).
//    It walks the row's set bits with __ffs and XORs 16-byte __ldg loads
//    of the selected input packets, then stores 16 bytes. The threads of a
//    warp hold neighbouring columns of one packet whenever P >= 512, so
//    they walk the same mask (no divergence) and their loads coalesce.
//  * A packetsize that is not a multiple of 16, or a data or output
//    pointer that is not 16-byte aligned, takes the byte path of the same
//    kernel: one thread per byte column.
//  * A grid-stride loop with 64-bit offsets; the grid is sized from the
//    occupancy the kernel reaches, queried once per device, path and
//    shared-memory size (launch_common.cuh, shared with gf_bitmatrix.cu).

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 128;

enum Path { kVector = 0, kByte = 1 };

// Kernel launches of each path, counted where the kernel is launched.
std::atomic<long long> g_launches[2];

__host__ __device__ inline int mask_words(int cols) { return (cols + 31) / 32; }

// Offsets (one long long per input packet of a superblock), then masks.
size_t packet_smem(int rows, int cols) {
  return (size_t)cols * sizeof(long long) +
         (size_t)rows * mask_words(cols) * sizeof(uint32_t);
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

}  // namespace

// Launches of `path` (0 the 16-byte path, 1 the byte path) since the last
// reset, or -1 for another path number.
extern "C" long long gf_packet_launches(int path) {
  return path == kVector || path == kByte ? g_launches[path].load() : -1;
}

extern "C" void gf_packet_reset_launches() {
  for (auto& count : g_launches) count.store(0);
}

// bitmat [rows, k*w] 0/1 uint8, data [batch, k, n] uint8, out
// [batch, rows/w, n] uint8, all contiguous on the current device, n a
// multiple of w*packetsize. Returns 0, a cudaError_t code from a device
// query or the launch, or -1 for a geometry the kernel does not take
// (its shared memory included). Launches on `stream` and does not
// synchronise.
extern "C" int gf_packet_encode(const void* bitmat, int rows, int k, int w,
                                long long packetsize, const void* data,
                                void* out, long long batch, long long n,
                                void* stream) {
  if (rows < 0 || k < 1 || w < 2 || w > 32 || packetsize < 1 || batch < 0 ||
      n < 0 || rows % w != 0 || n % ((long long)w * packetsize) != 0)
    return -1;
  const size_t smem = packet_smem(rows, k * w);
  size_t optin = 0;
  const cudaError_t err = launch_common::smem_optin(&optin);
  if (err != cudaSuccess) return (int)err;
  if (smem > optin) return -1;
  const auto* bm = static_cast<const uint8_t*>(bitmat);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = packetsize % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (vec)
    return (int)launch<16>(bm, rows, k, w, packetsize, in, o, batch, n, smem,
                           s);
  return (int)launch<1>(bm, rows, k, w, packetsize, in, o, batch, n, smem, s);
}
