// Batched CRUSH straw2 placement: one thread maps one seed through a whole
// rule (take -> choose/chooseleaf, indep or firstn -> emit) under the jewel
// tunables, with choose_args weight sets and ids and a reweight vector.
//
// Replaces the XLA program of ceph_tpu/crush/batched.py (_straw2_choose
// :128 inside _descend :173, _make_indep :217, _make_firstn :305), which
// vectorises every retry over [B, numrep, tries, S] because a TPU has no
// cheap per-lane control flow. Here each thread runs the scalar mapper's
// loop (ceph_tpu_torch/crush/mapper_ref.py _choose_indep / _choose_firstn,
// Ceph's mapper.c:443-826) on its seed: retries cost only the seeds that
// retry, and a warp diverges only where its seeds do.
//
// Bound: integer operations. A straw2 draw is a 3-word rjenkins hash (5
// mixes of 27 ALU operations), the fixed-point log (two table loads, a
// 64-bit product) and an exact division of the log by the item's weight
// (div_exact); utils/cuda_timing.crush_bound counts them per draw, and the
// kernel counts its draws per seed when asked (`work`). Seeds and results
// are the only device-memory traffic of size.
//
// Tables: one int32 buffer laid out by ops/crush_kernel.pack_tables: the
// ln tables (RH_LH [258] and LL [256] uint64), then items [NB, S], hash ids
// [NB, S], weight sets [NB, P, S], size [NB], type [NB] and the reweight
// vector [NW]. The ln tables are staged in shared memory always (their
// indices differ per thread, which constant memory would serialise); the
// map's tables too when the whole buffer fits kSmemBudget, else they are
// read from device memory through the read-only path (kGlobal). Any bucket
// size and depth takes one of the two.
//
// Per-seed working slots (out, out2 of the C) live in `scratch`, [2, R, B]
// int32 with R = result_max, so a warp's accesses to one slot coalesce. The
// result is written as int64 [B, result_max] with CRUSH_ITEM_NONE holes.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLnWords = (258 + 256) * 2;   // the ln tables, as int32 words
constexpr int kLlAt = 258;                  // LL's first uint64
constexpr size_t kSmemBudget = 64 * 1024;   // tables staged up to this
constexpr int32_t kUndef = 0x7FFFFFFE;
constexpr int32_t kNone = 0x7FFFFFFF;
constexpr uint32_t kHashSeed = 1315423911u;
constexpr long long kS64Min = -0x7FFFFFFFFFFFFFFFLL - 1;
constexpr long long kLnOffset = 0x1000000000000LL;

enum Design { kShared = 0, kGlobal = 1, kDesigns = 2 };
std::atomic<long long> g_launches[kDesigns];

// The rule and the table geometry, by value in the kernel's parameters.
struct Plan {
  int nb, s, npos, nw, max_devices;
  int root, firstn, chooseleaf, target_type, numrep, out_size, result_max;
  int tries, recurse_tries, vary_r;
  int items_at, ids_at, wsets_at, size_at, btype_at, w_at, words;
};

// Reads table words from shared (SMEM) or device memory, one layout.
template <bool SMEM>
struct Tabs {
  const int32_t* base;
  __device__ __forceinline__ int32_t at(int i) const {
    if constexpr (SMEM) return base[i];
    else return __ldg(base + i);
  }
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b, x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c, x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// crush_ln (mapper.c:247-290): 2^44 * log2(xin + 1). The product x * RH is
// taken in uint64, which wraps by rule where the C's signed one overflows
// (xin = 0xffff); only its bits 48..55 are used, the same either way.
__device__ __forceinline__ unsigned long long crush_ln(
    const unsigned long long* ln, uint32_t xin) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    const int bits = __clz((int)(x & 0x1FFFF)) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int index1 = (int)(x >> 8) << 1;
  const unsigned long long rh = ln[index1 - 256];
  const unsigned long long lh = ln[index1 + 1 - 256];
  const int index2 = (int)((((unsigned long long)x * rh) >> 48) & 0xFF);
  return ((unsigned long long)iexpon << 44) + ((lh + ln[kLlAt + index2]) >> 4);
}

// A chosen item and the draws (items hashed) it took. Counts travel in
// return values, not through pointers or references: a local whose address
// is taken must live in memory across the 64-bit division's call.
struct Pick {
  int item;
  int draws;
};

// floor(n / d) for n < 2^49 and 0 < d < 2^32, exact and without a call.
// The compiler's 64-bit division is a subroutine behind a call, and the
// registers that call's convention saves spilled the kernel's device-memory
// design. Here a double reciprocal (the hardware estimate refined by two
// Newton steps, relative error near 2^-52) gives a quotient within one of
// the true one (n/d < 2^49), and integer steps correct it: the loops run at
// most once each, and make the result exact whatever the estimate.
__device__ __forceinline__ unsigned long long div_exact(unsigned long long n,
                                                        uint32_t d) {
  const double dd = (double)d;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(dd));
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  unsigned long long q = __double2ull_rz(__dmul_rz((double)n, r));
  long long rem = (long long)(n - q * d);
  while (rem < 0) {
    --q;
    rem += d;
  }
  while (rem >= (long long)d) {
    ++q;
    rem -= d;
  }
  return q;
}

// bucket_straw2_choose (mapper.c:322-367) of bucket index b: the hash takes
// the substituted ids, the draw divides by the position's weight-set row,
// truncating toward zero; a zero weight draws S64_MIN; the first maximum
// wins (strict >). The bucket is not empty.
template <bool SMEM>
__device__ __forceinline__ Pick straw2(Tabs<SMEM> t, const Plan& p,
                                       const unsigned long long* ln, int b,
                                       uint32_t x, uint32_t r, int pos) {
  const int size = t.at(p.size_at + b);
  const int row = b * p.s;
  const int wrow = (b * p.npos + min(pos, p.npos - 1)) * p.s;
  int high = 0, draws = 0;
  long long high_draw = 0;
  for (int i = 0; i < size; ++i) {
    const uint32_t wt = (uint32_t)t.at(p.wsets_at + wrow + i);
    long long draw = kS64Min;
    if (wt) {
      const uint32_t u =
          hash32_3(x, (uint32_t)t.at(p.ids_at + row + i), r) & 0xFFFF;
      const long long lnv = (long long)crush_ln(ln, u) - kLnOffset;
      draw = -(long long)div_exact((unsigned long long)(-lnv), wt);
      ++draws;
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return Pick{t.at(p.items_at + row + high), draws};
}

// is_out (mapper.c:407-421) of device `item`: bit 0 set when it is out,
// bit 1 when the answer took a hash.
template <bool SMEM>
__device__ __forceinline__ int out_state(Tabs<SMEM> t, const Plan& p,
                                         int item, uint32_t x) {
  if (item >= p.nw) return 1;
  const uint32_t w = (uint32_t)t.at(p.w_at + item);
  if (w >= 0x10000) return 0;
  if (w == 0) return 1;
  return 2 | (int)((hash32_2(x, (uint32_t)item) & 0xFFFF) >= w);
}

enum Walk { kHit, kRetry, kPerm };

// The end of a walk: how it ended, the item chosen (kHit), the draws.
struct Step {
  Walk walk;
  int item;
  int draws;
};

// Walks from bucket index b until an item of `type` is chosen.
// kRetry: an empty bucket or a root that is no bucket; kPerm: an item that
// is no device or bucket, or a device of the wrong type (the failures
// choose_indep makes CRUSH_ITEM_NONE, mapper.c:724-751). The map is
// acyclic (compile_map checked), so a walk visits at most nb buckets; the
// bound only keeps a corrupt table from hanging the card.
template <bool SMEM>
__device__ __forceinline__ Step descend(Tabs<SMEM> t, const Plan& p,
                                        const unsigned long long* ln, int b,
                                        uint32_t x, uint32_t r, int type,
                                        int pos) {
  int draws = 0;
  if (b < 0 || b >= p.nb) return Step{kRetry, 0, 0};
  for (int level = 0; level < p.nb; ++level) {
    if (t.at(p.size_at + b) == 0) return Step{kRetry, 0, draws};
    const Pick pick = straw2(t, p, ln, b, x, r, pos);
    const int it = pick.item;
    draws += pick.draws;
    if (it >= p.max_devices || (it < 0 && -1 - it >= p.nb))
      return Step{kPerm, 0, draws};
    const int itype = it < 0 ? t.at(p.btype_at + (-1 - it)) : 0;
    if (itype == type) return Step{kHit, it, draws};
    if (it >= 0) return Step{kPerm, 0, draws};
    b = -1 - it;
  }
  return Step{kRetry, 0, draws};
}

// One seed's working slots: out (o) and out2 (o2), slot i at i * n.
struct Slots {
  int32_t* o;
  int32_t* o2;
  long long n;
  __device__ __forceinline__ int32_t& out(int i) const { return o[i * n]; }
  __device__ __forceinline__ int32_t& out2(int i) const { return o2[i * n]; }
};

// A seed's slots filled and its work: draws and is_out hashes.
struct Done {
  int filled;
  int draws;
  int hashes;
};

// crush_choose_indep from the rule's root (mapper.c:638-826): positional
// slots retried in rounds, r = rep + numrep * ftotal; chooseleaf recurses
// with left = 1 at outpos rep, r = rep + parent_r + numrep * ftotal_inner
// and weight-set position rep (the top level uses position 0).
template <bool SMEM>
__device__ __forceinline__ Done map_indep(Tabs<SMEM> t, const Plan& p,
                                          const unsigned long long* ln,
                                          uint32_t x, Slots sl) {
  const int n = p.out_size;
  int draws = 0, hashes = 0;
  for (int rep = 0; rep < n; ++rep) sl.out(rep) = sl.out2(rep) = kUndef;
  int left = n;
  for (int ftotal = 0; left > 0 && ftotal < p.tries; ++ftotal) {
    for (int rep = 0; rep < n; ++rep) {
      if (sl.out(rep) != kUndef) continue;
      const uint32_t r = (uint32_t)rep + (uint32_t)p.numrep * ftotal;
      const Step st = descend(t, p, ln, -1 - p.root, x, r, p.target_type, 0);
      draws += st.draws;
      if (st.walk == kRetry) continue;
      if (st.walk == kPerm) {
        sl.out(rep) = sl.out2(rep) = kNone;
        --left;
        continue;
      }
      const int item = st.item;
      bool collide = false;
      for (int i = 0; i < n; ++i) collide |= sl.out(i) == item;
      if (collide) continue;
      if (p.chooseleaf) {
        int leaf = item;
        if (item < 0) {
          leaf = kUndef;
          for (int f2 = 0; f2 < p.recurse_tries; ++f2) {
            const Step s2 =
                descend(t, p, ln, -1 - item, x,
                        (uint32_t)rep + r + (uint32_t)p.numrep * f2, 0, rep);
            draws += s2.draws;
            if (s2.walk == kRetry) continue;
            if (s2.walk == kPerm) {
              leaf = kNone;
              break;
            }
            const int o = out_state(t, p, s2.item, x);
            hashes += o >> 1;
            if (o & 1) continue;
            leaf = s2.item;
            break;
          }
          if (leaf == kUndef) leaf = kNone;
        }
        sl.out2(rep) = leaf;
        if (leaf == kNone) continue;
      }
      // itemtype == target_type here: is_out applies to devices only
      if (p.target_type == 0) {
        const int o = out_state(t, p, item, x);
        hashes += o >> 1;
        if (o & 1) continue;
      }
      sl.out(rep) = item;
      --left;
    }
  }
  return Done{n, draws, hashes};
}

// crush_choose_firstn from the rule's root under the jewel tunables
// (mapper.c:443-631 with local tries 0, stable 1): each rep retries with
// r = rep + ftotal until it places an item, fails `tries` times or meets a
// permanent failure (skip_rep); the weight-set position is the live outpos.
// chooseleaf recurses with numrep 1, parent_r = r >> (vary_r - 1) and
// recurse_tries tries, against the leaves placed so far.
template <bool SMEM>
__device__ __forceinline__ Done map_firstn(Tabs<SMEM> t, const Plan& p,
                                           const unsigned long long* ln,
                                           uint32_t x, Slots sl) {
  int outpos = 0, draws = 0, hashes = 0;
  for (int rep = 0; rep < p.numrep && outpos < p.result_max; ++rep) {
    for (int ftotal = 0; ftotal < p.tries; ++ftotal) {
      const uint32_t r = (uint32_t)rep + (uint32_t)ftotal;
      const Step st =
          descend(t, p, ln, -1 - p.root, x, r, p.target_type, outpos);
      draws += st.draws;
      if (st.walk == kPerm) break;            // skip_rep
      if (st.walk == kRetry) continue;        // reject
      const int item = st.item;
      bool collide = false;
      for (int i = 0; i < outpos; ++i) collide |= sl.out(i) == item;
      if (collide) continue;
      if (p.chooseleaf) {
        if (item < 0) {
          const uint32_t sub_r = p.vary_r ? r >> (p.vary_r - 1) : 0;
          bool got = false;
          for (int f2 = 0; f2 < p.recurse_tries; ++f2) {
            const Step s2 = descend(t, p, ln, -1 - item, x,
                                    sub_r + (uint32_t)f2, 0, outpos);
            draws += s2.draws;
            if (s2.walk == kPerm) break;      // the inner skip_rep
            if (s2.walk == kRetry) continue;
            bool c2 = false;
            for (int i = 0; i < outpos; ++i) c2 |= sl.out2(i) == s2.item;
            if (c2) continue;
            const int o = out_state(t, p, s2.item, x);
            hashes += o >> 1;
            if (o & 1) continue;
            sl.out2(outpos) = s2.item;
            got = true;
            break;
          }
          if (!got) continue;                 // reject
        } else {
          sl.out2(outpos) = item;
        }
      }
      if (p.target_type == 0) {
        const int o = out_state(t, p, item, x);
        hashes += o >> 1;
        if (o & 1) continue;
      }
      sl.out(outpos++) = item;
      break;
    }
  }
  return Done{outpos, draws, hashes};
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
    crush_straw2_kernel(const int32_t* __restrict__ tables,
                        const __grid_constant__ Plan p,
                        const long long* __restrict__ xs, long long n,
                        long long* __restrict__ out,
                        int32_t* __restrict__ scratch,
                        int* __restrict__ work) {
  extern __shared__ __align__(16) int32_t sm[];
  const int staged = SMEM ? kLnWords + p.words : kLnWords;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) sm[i] = tables[i];
  __syncthreads();
  const unsigned long long* ln =
      reinterpret_cast<const unsigned long long*>(sm);
  Tabs<SMEM> t;
  if constexpr (SMEM) t.base = sm + kLnWords;
  else t.base = tables + kLnWords;

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long rn = (long long)p.result_max * n;
  for (long long seed = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       seed < n; seed += stride) {
    const uint32_t x = (uint32_t)xs[seed];
    const Slots sl{scratch + seed, scratch + rn + seed, n};
    const Done d = p.firstn ? map_firstn(t, p, ln, x, sl)
                            : map_indep(t, p, ln, x, sl);
    long long* row = out + seed * p.result_max;
    for (int i = 0; i < p.result_max; ++i) {
      int32_t v = kNone;
      if (i < d.filled) {
        v = p.chooseleaf ? sl.out2(i) : sl.out(i);
        if (!p.firstn && sl.out(i) == kUndef) v = kNone;
      }
      row[i] = v;
    }
    if (work != nullptr) {
      work[2 * seed] = d.draws;
      work[2 * seed + 1] = d.hashes;
    }
  }
}

template <bool SMEM>
cudaError_t launch(const int32_t* tables, const Plan& p, size_t smem,
                   const long long* xs, long long n, long long* out,
                   int32_t* scratch, int* work, cudaStream_t stream) {
  auto kernel = crush_straw2_kernel<SMEM>;
  unsigned blocks = 0;
  cudaError_t err =
      launch_common::grid_blocks(kernel, kThreads, smem, n, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(tables, p, xs, n, out, scratch,
                                             work);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[SMEM ? kShared : kGlobal].fetch_add(1);
  return err;
}

size_t staged_bytes(int words) {
  return (size_t)(kLnWords + words) * sizeof(int32_t);
}

}  // namespace

// geo: nb, s, npos, nw, max_devices; plan: root, firstn, chooseleaf,
// target_type, numrep, out_size, result_max, tries, recurse_tries, vary_r.
// The table offsets follow from geo as ops/crush_kernel.pack_tables lays
// them out.
static bool make_plan(const int* geo, const int* rule, Plan* p) {
  *p = Plan{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  rule[0],
            rule[1], rule[2], rule[3], rule[4], rule[5], rule[6],
            rule[7], rule[8], rule[9]};
  if (p->nb < 1 || p->s < 1 || p->npos < 1 || p->nw < 1 ||
      p->result_max < 1 || p->out_size > p->result_max)
    return false;
  const long long cells = (long long)p->nb * p->s;
  const long long words = cells * (2 + p->npos) + 2LL * p->nb + p->nw;
  if (words + kLnWords > (1LL << 31) - 1) return false;
  p->items_at = 0;
  p->ids_at = (int)cells;
  p->wsets_at = (int)(2 * cells);
  p->size_at = (int)(cells * (2 + p->npos));
  p->btype_at = p->size_at + p->nb;
  p->w_at = p->btype_at + p->nb;
  p->words = (int)words;
  return true;
}

// The design a map of this geometry takes: 0 tables staged in shared
// memory, 1 tables read from device memory; -1 a geometry refused.
extern "C" int crush_straw2_design(const int* geo, const int* rule) {
  Plan p;
  if (!make_plan(geo, rule, &p)) return -1;
  return staged_bytes(p.words) <= kSmemBudget ? kShared : kGlobal;
}

// Maps seeds xs [n] (int64, hashed as uint32) into out [n, result_max]
// int64; scratch holds 2 * result_max * n int32; work, when not null, gets
// each seed's straw2 draws (items hashed) and is_out hashes ([n, 2]
// int32). Returns
// 0 or a cudaError_t, -1 for a refused geometry.
extern "C" int crush_straw2_map(const int32_t* tables, const int* geo,
                                const int* rule, const long long* xs,
                                long long n, long long* out, int32_t* scratch,
                                int* work, void* stream) {
  Plan p;
  if (!make_plan(geo, rule, &p)) return -1;
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged_bytes(p.words) <= kSmemBudget)
    return launch<true>(tables, p, staged_bytes(p.words), xs, n, out,
                        scratch, work, s);
  return launch<false>(tables, p, staged_bytes(0), xs, n, out, scratch, work,
                       s);
}

extern "C" long long crush_straw2_launches(int design) {
  return design >= 0 && design < kDesigns ? g_launches[design].load() : -1;
}

extern "C" void crush_straw2_reset_launches() {
  for (auto& c : g_launches) c.store(0);
}
