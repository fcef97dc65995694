// Batched CRUSH straw2 placement: a group of G lanes maps one seed through a
// whole rule (take -> choose/chooseleaf, indep or firstn -> emit) under the
// jewel tunables, with choose_args weight sets and ids and a reweight
// vector.
//
// Replaces the XLA program of ceph_tpu/crush/batched.py (_straw2_choose
// :128 inside _descend :173, _make_indep :217, _make_firstn :305), which
// vectorises every retry over [B, numrep, tries, S] because a TPU has no
// cheap per-lane control flow. Here a seed runs the scalar mapper's loop
// (ceph_tpu_torch/crush/mapper_ref.py _choose_indep / _choose_firstn,
// Ceph's mapper.c:443-826): retries cost only the seeds that retry.
//
// Bound: integer operations. A straw2 draw is a 3-word rjenkins hash (5
// mixes of 27 ALU operations), the fixed-point log (two table loads, a
// 64-bit product) and an exact division of the log by the item's weight;
// utils/cuda_timing.crush_bound counts them per draw, and the kernel
// counts its draws per seed when asked (`work`). Seeds and results are the
// only device-memory traffic of size.
//
// Design (measured in PERF.md):
//  * A group of G lanes a seed. In a bucket, lane l draws items l, l + G,
//    ... (a larger bucket loops), and the group takes the maximum by
//    (draw, lowest index) with __shfl_xor_sync: C's strict > in item
//    order, so the first maximum wins, and item 0 when every draw is
//    S64_MIN (idle lanes offer S64_MIN at an index past every item). Every
//    other step of the seed (retries, collisions, is_out, the weight-set
//    position, vary_r) runs the same on each lane of the group, so a group
//    never diverges and a seed's chain of draws is split G ways. G trades
//    that split against the bookkeeping that every lane repeats and the
//    lanes a small bucket leaves idle: it is the smallest power of two
//    whose square holds the largest bucket (4 for buckets of 16), doubled
//    once where the sweep's seeds would leave the card short of 16 warps
//    an SM (8 at 8,192 and 16,384 seeds, 4 from 32,768, on the phase-9
//    maps), and widened up to 32 where n * G threads stay within 8 warps
//    an SM (16 at 2,048 seeds, 32 at 1,024): a sweep that small is
//    latency, and a warp of one seed does not diverge (make_plan). One
//    thread a seed left half the SMs idle at 8,192 seeds, with 46% of its
//    lanes active at a draw.
//  * The division by the weight is a multiply-high by the weight's
//    reciprocal m = floor((2^64 - 1) / d), made with the tables
//    (ops/crush_kernel.pack_tables), and one correction: the numerator is
//    at most 2^48, so the estimate is q or q - 1 (the CPU model in
//    tests/test_torch_crush_model.py holds it to n // d).
//  * A seed's working slots (out, out2 of the C) live in shared memory, two
//    rows of out_size words a group; G doubles while a block's slots
//    exceed kSlotBudget. Past that (out_size above 1024 at G = 32) they
//    live in device memory, two rows a seed of a scratch the wrapper
//    allocates. Every lane of a group writes each slot (the same value),
//    so a lane reads only what it wrote; a collision test splits the slots
//    over the group's lanes and votes.
//
// Tables: one int32 buffer laid out by ops/crush_kernel.pack_tables: the
// ln tables (RH_LH [258] and LL [256] uint64), then items [NB, S], hash ids
// [NB, S], weight sets [NB, P, S], size [NB], type [NB], the reweight
// vector [NW] and, from an even word, the weight sets' reciprocals
// [NB, P, S] uint64. The ln tables are staged in shared memory always
// (their indices differ per thread, which constant memory would
// serialise); the map's tables too when the whole buffer fits
// kSmemBudget, else they are read from device memory through the
// read-only path (kGlobal). Any bucket size and depth takes one of the
// two. The result is written as int64 [B, result_max] with
// CRUSH_ITEM_NONE holes.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLnWords = (258 + 256) * 2;   // the ln tables, as int32 words
constexpr int kLlAt = 258;                  // LL's first uint64
constexpr size_t kSmemBudget = 64 * 1024;   // tables staged up to this
constexpr size_t kSlotBudget = 32 * 1024;   // a block's slots, at most
constexpr int kFillWarps = 16;              // warps an SM that fill the card
constexpr int kWideWarps = 8;               // warps an SM up to which G widens
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
  int items_at, ids_at, wsets_at, size_at, btype_at, w_at, recip_at, words;
  int group, group_log;   // G, lanes a seed, and log2(G)
  int slots_global;       // the slots in the wrapper's scratch
};

// Reads table words from shared (SMEM) or device memory, one layout.
template <bool SMEM>
struct Tabs {
  const int32_t* base;
  __device__ __forceinline__ int32_t at(int i) const {
    if constexpr (SMEM) return base[i];
    else return __ldg(base + i);
  }
  // the uint64 at words i, i + 1 (i even)
  __device__ __forceinline__ unsigned long long at64(int i) const {
    const auto* q = reinterpret_cast<const unsigned long long*>(base + i);
    if constexpr (SMEM) return *q;
    else return __ldg(q);
  }
};

// A seed's lanes: this lane's index in the group, G, the group's lanes in
// the warp.
struct Group {
  int lane;
  int size;
  unsigned mask;
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

// A chosen item and the draws (items hashed) this lane took.
struct Pick {
  int item;
  int draws;
};

// The clock split of a profiled launch (PROF): per warp, in shared
// memory, the draw steps it issued (a step is one issue of a draw by the
// lanes that run it together) and the lanes active at those steps.
template <bool PROF>
struct Prof {
  unsigned* steps;
  unsigned* lanes;
};

template <bool PROF>
__device__ __forceinline__ void count_draw(Prof<PROF> pf) {
  if constexpr (PROF) {
    const unsigned am = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(am) - 1) {
      atomicAdd(pf.steps + threadIdx.x / 32, 1u);
      atomicAdd(pf.lanes + threadIdx.x / 32, (unsigned)__popc(am));
    }
  }
}

// floor(n / d) for n <= 2^48 and 0 < d < 2^32, given m = floor((2^64 - 1)
// / d): m * d lies in (2^64 - 1 - d, 2^64 - 1], so n * m / 2^64 lies
// within n * (d + 1) / (d * 2^64) < 2^-15 below n / d, and the high word
// of the product is q or q - 1; one compare corrects it. A weight of 1
// (m = 2^64 - 1) estimates n - 1 for every n > 0 and is corrected.
__device__ __forceinline__ unsigned long long div_recip(unsigned long long n,
                                                        unsigned long long m,
                                                        uint32_t d) {
  unsigned long long q = __umul64hi(n, m);
  if (n - q * d >= d) ++q;
  return q;
}

// bucket_straw2_choose (mapper.c:322-367) of bucket index b, by a group: the
// hash takes the substituted ids, the draw divides by the position's
// weight-set row, truncating toward zero; a zero weight draws S64_MIN; the
// first maximum wins (strict >). Every lane returns the group's choice.
// The bucket is not empty.
template <bool SMEM, bool PROF>
__device__ __forceinline__ Pick straw2(Tabs<SMEM> t, const Plan& p,
                                       const unsigned long long* ln,
                                       Group g, Prof<PROF> pf, int b,
                                       uint32_t x, uint32_t r, int pos) {
  const int size = t.at(p.size_at + b);
  const int row = b * p.s;
  const int cell = (b * p.npos + min(pos, p.npos - 1)) * p.s;
  int high = INT_MAX, draws = 0;
  long long high_draw = kS64Min;
  for (int i = g.lane; i < size; i += g.size) {
    const uint32_t wt = (uint32_t)t.at(p.wsets_at + cell + i);
    long long draw = kS64Min;
    if (wt) {
      count_draw(pf);
      const uint32_t u =
          hash32_3(x, (uint32_t)t.at(p.ids_at + row + i), r) & 0xFFFF;
      const long long lnv = (long long)crush_ln(ln, u) - kLnOffset;
      draw = -(long long)div_recip((unsigned long long)(-lnv),
                                   t.at64(p.recip_at + 2 * (cell + i)), wt);
      ++draws;
    }
    if (high == INT_MAX || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  for (int off = g.size >> 1; off > 0; off >>= 1) {
    const long long od = __shfl_xor_sync(g.mask, high_draw, off);
    const int oi = __shfl_xor_sync(g.mask, high, off);
    if (od > high_draw || (od == high_draw && oi < high)) {
      high = oi;
      high_draw = od;
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
template <bool SMEM, bool PROF>
__device__ __forceinline__ Step descend(Tabs<SMEM> t, const Plan& p,
                                        const unsigned long long* ln,
                                        Group g, Prof<PROF> pf, int b,
                                        uint32_t x, uint32_t r, int type,
                                        int pos) {
  int draws = 0;
  if (b < 0 || b >= p.nb) return Step{kRetry, 0, 0};
  for (int level = 0; level < p.nb; ++level) {
    if (t.at(p.size_at + b) == 0) return Step{kRetry, 0, draws};
    const Pick pick = straw2(t, p, ln, g, pf, b, x, r, pos);
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

// One seed's working slots, in shared or device memory: out (o) and out2
// (o2). Every lane of the group writes each slot it sets, with the same
// value.
struct Slots {
  int32_t* o;
  int32_t* o2;
  __device__ __forceinline__ int32_t& out(int i) const { return o[i]; }
  __device__ __forceinline__ int32_t& out2(int i) const { return o2[i]; }
};

// Whether any of slots [0, count) of `slots` holds item: the group's lanes
// test every G-th slot each and vote.
__device__ __forceinline__ bool any_slot(Group g, const int32_t* slots,
                                         int count, int item) {
  bool hit = false;
  for (int i = g.lane; i < count; i += g.size) hit |= slots[i] == item;
  return __any_sync(g.mask, hit);
}

// A seed's slots filled and this lane's work: draws and is_out hashes
// (the same on every lane).
struct Done {
  int filled;
  int draws;
  int hashes;
};

// crush_choose_indep from the rule's root (mapper.c:638-826): positional
// slots retried in rounds, r = rep + numrep * ftotal; chooseleaf recurses
// with left = 1 at outpos rep, r = rep + parent_r + numrep * ftotal_inner
// and weight-set position rep (the top level uses position 0).
template <bool SMEM, bool PROF>
__device__ __forceinline__ Done map_indep(Tabs<SMEM> t, const Plan& p,
                                          const unsigned long long* ln,
                                          Group g, Prof<PROF> pf,
                                          uint32_t x, Slots sl) {
  const int n = p.out_size;
  int draws = 0, hashes = 0;
  for (int rep = 0; rep < n; ++rep) sl.out(rep) = sl.out2(rep) = kUndef;
  int left = n;
  for (int ftotal = 0; left > 0 && ftotal < p.tries; ++ftotal) {
    for (int rep = 0; rep < n; ++rep) {
      if (sl.out(rep) != kUndef) continue;
      const uint32_t r = (uint32_t)rep + (uint32_t)p.numrep * ftotal;
      const Step st =
          descend(t, p, ln, g, pf, -1 - p.root, x, r, p.target_type, 0);
      draws += st.draws;
      if (st.walk == kRetry) continue;
      if (st.walk == kPerm) {
        sl.out(rep) = sl.out2(rep) = kNone;
        --left;
        continue;
      }
      const int item = st.item;
      if (any_slot(g, sl.o, n, item)) continue;
      if (p.chooseleaf) {
        int leaf = item;
        if (item < 0) {
          leaf = kUndef;
          for (int f2 = 0; f2 < p.recurse_tries; ++f2) {
            const Step s2 =
                descend(t, p, ln, g, pf, -1 - item, x,
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
template <bool SMEM, bool PROF>
__device__ __forceinline__ Done map_firstn(Tabs<SMEM> t, const Plan& p,
                                           const unsigned long long* ln,
                                           Group g, Prof<PROF> pf,
                                           uint32_t x, Slots sl) {
  int outpos = 0, draws = 0, hashes = 0;
  for (int rep = 0; rep < p.numrep && outpos < p.result_max; ++rep) {
    for (int ftotal = 0; ftotal < p.tries; ++ftotal) {
      const uint32_t r = (uint32_t)rep + (uint32_t)ftotal;
      const Step st =
          descend(t, p, ln, g, pf, -1 - p.root, x, r, p.target_type, outpos);
      draws += st.draws;
      if (st.walk == kPerm) break;            // skip_rep
      if (st.walk == kRetry) continue;        // reject
      const int item = st.item;
      if (any_slot(g, sl.o, outpos, item)) continue;
      if (p.chooseleaf) {
        if (item < 0) {
          const uint32_t sub_r = p.vary_r ? r >> (p.vary_r - 1) : 0;
          bool got = false;
          for (int f2 = 0; f2 < p.recurse_tries; ++f2) {
            const Step s2 = descend(t, p, ln, g, pf, -1 - item, x,
                                    sub_r + (uint32_t)f2, 0, outpos);
            draws += s2.draws;
            if (s2.walk == kPerm) break;      // the inner skip_rep
            if (s2.walk == kRetry) continue;
            if (any_slot(g, sl.o2, outpos, s2.item)) continue;
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

// At least 4 blocks an SM, so at most 128 registers a thread: without a
// minimum, ptxas held the device-memory instantiations at 40-48 registers
// and spilled.
template <bool SMEM, bool PROF>
__global__ void __launch_bounds__(kThreads, 4)
    crush_straw2_kernel(const int32_t* __restrict__ tables,
                        const __grid_constant__ Plan p,
                        const long long* __restrict__ xs, long long n,
                        long long* __restrict__ out,
                        int* __restrict__ work,
                        long long* __restrict__ clk,
                        int32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ unsigned prof_steps[PROF ? kThreads / 32 : 1];
  __shared__ unsigned prof_lanes[PROF ? kThreads / 32 : 1];
  const int staged = SMEM ? kLnWords + p.words : kLnWords;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) sm[i] = tables[i];
  if constexpr (PROF) {
    if (threadIdx.x < kThreads / 32)
      prof_steps[threadIdx.x] = prof_lanes[threadIdx.x] = 0;
  }
  __syncthreads();
  const unsigned long long* ln =
      reinterpret_cast<const unsigned long long*>(sm);
  Tabs<SMEM> t;
  if constexpr (SMEM) t.base = sm + kLnWords;
  else t.base = tables + kLnWords;
  const Prof<PROF> pf{prof_steps, prof_lanes};
  const long long t0 = PROF ? clock64() : 0;

  const int G = p.group;
  const int warp_lane = threadIdx.x & 31;
  const Group g{warp_lane & (G - 1), G,
                (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u)
                    << (warp_lane & ~(G - 1))};
  const int per_block = kThreads >> p.group_log;   // seeds a block holds
  const int in_block = threadIdx.x >> p.group_log;
  int32_t* const shared_slots = sm + staged + in_block * 2 * p.out_size;
  const long long stride = (long long)gridDim.x * per_block;
  for (long long seed = (long long)blockIdx.x * per_block + in_block;
       seed < n; seed += stride) {
    int32_t* const slots =
        p.slots_global ? scratch + seed * 2 * p.out_size : shared_slots;
    const Slots sl{slots, slots + p.out_size};
    const uint32_t x = (uint32_t)xs[seed];
    const Done d = p.firstn ? map_firstn(t, p, ln, g, pf, x, sl)
                            : map_indep(t, p, ln, g, pf, x, sl);
    long long* row = out + seed * p.result_max;
    for (int i = g.lane; i < p.result_max; i += G) {
      int32_t v = kNone;
      if (i < d.filled) {
        v = p.chooseleaf ? sl.out2(i) : sl.out(i);
        if (!p.firstn && sl.out(i) == kUndef) v = kNone;
      }
      row[i] = v;
    }
    // the next seed rewrites the slots: every lane has read this one's
    __syncwarp(g.mask);
    if (work != nullptr) {
      int draws = d.draws;
      for (int off = G >> 1; off > 0; off >>= 1)
        draws += __shfl_xor_sync(g.mask, draws, off);
      if (g.lane == 0) {
        work[2 * seed] = draws;
        work[2 * seed + 1] = d.hashes;
      }
    }
  }
  if constexpr (PROF) {
    // per warp: its cycles from the first seed to the last, the draw
    // steps it issued, the lanes active at them, its SM
    __syncwarp();
    const long long cycles = clock64() - t0;
    const long long gw =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    if (warp_lane == 0 && gw * 32 < n * G) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      clk[4 * gw] = cycles;
      clk[4 * gw + 1] = prof_steps[threadIdx.x / 32];
      clk[4 * gw + 2] = prof_lanes[threadIdx.x / 32];
      clk[4 * gw + 3] = smid;
    }
  }
}

// A block's slots: two rows of out_size words for each of its seeds.
size_t slot_bytes(int group, int out_size) {
  return (size_t)(kThreads / group) * 2 * (out_size > 0 ? out_size : 0) *
         sizeof(int32_t);
}

// Dynamic shared memory of a launch: the ln tables, the map's tables when
// staged, the slots unless they lie in the scratch.
size_t smem_bytes(const Plan& p, bool tables) {
  return (kLnWords + (tables ? (size_t)p.words : 0)) * sizeof(int32_t) +
         (p.slots_global ? 0 : slot_bytes(p.group, p.out_size));
}

bool tables_staged(const Plan& p) {
  return (size_t)(kLnWords + p.words) * sizeof(int32_t) <= kSmemBudget;
}

template <bool SMEM, bool PROF>
cudaError_t launch(const int32_t* tables, const Plan& p, const long long* xs,
                   long long n, long long* out, int* work, long long* clk,
                   int32_t* scratch, cudaStream_t stream) {
  auto kernel = crush_straw2_kernel<SMEM, PROF>;
  const size_t smem = smem_bytes(p, SMEM);
  unsigned blocks = 0;
  cudaError_t err =
      launch_common::grid_blocks(kernel, kThreads, smem, n * p.group, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(tables, p, xs, n, out, work,
                                             clk, scratch);
  err = cudaGetLastError();
  if (err == cudaSuccess) g_launches[SMEM ? kShared : kGlobal].fetch_add(1);
  return err;
}

}  // namespace

// The threads that fill the card: kFillWarps warps on each SM.
static cudaError_t fill_threads(long long* threads) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *threads = (long long)sms * kFillWarps * 32;
  return err;
}

// geo: nb, s, npos, nw, max_devices; plan: root, firstn, chooseleaf,
// target_type, numrep, out_size, result_max, tries, recurse_tries, vary_r.
// The table offsets follow from geo as ops/crush_kernel.pack_tables lays
// them out. The group (PERF.md): the smallest power of two whose
// square holds a bucket of s items, doubled once where a sweep of n seeds
// would leave the card short of `fill` threads (kFillWarps an SM), or
// more where the sweep's n * G threads stay within kWideWarps an SM (up
// to 32 lanes, a warp a seed); then doubled while a block's slots exceed
// kSlotBudget (where 32 lanes would still exceed it, the slots go to the
// scratch instead). A power of two `group` up to 32 (for tests and
// timing) names it instead. A group past 32 is refused.
static bool make_plan(const int* geo, const int* rule, int group,
                      long long n, long long fill, Plan* p) {
  *p = Plan{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  rule[0],
            rule[1], rule[2], rule[3], rule[4], rule[5], rule[6],
            rule[7], rule[8], rule[9]};
  if (p->nb < 1 || p->s < 1 || p->npos < 1 || p->nw < 1 ||
      p->result_max < 1 || p->out_size > p->result_max)
    return false;
  const long long cells = (long long)p->nb * p->s;
  const long long w_at = cells * (2 + p->npos) + 2LL * p->nb;
  const long long recip_at = (w_at + p->nw + 1) & ~1LL;
  const long long words = recip_at + 2 * cells * p->npos;
  if (words + kLnWords > (1LL << 31) - 1) return false;
  p->items_at = 0;
  p->ids_at = (int)cells;
  p->wsets_at = (int)(2 * cells);
  p->size_at = (int)(cells * (2 + p->npos));
  p->btype_at = p->size_at + p->nb;
  p->w_at = (int)w_at;
  p->recip_at = (int)recip_at;
  p->words = (int)words;
  if (group < 0 || group > 32 || (group & (group - 1)) != 0) return false;
  int g = 1;
  while (g < 32 && g * g < p->s) g *= 2;
  if (g < 32 && n * g < fill) g *= 2;
  int wide = 32;
  while (wide > g && n * wide > fill / kFillWarps * kWideWarps) wide >>= 1;
  g = wide;
  if (group > 0) {
    g = group;
  } else {
    int h = g;
    while (h < 32 && slot_bytes(h, p->out_size) > kSlotBudget) h *= 2;
    if (slot_bytes(h, p->out_size) <= kSlotBudget) g = h;
  }
  p->group = g;
  p->group_log = __builtin_ctz(g);
  p->slots_global = slot_bytes(g, p->out_size) > kSlotBudget;
  return true;
}

// The design a map of this geometry takes: 0 tables staged in shared
// memory, 1 tables read from device memory; -1 a geometry refused.
extern "C" int crush_straw2_design(const int* geo, const int* rule) {
  Plan p;
  if (!make_plan(geo, rule, 0, 0, 0, &p)) return -1;
  return tables_staged(p) ? kShared : kGlobal;
}

// The lanes a seed (G) of a sweep of n seeds of this geometry on the
// current device; -1 a geometry refused, -2 a failed device query.
extern "C" int crush_straw2_group(const int* geo, const int* rule,
                                  long long n) {
  long long fill = 0;
  if (fill_threads(&fill) != cudaSuccess) return -2;
  Plan p;
  return make_plan(geo, rule, 0, n, fill, &p) ? p.group : -1;
}

// The int32 words of scratch a sweep of n seeds needs for its slots (0
// where they fit shared memory: two rows of out_size words a seed);
// -1 a geometry refused, -2 a failed device query.
extern "C" long long crush_straw2_scratch(const int* geo, const int* rule,
                                          int group, long long n) {
  long long fill = 0;
  if (fill_threads(&fill) != cudaSuccess) return -2;
  Plan p;
  if (!make_plan(geo, rule, group, n, fill, &p)) return -1;
  return p.slots_global ? n * 2 * p.out_size : 0;
}

// Maps seeds xs [n] (int64, hashed as uint32) into out [n, result_max]
// int64, `group` lanes a seed (0: as make_plan picks); work, when not
// null, gets each seed's straw2 draws (items hashed) and is_out hashes
// ([n, 2] int32); clk, when not null, makes a profiled launch that writes
// each warp's clock split ([ceil(n * G / 32), 4] int64: cycles, draw
// steps, lanes active at them, SM); scratch holds the slots where
// crush_straw2_scratch asks for it. Returns 0 or a cudaError_t, -1 for a
// refused geometry, -3 for a missing scratch.
extern "C" int crush_straw2_map(const int32_t* tables, const int* geo,
                                const int* rule, int group,
                                const long long* xs, long long n,
                                long long* out, int* work, long long* clk,
                                int32_t* scratch, void* stream) {
  long long fill = 0;
  const cudaError_t err = fill_threads(&fill);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!make_plan(geo, rule, group, n, fill, &p)) return -1;
  if (n == 0) return 0;
  if (p.slots_global && scratch == nullptr) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool smem = tables_staged(p);
  if (clk != nullptr)
    return smem ? launch<true, true>(tables, p, xs, n, out, work, clk,
                                     scratch, s)
                : launch<false, true>(tables, p, xs, n, out, work, clk,
                                      scratch, s);
  return smem ? launch<true, false>(tables, p, xs, n, out, work, clk,
                                    scratch, s)
              : launch<false, false>(tables, p, xs, n, out, work, clk,
                                     scratch, s);
}

extern "C" long long crush_straw2_launches(int design) {
  return design >= 0 && design < kDesigns ? g_launches[design].load() : -1;
}

extern "C" void crush_straw2_reset_launches() {
  for (auto& c : g_launches) c.store(0);
}
