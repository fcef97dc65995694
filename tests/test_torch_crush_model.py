"""A Python model of the CUDA CRUSH kernel's per-seed loop, on the CPU.

``ceph_tpu_torch/csrc/crush_straw2.cu`` runs only on the card. This file
restates its per-seed loop (``map_indep``, ``map_firstn``, ``descend``,
``straw2``, ``is_out``, ``crush_ln``, ``div_recip`` and the hashes) line
for line in Python, reading the very int32 table buffer that
``ops/crush_kernel.pack_tables`` lays out at the kernel's offsets, with
a seed's group of G lanes modelled lane by lane: in a bucket lane l draws
items l, l + G, ..., and the group takes the maximum by (draw, lowest
index) through the kernel's butterfly of xor shuffles. It holds the
model against the port's scalar interpreter (itself held against the JAX
package's in tests/test_torch_crush.py), the plain version and the JAX
package's ``batched_do_rule``: at the group size the kernel takes and at
every other one, on buckets of 1, 3, 17 and 33 items, with forced ties
(two items of one hash id at equal weights) and a bucket of zero
weights. The reciprocal division is held to ``n // d`` at the extremes
and on 10^5 random weights; Python ints model ``__umul64hi`` exactly.
Tolerance: none, every slot equal.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import batched, mapper_ref
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, CrushMap, Rule
from ceph_tpu_torch.crush import map as cmap_mod
from ceph_tpu_torch.ops import crush_kernel
from ceph_tpu_torch.tools.crushtool import build_map

from .torch_util import one_torch_thread  # noqa: F401

M32 = 0xFFFFFFFF
S64_MIN = -(1 << 63)
INT_MAX = (1 << 31) - 1
UNDEF, NONE = 0x7FFFFFFE, 0x7FFFFFFF
HIT, RETRY, PERM = 0, 1, 2
LN_WORDS = (258 + 256) * 2


def div_recip(n, m, d):
    """The kernel's division: the high word of n * m (m the weight's
    reciprocal floor((2^64 - 1) / d)), then one correction."""
    q = (n * m) >> 64
    if n - q * d >= d:
        q += 1
    return q


H100_FILL = 132 * 16 * 32    # threads that fill an H100: 16 warps an SM


def kernel_group(s, n=0, fill=0, out_size=1):
    """G of a sweep of n seeds of a map whose largest bucket has s items,
    as make_plan picks it: the smallest power of two whose square holds s,
    doubled once where n * G threads fall short of `fill` (16 warps an
    SM), widened up to 32 while n * G stays within half of it (8 warps an
    SM); then doubled while a block's slots (two rows of out_size words a
    seed) exceed 32 KiB, unless they exceed it at 32 lanes too (then the
    slots lie in device memory, at the G before)."""
    def slot_bytes(g):
        return (128 // g) * 2 * max(out_size, 0) * 4
    g = 1
    while g < 32 and g * g < s:
        g *= 2
    if g < 32 and n * g < fill:
        g *= 2
    wide = 32
    while wide > g and n * wide > fill // 16 * 8:
        wide //= 2
    g = wide
    h = g
    while h < 32 and slot_bytes(h) > 32 * 1024:
        h *= 2
    return h if slot_bytes(h) <= 32 * 1024 else g


def mix(a, b, c):
    a = (a - b - c) & M32; a ^= c >> 13              # noqa: E702
    b = (b - c - a) & M32; b ^= (a << 8) & M32       # noqa: E702
    c = (c - a - b) & M32; c ^= b >> 13              # noqa: E702
    a = (a - b - c) & M32; a ^= c >> 12              # noqa: E702
    b = (b - c - a) & M32; b ^= (a << 16) & M32      # noqa: E702
    c = (c - a - b) & M32; c ^= b >> 5               # noqa: E702
    a = (a - b - c) & M32; a ^= c >> 3               # noqa: E702
    b = (b - c - a) & M32; b ^= (a << 10) & M32      # noqa: E702
    c = (c - a - b) & M32; c ^= b >> 15              # noqa: E702
    return a, b, c


def hash2(a, b):
    h, x, y = 1315423911 ^ a ^ b, 231232, 1232
    a, b, h = mix(a, b, h)
    x, a, h = mix(x, a, h)
    b, y, h = mix(b, y, h)
    return h


def hash3(a, b, c):
    h, x, y = 1315423911 ^ a ^ b ^ c, 231232, 1232
    a, b, h = mix(a, b, h)
    c, x, h = mix(c, x, h)
    y, a, h = mix(y, a, h)
    b, x, h = mix(b, x, h)
    y, c, h = mix(y, c, h)
    return h


class Kernel:
    """The kernel's Plan, tables and per-seed loop."""

    def __init__(self, cm, plan, wvec, group=None):
        # group None: as the kernel picks it for a sweep that fills no card
        buf = crush_kernel.pack_tables(cm, wvec)
        self.ln = [int(v) for v in buf[:LN_WORDS].view(np.uint64)]
        self.t = [int(v) for v in buf[LN_WORDS:]]
        nb, s = cm.items.shape
        self.nb, self.s, self.npos = nb, s, cm.npos
        self.nw, self.max_devices = len(wvec), cm.max_devices
        self.p = plan
        self.g = kernel_group(s, 0, 0, plan.out_size) if group is None \
            else group
        cells = nb * s
        self.ids_at, self.wsets_at = cells, 2 * cells
        self.size_at = cells * (2 + cm.npos)
        self.btype_at = self.size_at + nb
        self.w_at = self.btype_at + nb
        self.recip_at = (self.w_at + self.nw + 1) & ~1
        self.recips = [int(v) for v in
                       buf[LN_WORDS + self.recip_at:].view(np.uint64)]

    def crush_ln(self, xin):
        x, iexpon = xin + 1, 15
        if not x & 0x18000:
            bits = (32 - (x & 0x1FFFF).bit_length()) - 16   # __clz - 16
            x <<= bits
            iexpon = 15 - bits
        index1 = (x >> 8) << 1
        rh, lh = self.ln[index1 - 256], self.ln[index1 + 1 - 256]
        index2 = (((x * rh) & ((1 << 64) - 1)) >> 48) & 0xFF
        return (iexpon << 44) + ((lh + self.ln[258 + index2]) >> 4)

    def straw2(self, b, x, r, pos):
        t, g = self.t, self.g
        size = t[self.size_at + b]
        row = b * self.s
        cell = (b * self.npos + min(pos, self.npos - 1)) * self.s
        best = []                       # each lane's (draw, index)
        for lane in range(g):
            high, high_draw = None, S64_MIN
            for i in range(lane, size, g):
                wt = t[self.wsets_at + cell + i] & M32
                draw = S64_MIN
                if wt:
                    u = hash3(x, t[self.ids_at + row + i] & M32,
                              r & M32) & 0xFFFF
                    lnv = self.crush_ln(u) - 0x1000000000000
                    draw = -div_recip(-lnv, self.recips[cell + i], wt)
                if high is None or draw > high_draw:
                    high, high_draw = i, draw
            best.append((high_draw, INT_MAX if high is None else high))
        off = g >> 1
        while off:                      # __shfl_xor_sync's butterfly
            best = [max(best[lane], best[lane ^ off],
                        key=lambda di: (di[0], -di[1])) for lane in range(g)]
            off >>= 1
        assert len(set(best)) == 1      # every lane holds the choice
        return t[row + best[0][1]]

    def is_out(self, item, x):
        if item >= self.nw:
            return True
        w = self.t[self.w_at + item] & M32
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (hash2(x, item) & 0xFFFF) >= w

    def descend(self, b, x, r, typ, pos):
        if b < 0 or b >= self.nb:
            return RETRY, 0
        while True:
            if self.t[self.size_at + b] == 0:
                return RETRY, 0
            it = self.straw2(b, x, r, pos)
            if it >= self.max_devices or (it < 0 and -1 - it >= self.nb):
                return PERM, 0
            itype = self.t[self.btype_at + (-1 - it)] if it < 0 else 0
            if itype == typ:
                return HIT, it
            if it >= 0:
                return PERM, 0
            b = -1 - it

    def map_indep(self, x):
        p = self.p
        n = p.out_size
        out, out2 = [UNDEF] * n, [UNDEF] * n
        left, ftotal = n, 0
        while left > 0 and ftotal < p.tries:
            for rep in range(n):
                if out[rep] != UNDEF:
                    continue
                r = (rep + p.numrep * ftotal) & M32
                w, item = self.descend(-1 - p.root, x, r, p.target_type, 0)
                if w == RETRY:
                    continue
                if w == PERM:
                    out[rep] = out2[rep] = NONE
                    left -= 1
                    continue
                if item in out:
                    continue
                if p.chooseleaf:
                    leaf = item
                    if item < 0:
                        leaf = UNDEF
                        for f2 in range(p.recurse_tries):
                            w2, cand = self.descend(
                                -1 - item, x, (rep + r + p.numrep * f2) & M32,
                                0, rep)
                            if w2 == RETRY:
                                continue
                            if w2 == PERM:
                                leaf = NONE
                                break
                            if self.is_out(cand, x):
                                continue
                            leaf = cand
                            break
                        if leaf == UNDEF:
                            leaf = NONE
                    out2[rep] = leaf
                    if leaf == NONE:
                        continue
                if p.target_type == 0 and self.is_out(item, x):
                    continue
                out[rep] = item
                left -= 1
            ftotal += 1
        res = out2 if p.chooseleaf else out
        return [NONE if o == UNDEF else v for o, v in zip(out, res)]

    def map_firstn(self, x):
        p = self.p
        out, out2 = [NONE] * p.result_max, [NONE] * p.result_max
        outpos = 0
        for rep in range(p.numrep):
            if outpos >= p.result_max:
                break
            for ftotal in range(p.tries):
                r = rep + ftotal
                w, item = self.descend(-1 - p.root, x, r, p.target_type,
                                       outpos)
                if w == PERM:
                    break
                if w == RETRY or item in out[:outpos]:
                    continue
                if p.chooseleaf:
                    if item < 0:
                        sub_r = r >> (p.vary_r - 1) if p.vary_r else 0
                        got = False
                        for f2 in range(p.recurse_tries):
                            w2, cand = self.descend(-1 - item, x, sub_r + f2,
                                                    0, outpos)
                            if w2 == PERM:
                                break
                            if w2 == RETRY:
                                continue
                            if cand in out2[:outpos] or self.is_out(cand, x):
                                continue
                            out2[outpos] = cand
                            got = True
                            break
                        if not got:
                            continue
                    else:
                        out2[outpos] = item
                if p.target_type == 0 and self.is_out(item, x):
                    continue
                out[outpos] = item
                outpos += 1
                break
        res = out2 if p.chooseleaf else out
        return res[:outpos] + [NONE] * (p.result_max - outpos)

    def run(self, xs):
        rows = []
        for x in xs:
            x = int(x) & M32
            row = self.map_firstn(x) if self.p.firstn else self.map_indep(x)
            rows.append(row + [NONE] * (self.p.result_max - len(row)))
        return np.asarray(rows, dtype=np.int64)


def two_level(hosts, per, weights):
    m = CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids, hw = [], []
    for h in range(hosts):
        items = [h * per + i for i in range(per)]
        w = [int(weights[i]) for i in items]
        hids.append(m.add_bucket("straw2", 1, items, w, id=-2 - h))
        hw.append(sum(w))
    m.add_bucket("straw2", 2, hids, hw, id=-1, name="default")
    return m


def bench_map():
    rng = np.random.default_rng(7070)
    weights = rng.integers(0x8000, 3 * 0x10000, size=32, dtype=np.uint32)
    m = two_level(8, 4, weights)
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSELEAF_INDEP, 5, 1),
                           (cmap_mod.RULE_EMIT,)]))
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSELEAF_FIRSTN, 0, 1),
                           (cmap_mod.RULE_EMIT,)]))
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSE_FIRSTN, 4, 1),
                           (cmap_mod.RULE_EMIT,)]))
    reweight = np.full(32, 0x10000, dtype=np.int64)
    reweight[3] = 0
    reweight[9] = 0x8000
    return m, reweight


def rack_map():
    """A 256-OSD cut of the 1024-OSD cluster: hosts of 16, racks of 4."""
    m = build_map(256, [("host", "straw2", 16), ("rack", "straw2", 4),
                        ("root", "straw2", 0)])
    m.add_simple_rule("ec", "default", "host", mode="indep")
    m.add_simple_rule("rep", "default", "host")
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, m.bucket_names["default"]),
                           (cmap_mod.RULE_CHOOSE_INDEP, 6, 0),
                           (cmap_mod.RULE_EMIT,)], name="osds"))
    reweight = np.full(256, 0x10000, dtype=np.int64)
    reweight[::97] = 0
    reweight[5::89] = 0x8000
    return m, reweight


CASES = [
    ("bench_indep", bench_map, 0, 5, None),
    ("bench_firstn_rel", bench_map, 1, 3, None),
    ("bench_choose_hosts", bench_map, 2, 3, None),
    ("rack_ec", rack_map, 0, 12, None),
    ("rack_rep", rack_map, 1, 3, None),
    ("rack_choose_osds", rack_map, 2, 6, None),
    ("rack_ec_weightset", rack_map, 0, 12, 2),
    ("rack_rep_weightset", rack_map, 1, 3, 3),
]


def choose_args(m, positions):
    rng = np.random.default_rng(positions)
    m.create_choose_args(0, positions=positions)
    for host in range(0, 16, 5):
        m.choose_args_adjust_item_weight(
            0, -1 - host, host * 16 + 1,
            [int(w) for w in rng.integers(0, 0x20000, positions)])
    return m.choose_args[0]


@pytest.mark.parametrize("name,make,rule,result_max,positions", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_model_matches_scalar_and_plain(one_torch_thread, name,  # noqa: F811
                                               make, rule, result_max,
                                               positions):
    m, reweight = make()
    cargs = choose_args(m, positions) if positions else None
    xs = np.concatenate([np.arange(-8, 40), [2**31 - 1, 2**31, 2**32 + 5]])
    plan = batched.plan_rule(m, rule, result_max)
    cm = batched.compile_map(m, cargs)
    wvec = batched.reweight_vector(reweight, cm.max_devices)
    got = Kernel(cm, plan, wvec).run(xs)
    for i, x in enumerate(xs):
        ref = mapper_ref.crush_do_rule(m, rule, int(x), result_max,
                                       list(reweight), choose_args=cargs)
        ref = ref + [CRUSH_ITEM_NONE] * (result_max - len(ref))
        assert list(got[i]) == ref, (int(x), list(got[i]), ref)
    plain = batched.map_plain(cm, plan, torch.from_numpy(xs),
                              torch.from_numpy(wvec)).numpy()
    np.testing.assert_array_equal(got, plain)


def test_table_offsets_follow_the_geometry():
    m, reweight = rack_map()
    cm = batched.compile_map(m, choose_args(m, 2))
    wvec = batched.reweight_vector(reweight, cm.max_devices)
    buf = crush_kernel.pack_tables(cm, wvec)
    nb, s = cm.items.shape
    k = Kernel(cm, batched.plan_rule(m, 0, 12), wvec)
    cells = nb * s * cm.npos
    assert buf.dtype == np.int32
    assert k.recip_at % 2 == 0 and (LN_WORDS + k.recip_at) % 2 == 0
    assert buf.size == LN_WORDS + k.recip_at + 2 * cells
    assert k.t[:nb * s] == list(cm.items.reshape(-1))
    assert k.t[k.w_at:k.w_at + wvec.size] == list(wvec)
    assert k.t[k.size_at:k.size_at + nb] == list(cm.size)
    w = cm.wsets.reshape(-1)
    assert k.recips == [M64 // int(d) if d else 0 for d in w]


def test_tables_of_the_chip_maps_fit_shared_memory():
    """The reciprocals grow the tables by 8 bytes a weight-set cell; the
    1024-OSD cluster, with and without its two-position weight set, and
    the bench's map must still be staged in shared memory (64 KiB)."""
    cluster = build_map(1024, [("host", "straw2", 16), ("rack", "straw2", 8),
                               ("root", "straw2", 0)])
    weighted = build_map(1024, [("host", "straw2", 16), ("rack", "straw2", 8),
                                ("root", "straw2", 0)])
    weighted.create_choose_args(0, positions=2)
    for host in (3, 17, 29, 42, 58):
        weighted.choose_args_adjust_item_weight(
            0, -1 - host, host * 16 + 4, [0x4000, 0xC000])
    maps = [(cluster, None, 1024), (weighted, weighted.choose_args[0], 1024),
            (bench_map()[0], None, 32)]
    for m, cargs, nw in maps:
        cm = batched.compile_map(m, cargs)
        nbytes = crush_kernel.pack_tables(cm, np.zeros(nw, np.int64)).nbytes
        assert nbytes <= 64 * 1024, nbytes


M64 = (1 << 64) - 1
DIVISORS = [1, 2, 0xFFFF, 0x10000, 0x10001, 0x8000, 0xFFFFFFFF]


def numerators(d, rng, count):
    return [0, 1, d - 1, d, 1 << 48, (1 << 48) - 1] + \
        [int(v) for v in rng.integers(0, (1 << 48) + 1, count,
                                      dtype=np.int64)]


@pytest.mark.parametrize("d", DIVISORS)
def test_div_recip_at_the_extremes(d):
    """-ln is at most 2^48 and a weight below 2^32: the multiply-high
    estimate is q or q - 1 and one correction makes it exact."""
    m = int(crush_kernel.reciprocals(np.array([d]))[0])
    assert m == M64 // d
    rng = np.random.default_rng(d)
    for n in numerators(d, rng, 2000):
        assert div_recip(n, m, d) == n // d, (n, d)
        q = (n * m) >> 64
        assert q in (n // d, n // d - 1)


def test_div_recip_on_random_weights():
    """10^5 seeded random weights in [1, 2^32), each at 0, 1, d - 1, d,
    2^48 and a random numerator; the reciprocals as pack_tables makes
    them."""
    rng = np.random.default_rng(10)
    ds = rng.integers(1, 1 << 32, 100_000, dtype=np.int64)
    ms = crush_kernel.reciprocals(ds)
    ns = rng.integers(0, (1 << 48) + 1, ds.size, dtype=np.int64)
    for d, m, r in zip(ds.tolist(), ms.tolist(), ns.tolist()):
        assert m == M64 // d
        for n in (0, 1, d - 1, d, 1 << 48, r):
            assert div_recip(n, m, d) == n // d, (n, d)


def test_a_zero_weight_has_no_reciprocal():
    assert crush_kernel.reciprocals(np.array([0, 1, 0]))[[0, 2]].tolist() == \
        [0, 0]


GROUP_CASES = [
    ("bench_indep", bench_map, 0, 5, None),
    ("rack_ec", rack_map, 0, 12, None),
    ("rack_rep", rack_map, 1, 3, None),
    ("rack_ec_weightset", rack_map, 0, 12, 2),
]


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("name,make,rule,result_max,positions", GROUP_CASES,
                         ids=[c[0] for c in GROUP_CASES])
def test_group_model_at_every_group_size(one_torch_thread, name,  # noqa: F811
                                         make, rule, result_max, positions,
                                         group):
    """Any G gives the same placements: below a bucket's size the lanes
    loop over its items, above it the idle lanes offer S64_MIN at an
    index past every item."""
    m, reweight = make()
    cargs = choose_args(m, positions) if positions else None
    xs = np.arange(24)
    plan = batched.plan_rule(m, rule, result_max)
    cm = batched.compile_map(m, cargs)
    wvec = batched.reweight_vector(reweight, cm.max_devices)
    got = Kernel(cm, plan, wvec, group).run(xs)
    plain = batched.map_plain(cm, plan, torch.from_numpy(xs),
                              torch.from_numpy(wvec)).numpy()
    np.testing.assert_array_equal(got, plain)


def cluster_1024():
    m = build_map(1024, [("host", "straw2", 16), ("rack", "straw2", 8),
                         ("root", "straw2", 0)])
    m.add_simple_rule("ec", "default", "host", mode="indep")
    m.add_simple_rule("rep", "default", "host")
    reweight = np.full(1024, 0x10000, dtype=np.int64)
    reweight[::97] = 0
    reweight[5::89] = 0x8000
    return m, reweight


def cluster_weighted(m):
    m.create_choose_args(0, positions=2)
    for host in (3, 17, 29, 42, 58):
        m.choose_args_adjust_item_weight(0, -1 - host, host * 16 + 4,
                                         [0x4000, 0xC000])
    return m.choose_args[0]


REF_CASES = {
    # name: (map maker, rule, result_max, weight sets, phase 9's seeds,
    # the kernel's G there on an H100)
    "bench_indep": (bench_map, 0, 5, False, 65536, 4),
    "cluster_ec": (cluster_1024, 0, 12, False, 8192, 8),
    "cluster_rep": (cluster_1024, 1, 3, False, 1 << 20, 4),
    "cluster_ec_weight_sets": (cluster_1024, 0, 12, True, 65536, 4),
}


def jax_map(name):
    """The same map in the JAX package's classes."""
    from ceph_tpu.crush import map as jmap
    from ceph_tpu.tools import crushtool as jcrushtool

    from .torch_crush_maps import bench_map as shared_bench, cluster_map
    if name.startswith("bench"):
        m = shared_bench(jmap)
        return m, None
    m = cluster_map(jcrushtool)
    return m, cluster_weighted(m) if name.endswith("weight_sets") else None


@pytest.mark.parametrize("name", list(REF_CASES))
def test_group_model_matches_scalar_and_reference(one_torch_thread,  # noqa: F811
                                                   name):
    """The group model at the kernel's G against the scalar mapper and
    the JAX package's batched_do_rule on the phase-9 maps."""
    from ceph_tpu.crush import batched as jbatched

    make, rule, rmax, weights, seeds, group = REF_CASES[name]
    m, reweight = make()
    cargs = cluster_weighted(m) if weights else None
    xs = np.concatenate([np.arange(40), [2**31 - 1, 2**31, 2**32 + 5]])
    plan = batched.plan_rule(m, rule, rmax)
    cm = batched.compile_map(m, cargs)
    assert kernel_group(cm.items.shape[1], seeds, H100_FILL,
                        plan.out_size) == group
    wvec = batched.reweight_vector(reweight, cm.max_devices)
    got = Kernel(cm, plan, wvec, group).run(xs)
    for i, x in enumerate(xs):
        ref = mapper_ref.crush_do_rule(m, rule, int(x), rmax, list(reweight),
                                       choose_args=cargs)
        assert list(got[i]) == ref + [CRUSH_ITEM_NONE] * (rmax - len(ref))
    jm, jargs = jax_map(name)
    ref = jbatched.batched_do_rule(jm, rule, xs, rmax, reweight,
                                   choose_args=jargs)
    np.testing.assert_array_equal(got, np.asarray(ref))


def flat_map(n):
    m = CrushMap()
    m.type_names = {"osd": 0, "root": 1}
    m.add_bucket("straw2", 1, list(range(n)),
                 [0x8000 + (i * 7919) % 0x20000 for i in range(n)], id=-1,
                 name="default")
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSE_INDEP, min(n, 4), 0),
                           (cmap_mod.RULE_EMIT,)]))
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSE_FIRSTN, min(n, 3), 0),
                           (cmap_mod.RULE_EMIT,)]))
    reweight = np.full(n, 0x10000, dtype=np.int64)
    reweight[1::7] = 0x9000
    return m, reweight


def held_to_scalar_and_plain(m, reweight, rule, rmax, cargs=None, xs=None,
                             group=None):
    xs = np.arange(48) if xs is None else xs
    plan = batched.plan_rule(m, rule, rmax)
    cm = batched.compile_map(m, cargs)
    wvec = batched.reweight_vector(reweight, cm.max_devices)
    got = Kernel(cm, plan, wvec, group).run(xs)
    for i, x in enumerate(xs):
        ref = mapper_ref.crush_do_rule(m, rule, int(x), rmax, list(reweight),
                                       choose_args=cargs)
        assert list(got[i]) == ref + [CRUSH_ITEM_NONE] * (rmax - len(ref))
    plain = batched.map_plain(cm, plan, torch.from_numpy(xs),
                              torch.from_numpy(wvec)).numpy()
    np.testing.assert_array_equal(got, plain)
    return got


@pytest.mark.parametrize("size", [1, 3, 17, 33])
@pytest.mark.parametrize("rule", [0, 1], ids=["indep", "firstn"])
def test_group_model_on_bucket_sizes(one_torch_thread, size,  # noqa: F811
                                     rule):
    """G (the kernel's at 4,093 seeds) is 8, 8, 16 and 16: idle lanes,
    loops of two and of three with one item on the last; and G = 1 and 32
    as well: one lane, and lanes past every item."""
    m, reweight = flat_map(size)
    g = kernel_group(size, 4093, H100_FILL, min(size, 4))
    assert g == {1: 8, 3: 8, 17: 16, 33: 16}[size]
    for group in (1, g, 32):
        held_to_scalar_and_plain(m, reweight, rule, min(size, 4),
                                 group=group)


@pytest.mark.parametrize("out_size,group", [(3, 4), (128, 4), (129, 8),
                                            (1024, 32), (1025, 4)])
def test_group_model_sizes_slots_by_replicas(out_size, group):
    """A block holds 32 KiB of slots, two rows of out_size words a seed:
    G doubles until they fit, and where even 32 lanes a seed do not fit,
    G stays as the bucket and seeds pick it and the slots lie in device
    memory (the cluster's buckets of 16 at 2^20 seeds: G = 4)."""
    assert kernel_group(16, 1 << 20, H100_FILL, out_size) == group


def test_group_model_on_forced_ties(one_torch_thread):  # noqa: F811
    """Items of one hash id at equal weights draw the same: the lowest
    index wins, within a lane and across lanes (host 0's four OSDs on
    lanes 0-3 all tie, as do the root's items 2 and 5)."""
    m, reweight = bench_map()
    m.create_choose_args(0, positions=1)
    cargs = m.choose_args[0]
    cargs[-2] = {"weight_set": [[0x10000] * 4], "ids": [700] * 4}
    root = m.buckets[-1]
    ids = list(root.items)
    ids[5] = ids[2]
    ws = list(root.weights)
    ws[5] = ws[2]
    cargs[-1] = {"weight_set": [ws], "ids": ids}
    reweight = np.full(32, 0x10000, dtype=np.int64)
    got = held_to_scalar_and_plain(m, reweight, 0, 5, cargs,
                                   xs=np.arange(96))
    assert not np.isin(got, [1, 2, 3]).any()    # host 0 gives OSD 0 only
    assert (got == 0).any()


def test_group_model_on_a_bucket_of_zero_weights(one_torch_thread):  # noqa: F811
    """Every draw is S64_MIN, so item 0 wins, on the scalar mapper and in
    the group."""
    m = CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids = [m.add_bucket("straw2", 1, [h * 4 + i for i in range(4)],
                         [0] * 4 if h == 1 else [0x10000] * 4, id=-2 - h)
            for h in range(4)]
    m.add_bucket("straw2", 2, hids, [0x40000] * 4, id=-1, name="default")
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSELEAF_INDEP, 3, 1),
                           (cmap_mod.RULE_EMIT,)]))
    got = held_to_scalar_and_plain(m, np.full(16, 0x10000, np.int64), 0, 3)
    assert not np.isin(got, [5, 6, 7]).any() and (got == 4).any()
