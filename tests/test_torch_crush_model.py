"""A Python model of the CUDA CRUSH kernel's per-seed loop, on the CPU.

``ceph_tpu_torch/csrc/crush_straw2.cu`` runs only on the card. This file
restates its per-seed loop (``map_indep``, ``map_firstn``, ``descend``,
``straw2``, ``is_out``, ``crush_ln``, ``div_exact`` and the hashes) line
for line in
Python, reading the very int32 table buffer that
``ops/crush_kernel.pack_tables`` lays out at the kernel's offsets, and
holds it against the port's scalar interpreter (itself held against the
JAX package's in tests/test_torch_crush.py) and the plain version.
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
UNDEF, NONE = 0x7FFFFFFE, 0x7FFFFFFF
HIT, RETRY, PERM = 0, 1, 2
LN_WORDS = (258 + 256) * 2


def div_exact(n, d, estimate=None):
    """The kernel's exact division: a quotient estimated in double (here
    numpy's correctly rounded 1/d and product, truncated; the card's is
    the hardware estimate after two Newton steps), then corrected by
    integer steps until n - q*d lies in [0, d)."""
    if estimate is None:
        estimate = int(np.float64(n) * (np.float64(1.0) / np.float64(d)))
    q = estimate
    rem = n - q * d
    while rem < 0:
        q -= 1
        rem += d
    while rem >= d:
        q += 1
        rem -= d
    return q


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

    def __init__(self, cm, plan, wvec):
        buf = crush_kernel.pack_tables(cm, wvec)
        self.ln = [int(v) for v in buf[:LN_WORDS].view(np.uint64)]
        self.t = [int(v) for v in buf[LN_WORDS:]]
        nb, s = cm.items.shape
        self.nb, self.s, self.npos = nb, s, cm.npos
        self.nw, self.max_devices = len(wvec), cm.max_devices
        self.p = plan
        cells = nb * s
        self.ids_at, self.wsets_at = cells, 2 * cells
        self.size_at = cells * (2 + cm.npos)
        self.btype_at = self.size_at + nb
        self.w_at = self.btype_at + nb

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
        t = self.t
        size = t[self.size_at + b]
        row = b * self.s
        wrow = (b * self.npos + min(pos, self.npos - 1)) * self.s
        high, high_draw = 0, 0
        for i in range(size):
            wt = t[self.wsets_at + wrow + i] & M32
            draw = -(1 << 63)
            if wt:
                u = hash3(x, t[self.ids_at + row + i] & M32, r & M32) & 0xFFFF
                lnv = self.crush_ln(u) - 0x1000000000000
                draw = -div_exact(-lnv, wt)
            if i == 0 or draw > high_draw:
                high, high_draw = i, draw
        return t[row + high]

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
    assert buf.dtype == np.int32
    assert buf.size == LN_WORDS + nb * s * (2 + cm.npos) + 2 * nb + wvec.size
    assert k.t[:nb * s] == list(cm.items.reshape(-1))
    assert k.t[k.w_at:] == list(wvec)
    assert k.t[k.size_at:k.size_at + nb] == list(cm.size)


def test_div_exact_at_the_extremes():
    """The dividend is -ln in [0, 2^48] and the divisor a weight in
    [1, 2^32); any estimate within a few of the quotient comes out exact,
    as the card's (within one) must."""
    ns = [0, 1, 2, 0xFFFF, 1 << 32, (1 << 32) + 1, (1 << 44) - 1, 1 << 44,
          (1 << 48) - 1, 1 << 48]
    ds = [1, 2, 3, 7, 0x8000, 0x10000, 0x10001, 0x7FFFFFFF, 0x80000000,
          0xFFFFFFFF]
    rng = np.random.default_rng(48)
    ns += [int(v) for v in rng.integers(0, 1 << 48, 200, dtype=np.int64)]
    ds += [int(v) for v in rng.integers(1, 1 << 32, 200, dtype=np.int64)]
    for n in ns:
        for d in ds:
            assert div_exact(n, d) == n // d, (n, d)
        for d in ds[:10]:
            for off in (-2, -1, 1, 3):
                assert div_exact(n, d, max(0, n // d + off)) == n // d
