"""Bit-level model of the GF kernel's mma design, against the JAX package.

``ceph_tpu_torch/csrc/gf_bitmatrix.cu`` computes every geometry the
bit-sliced design does not take (w = 16, 32, k*w > 128) on the int8
tensor cores (``gf_mma_kernel``, ``mma.sync.m16n8k32.s8``). This file
restates its steps in numpy, on the same registers and bytes, so that a
layout mistake shows on the CPU:

  1. the bitmatrix's row groups (the C entry point's plan, restated in
     tests/torch_mma_plan.py and read on a card by
     ``gf_kernel.row_groups``): a block stages
     its group in fragment order, [N-tile][K-tile pair][lane][16 bytes],
     each 8 bytes the 0/1 entries (``& 1``) of row 8*N-tile + lane/4 at
     columns 32*K-tile + 8*(lane%4) ..., zero past the rows and past k*w,
     so that one 16-byte load brings a lane two K-tiles' B registers;
  2. a warp's unit, 32 element columns of one batch lane, staged as k tile
     rows of 32*w/8 bytes (bytes past N zero; the rows past k up to the
     padded K are left as they are, here random);
  3. the A registers of K-tile kt for lane l = 4g + t: byte 4*kt + t of the
     k*w-bit vectors of columns 4g .. 4g+3 (``column_bytes``: one word at
     w=8, ``__byte_perm`` of 8 or 16 bytes at w=16/32), each byte's low and
     high nibble spread into four 0/1 bytes, (nib * 0x00204081) &
     0x01010101: the fragments of A-rows g, g+8 of M-tiles 0 and 1;
  4. the products by the PTX fragment maps of m16n8k32 with .s8 operands
     (groupID g = lane / 4, threadID_in_group t = lane % 4): A register r
     byte q is A[g + 8*(r % 2), 4t + q + 16*(r // 2)], B register r byte q
     is B[4t + q + 16r, g], D register i is D[g + 8*(i // 2), 2t + i % 2];
     past 16 K-tiles in chunks of 4 K-tiles, A rebuilt for each;
  5. the epilogue of 4 N-tiles: (d & 1) shifted to bit 16*mt + 8*(i // 2)
     + 2t + i % 2, two ``__shfl_xor_sync`` (1, 2) OR the four lanes of a
     group, and lane t stores one word (w=8: N-tile t's; w=16/32: the four
     words interleaved by ``__byte_perm`` into element bytes) at element
     row rho0/(w/8) + t/(w/8), byte e0*w/8 + 4g*w/8 + 4*(t % (w/8)).

The model is held bit for bit (tolerance: none) against
``ceph_tpu.ops.xor_mm.matrix_encode`` and, for one w=8 case with N % 512
== 0, against the Pallas kernel ``pallas_gf.matrix_encode8`` in interpret
mode. The CUDA kernel is held against the port's plain version on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from ceph_tpu import registry as jregistry
from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import pallas_gf
from ceph_tpu.ops import xor_mm as jxor_mm
from ceph_tpu_torch import registry

from . import torch_mma_plan as plan
from .torch_mma_plan import H100_OPTIN

U32 = np.uint32
COLS = 32                       # element columns a warp unit
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4    # groupID, threadID_in_group


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on arrays: byte i of the result is byte
    (sel >> 4i) & 7 of y:x (x holds bytes 0-3); `sel` may vary per
    element."""
    src = np.stack([(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] +
                   [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)])
    sel = np.broadcast_to(np.asarray(sel, dtype=np.int64), x.shape)
    out = np.zeros(x.shape, dtype=U32)
    for i in range(4):
        pick = (sel >> (4 * i)) & 7
        out |= np.take_along_axis(src, pick[None], axis=0)[0] << U32(8 * i)
    return out


def spread_nibble(x):
    return (x.astype(U32) * U32(0x00204081)) & U32(0x01010101)


def words(raw):
    """[..., 4*m] uint8 -> m little-endian uint32 words [..., m]."""
    return np.ascontiguousarray(raw).view("<u4")


# -- step 1: the row groups, staged in fragment order ---------------------

def stage_group(bitmat, tile0, group_tiles, kt_count):
    """[group_tiles, K-tile pairs, 32 lanes, 4] uint32: the group starting
    at N-tile tile0 as a block stages it, [N-tile][pair][lane][16 bytes],
    a lane's 16 bytes the fragments of K-tiles 2p and 2p + 1 (one 16-byte
    load)."""
    rows, kw = bitmat.shape
    pairs = -(-kt_count // 2)
    padded = np.zeros(((tile0 + group_tiles) * 8, pairs * 64),
                      dtype=np.uint8)
    have = min(rows, padded.shape[0])
    padded[:have, :kw] = bitmat[:have] & 1
    grp = padded[tile0 * 8:].reshape(group_tiles, 8, pairs, 2, 4, 8)
    # lane 4g + t takes row g, bytes 8t .. 8t+7 of each K-tile of a pair
    frag = grp.transpose(0, 2, 1, 4, 3, 5).reshape(group_tiles, pairs, 32,
                                                   16)
    return words(frag)


def b_registers(bs, kt_count):
    """[group_tiles, KT, 2 registers, 32 lanes]: K-tile kt's B registers,
    words 2*(kt % 2) and 2*(kt % 2) + 1 of pair kt // 2."""
    tiles, pairs = bs.shape[:2]
    regs = bs.reshape(tiles, pairs, 32, 2, 2).transpose(0, 1, 3, 4, 2)
    return regs.reshape(tiles, 2 * pairs, 2, 32)[:, :kt_count]


# -- step 2: the warps' units ------------------------------------------------

def stage_units(data, w, kt_count, rng):
    """[U, rows of the padded K, 32*w/8] uint8 tiles, unit u = (batch lane
    u // chunks, elements 32*(u % chunks) ...)."""
    wb = w // 8
    b, k, n = data.shape
    chunks = -(-(n // wb) // COLS)
    trows = kt_count * 4 // wb
    buf = np.zeros((b, k, chunks * COLS * wb), dtype=np.uint8)
    buf[..., :n] = data
    tiles = rng.integers(0, 256, (b, chunks, trows, COLS * wb),
                         dtype=np.uint8)      # rows past k: never zeroed
    tiles[:, :, :k] = buf.reshape(b, k, chunks, COLS * wb).transpose(
        0, 2, 1, 3)
    return tiles.reshape(b * chunks, trows, COLS * wb), chunks


# -- step 3: the A registers ----------------------------------------------

def column_bytes(tiles, kt, w):
    """[U, 32 lanes] uint32: byte 4*kt + t of the columns 4g .. 4g+3."""
    wb = w // 8
    beta = 4 * kt + T
    j, s = beta // wb, beta % wb
    per = 4 * wb                                   # bytes of 4 elements
    raw = tiles[:, j[:, None], G[:, None] * per + np.arange(per)]
    v = words(raw)
    if w == 8:
        return v[..., 0]
    if w == 16:
        return byte_perm(v[..., 0], v[..., 1], 0x6420 + 0x1111 * s)
    sel = s | (s + 4) << 4
    return byte_perm(byte_perm(v[..., 0], v[..., 1], sel),
                     byte_perm(v[..., 2], v[..., 3], sel), 0x5410)


def build_a(tiles, kt, w):
    """[2 M-tiles, 4 registers, U, 32 lanes] uint32 for K-tile kt."""
    p = column_bytes(tiles, kt, w)
    a = np.zeros((2, 4) + p.shape, dtype=U32)
    for c in range(4):
        byte = p >> U32(8 * c)
        a[c // 2, c % 2] = spread_nibble(byte & U32(0xF))
        a[c // 2, 2 + c % 2] = spread_nibble((byte >> U32(4)) & U32(0xF))
    return a


# -- step 4: one mma by the PTX fragment maps ---------------------------------

def reg_bytes(r):
    """[..., 32 lanes] uint32 -> [..., 32, 4] 0/1 int64 bytes."""
    return ((r[..., None] >> (U32(8) * np.arange(4, dtype=U32)))
            & U32(0xFF)).astype(np.int64)


def a_matrix(a):
    """[U, 16, 32] int64: the A tile that registers a [4, U, 32] hold."""
    am = np.zeros((a.shape[1], 16, 32), dtype=np.int64)
    for r in range(4):
        rows = (G + 8 * (r % 2))[:, None]
        cols = (4 * T + 16 * (r // 2))[:, None] + np.arange(4)
        am[:, rows, cols] = reg_bytes(a[r])
    return am


def b_matrix(b):
    """[..., 32, 8] int64: the B tiles that registers b [..., 2, 32]
    hold."""
    bm = np.zeros(b.shape[:-2] + (32, 8), dtype=np.int64)
    for r in range(2):
        rows = (4 * T + 16 * r)[:, None] + np.arange(4)
        bm[..., rows, G[:, None]] = reg_bytes(b[..., r, :])
    return bm


def d_registers(prod):
    """[4, U, 32]: the D registers of a [U, 16, 8] product."""
    return np.stack([prod[:, G + 8 * (i // 2), 2 * T + i % 2]
                     for i in range(4)])


def mma(d, a, b):
    """d [4, U, 32] += A (registers a [4, U, 32]) x B (b [2, 32]), as
    m16n8k32.row.col.s32.s8.s8.s32 maps them."""
    d += d_registers(a_matrix(a) @ b_matrix(b))


# -- step 5: the epilogue -------------------------------------------------

def shfl_xor(x, m):
    return x[..., LANES ^ m]


def store_tiles(acc, q0, out, rho0, units_b, units_e0, w, n):
    """Stores 4 N-tiles' words: acc [NB, 2, 4, U, 32] int64."""
    wb = w // 8
    v = []
    for q in range(4):
        x = np.zeros(acc.shape[-2:], dtype=U32)
        for mt in range(2):
            for i in range(4):
                bit = 16 * mt + 8 * (i // 2) + i % 2
                x |= (acc[q0 + q, mt, i] & 1).astype(U32) << U32(bit)
        x = x << (U32(2) * T.astype(U32))
        x |= shfl_xor(x, 1)
        x |= shfl_xor(x, 2)
        v.append(x)
    if w == 8:
        word = np.choose(T, v)                       # N-tile t's word
    elif w == 16:
        lo = np.where(T < 2, v[0], v[2])
        hi = np.where(T < 2, v[1], v[3])
        word = byte_perm(lo, hi, np.where(T & 1, 0x7362, 0x5140))
    else:
        sel = T | (T + 4) << 4
        word = byte_perm(byte_perm(v[0], v[1], sel),
                         byte_perm(v[2], v[3], sel), 0x5410)
    out_rows = out.shape[1]
    for l in range(32):
        i = rho0 // wb + T[l] // wb
        if i >= out_rows:
            continue                                 # a group's padding
        ob = units_e0 * wb + 4 * G[l] * wb + 4 * (T[l] % wb)
        for x in range(4):
            keep = ob + x < n
            out[units_b[keep], i, ob[keep] + x] = (
                word[keep, l] >> U32(8 * x)) & U32(0xFF)


# -- the kernel -------------------------------------------------------------

def mma_encode(bitmat, data, w, smem_limit=H100_OPTIN, seed=0):
    """[B, k, N] uint8 -> [B, R/w, N] uint8, as gf_mma_kernel computes it
    with the row groups `smem_limit` bytes of shared memory allow."""
    rows, kw = bitmat.shape
    b, k, n = data.shape
    assert kw == k * w and rows % w == 0 and n % (w // 8) == 0
    kt_count = -(-kw // 32)
    chunked = kt_count > plan.MMA_REG_TILES
    nb, kc = (8, 4) if chunked else (4, kt_count)
    groups = plan.row_groups(rows, kw, smem_limit)
    span = groups[0][1] - groups[0][0]
    group_tiles = -(-span // (8 * nb)) * nb
    rng = np.random.default_rng(seed)
    tiles, chunks = stage_units(data, w, kt_count, rng)
    units = np.arange(tiles.shape[0])
    units_b, units_e0 = units // chunks, (units % chunks) * COLS
    out = np.zeros((b, rows // w, n), dtype=np.uint8)
    row_tiles = rows // 8
    for gidx, (r0, _) in enumerate(groups):      # blockIdx.y
        tile0 = gidx * group_tiles
        assert r0 == 8 * tile0
        bs = stage_group(bitmat, tile0, group_tiles, kt_count)
        here = min(group_tiles, -(-(row_tiles - tile0) // nb) * nb)
        bmats = b_matrix(b_registers(bs, kt_count))  # [tiles, KT, 32, 8]
        if not chunked:                          # A once per unit
            a = np.stack([[a_matrix(x) for x in build_a(tiles, kt, w)]
                          for kt in range(kt_count)])
        for nt0 in range(0, here, nb):
            acc = np.zeros((nb, 2, 4) + tiles.shape[:1] + (32,),
                           dtype=np.int64)
            for c0 in range(0, kt_count, kc):
                kts = slice(c0, min(c0 + kc, kt_count))
                if chunked:                      # A again for each chunk
                    a = np.zeros((kt_count, 2) + tiles.shape[:1] + (16, 32),
                                 dtype=np.int64)
                    for kt in range(kts.start, kts.stop):
                        a[kt] = [a_matrix(x) for x in build_a(tiles, kt, w)]
                # the chain of products over the chunk's K-tiles, for each
                # N-tile q and M-tile m
                prod = np.einsum("kmuij,qkjn->qmuin", a[kts],
                                 bmats[nt0:nt0 + nb, kts])
                for q in range(nb):
                    for mt in range(2):
                        acc[q, mt] += d_registers(prod[q, mt])
            for h in range(0, nb, 4):
                store_tiles(acc, h, out, tile0 + nt0 + h, units_b,
                            units_e0, w, n)
    return out


# -- the reference ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference(case):
    """xor_mm.matrix_encode of a case's bitmatrix and data, once."""
    bitmat, data, w = CASES[case]()
    return np.asarray(jxor_mm.matrix_encode(jnp.asarray(bitmat),
                                            jnp.asarray(data), w))


def rand_data(seed, b, k, n):
    return np.random.default_rng(seed).integers(0, 256, (b, k, n),
                                                dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def msr(k, m):
    """The reference's msr codec at k=8; at k=10 the port's numpy one,
    whose tables tests/test_torch_msr.py holds equal to the reference's
    (the reference builds a k=10 decode table in about 9 s)."""
    factory = jregistry.factory if k == 8 else registry.factory
    return factory("msr", {"technique": "msr", "k": str(k), "m": str(m),
                           "w": "8"})


def msr_case(k, m, decode, n):
    codec = msr(k, m)
    if decode:
        avail = tuple(range(1, k + 1))
        bm = codec._decode_entry(avail)["bitmat"]
    else:
        bm = codec._bitmat
    return np.asarray(bm, dtype=np.uint8), rand_data(k + n, 2,
                                                     k * (k - 1), n), 8


def rs_case(k, m, w, n):
    coding = jgf.rs_vandermonde_generator(k, m, w)
    return jgf.generator_to_bitmatrix(coding, w), rand_data(w, 2, k, n), w


CASES = {
    "msr_k8_encode": lambda: msr_case(8, 7, False, 64),
    "msr_k8_decode": lambda: msr_case(8, 7, True, 64),
    "msr_k10_decode": lambda: msr_case(10, 9, True, 40),
    "rs_w16": lambda: rs_case(8, 3, 16, 2 * 70),
    "rs_w32": lambda: rs_case(4, 2, 32, 4 * 45),
    "random_512x128": lambda: (
        np.random.default_rng(5).integers(0, 2, (512, 128), dtype=np.uint8),
        rand_data(6, 1, 16, 64), 8),
    "ragged_n": lambda: rs_case(20, 4, 8, 32 * 3 + 7),
    "k5_w8_40_bits": lambda: rs_case(5, 3, 8, 50),
    "k3_w16_48_bits": lambda: rs_case(3, 2, 16, 2 * 33),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_equals_xla(case):
    bitmat, data, w = CASES[case]()
    assert data.shape[-2] * w == bitmat.shape[1]
    got = mma_encode(bitmat, data, w)
    assert np.array_equal(got, reference(case))


def test_msr_k8_decode_in_many_row_groups():
    """48 KiB of shared memory: the [840, 448] decode in 27 groups of 4
    N-tiles, the last one shorter; the same bytes."""
    bitmat, data, w = CASES["msr_k8_decode"]()
    assert len(plan.row_groups(840, 448, 48 * 1024)) == 27
    assert np.array_equal(mma_encode(bitmat, data, w, 48 * 1024),
                          reference("msr_k8_decode"))


def test_model_equals_pallas_in_interpret_mode():
    """One w=8 case with N % 512 == 0 against the Pallas kernel itself."""
    bitmat = CASES["random_512x128"]()[0][:64]
    data = rand_data(7, 1, 16, pallas_gf._TILE_N)
    want = np.asarray(pallas_gf.matrix_encode8(
        jnp.asarray(bitmat), jnp.asarray(data), interpret=True))
    assert np.array_equal(mma_encode(bitmat, data, 8), want)


def test_fragment_maps_compute_a_product():
    """The maps of step 4 alone: random 0/1 A and B placed in registers
    by the maps give D = A @ B back through the D map."""
    rng = np.random.default_rng(3)
    am = rng.integers(0, 2, (1, 16, 32))
    bm = rng.integers(0, 2, (32, 8))
    a = np.zeros((4, 1, 32), dtype=U32)
    b = np.zeros((2, 32), dtype=U32)
    for l in range(32):
        for r in range(4):
            row, col = G[l] + 8 * (r % 2), 4 * T[l] + 16 * (r // 2)
            a[r, 0, l] = sum(int(am[0, row, col + q]) << (8 * q)
                             for q in range(4))
        for r in range(2):
            b[r, l] = sum(int(bm[4 * T[l] + 16 * r + q, G[l]]) << (8 * q)
                          for q in range(4))
    d = np.zeros((4, 1, 32), dtype=np.int64)
    mma(d, a, b)
    want = am[0] @ bm
    for l in range(32):
        for i in range(4):
            assert d[i, 0, l] == want[G[l] + 8 * (i // 2), 2 * T[l] + i % 2]


def test_spread_nibble_and_k_order():
    """Lane t's A registers of K-tile kt hold bits 0-3 and 4-7 of column
    byte 4*kt + t, and its B registers the bitmatrix columns 32*kt + 8t
    ... 32*kt + 8t + 7: the same K order on both operands."""
    x = np.arange(16, dtype=U32)
    got = spread_nibble(x)
    want = sum(((x >> U32(q)) & U32(1)) << U32(8 * q) for q in range(4))
    assert np.array_equal(got, want)
    bm = np.zeros((8, 64), dtype=np.uint8)
    bm[5, 32 + 8 * 2 + 6] = 1               # row 5, K-tile 1, lane t=2, bit 6
    bs = stage_group(bm, 0, 4, 2)
    lane = 4 * 5 + 2
    assert bs[0, 0, lane].tolist() == [0, 0, 0, 1 << 16]
    assert bs.sum() == 1 << 16
    assert b_registers(bs, 2)[0, 1, :, lane].tolist() == [0, 1 << 16]


# -- the row-group plan -------------------------------------------------------

def groups_of(rows, span):
    return [(r, min(r + span, rows)) for r in range(0, rows, span)]


@pytest.mark.parametrize("rows,cols,limit,want", [
    (392, 448, H100_OPTIN, [(0, 392)]),
    (840, 448, H100_OPTIN, [(0, 448), (448, 840)]),
    (648, 720, H100_OPTIN, groups_of(648, 192)),
    (1368, 720, H100_OPTIN, groups_of(1368, 192)),
    (4224, 1088, H100_OPTIN, groups_of(4224, 128)),
    (840, 448, 48 * 1024, groups_of(840, 32)),
    (48, 128, H100_OPTIN, [(0, 48)]),
    (2048, 32, H100_OPTIN, [(0, 2048)]),
    (24, 1792, H100_OPTIN, [(0, 24)]),
], ids=["msr_encode", "msr_decode", "k10_encode", "k10_decode",
        "k17_decode_block", "default_48KiB", "rs_w16", "random_2048x32",
        "widest"])
def test_row_group_plan(rows, cols, limit, want):
    """The mma design's plan: as few balanced groups as the shared memory
    allows, each a multiple of 4 N-tiles (8 past 16 K-tiles) that fits
    beside the warps' data tiles, covering the rows in order."""
    groups = plan.row_groups(rows, cols, limit)
    assert groups == want
    assert groups[0][0] == 0 and groups[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    span = groups[0][1] - groups[0][0]
    s = plan.step(cols)
    assert len(groups) == 1 or span % (8 * s) == 0
    assert plan.mma_smem(cols, -(-span // (8 * s)) * s) <= limit


def test_row_group_plan_refuses_past_shared_memory():
    """k*w = 1,800 bits: even 8 N-tiles beside the data tiles pass an
    H100's opt-in limit, so one launch does not take it."""
    with pytest.raises(ValueError, match="shared memory"):
        plan.row_groups(8, 1800, H100_OPTIN)


@pytest.mark.parametrize("w,want", [(8, 224), (16, 112), (32, 56)])
def test_one_launch_takes_1792_bits_on_an_h100(w, want):
    """The widest k*w of one launch (gf_bitmatrix_max_k): 1,792 bits, the
    MSR code up to k = 15 (k*alpha*8 = 15*14*8 = 1,680)."""
    assert plan.max_k(w, H100_OPTIN) == want
    assert plan.group_tiles(8, want * w, H100_OPTIN) == 8
    assert plan.group_tiles(8, (want + 1) * w, H100_OPTIN) == 0
