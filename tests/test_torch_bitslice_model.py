"""Bit-level model of the bit-sliced GF(2^8) kernel, against the JAX package.

``ceph_tpu_torch/csrc/gf_bitmatrix.cu`` computes the w=8, k <= 16 encode
with a bit-sliced schedule (``gf_bitsliced_kernel``). This file restates
that schedule in numpy, one step per step of the kernel and on the same
uint32 words, so that a layout mistake shows on the CPU:

  1. a thread's 32 columns of data row j are 8 little-endian words; an
     8x8 bit transpose of each 8-byte group (three delta swaps) and a 4x4
     byte transpose (``__byte_perm``) turn them into 8 plane words, bit e
     of plane (j, s) being bit s of column e's byte of row j;
  2. the bitmatrix is expanded to one word per entry, 0 or 0xFFFFFFFF
     (``E``), with two masks per output row: a bit per 8x8 block equal
     to the identity (``id``) and per other nonzero block (``nz``);
  3. out plane (i, t) = XOR over the ``nz`` blocks (i, j) and s of
     plane (j, s) & E[i*8 + t][j*8 + s], one LOP3 each, and over the
     ``id`` blocks of plane (j, t);
  4. the 8 out planes go back to 32 bytes by the same two transposes in
     the reverse order.

The model is held bit for bit (tolerance: none) against
``ceph_tpu.ops.xor_mm.matrix_encode`` and, where N % 512 == 0, the Pallas
kernel ``pallas_gf.matrix_encode8`` in interpret mode. The CUDA kernel is
held against the port's plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp

from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import pallas_gf
from ceph_tpu.ops import xor_mm as jxor_mm

U32 = np.uint32
COLS = 32                       # columns (bytes of a row) per thread
ALL_ONES = U32(0xFFFFFFFF)


def kmax_of(k: int) -> int:
    """The kernel's template parameter: data rows held as planes."""
    return 4 if k <= 4 else 8 if k <= 8 else 16


# -- step 1 and 4: the two transposes -----------------------------------

def bit_transpose8(lo, hi):
    """8x8 bit transpose of the 8 bytes (lo = bytes 0-3, hi = bytes 4-7):
    bit 8r + c goes to bit 8c + r. Hacker's Delight 7-3, the 64-bit delta
    swaps written on the two 32-bit halves as the kernel does."""
    t = (lo ^ (lo >> U32(7))) & U32(0x00AA00AA)
    lo = lo ^ t ^ (t << U32(7))
    t = (hi ^ (hi >> U32(7))) & U32(0x00AA00AA)
    hi = hi ^ t ^ (t << U32(7))
    t = (lo ^ (lo >> U32(14))) & U32(0x0000CCCC)
    lo = lo ^ t ^ (t << U32(14))
    t = (hi ^ (hi >> U32(14))) & U32(0x0000CCCC)
    hi = hi ^ t ^ (t << U32(14))
    t = (lo ^ (hi << U32(4))) & U32(0xF0F0F0F0)
    return lo ^ t, hi ^ (t >> U32(4))


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    the 8 bytes y:x (x holds bytes 0-3)."""
    src = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
          [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = U32(0)
    for n in range(4):
        out = out | (src[(sel >> (4 * n)) & 7] << U32(8 * n))
    return out


def byte_transpose4(w0, w1, w2, w3):
    """4x4 byte transpose: byte g of output s is byte s of input g."""
    a = byte_perm(w0, w1, 0x5140)
    b = byte_perm(w0, w1, 0x7362)
    c = byte_perm(w2, w3, 0x5140)
    d = byte_perm(w2, w3, 0x7362)
    return (byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
            byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632))


def to_planes(words):
    """8 words of 32 column bytes -> 8 planes (bit e of plane s = bit s of
    byte e). words: list of 8 uint32 arrays (word q = bytes 4q..4q+3)."""
    w = list(words)
    for g in range(4):
        w[2 * g], w[2 * g + 1] = bit_transpose8(w[2 * g], w[2 * g + 1])
    return list(byte_transpose4(w[0], w[2], w[4], w[6])) + \
        list(byte_transpose4(w[1], w[3], w[5], w[7]))


def from_planes(planes):
    """Inverse of to_planes: both transposes are involutions, so they run
    again in the reverse order."""
    w = [None] * 8
    w[0], w[2], w[4], w[6] = byte_transpose4(*planes[0:4])
    w[1], w[3], w[5], w[7] = byte_transpose4(*planes[4:8])
    for g in range(4):
        w[2 * g], w[2 * g + 1] = bit_transpose8(w[2 * g], w[2 * g + 1])
    return w


# -- step 2: the expanded bitmatrix in shared memory ----------------------

def block_mask(flags: np.ndarray) -> np.ndarray:
    """[R/8, kmax] booleans -> [R/8] uint32, bit j = flags[:, j]."""
    shifts = np.arange(flags.shape[1], dtype=np.uint64)
    return (flags.astype(np.uint64) << shifts).sum(axis=1).astype(U32)


def expand(bitmat: np.ndarray, kmax: int):
    """E [R, kmax*8] words (0 or all ones; columns >= k*8 zero) and two
    [R/8] masks: nz, bit j set where block (i, j) has a one and is not
    the identity; id, where it is the identity."""
    rows, bits = bitmat.shape
    e = np.zeros((rows, kmax * 8), dtype=U32)
    e[:, :bits] = np.where(bitmat & 1, ALL_ONES, U32(0))
    blocks = (e.reshape(rows // 8, 8, kmax, 8) != 0).transpose(0, 2, 1, 3)
    ident = (blocks == np.eye(8, dtype=bool)).all(axis=(2, 3))
    nonzero = blocks.any(axis=(2, 3))
    return e, block_mask(nonzero & ~ident), block_mask(ident)


# -- the kernel, vectorised over its units (batch lane, 32 columns) ------

def bitsliced_encode(bitmat: np.ndarray, data: np.ndarray, stats=None):
    """[B, k, N] uint8 -> [B, R/8, N] uint8, as gf_bitsliced_kernel does.

    stats, a dict, receives the blocks the schedule visits: dense
    (LOP3s) and identity (plain XORs)."""
    rows, bits = bitmat.shape
    b, k, n = data.shape
    assert bits == k * 8 and k <= 16 and rows % 8 == 0
    kmax = kmax_of(k)
    chunks = -(-n // COLS)
    # ragged edge: bytes past N load as zero (the kernel's bounds mask)
    padded = np.zeros((b, k, chunks * COLS), dtype=np.uint8)
    padded[..., :n] = data
    words = padded.reshape(b, k, chunks, COLS).view("<u4")  # [b,k,ch,8]
    planes = []
    for j in range(kmax):
        if j < k:
            planes += to_planes([words[:, j, :, q] for q in range(8)])
        else:
            planes += [np.zeros((b, chunks), dtype=U32)] * 8
    e, nz, ident = expand(bitmat, kmax)
    out = np.zeros((b, rows // 8, chunks, COLS), dtype=np.uint8)
    dense = identity = 0
    for i in range(rows // 8):
        acc = [np.zeros((b, chunks), dtype=U32) for _ in range(8)]
        for j in range(kmax):           # warp-uniform tests
            if (int(ident[i]) >> j) & 1:
                identity += 1
                for t in range(8):
                    acc[t] = acc[t] ^ planes[j * 8 + t]
            elif (int(nz[i]) >> j) & 1:
                dense += 1
                for t in range(8):
                    for s in range(8):
                        acc[t] = acc[t] ^ (planes[j * 8 + s]
                                           & e[i * 8 + t, j * 8 + s])
        ow = np.stack(from_planes(acc), axis=-1).astype("<u4")
        out[:, i] = ow.view(np.uint8).reshape(b, chunks, COLS)
    if stats is not None:
        stats.update(dense=dense, identity=identity, blocks=(rows // 8) * k)
    return out.reshape(b, rows // 8, chunks * COLS)[..., :n]


# -- the reference ------------------------------------------------------

def reference(bitmat: np.ndarray, data: np.ndarray) -> list:
    """[xor_mm.matrix_encode] plus the Pallas kernel where it applies."""
    outs = [np.asarray(jxor_mm.matrix_encode(jnp.asarray(bitmat),
                                             jnp.asarray(data), 8))]
    if data.shape[-1] % pallas_gf._TILE_N == 0:
        outs.append(np.asarray(pallas_gf.matrix_encode8(
            jnp.asarray(bitmat), jnp.asarray(data), interpret=True)))
    return outs


def check(bitmat: np.ndarray, data: np.ndarray, stats=None) -> None:
    got = bitsliced_encode(bitmat, data, stats)
    for want in reference(bitmat, data):
        assert got.shape == want.shape
        assert np.array_equal(got, want)


def rand_data(seed: int, b: int, k: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, k, n),
                                                dtype=np.uint8)


def decode_bitmat(coding, k, avail):
    dec = jgf.decode_matrix(coding, k, avail, 8)
    full = np.concatenate([dec, jgf.gf_matmul(coding, dec, 8)], axis=0)
    return jgf.generator_to_bitmatrix(full, 8)


CODING_8_3 = jgf.rs_vandermonde_generator(8, 3, 8)
SIGNATURES = list(itertools.combinations(range(11), 8))


# -- tests of the primitives ----------------------------------------------

def test_bit_transpose8_is_the_transpose():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 63, 64, dtype=np.uint64)
    lo, hi = bit_transpose8((x & 0xFFFFFFFF).astype(U32),
                            (x >> np.uint64(32)).astype(U32))
    got = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    bits = ((x[:, None] >> np.arange(64, dtype=np.uint64)) & 1) \
        .reshape(-1, 8, 8)
    want_bits = bits.transpose(0, 2, 1).reshape(-1, 64)
    want = (want_bits << np.arange(64, dtype=np.uint64)).sum(axis=1)
    assert np.array_equal(got, want.astype(np.uint64))


def test_planes_hold_bit_s_of_byte_e_and_round_trip():
    rng = np.random.default_rng(1)
    cols = rng.integers(0, 256, (16, COLS), dtype=np.uint8)
    words = cols.view("<u4")
    planes = to_planes([words[:, q] for q in range(8)])
    for s in range(8):
        want = ((cols >> s) & 1).astype(np.uint64)
        want = (want << np.arange(COLS, dtype=np.uint64)).sum(axis=1)
        assert np.array_equal(planes[s].astype(np.uint64), want)
    back = np.stack(from_planes(planes), axis=-1).astype("<u4")
    assert np.array_equal(back.view(np.uint8), cols)


def test_expand_marks_nonzero_and_identity_blocks():
    bm = np.zeros((16, 24), dtype=np.uint8)
    bm[3, 9] = 1                         # block (0, 1)
    bm[15, 23] = 1                       # block (1, 2)
    bm[8:16, 0:8] = np.eye(8, dtype=np.uint8)   # block (1, 0)
    e, nz, ident = expand(bm, kmax_of(3))
    assert e.shape == (16, 32) and e[3, 9] == ALL_ONES and e.sum() == \
        10 * int(ALL_ONES)
    assert nz.tolist() == [0b010, 0b100]
    assert ident.tolist() == [0b000, 0b001]


def test_decode_skips_all_but_32_of_88_blocks():
    """Signature (3..10): the 3 erased data rows have 8 nonzero blocks
    each (one of them, a coefficient 1, the identity); every other output
    row is one identity block."""
    bm = decode_bitmat(CODING_8_3, 8, (3, 4, 5, 6, 7, 8, 9, 10))
    stats = {}
    check(bm, rand_data(2, 1, 8, 512), stats)
    assert stats == {"dense": 23, "identity": 9, "blocks": 88}


# -- the cases, each against the JAX package -------------------------------

@pytest.mark.parametrize("b,n", [(2, 1024), (3, 32 * 9 + 7), (1, 7)])
def test_encode_k8_m3(b, n):
    bm = jgf.generator_to_bitmatrix(CODING_8_3, 8)
    stats = {}
    check(bm, rand_data(n, b, 8, n), stats)
    # reed_sol_van's first parity row is all ones: 8 identity blocks
    assert stats == {"dense": 16, "identity": 8, "blocks": 24}


@pytest.mark.parametrize("avail", SIGNATURES, ids=lambda a: "".join(
    "%x" % i for i in a))
def test_every_decode_bitmatrix(avail):
    bm = decode_bitmat(CODING_8_3, 8, avail)
    assert bm.shape == (88, 64)
    check(bm, rand_data(sum(avail), 1, 8, 512))


@pytest.mark.parametrize("k,m", [(2, 1), (12, 4), (16, 4)])
@pytest.mark.parametrize("decode", [False, True])
def test_other_k(k, m, decode):
    coding = jgf.rs_vandermonde_generator(k, m, 8)
    if decode:
        avail = tuple(range(m, k + m))
        bm = decode_bitmat(coding, k, avail)
    else:
        bm = jgf.generator_to_bitmatrix(coding, 8)
    check(bm, rand_data(k, 2, k, 512))
    check(bm, rand_data(k + 1, 1, k, 32 * 3 + 7))


@pytest.mark.parametrize("k", [3, 8, 16])
def test_random_dense_bitmatrix(k):
    rng = np.random.default_rng(k)
    bm = rng.integers(0, 2, (40, k * 8), dtype=np.uint8)
    stats = {}
    check(bm, rand_data(k, 2, k, 512), stats)
    assert stats["dense"] == stats["blocks"]


@pytest.mark.parametrize("k", [5, 8, 16])
def test_bitmatrix_with_zero_blocks(k):
    rng = np.random.default_rng(100 + k)
    rows = 48
    bm = rng.integers(0, 2, (rows, k * 8), dtype=np.uint8)
    keep = rng.random((rows // 8, k)) < 0.4
    keep[1] = False                     # an all-zero output row
    bm = bm * np.repeat(np.repeat(keep, 8, 0), 8, 1).astype(np.uint8)
    stats = {}
    got_ref = reference(bm, rand_data(k, 2, k, 512))
    assert not got_ref[0][:, 1].any()
    check(bm, rand_data(k, 2, k, 512), stats)
    assert stats["dense"] + stats["identity"] == int(keep.sum())


@pytest.mark.parametrize("n", [32 * 1 + 7, 32 * 16 + 7, 32 * 40 + 7])
def test_ragged_n(n):
    bm = decode_bitmat(CODING_8_3, 8, (0, 1, 2, 4, 5, 6, 9, 10))
    check(bm, rand_data(n, 2, 8, n))
