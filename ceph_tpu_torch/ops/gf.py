"""Galois-field GF(2^w) arithmetic and generator-matrix construction.

Port of ``ceph_tpu/ops/gf.py`` (a numpy copy; the Cauchy constructions
wait for the slice that ports the Cauchy techniques). This is the
host-side math that prepares the (tiny) generator / decode matrices; the
bulk per-byte work never happens here — it is compiled into binary
"bitplane" matrices (see :func:`generator_to_bitmatrix`) and executed by
the GF bitmatrix kernel behind :mod:`ceph_tpu_torch.ops.xor_mm`.

Behavioral parity targets (studied in the reference, reimplemented from the
underlying published algorithms — Plank's jerasure/RS tutorials and the
Cauchy-RS literature):
  - technique/parameter space of the jerasure plugin
    (src/erasure-code/jerasure/ErasureCodeJerasure.cc:150-496,
    w in {8,16,32} for RS, bitmatrix techniques for Cauchy/Liberation)
  - matrix->bitmatrix decomposition used by the bitmatrix techniques
    (jerasure_matrix_to_bitmatrix call at ErasureCodeJerasure.cc:301)

All scalar arithmetic uses exact Python ints (carryless polynomial multiply +
reduction); matrices are numpy object-free int64 arrays. Everything is exact.
"""

from __future__ import annotations

import functools

import numpy as np

# gf-complete's default primitive polynomials (public constants; the w we
# must support for jerasure parity is {8, 16, 32}, small odd w appear in
# Liberation/Blaum-Roth bitmatrix codes which do not use GF multiply).
PRIM_POLY = {
    2: 0x7,
    3: 0xB,
    4: 0x13,
    5: 0x25,
    6: 0x43,
    7: 0x89,
    8: 0x11D,
    9: 0x211,
    10: 0x409,
    11: 0x805,
    12: 0x1053,
    13: 0x201B,
    14: 0x4143,
    15: 0x8003,
    16: 0x1100B,
    17: 0x20009,
    18: 0x40081,
    19: 0x80027,
    20: 0x100009,
    21: 0x200005,
    22: 0x400003,
    23: 0x800021,
    24: 0x1000087,
    25: 0x2000009,
    26: 0x4000047,
    27: 0x8000027,
    28: 0x10000009,
    29: 0x20000005,
    30: 0x40000053,
    31: 0x80000009,
    # gf-complete writes polys without the implicit leading term; here the
    # degree-w bit must be present for reduction (x^32 + x^22 + x^2 + x + 1).
    32: 0x100400007,
}


def clmul(a: int, b: int) -> int:
    """Carryless (polynomial over GF(2)) multiply of two nonnegative ints."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def poly_mod(a: int, poly: int, w: int) -> int:
    """Reduce polynomial a modulo poly (degree w)."""
    for bit in range(a.bit_length() - 1, w - 1, -1):
        if a >> bit & 1:
            a ^= poly << (bit - w)
    return a


def gf_mult(a: int, b: int, w: int) -> int:
    return poly_mod(clmul(a, b), PRIM_POLY[w], w)


def gf_pow(a: int, n: int, w: int) -> int:
    r = 1
    while n:
        if n & 1:
            r = gf_mult(r, a, w)
        a = gf_mult(a, a, w)
        n >>= 1
    return r


def gf_inv(a: int, w: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF inverse of 0")
    return gf_pow(a, (1 << w) - 2, w)


# ---------------------------------------------------------------------------
# w=8 and w=16 dense tables for the numpy reference path (exact, host-only).


@functools.lru_cache(maxsize=None)
def exp_log_tables(w: int):
    """Return (exp, log) tables for GF(2^w) with generator 2.

    exp has 2*(2^w - 1) entries so exp[log[a] + log[b]] needs no modulo.
    log[0] is undefined (set to 0; callers must special-case zero).
    """
    order = (1 << w) - 1
    exp = np.zeros(2 * order, dtype=np.int64)
    log = np.zeros(1 << w, dtype=np.int64)
    x = 1
    for i in range(order):
        exp[i] = x
        exp[i + order] = x
        log[x] = i
        x = gf_mult(x, 2, w)
    assert x == 1, "2 must be primitive for this poly"
    return exp, log


@functools.lru_cache(maxsize=None)
def gf8_mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) multiplication table (uint8)."""
    exp, log = exp_log_tables(8)
    a = np.arange(256)
    t = exp[(log[a][:, None] + log[a][None, :])].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


# ---------------------------------------------------------------------------
# Bitplane ("bitmatrix") decomposition.


def gf_mult_bitmatrix(g: int, w: int) -> np.ndarray:
    """[w, w] 0/1 matrix M with bits(g*x) = M @ bits(x) mod 2.

    Column c holds the bits of g * 2^c; bit r of the product y = g*x is
    sum_c x_c * bit_r(g * 2^c) mod 2.
    """
    m = np.zeros((w, w), dtype=np.uint8)
    for c in range(w):
        prod = gf_mult(g, 1 << c, w)
        for r in range(w):
            m[r, c] = (prod >> r) & 1
    return m


def generator_to_bitmatrix(gen: np.ndarray, w: int) -> np.ndarray:
    """Expand an [m, k] GF(2^w) generator into an [m*w, k*w] 0/1 matrix.

    Same decomposition the reference's bitmatrix techniques rely on
    (jerasure_matrix_to_bitmatrix at ErasureCodeJerasure.cc:301): block
    (i, j) is the w x w multiply-by-gen[i,j] matrix.
    """
    gen = np.asarray(gen)
    m, k = gen.shape
    out = np.zeros((m * w, k * w), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i * w:(i + 1) * w, j * w:(j + 1) * w] = gf_mult_bitmatrix(
                int(gen[i, j]), w)
    return out


# ---------------------------------------------------------------------------
# Small exact matrix algebra over GF(2^w) (host side; matrices are <= 32x32).


def gf_matmul(a: np.ndarray, b: np.ndarray, w: int) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    n, p = a.shape
    p2, q = b.shape
    assert p == p2
    out = np.zeros((n, q), dtype=np.int64)
    for i in range(n):
        for j in range(q):
            acc = 0
            for t in range(p):
                acc ^= gf_mult(int(a[i, t]), int(b[t, j]), w)
            out[i, j] = acc
    return out


def gf_invert_matrix(a: np.ndarray, w: int) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^w). Raises ValueError if singular."""
    a = np.asarray(a, dtype=np.int64).copy()
    n = a.shape[0]
    assert a.shape == (n, n)
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r, col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^%d)" % w)
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pv = gf_inv(int(a[col, col]), w)
        for j in range(n):
            a[col, j] = gf_mult(int(a[col, j]), pv, w)
            inv[col, j] = gf_mult(int(inv[col, j]), pv, w)
        for r in range(n):
            if r != col and a[r, col]:
                f = int(a[r, col])
                for j in range(n):
                    a[r, j] ^= gf_mult(f, int(a[col, j]), w)
                    inv[r, j] ^= gf_mult(f, int(inv[col, j]), w)
    return inv


# ---------------------------------------------------------------------------
# Generator constructions.


def rs_vandermonde_generator(k: int, m: int, w: int) -> np.ndarray:
    """[m, k] systematic Reed-Solomon coding matrix (Vandermonde derived).

    V[i, j] = i**j for i in 0..k+m-1 (distinct evaluation points; requires
    k + m <= 2^w). Any k rows of V are independent, so C = V[k:] @ inv(V[:k])
    yields a systematic generator [I; C] whose every k-row subset is
    invertible (MDS). This mirrors the role of
    reed_sol_vandermonde_coding_matrix (ErasureCodeJerasure.cc:199) without
    reproducing jerasure's exact row operations.
    """
    if k + m > (1 << w):
        raise ValueError("k+m=%d exceeds field size 2^%d" % (k + m, w))
    v = np.zeros((k + m, k), dtype=np.int64)
    for i in range(k + m):
        for j in range(k):
            v[i, j] = gf_pow(i, j, w) if not (i == 0 and j == 0) else 1
    top_inv = gf_invert_matrix(v[:k], w)
    c = gf_matmul(v[k:], top_inv, w)
    # Normalize so the first parity row is all ones (as jerasure's
    # reed_sol_vandermonde_coding_matrix guarantees): scale parity column j
    # by inv(C[0,j]). Column scaling of the parity block is equivalent to
    # scaling column j of [I; C] then rescaling data row j — both preserve
    # every k x k subdeterminant, so the code stays systematic and MDS.
    # This enables the single-erasure XOR fast path (isa/xor_op analog).
    for j in range(k):
        f = gf_inv(int(c[0, j]), w)
        for i in range(m):
            c[i, j] = gf_mult(int(c[i, j]), f, w)
    return c


def rs_r6_generator(k: int, w: int) -> np.ndarray:
    """[2, k] RAID6 P+Q coding matrix: P = sum d_i, Q = sum 2^i * d_i.

    Same P/Q construction as reed_sol_r6_coding_matrix
    (ErasureCodeJerasure.cc:250). MDS requires the 2^j to be distinct,
    i.e. k <= 2^w - 1.
    """
    if k > (1 << w) - 1:
        raise ValueError("k=%d exceeds 2^%d - 1; P+Q is not MDS" % (k, w))
    gen = np.zeros((2, k), dtype=np.int64)
    gen[0, :] = 1
    for j in range(k):
        gen[1, j] = gf_pow(2, j, w)
    return gen


def systematic_full_generator(coding: np.ndarray, k: int) -> np.ndarray:
    """Stack [I_k; coding] -> [(k+m), k] full generator."""
    coding = np.asarray(coding, dtype=np.int64)
    return np.concatenate([np.eye(k, dtype=np.int64), coding], axis=0)


def decode_matrix(coding: np.ndarray, k: int, avail_rows, w: int) -> np.ndarray:
    """[k, k] matrix mapping k available chunk rows -> original data rows.

    avail_rows are indices into the k+m chunk space (sorted, len == k).
    """
    full = systematic_full_generator(coding, k)
    sub = full[np.asarray(sorted(avail_rows), dtype=np.int64)]
    return gf_invert_matrix(sub, w)
