"""Exact numpy reference implementations of the codec math (the oracle).

Port of ``ceph_tpu/ops/gf_ref.py`` (a numpy copy of the element layout;
the packet layout waits for the bitmatrix techniques' slice).

Everything the GPU kernels produce must be bit-identical to these functions
(BASELINE.md correctness gate: "jax_tpu output bit-identical to the CPU
reference implementation for the same profile"). They are deliberately
simple and unoptimized.

The layout ported here is the "matrix" (element) layout of the
reference's jerasure plugin (src/erasure-code/jerasure/ErasureCodeJerasure.cc):
a chunk is a flat array of w-bit little-endian elements; parity element p =
sum_GF gen[i,j] * data element at the same position (jerasure_matrix_encode
semantics, w in {8,16,32}). It reduces to an XOR-accumulated selection,
i.e. a binary matmul mod 2.
"""

from __future__ import annotations

import numpy as np

from . import gf


def _elem_dtype(w: int):
    return {8: np.uint8, 16: np.dtype("<u2"), 32: np.dtype("<u4")}[w]


def matrix_encode_ref(coding: np.ndarray, data: np.ndarray, w: int) -> np.ndarray:
    """Element-wise GF(2^w) encode. data: [k, N] uint8 -> [m, N] uint8.

    N must be a multiple of w//8.
    """
    coding = np.asarray(coding, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = coding.shape
    assert data.shape[0] == k
    n = data.shape[1]
    assert n % (w // 8) == 0
    elems = data.view(_elem_dtype(w)).reshape(k, -1)
    out = np.zeros((m, elems.shape[1]), dtype=_elem_dtype(w))
    if w == 8:
        mul = gf.gf8_mul_table()
        for i in range(m):
            acc = np.zeros(elems.shape[1], dtype=np.uint8)
            for j in range(k):
                acc ^= mul[int(coding[i, j])][elems[j]]
            out[i] = acc
    elif w == 16:
        exp, log = gf.exp_log_tables(16)
        for i in range(m):
            acc = np.zeros(elems.shape[1], dtype=np.int64)
            for j in range(k):
                g = int(coding[i, j])
                if g == 0:
                    continue
                e = elems[j].astype(np.int64)
                prod = exp[log[e] + log[g]]
                prod[e == 0] = 0
                acc ^= prod
            out[i] = acc.astype(_elem_dtype(16))
    else:
        # Bitplane path (exact for any w, used for w=32).
        bitmat = gf.generator_to_bitmatrix(coding, w)
        bits = _unpack_element_bits(data, w)          # [k*w, ne]
        out_bits = (bitmat.astype(np.int64) @ bits.astype(np.int64)) & 1
        return _pack_element_bits(out_bits.astype(np.uint8), m, w)
    return out.view(np.uint8).reshape(m, n)


def _unpack_element_bits(data: np.ndarray, w: int) -> np.ndarray:
    """[k, N] uint8 -> [k*w, N*8//w] bits (bit c of element at row i*w+c)."""
    k, n = data.shape
    wb = w // 8
    ne = n // wb
    x = data.reshape(k, ne, wb)
    bits = (x[..., None] >> np.arange(8)) & 1        # [k, ne, wb, 8]
    bits = np.moveaxis(bits, 1, -1)                  # [k, wb, 8, ne]
    return bits.reshape(k * w, ne).astype(np.uint8)


def _pack_element_bits(bits: np.ndarray, m: int, w: int) -> np.ndarray:
    """[m*w, ne] bits -> [m, ne*w//8] uint8."""
    wb = w // 8
    ne = bits.shape[1]
    x = bits.reshape(m, wb, 8, ne)
    byts = (x << np.arange(8)[None, None, :, None]).sum(axis=2).astype(np.uint8)
    byts = np.moveaxis(byts, 1, -1)                  # [m, ne, wb]
    return byts.reshape(m, ne * wb)


def decode_ref(coding: np.ndarray, k: int, w: int, chunks: dict) -> dict:
    """Reconstruct all k+m chunks from any >=k available ones (oracle).

    chunks maps chunk index -> [N] uint8. Returns the full dict.
    """
    coding = np.asarray(coding, dtype=np.int64)
    m = coding.shape[0]
    avail = sorted(chunks)
    data_avail = [i for i in avail]
    use = data_avail[:k]
    dec = gf.decode_matrix(coding, k, use, w)
    stacked = np.stack([chunks[i] for i in use])
    data = matrix_encode_ref(dec, stacked, w)
    out = {i: data[i] for i in range(k)}
    parity = matrix_encode_ref(coding, data, w)
    for i in range(m):
        out[k + i] = parity[i]
    for i in avail:
        out[i] = np.asarray(chunks[i], dtype=np.uint8)
    return out
