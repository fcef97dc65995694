"""Model of K1's one-launch CRC design, against the JAX package.

``ceph_tpu_torch/csrc/write_transform.cu`` computes the CRC-32 of strided
rows (K1, ``crc_rows_kernel``), porting ``ceph_tpu/osd/fused_transform.py``
``_crc_raw_tree``, ``_crc32_full``, ``_crc_unshift`` and ``device_crc32``.
This file restates its design in numpy, on the same uint32 words, so that
a mistake in the schedule shows on the CPU:

  1. slicing tables: T_0 is the polynomial's byte table and
     T_k[b] = (T_{k-1}[b] >> 8) ^ T_0[T_{k-1}[b] & 0xFF]; a 16-byte word
     x (with the register XORed into its first 4 bytes) steps the
     register to XOR over byte i of T_{15-i}[x_i];
  2. the row is front-padded with zeros to whole spans of 32 units of 64
     bytes (128 for an aligned row of 2049..4096 bytes, which one warp
     then takes whole); lane l of the warp of span s owns unit s*32 + l
     and starts
     from a register of 0, which the leading zeros leave at 0; the
     register is XORed with 0xFFFFFFFF where the row's first byte enters
     (the init constant, folded into the data: no shift_len at all);
     16-byte words on the aligned path, the byte table on the byte path;
  3. the warp combines its 32 units in a 5-level shuffle tree, level l
     applying the "append 2^l units" matrix to the left half;
  4. a row of one span is done; otherwise each warp carries its span's
     word past the spans after it (the "append 2^l bytes" matrices of the
     set bits of that byte count) and stores it, and the last warp of the
     row to arrive (an arrival counter) XORs the row's words;
  5. the result is un-shifted by the pad (the inverse matrices of the
     pad's set bits) and XORed with 0xFFFFFFFF; a row of 0 bytes gives
     the register 0xFFFFFFFF before the un-shift.

The model is held value for value (tolerance: none) against
``_crc32_full`` (and ``_crc_raw_tree`` with ``_crc_unshift`` for pads),
``device_crc32``, ``crc32c_host`` and ``zlib.crc32`` on ragged lengths,
strided shard streams and pads, on both of its paths. The CUDA kernel is
held against the port's plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ceph_tpu.osd import fused_transform as jft
from ceph_tpu_torch.ops import write_kernels
from ceph_tpu_torch.osd import fused_transform as ft

from .torch_util import one_torch_thread  # noqa: F401

U32 = np.uint32
ONES = U32(0xFFFFFFFF)
RUN, WIDE_RUN, SPAN_UNITS = 64, 128, 32
SPAN = RUN * SPAN_UNITS             # bytes a warp covers
POLYS = {"zlib": ft.POLY_ZLIB, "crc32c": ft.POLY_C}
# the reference's steps, each compiled once: rows go in front-padded with
# zero bytes to one shape (a no-op for the raw CRC, the reference's own
# padding), each with the init constant of its true length
_JAX_FULL = jax.jit(jft._crc32_full)
_JAX_RAW = jax.jit(jft._crc_raw_tree)
_JAX_UNSHIFT = jax.jit(jft._crc_unshift)
JAX_ROWS, JAX_WIDTH = 3, 8192


def front_pad(rows_np: np.ndarray) -> np.ndarray:
    """[r <= JAX_ROWS, L <= JAX_WIDTH] -> [JAX_ROWS, JAX_WIDTH], the rows'
    bytes at the end of each row."""
    out = np.zeros((JAX_ROWS, JAX_WIDTH), dtype=np.uint8)
    out[:rows_np.shape[0], JAX_WIDTH - rows_np.shape[1]:] = rows_np
    return out


def consts(poly: int):
    """(T [16, 256], shift [31, 32], inv [31, 32]) uint32 from the port's
    constants, as the kernel reads them."""
    c = ft._poly_consts(poly).packed().astype(U32)
    assert c.size == write_kernels.CONSTS_WORDS
    lv = write_kernels.LEVELS
    table0 = c[:256]
    shift = c[256:256 + lv * 32].reshape(lv, 32)
    inv = c[256 + lv * 32:256 + 2 * lv * 32].reshape(lv, 32)
    slices = c[256 + 2 * lv * 32:].reshape(15, 256)
    return np.concatenate([table0[None], slices]), shift, inv


def mat_apply(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """M.x for 32 column masks, on an array of registers."""
    r = np.zeros_like(x)
    for j in range(32):
        r ^= np.where((x >> U32(j)) & U32(1), cols[j], U32(0))
    return r


def unit_bytes(length: int, vec: bool) -> int:
    """The kernel's unit: 128 bytes for an aligned row of 2049..4096
    bytes (one span), else 64."""
    return WIDE_RUN if vec and SPAN < length <= WIDE_RUN * SPAN_UNITS \
        else RUN


def unit_crcs(buf, rows, length, row_stride, seg_stride, seglen, tables,
              vec, run):
    """[rows, spans*32] raw registers of every unit (step 2), all units at
    once: a unit's bytes before the row's data are skipped, the register
    takes 0xFFFFFFFF where logical byte 0 enters, then 16-byte slicing
    steps (aligned path) or byte-table steps (byte path)."""
    span = run * SPAN_UNITS
    spans = max(1, -(-length // span))
    lead = spans * span - length
    units = spans * SPAN_UNITS
    p = np.arange(units)[:, None] * run - lead + np.arange(run)  # [units, run]
    seg, off = np.divmod(np.maximum(p, 0), max(seglen, 1))
    addr = (np.arange(rows)[:, None, None] * row_stride + seg * seg_stride
            + off)                                              # segment walk
    data = np.zeros(addr.shape, dtype=U32)
    data[:, p >= 0] = buf[addr[:, p >= 0]]
    reg = np.zeros((rows, units), dtype=U32)
    step = 16 if vec else 1
    for at in range(0, run, step):
        start = p[:, at]                        # the step's logical byte
        reg = np.where(start == 0, reg ^ ONES, reg)
        if vec:
            w = data[:, :, at:at + 16]
            x = (w[..., 0] | (w[..., 1] << U32(8)) | (w[..., 2] << U32(16))
                 | (w[..., 3] << U32(24))) ^ reg
            new = np.zeros_like(reg)
            for i in range(16):
                byte = (x >> U32(8 * i)) & U32(0xFF) if i < 4 else w[..., i]
                new ^= tables[15 - i][byte]
        else:
            new = tables[0][(reg ^ data[:, :, at]) & U32(0xFF)] ^ \
                (reg >> U32(8))
        reg = np.where(start >= 0, new, reg)    # leading zeros: skipped
    return reg, spans


def warp_tree(v: np.ndarray, shift: np.ndarray, level0: int) -> np.ndarray:
    """[..., 32] lane words -> [...]: the shuffle tree, level l applying
    shift[level0 + l] to the left half (step 3)."""
    lanes = np.arange(32)
    for lv in range(5):
        partner = v[..., lanes ^ (1 << lv)]
        right_lane = (lanes >> lv) & 1
        left = np.where(right_lane, partner, v)
        right = np.where(right_lane, v, partner)
        v = mat_apply(shift[level0 + lv], left) ^ right
    assert (v == v[..., :1]).all()      # every lane holds the result
    return v[..., 0]


def shift_bytes(shift: np.ndarray, reg: np.ndarray, n: int,
                level: int) -> np.ndarray:
    """The registers after appending n * 2^level zero bytes."""
    while n:
        if n & 1:
            reg = mat_apply(shift[level], reg)
        n >>= 1
        level += 1
    return reg


def combine_spans(partial: np.ndarray, shift: np.ndarray,
                  span_level: int) -> np.ndarray:
    """[rows, spans] span words -> [rows] (step 4): each word carried
    past the spans after it, then the last warp's XOR."""
    rows, spans = partial.shape
    words = np.stack([shift_bytes(shift, partial[:, s], spans - 1 - s,
                                  span_level) for s in range(spans)], axis=1)
    return np.bitwise_xor.reduce(words, axis=1)


def k1_model(buf, rows, length, row_stride, seg_stride, seglen, poly,
             pad=None, vec=True):
    tables, shift, inv = consts(poly)
    run = unit_bytes(length, vec)
    units, spans = unit_crcs(buf, rows, length, row_stride, seg_stride,
                             seglen, tables, vec, run)
    level = run.bit_length() - 1        # log2 of the unit
    span_words = warp_tree(units.reshape(rows, spans, 32), shift, level)
    reg = span_words[:, 0] if spans == 1 else combine_spans(
        span_words, shift, level + 5)
    if length == 0:
        reg = np.full(rows, ONES, dtype=U32)
    if pad is not None:
        for lv in range(write_kernels.LEVELS):
            if (pad >> lv) & 1:
                reg = mat_apply(inv[lv], reg)
    return reg ^ ONES


def contiguous_model(rows_np: np.ndarray, poly, pad=None, vec=True):
    rows, length = rows_np.shape
    return k1_model(rows_np.reshape(-1), rows, length, length, length,
                    max(length, 1), poly, pad, vec)


def jax_full(rows_np: np.ndarray, poly) -> np.ndarray:
    """_crc32_full of each row, its true length in the init constant."""
    pc = jft._poly_consts(poly)
    init = U32(pc.shift_n(0xFFFFFFFF, rows_np.shape[1]))
    return np.asarray(_JAX_FULL(
        jnp.asarray(front_pad(rows_np)), jnp.asarray(pc.table),
        jnp.asarray(pc.shift), jnp.uint32(init)))[:rows_np.shape[0]]


def test_consts_hold_the_slicing_tables():
    for poly in POLYS.values():
        tables, _, _ = consts(poly)
        assert np.array_equal(tables[0], jft._poly_consts(poly).table)
        for k in range(1, 16):
            prev = tables[k - 1]
            assert np.array_equal(tables[k], (prev >> U32(8)) ^
                                  tables[0][prev & U32(0xFF)])


@pytest.mark.parametrize("poly", sorted(POLYS))
@pytest.mark.parametrize("length", [1, 15, 16, 96, 2048, 2064, 4096, 4097,
                                    6244])
def test_ragged_rows_match_jax_and_host_oracles(one_torch_thread, poly,
                                                length):
    rows_np = np.random.default_rng(length).integers(
        0, 256, (3, length), dtype=np.uint8)
    want = jax_full(rows_np, POLYS[poly])
    oracle = zlib.crc32 if poly == "zlib" else ft.crc32c_host
    assert [int(v) for v in want] == [oracle(r.tobytes()) for r in rows_np]
    for vec in ((True, False) if length % 16 == 0 else (False,)):
        assert np.array_equal(contiguous_model(rows_np, POLYS[poly],
                                               vec=vec), want)


def test_empty_rows(one_torch_thread):
    rows_np = np.zeros((2, 0), dtype=np.uint8)
    for poly in POLYS.values():
        assert list(contiguous_model(rows_np, poly, vec=False)) == [0, 0]


def test_many_spans_match_zlib_and_device_crc32(one_torch_thread):
    """Rows of 65539 bytes (33 spans) and 4 * 2048 * 32 + 16 bytes (129
    spans), on both paths."""
    rng = np.random.default_rng(7)
    for length in (65539, 4 * SPAN * 32 + 16):
        row = rng.integers(0, 256, (1, length), dtype=np.uint8)
        want = zlib.crc32(row.tobytes())
        assert int(contiguous_model(row, ft.POLY_ZLIB, vec=False)[0]) == want
        if length % 16 == 0:
            assert int(contiguous_model(row, ft.POLY_ZLIB)[0]) == want
    assert jft.device_crc32(row.tobytes()) == want


@pytest.mark.parametrize("shape,pad_stripes", [((5, 3, 96), 0),
                                               ((5, 3, 96), 2),
                                               ((9, 2, 64), 7),
                                               ((3, 2, 40), 1)])
def test_strided_shard_streams_with_pad_match_jax(one_torch_thread, shape,
                                                  pad_stripes):
    """Shard streams read in place from [S, n, chunk] at a segment
    stride, un-shifted by a pad of zero stripes."""
    s_, n, chunk = shape
    data = np.random.default_rng(s_ * chunk).integers(
        0, 256, shape, dtype=np.uint8)
    data[s_ - pad_stripes:] = 0
    pad = pad_stripes * chunk
    streams = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(
        n, s_ * chunk)
    pc = jft._poly_consts(ft.POLY_ZLIB)
    reg = np.asarray(_JAX_RAW(
        jnp.asarray(front_pad(streams)), jnp.asarray(pc.table),
        jnp.asarray(pc.shift))) ^ U32(pc.shift_n(0xFFFFFFFF, s_ * chunk))
    want = (np.asarray(_JAX_UNSHIFT(
        jnp.asarray(reg), jnp.asarray(pc.inv), jnp.uint32(pad))) ^ ONES)[:n]
    assert [int(v) for v in want] == [
        zlib.crc32(np.ascontiguousarray(data[:s_ - pad_stripes, i]).tobytes())
        for i in range(n)]
    for vec in ((True, False) if chunk % 16 == 0 else (False,)):
        got = k1_model(data.reshape(-1), n, s_ * chunk, chunk, n * chunk,
                       chunk, ft.POLY_ZLIB, pad, vec)
        assert np.array_equal(got, want)


def test_plain_version_reads_the_new_consts(one_torch_thread):
    """crc32_rows_plain on the consts with the slicing tables appended."""
    rows_np = np.random.default_rng(11).integers(0, 256, (4, 4097),
                                                 dtype=np.uint8)
    for poly in POLYS.values():
        dev = torch.from_numpy(ft._poly_consts(poly).packed().view(
            np.int32)).view(torch.uint32)
        got = write_kernels.crc32_rows(torch.from_numpy(rows_np)[:, None],
                                       dev)
        assert np.array_equal(got.view(torch.int32).numpy().view(U32),
                              contiguous_model(rows_np, poly, vec=False))
