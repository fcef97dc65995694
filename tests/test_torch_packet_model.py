"""Model of the packet kernel's staged design, against the JAX package.

``ceph_tpu_torch/csrc/gf_packet.cu`` computes the packet-layout product
(``ceph_tpu/ops/xor_mm.py:bitmatrix_encode``) for 16-byte aligned
geometries with its staged design (``gf_packet_staged_kernel``). This
file restates that design in numpy, step by step, so that a tiling or
indexing mistake shows on the CPU:

  1. the tile: the largest power of two from 16 up to the packetsize P
     with k*w tiles within one 32 KiB buffer, taken only if it is at
     least min(P, 128) bytes (``stage_tile``); the last tile of a packet
     may be partial;
  2. the work items: (batch, superblock, tile) in that order, one per
     block at a time (two buffers alternate, which changes when a copy
     runs, not what it holds);
  3. the copy: 16-byte chunk idx of the item goes to input packet
     c = idx // (tile/16) at byte (idx % (tile/16))*16 of the tile, and
     chunks past the packet's end are not copied (the model fills the
     stage with other bytes first, so that a read of them shows);
  4. the lists: bit t of word q of row r's masks is bitmat[r, q*32 + t],
     and row r's list holds the byte offset c * tile of every set column
     c, walked from the masks lowest bit first;
  5. the product: output (r, 16-byte column x) XORs the stage word at
     offset x of each listed column, eight at a time into two
     accumulators, and goes to output packet r of the superblock at byte
     t0 + x.

The model is held byte for byte (tolerance: none) against
``ceph_tpu.ops.xor_mm.bitmatrix_encode`` on the Cauchy k=10, m=4 encode
and a decode bitmatrix, the liberation, blaum_roth and liber8tion
bitmatrices and random ones, with S >= 2 superblocks and partial tiles.
The CUDA kernel is held against the port's plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ceph_tpu.ops import xor_mm as jxor_mm
from ceph_tpu_torch import registry
from ceph_tpu_torch.ops import gf

from .torch_util import one_torch_thread  # noqa: F401

STAGE_BYTES = 32 * 1024
MIN_TILE = 128
VEC = 16


def stage_tile(cols: int, packet: int) -> int:
    """Bytes of each input packet a staged tile holds, 0 where the staged
    design does not take the geometry (``stage_tile`` in the kernel)."""
    cap = STAGE_BYTES // cols
    if cap < VEC:
        return 0
    tile = VEC
    while tile < packet and 2 * tile <= cap:
        tile *= 2
    return tile if tile >= packet or tile >= MIN_TILE else 0


def design(cols: int, packet: int, aligned: bool = True) -> str:
    """The design the entry point picks where shared memory holds the
    masks (``pick`` in the kernel)."""
    if not aligned or packet % VEC:
        return "byte"
    return "staged" if stage_tile(cols, packet) else "vector"


def pack_masks(bitmat: np.ndarray) -> np.ndarray:
    """[rows, cols] 0/1 -> [rows, ceil(cols/32)] uint32 row masks."""
    rows, cols = bitmat.shape
    nw = -(-cols // 32)
    padded = np.zeros((rows, nw * 32), dtype=np.uint64)
    padded[:, :cols] = bitmat & 1
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (padded.reshape(rows, nw, 32) * weights).sum(-1).astype(np.uint32)


def set_bits(word: int):
    """The bits of a mask word in the order __ffs walks them."""
    while word:
        bit = (word & -word).bit_length() - 1
        word &= word - 1
        yield bit


def staged_model(bitmat: np.ndarray, data: np.ndarray, w: int,
                 packet: int) -> np.ndarray:
    rows, cols = bitmat.shape
    batch, k, n = data.shape
    assert cols == k * w and design(cols, packet) == "staged"
    tile = stage_tile(cols, packet)
    supers = n // (w * packet)
    tiles = -(-packet // tile)
    vcols = tile // VEC
    masks = pack_masks(bitmat)
    lists = [[(q * 32 + bit) * tile for q, word in enumerate(row)
              for bit in set_bits(int(word))] for row in masks]
    assert all(off < 1 << 16 for row in lists for off in row)   # uint16
    out = np.zeros((batch, rows // w, n), dtype=np.uint8)
    written = np.zeros(out.shape, dtype=np.int64)
    junk = np.random.default_rng(99)
    for item in range(batch * supers * tiles):
        b, rem = divmod(item, supers * tiles)
        s, t = divmod(rem, tiles)
        t0 = t * tile
        stage = junk.integers(0, 256, (cols, tile), dtype=np.uint8)
        for idx in range(cols * vcols):          # the copy
            c, x = divmod(idx, vcols)
            x *= VEC
            if t0 + x < packet:
                j, u = divmod(c, w)
                src = s * w * packet + u * packet + t0 + x
                stage[c, x:x + VEC] = data[b, j, src:src + VEC]
        valid = min(tile, packet - t0)            # columns of this tile
        for r in range(rows):                     # threads (r, x), x < valid
            acc = np.zeros(valid, dtype=np.uint8)
            for off in lists[r]:
                c, rest = divmod(off, tile)
                assert rest == 0
                acc ^= stage[c, :valid]
            i, tt = divmod(r, w)
            dst = s * w * packet + tt * packet + t0
            out[b, i, dst:dst + valid] = acc
            written[b, i, dst:dst + valid] += 1
    assert (written == 1).all(), "every output byte written exactly once"
    return out


def reference(bitmat, data, w, packet):
    return np.asarray(jxor_mm.bitmatrix_encode(
        jnp.asarray(bitmat), jnp.asarray(data), w, packet))


def codec_bitmats(profile: dict):
    """k, w, and a port codec's encode bitmatrix and its decode bitmatrix
    with chunks 0 and 1 erased."""
    codec = registry.factory("torch_cuda", dict(profile), device="cpu")
    dec = codec._decode_entry(tuple(range(2, codec.k + 2)))["bitmat"]
    return codec.k, codec.w, [codec._bitmat, dec]


def cauchy_bitmats():
    coding = gf.cauchy_good_generator(10, 4, 8)
    dec = gf.decode_matrix(coding, 10, tuple(range(4, 14)), 8)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, 8)])
    return [gf.generator_to_bitmatrix(coding, 8),
            gf.generator_to_bitmatrix(full, 8)]


def test_stage_tile_and_design():
    assert stage_tile(80, 2048) == 256          # Cauchy k=10, w=8: 20 KiB
    assert stage_tile(80, 8192) == 256
    assert stage_tile(80, 2064) == 256          # 9 tiles, the last 16 B
    assert stage_tile(35, 48) == 64             # one partial tile
    assert stage_tile(96, 16) == 16             # the whole packet
    assert stage_tile(256, 2048) == 128         # the smallest tile taken
    assert stage_tile(288, 2048) == 0           # w=32, k=9: past 32 KiB
    assert stage_tile(288, 64) == 64            # a whole small packet fits
    assert design(288, 2048) == "vector"
    assert design(80, 24) == "byte"
    assert design(80, 2048, aligned=False) == "byte"
    for cols in range(2, 1025):
        tile = stage_tile(cols, 4096)
        assert tile == 0 or (cols * tile <= STAGE_BYTES and
                             tile & (tile - 1) == 0 and tile % VEC == 0)


@pytest.mark.parametrize("which", ["encode", "decode0123"])
def test_cauchy_k10_m4_model_matches_jax(one_torch_thread, which):
    bm = cauchy_bitmats()[which != "encode"]
    assert bm.shape == ((32, 80) if which == "encode" else (112, 80))
    data = np.random.default_rng(3).integers(0, 256, (2, 10, 2 * 8 * 512),
                                             dtype=np.uint8)
    assert np.array_equal(staged_model(bm, data, 8, 512),
                          reference(bm, data, 8, 512))


@pytest.mark.parametrize("profile", [
    {"technique": "liberation", "k": "5", "w": "7", "packetsize": "48"},
    {"technique": "blaum_roth", "k": "4", "w": "6", "packetsize": "32"},
    {"technique": "liber8tion", "k": "8", "packetsize": "64"},
], ids=lambda p: p["technique"])
def test_liberation_family_model_matches_jax(one_torch_thread, profile):
    k, w, mats = codec_bitmats(profile)
    packet = int(profile["packetsize"])
    data = np.random.default_rng(k * w).integers(
        0, 256, (2, k, 3 * w * packet), dtype=np.uint8)
    for bm in mats:
        assert np.array_equal(staged_model(bm, data, w, packet),
                              reference(bm, data, w, packet))


@pytest.mark.parametrize("rows,k,w,packet", [
    (16, 10, 8, 2064),      # 9 tiles of 256 bytes, the last one 16 bytes
    (14, 5, 7, 48),         # one tile of 64 bytes holding 48
    (64, 16, 16, 256),      # two tiles of 128, the smallest taken
    (6, 3, 2, 16),          # w=2, one 16-byte column
])
def test_random_bitmatrix_partial_tiles_match_jax(one_torch_thread, rows, k,
                                                  w, packet):
    rng = np.random.default_rng(rows * packet)
    bm = rng.integers(0, 2, (rows, k * w), dtype=np.uint8)
    data = rng.integers(0, 256, (1, k, 2 * w * packet), dtype=np.uint8)
    assert design(k * w, packet) == "staged"
    assert np.array_equal(staged_model(bm, data, w, packet),
                          reference(bm, data, w, packet))
