"""Model of K2's four-lane xxh32 design, against the JAX package.

``ceph_tpu_torch/csrc/write_transform.cu`` computes xxh32 (seed 0) of
every row (K2), porting ``ceph_tpu/osd/fused_transform.py``
``_xxh32_dev``. This file restates its design in numpy, on the same
uint32 words, so that a mistake in the lane split or the combine shows
on the CPU:

  1. rows go 8 to a block; lane 4r + j of the computing warp runs
     accumulator j (seeds P1 + P2, P2, 0, -P1) of row r; lanes of rows
     past the last compute on nothing and write nothing;
  2. on the TMA path (rows of a multiple of 16 bytes, at least 16) a row
     streams in tiles of 1 KiB, the last one partial; the product warp
     turns each landed word w of a tile into w * P2 in place, and a round
     on a product p is acc = rotl(acc + p, 13) * P1. The direct path
     (any other rows) runs acc = rotl(acc + w * P2, 13) * P1 on words
     loaded a byte at a time;
  3. the row's four lanes combine: v_j = rotl(acc_j, (1, 7, 12, 18)[j]),
     then v += v[lane ^ 1] and v += v[lane ^ 2], so lane 4r holds the sum;
  4. lane 4r finishes the row: a row under 16 bytes starts from P5; then
     the length, the tail's 4-byte and 1-byte steps and the avalanche.

The model is held value for value (tolerance: none) against
``_xxh32_dev`` and the JAX package's ``xxh32_host`` at lengths 0, 1, 15,
16, 17, 96, 4097 and 65536 and row counts 1, 3, 8 and 33, on both paths
where a length takes both. The CUDA kernel is held against the port's
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

from ceph_tpu.osd import fused_transform as jft
from ceph_tpu_torch.ops import write_kernels

from .torch_fused_ref import jax_xxh32
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

U32 = np.uint32
P1, P2, P3 = U32(2654435761), U32(2246822519), U32(3266489917)
P4, P5 = U32(668265263), U32(374761393)
ROWS_PER_BLOCK, TILE = 8, 1024
SEEDS = np.array([(int(P1) + int(P2)) & 0xFFFFFFFF, int(P2), 0,
                  (-int(P1)) & 0xFFFFFFFF], dtype=U32)
ROTS = np.array([1, 7, 12, 18], dtype=U32)
LENGTHS = [0, 1, 15, 16, 17, 96, 4097, 65536]
ROW_COUNTS = [1, 3, 8, 33]
JAX_ROWS = max(ROW_COUNTS)     # each length's reference computed once


def rotl(x: np.ndarray, r) -> np.ndarray:
    r = np.asarray(r, dtype=U32)
    return (x << r) | (x >> (U32(32) - r))


def le32(b: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> [...] little-endian uint32."""
    b = b.astype(U32)
    return b[..., 0] | (b[..., 1] << U32(8)) | (b[..., 2] << U32(16)) | \
        (b[..., 3] << U32(24))


def takes_tma(length: int) -> bool:
    """The entry point's choice for 16-byte aligned rows."""
    return length >= 16 and length % 16 == 0


def lane_words(rows_np: np.ndarray) -> np.ndarray:
    """[blocks, 32, stripes] uint32: lane 4r + j's word j of each 16-byte
    stripe of row r of its block (zero rows past the last)."""
    n_rows, length = rows_np.shape
    blocks = -(-n_rows // ROWS_PER_BLOCK)
    stripes = length // 16
    padded = np.zeros((blocks * ROWS_PER_BLOCK, stripes * 16), np.uint8)
    padded[:n_rows] = rows_np[:, :stripes * 16]
    w = le32(padded.reshape(blocks, ROWS_PER_BLOCK, stripes, 4, 4))
    return w.transpose(0, 1, 3, 2).reshape(blocks, 32, stripes)


def chain(words: np.ndarray, tma: bool) -> np.ndarray:
    """[blocks, 32] accumulators after every stripe (step 2)."""
    blocks, _, stripes = words.shape
    acc = np.broadcast_to(SEEDS[np.arange(32) & 3], (blocks, 32)).copy()
    if tma:
        per_tile = TILE // 16
        for t in range(-(-stripes // per_tile)):
            tile = words[:, :, t * per_tile:(t + 1) * per_tile] * P2
            for u in range(tile.shape[2]):
                acc = rotl(acc + tile[:, :, u], 13) * P1
    else:
        for i in range(stripes):
            acc = rotl(acc + words[:, :, i] * P2, 13) * P1
    return acc


def combine(acc: np.ndarray) -> np.ndarray:
    """[blocks, 32] -> [blocks, 8]: the butterfly of step 3, read from
    each row's first lane."""
    lanes = np.arange(32)
    v = rotl(acc, ROTS[lanes & 3])
    v = v + v[:, lanes ^ 1]
    v = v + v[:, lanes ^ 2]
    return v[:, ::4]


def finish(h: np.ndarray, rows_np: np.ndarray) -> np.ndarray:
    """Step 4 over all rows at once."""
    length = rows_np.shape[1]
    h = h + U32(length & 0xFFFFFFFF)
    i = (length // 16) * 16
    while i + 4 <= length:
        h = rotl(h + le32(rows_np[:, i:i + 4]) * P3, 17) * P4
        i += 4
    while i < length:
        h = rotl(h + rows_np[:, i].astype(U32) * P5, 11) * P1
        i += 1
    h ^= h >> U32(15)
    h *= P2
    h ^= h >> U32(13)
    h *= P3
    return h ^ (h >> U32(16))


def k2_model(rows_np: np.ndarray, tma: bool) -> np.ndarray:
    n_rows, length = rows_np.shape
    if tma:
        assert takes_tma(length)
    if length >= 16:
        h = combine(chain(lane_words(rows_np), tma)).reshape(-1)[:n_rows]
    else:
        h = np.full(n_rows, P5, dtype=U32)
    return finish(h, rows_np)


@pytest.mark.parametrize("rows", ROW_COUNTS)
@pytest.mark.parametrize("length", LENGTHS)
def test_model_matches_jax_and_host(length, rows):
    data, want = jax_xxh32(length, JAX_ROWS)
    data, want = data[:rows], want[:rows]
    assert [int(v) for v in want[:3]] == [jft.xxh32_host(r.tobytes())
                                          for r in data[:3]]
    paths = (False, True) if takes_tma(length) else (False,)
    for tma in paths:
        assert np.array_equal(k2_model(data, tma), want), tma


@pytest.mark.parametrize("length", [0, 15, 96, 4097])
def test_plain_version_matches_model(length):
    """The port's plain version, which the kernel is held against on the
    card, agrees with the model on 33 rows (a block of 1 row past 32)."""
    import torch

    data, _ = jax_xxh32(length, JAX_ROWS)
    got = write_kernels.xxh32_rows_plain(torch.from_numpy(data))
    assert np.array_equal(got.view(torch.int32).numpy().view(U32),
                          k2_model(data, takes_tma(length)))


def test_lane_combine_is_the_references_sum():
    """The butterfly adds the rotated accumulators in another order than
    the reference's left-to-right sum; addition mod 2^32 makes them one
    value, which row 0 here checks on random accumulators."""
    rng = np.random.default_rng(5)
    acc = rng.integers(0, 1 << 32, (3, 32), dtype=np.uint64).astype(U32)
    got = combine(acc)
    for b in range(3):
        for r in range(ROWS_PER_BLOCK):
            a = acc[b, 4 * r:4 * r + 4]
            want = (int(rotl(a[0], 1)) + int(rotl(a[1], 7)) +
                    int(rotl(a[2], 12)) + int(rotl(a[3], 18))) & 0xFFFFFFFF
            assert int(got[b, r]) == want


def test_tiles_cover_every_stripe_once():
    """The ring's tiles: 1 KiB a row, the last one partial, together the
    row's whole stripes in order."""
    for length in (16, 96, 1024, 1040, 4096, 65536):
        stripes = length // 16
        per_tile = TILE // 16
        seen = [u + t * per_tile for t in range(-(-stripes // per_tile))
                for u in range(min(per_tile, stripes - t * per_tile))]
        assert seen == list(range(stripes))
