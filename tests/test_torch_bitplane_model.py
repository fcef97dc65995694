"""Model of K3's one-launch bit-plane design, against the JAX package.

``ceph_tpu_torch/csrc/write_transform.cu`` runs the compress mode's
probe, bit-plane container and decision (K3, ``bitplane_kernel``) in one
cooperative launch, porting ``ceph_tpu/osd/fused_transform.py``
``_bitplane_dev`` and the decision of ``_build_program`` (:515-535). This
file restates its schedule in numpy so that a mistake in it shows on the
CPU:

  1. tiles of 256 64-byte blocks, a thread a block; block x of a grid of
     G (the resident blocks, at most one a tile) takes tiles x, x + G, ...;
  2. before the one barrier: each thread loads its block once, counts its
     bytes into its lane's copy of the block's 256 bins, and transposes
     the block into 8 planes (8x8 bit transposes, then a byte transpose);
     each tile's count of stored planes (neither all 0 nor all 1) goes
     to the scratch, and each block adds its bins, summed over the 32
     copies, to the histogram;
  3. after it, every block computes the same decision: the entropy in a
     fixed pairwise order in float32, comp_len = 2 nb + 8 planes, the
     probe, the ratio test in int64; its tiles' first planes from the
     tiles before them (its first tile from all of them, each next one
     from the ones between);
  4. each tile's output: the container's header (flags, consts) and its
     stored planes at 2 nb + 8 (first + rank), rank the thread's
     exclusive scan in the tile; or the raw bytes, staged swizzled in
     pairs of words and stored 16 bytes at a time; tiles past the first
     of a block are loaded and transposed again (counted);
  5. the grid writes zeros from the end of the selected stream to cap2,
     bytes up to 16-byte alignment, then 16 bytes a store, then bytes.

The model runs with small stand-ins for the resident grid, so that the
grid-stride loop and the second load run, and is held byte for byte
against ``_bitplane_dev`` and the JAX package's ``bitplane_compress_host``
(forced to compress or to store through the thresholds), against the
reference's decision from ``run_fused`` (``entropy_milli`` within 1: a
float32 log2 on another device), and against the port's plain version.
The reference's int32 ratio overflow (above 2,454,267 bytes) stays
pinned by ``test_torch_fused_transform.test_ratio_rule_has_no_int32_
overflow``; these inputs are far under it. The CUDA kernel is held
against the port's plain version on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.osd import fused_transform as jft
from ceph_tpu_torch.ops import write_kernels as wk
from ceph_tpu_torch.osd import fused_transform as ft

from .torch_fused_ref import jax_bitplane, make_batch, reference
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

U64 = np.uint64
BLOCK, TILE, COPIES = 64, 256, 32


def transpose8(x: np.ndarray) -> np.ndarray:
    """The kernel's 8x8 bit transpose of uint64 words."""
    t = (x ^ (x >> U64(7))) & U64(0x00AA00AA00AA00AA)
    x = x ^ t ^ (t << U64(7))
    t = (x ^ (x >> U64(14))) & U64(0x0000CCCC0000CCCC)
    x = x ^ t ^ (t << U64(14))
    t = (x ^ (x >> U64(28))) & U64(0x00000000F0F0F0F0)
    return x ^ t ^ (t << U64(28))


def byte_transpose(rows: np.ndarray) -> np.ndarray:
    """[m, 8] words -> [m, 8]: byte i of out[p] = byte p of rows[i]."""
    out = np.zeros_like(rows)
    for p in range(8):
        for i in range(8):
            out[:, p] |= ((rows[:, i] >> U64(8 * p)) & U64(0xFF)) << \
                U64(8 * i)
    return out


def block_planes(words: np.ndarray):
    """[m, 8] little-endian words of m blocks -> (planes [m, 8] words,
    flags [m], consts [m]) as the kernel's block_planes."""
    planes = byte_transpose(transpose8(words))
    all0 = planes == U64(0)
    all1 = planes == ~U64(0)
    pw = 1 << np.arange(8)
    flags = ((~(all0 | all1)) * pw).sum(1)
    consts = (all1 * pw).sum(1)
    return planes, flags, consts


def block_words(planes: np.ndarray) -> np.ndarray:
    """The raw path's block_word: the words back from the planes."""
    return transpose8(byte_transpose(planes))


def entropy_milli(hist: np.ndarray, n: int) -> int:
    f32 = np.float32
    p = hist.astype(f32) / f32(n)
    terms = np.where(hist > 0, p * np.log2(np.maximum(p, f32(1e-12))),
                     f32(0)).astype(f32)
    s = 128
    while s:                    # terms[i] += terms[i + s], s = 128 .. 1
        terms[:s] = terms[:s] + terms[s:2 * s]
        s //= 2
    return int(f32(-terms[0]) * f32(1000.0))


def k3_model(data: np.ndarray, cap2: int, sw: int, chunk: int,
             required_milli: int, entropy_max_milli: int, grid: int):
    """(stored [cap2], dec [6], tiles loaded twice) of the one-launch
    schedule with `grid` resident blocks."""
    n = data.size
    nb = -(-n // BLOCK)
    tiles = -(-nb // TILE)
    G = min(tiles, grid)
    padded = np.zeros(nb * BLOCK, np.uint8)
    padded[:n] = data
    words = padded.view("<u8").reshape(nb, 8).astype(U64)

    def tile_of(t):
        b = np.arange(t * TILE, min((t + 1) * TILE, nb))
        return b, block_planes(words[b])

    # -- before the barrier (step 2)
    hist = np.zeros(256, np.int64)
    tile_count = np.zeros(tiles, np.int64)
    kept = {}
    for x in range(G):
        bins = np.zeros((256, COPIES), np.int64)
        for t in range(x, tiles, G):
            b, (planes, flags, consts) = tile_of(t)
            real = np.minimum(n - b * BLOCK, BLOCK)
            lane = (b - t * TILE) % COPIES
            for k, blk in enumerate(b):
                np.add.at(bins, (padded[blk * BLOCK:blk * BLOCK + real[k]],
                                 lane[k]), 1)
            tile_count[t] = sum(bin(int(f)).count("1") for f in flags)
            if t == x:
                kept[x] = (planes, flags, consts)
        hist += bins.sum(1)
    assert np.array_equal(hist, np.bincount(data, minlength=256))

    # -- the decision (step 3), the same in every block
    milli = entropy_milli(hist, n)
    probe_ok = milli <= entropy_max_milli
    comp_len = 2 * nb + 8 * int(tile_count.sum())
    compress = probe_ok and comp_len * 1000 <= n * required_milli
    used = -(-(comp_len if compress else n) // sw)
    dec = np.array([comp_len, compress, probe_ok, milli, used,
                    (cap2 // sw - used) * chunk], np.int64)

    # -- each tile's output (step 4); `written` marks each byte stored
    stored = np.zeros(cap2, np.uint8)
    written = np.zeros(cap2, bool)
    recomputed = 0

    def write(t, first, planes, flags, consts):
        b0 = t * TILE
        nblk = planes.shape[0]
        if compress:
            stored[2 * (b0 + np.arange(nblk))] = flags
            stored[2 * (b0 + np.arange(nblk)) + 1] = consts
            written[2 * b0:2 * (b0 + nblk)] = True
            pops = np.array([bin(int(f)).count("1") for f in flags])
            rank = np.cumsum(pops) - pops           # the block scan
            st = np.zeros(TILE * 8, U64)
            for tid in range(nblk):
                k = rank[tid]
                for p in range(8):
                    if flags[tid] >> p & 1:
                        st[k] = planes[tid, p]
                        k += 1
            total = int(pops.sum())
            at = 2 * nb + 8 * first
            stored[at:at + 8 * total] = st[:total].view(np.uint8)
            written[at:at + 8 * total] = True
        else:
            st8 = np.zeros(TILE * 8, U64)
            w = block_words(planes)
            for tid in range(nblk):
                swz = ((tid >> 1) & 3) << 1
                for i in range(8):
                    st8[tid * 8 + (i ^ swz)] = w[tid, i]
            st4 = st8.view(np.uint8).reshape(-1, 16)
            out = stored[b0 * BLOCK:(b0 + nblk) * BLOCK].reshape(-1, 16)
            for m in range(nblk * 4):
                bb = m >> 2
                out[m] = st4[bb * 4 + ((m & 3) ^ ((bb >> 1) & 3))]
            written[b0 * BLOCK:(b0 + nblk) * BLOCK] = True

    for x in range(G):
        before = int(tile_count[:x].sum())
        write(x, before, *kept[x])
        prev, first = x, before
        for t in range(x + G, tiles, G):
            first += int(tile_count[prev:t].sum())
            _, again = tile_of(t)                   # loaded again
            recomputed += 1
            write(t, first, *again)
            prev = t

    # -- the zero tail (step 5)
    zfrom = comp_len if compress else n
    a16 = min(-(-zfrom // 16) * 16, cap2)
    e16 = max(cap2 // 16 * 16, a16)
    for lo, hi in ((zfrom, a16), (a16, e16), (e16, cap2)):
        assert not (compress and written[lo:hi].any()), "a container byte " \
            "zeroed"
        stored[lo:hi] = 0
        written[lo:hi] = True
    assert written.all(), "a byte of stored was never written"
    return stored, dec, recomputed


SW, CHUNK = 2 * 4096, 4096
SIZES = [4096, 3 * 16384 + 100, 65536]      # 1 tile; 4 ragged; 4
GRIDS = [1, 3, 8]


def forced(data, cap2, grid, compress: bool):
    """The model forced to one stream: any container passes 8000 milli
    and 1.1 N; none passes a ratio of 0."""
    return k3_model(data, cap2, SW, CHUNK, 1100 if compress else 0, 8000,
                    grid)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["low", "random", "zeros", "ones"])
def test_container_matches_bitplane_dev_and_host(kind, n, grid):
    cap2 = ft.plan_capacity(n, SW)
    data, want, comp_len = jax_bitplane(n, kind, cap2)
    twin, _ = jft.bitplane_compress_host(data.tobytes())
    assert want[:comp_len].tobytes() == twin and not want[comp_len:].any()
    stored, dec, recomputed = forced(data, cap2, grid, True)
    tiles = -(-(-(-n // BLOCK)) // TILE)
    assert recomputed == max(0, tiles - grid)
    assert dec[1] == 1 and dec[0] == comp_len
    assert np.array_equal(stored, want)
    stored, dec, _ = forced(data, cap2, grid, False)
    assert dec[1] == 0
    assert stored[:n].tobytes() == data.tobytes() and not stored[n:].any()


@pytest.mark.parametrize("kind", ["low", "random"])
def test_decision_matches_run_fused(kind):
    """[6, 2, 4096]: 3 tiles on a grid of 2, one of them loaded twice,
    at the OSD's thresholds (875 milli, 7000 milli)."""
    shape = (6, 2, 4096)
    ref = reference(1, shape, kind, "compress")
    data = make_batch(shape, kind).reshape(-1)
    sw = shape[1] * shape[2]
    cap2 = ref["stored"].size
    stored, dec, recomputed = k3_model(data, cap2, sw, shape[2], 875, 7000,
                                       2)
    assert recomputed == 1
    got = dict(zip(wk.DEC_FIELDS, dec.tolist()))
    for name in ("comp_len", "do_compress", "probe_ok", "used_stripes"):
        assert got[name] == int(ref[name]), name
    assert abs(got["entropy_milli"] - int(ref["entropy_milli"])) <= 1
    assert np.array_equal(stored, ref["stored"].reshape(-1))
    assert bool(got["do_compress"]) == (kind == "low")


@pytest.mark.parametrize("kind", ["low", "random", "zeros"])
@pytest.mark.parametrize("n", [1000, 4096 + 64 * 3])
def test_plain_version_matches_model(kind, n):
    """The port's plain version, which the kernel is held against on the
    card, and the model agree on every byte and field: an N that is not a
    multiple of 64, and one whose planes start off 8 bytes."""
    data = make_batch((n,), kind, seed=n)
    sw, chunk = 2 * 128, 128
    cap2 = ft.plan_capacity(n, sw)
    stored, dec = wk.bitplane_stage_plain(torch.from_numpy(data), cap2, sw,
                                          chunk, 875, 7000)
    m_stored, m_dec, _ = k3_model(data, cap2, sw, chunk, 875, 7000, 1)
    assert np.array_equal(stored.numpy(), m_stored)
    got, want = dec.tolist(), m_dec.tolist()
    assert abs(got[3] - want[3]) <= 1
    assert got[:3] + got[4:] == want[:3] + want[4:]


def test_raw_staging_swizzle_is_a_permutation():
    """The raw path's staging: thread tid's word i goes to slot tid * 8 +
    (i ^ swz(tid)), and 16-byte slot m of the copy-out reads back block
    m >> 2's words 2 (m & 3) and 2 (m & 3) + 1, in order."""
    for tid in range(TILE):
        swz = ((tid >> 1) & 3) << 1
        slots = [tid * 8 + (i ^ swz) for i in range(8)]
        assert sorted(slots) == list(range(tid * 8, tid * 8 + 8))
        for k in range(4):
            q = tid * 4 + (k ^ ((tid >> 1) & 3))      # the copy-out's read
            assert slots[2 * k] == 2 * q and slots[2 * k + 1] == 2 * q + 1


def test_block_words_invert_block_planes():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 63, (50, 8), dtype=np.int64).astype(U64)
    planes, _, _ = block_planes(words)
    assert np.array_equal(block_words(planes), words)
