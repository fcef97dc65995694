"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``).

They skip where ``torch.cuda.is_available()`` is false, and import neither
JAX nor the ceph_tpu package, so that on a machine with a card they run
without the reference installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

The CUDA kernels have no CPU mode; each test holds one against its plain
PyTorch version on the card (tolerance: none, bit-exact). The GF
bitmatrix kernel on both of its designs: bit-sliced for w=8 with k <= 16
when the expanded bitmatrix fits in shared memory, popcount for every
other geometry. The packet kernel on its three designs: staged through
shared memory where k*w tiles fit, 16-byte columns loaded per set bit
past that, byte columns for other packetsizes or unaligned pointers. The write transform's kernels (CRC rows, xxh32
rows, the bit-plane stage) on their aligned and byte paths, and one
``ec_util.encode_fused`` on the card in each mode against the CPU path.
"""

import itertools
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch import registry
from ceph_tpu_torch.ops import (gf, gf_kernel, gf_ref, packet_kernel,
                                write_kernels, xor_mm)
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd import fused_transform as ft
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def decode_bitmat(coding, k, avail, w):
    dec = gf.decode_matrix(coding, k, avail, w)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, w)], axis=0)
    return gf.generator_to_bitmatrix(full, w)


def bitmats(k, m, w):
    coding = gf.rs_vandermonde_generator(k, m, w)
    return [gf.generator_to_bitmatrix(coding, w),
            decode_bitmat(coding, k, tuple(range(m, k + m)), w)]


def expected_design(k, w):
    return "bitsliced" if w == 8 and k * w <= 128 else "popcount"


def held_against_plain(bm, data, w, design=None):
    """One launch, as the entry point counts it, byte-equal to the plain
    version, on the design the geometry takes."""
    design = design or expected_design(data.shape[-2], w)
    assert gf_kernel.kernel_design(bm.shape[0], data.shape[-2], w,
                                   data.device) == design
    before = gf_kernel.launches_by_design()
    out = gf_kernel.matrix_encode(bm, data, w)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design()
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == design) for d in gf_kernel.DESIGNS}
    assert torch.equal(out, gf_kernel.matrix_encode_plain(bm, data, w))


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,m,n", [
    (8, 8, 3, 4096), (8, 12, 4, 1000), (8, 2, 1, 512), (8, 16, 4, 4096),
    (8, 16, 4, 32 * 40 + 7), (8, 40, 4, 1024), (8, 1, 2, 7),
    (16, 8, 3, 2050), (32, 8, 3, 4100), (32, 16, 2, 2052),
])
def test_kernel_matches_plain_on_card(cuda, w, k, m, n):
    rng = np.random.default_rng(w * 1000 + k)
    before = gf_kernel.LAUNCHES
    for mat in bitmats(k, m, w):
        bm = torch.from_numpy(mat).to(cuda)
        data = torch.from_numpy(rng.integers(0, 256, (3, k, n),
                                             dtype=np.uint8)).to(cuda)
        held_against_plain(bm, data, w)
    assert gf_kernel.LAUNCHES == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,m", [(8, 8, 3), (8, 16, 4), (8, 40, 4),
                                   (16, 8, 3)])
def test_data_pointer_off_by_one_on_card(cuda, w, k, m):
    """A contiguous view one byte into a larger buffer takes the byte path
    of either design."""
    n = 2048
    buf = torch.from_numpy(np.random.default_rng(k).integers(
        0, 256, 2 * k * n + 1, dtype=np.uint8)).to(cuda)
    data = buf[1:].view(2, k, n)
    assert data.is_contiguous() and data.data_ptr() % 16 == 1
    for mat in bitmats(k, m, w):
        held_against_plain(torch.from_numpy(mat).to(cuda), data, w)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,design", [
    (448, 16, "bitsliced"),   # E of 224 KiB fits the opt-in shared memory
    (512, 16, "popcount"),    # 256 KiB does not, at KMAX = 16, 8 and 4
    (1024, 8, "popcount"),
    (2048, 4, "popcount"),
])
def test_shared_memory_limit_picks_the_design_on_card(cuda, rows, k, design):
    """A w=8 bitmatrix whose expansion does not fit in shared memory takes
    the popcount kernel."""
    rng = np.random.default_rng(rows)
    bm = torch.from_numpy(rng.integers(0, 2, (rows, k * 8),
                                       dtype=np.uint8)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, (2, k, 32 * 70 + 9),
                                         dtype=np.uint8)).to(cuda)
    held_against_plain(bm, data, 8, design)


@pytest.mark.gpu
def test_every_decode_bitmatrix_on_card(cuda):
    coding = gf.rs_vandermonde_generator(8, 3, 8)
    data = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8, 32 * 9 + 5), dtype=np.uint8)).to(cuda)
    for avail in itertools.combinations(range(11), 8):
        bm = torch.from_numpy(decode_bitmat(coding, 8, avail, 8)).to(cuda)
        held_against_plain(bm, data, 8)


@pytest.mark.gpu
def test_codec_on_card_matches_oracle(cuda):
    codec = registry.factory("torch_cuda", dict(PROFILE))
    assert codec.device.type == "cuda"
    data = np.random.default_rng(1).integers(0, 256, (2, 8, 4096),
                                             dtype=np.uint8)
    parity = codec.encode_batch(data)
    for b in range(2):
        assert np.array_equal(
            parity[b], gf_ref.matrix_encode_ref(codec.coding, data[b], 8))
    full = torch.from_numpy(np.concatenate([data, parity], 1)).to(cuda)
    for avail in itertools.combinations(range(11), 8):
        out = codec.decode_batch(avail, full[:, list(avail)].contiguous())
        assert torch.equal(out, full), avail


@pytest.mark.gpu
def test_dispatcher_on_card(cuda):
    codec = registry.factory("torch_cuda", dict(PROFILE))
    data = np.random.default_rng(2).integers(0, 256, (6, 8, 8192),
                                             dtype=np.uint8)
    full = np.concatenate([data, codec.encode_batch(data)], 1)
    disp = GpuDispatcher()
    try:
        futs = [(disp.encode_async(codec, data[i:i + 1]),
                 disp.decode_async(codec, (1, 2, 3, 4, 5, 6, 7, 10),
                                   full[i:i + 1][:, [1, 2, 3, 4, 5, 6, 7,
                                                     10]]))
                for i in range(6)]
        for i, (fe, fd) in enumerate(futs):
            assert np.array_equal(fe.result(60), full[i:i + 1, 8:])
            assert np.array_equal(fd.result(60), full[i:i + 1])
    finally:
        disp.shutdown()
    assert disp.stats["dispatches"] < disp.stats["ops"]


# -- the packet-layout kernel (csrc/gf_packet.cu) ----------------------------

def packet_held_against_plain(bm, data, w, packetsize, design=None,
                              set_bits=None):
    """One launch, on the design the geometry, alignment and `set_bits`
    take (and `design` if given), byte-equal to the plain version."""
    taken = packet_kernel.kernel_design(bm, data, w, packetsize, set_bits)
    assert design is None or taken == design
    before = packet_kernel.launches_by_design()
    count = packet_kernel.LAUNCHES
    out = packet_kernel.bitmatrix_encode(bm, data, w, packetsize,
                                         set_bits=set_bits)
    torch.cuda.synchronize()
    after = packet_kernel.launches_by_design()
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == taken) for d in packet_kernel.DESIGNS}
    assert packet_kernel.LAUNCHES == count + 1
    assert torch.equal(out, xor_mm.bitmatrix_encode_plain(bm, data, w,
                                                          packetsize))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("packetsize", [3, 8, 24, 2048, 8192])
@pytest.mark.parametrize("w", [7, 8, 16, 32])
def test_packet_kernel_matches_plain_on_card(cuda, w, packetsize, batch):
    rng = np.random.default_rng(w * 100 + packetsize + batch)
    k, m = 3, 2
    supers = 3 if batch == 1 else 2
    bm = torch.from_numpy(rng.integers(0, 2, (m * w, k * w),
                                       dtype=np.uint8)).to(cuda)
    data = torch.from_numpy(rng.integers(
        0, 256, (batch, k, supers * w * packetsize), dtype=np.uint8)).to(cuda)
    packet_held_against_plain(bm, data, w, packetsize)


@pytest.mark.gpu
@pytest.mark.parametrize("packetsize", [8, 2048])
def test_packet_kernel_data_pointer_off_by_one_on_card(cuda, packetsize):
    """A contiguous view one byte into a larger buffer takes the byte path."""
    w, k, m = 8, 4, 2
    n = 3 * w * packetsize
    buf = torch.from_numpy(np.random.default_rng(packetsize).integers(
        0, 256, 2 * k * n + 1, dtype=np.uint8)).to(cuda)
    data = buf[1:].view(2, k, n)
    assert data.is_contiguous() and data.data_ptr() % 16 == 1
    bm = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (m * w, k * w), dtype=np.uint8)).to(cuda)
    packet_held_against_plain(bm, data, w, packetsize)


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,packetsize,offset,design", [
    (8, 10, 2048, 0, "staged"),     # Cauchy k=10: tiles of 256 bytes
    (8, 10, 2064, 0, "staged"),     # the last tile of a packet 16 bytes
    (7, 5, 48, 0, "staged"),        # one tile of 64 bytes holding 48
    (16, 16, 256, 0, "staged"),     # tiles of 128, the smallest taken
    (32, 9, 64, 0, "staged"),       # a whole small packet per tile
    (32, 9, 2048, 0, "vector"),     # k*w tiles of 128 bytes past 32 KiB
    (32, 9, 2048, 1, "byte"),
    (8, 10, 24, 0, "byte")])
def test_packet_kernel_design_by_geometry_on_card(cuda, w, k, packetsize,
                                                  offset, design):
    """The entry point picks the staged design where k*w tiles of at least
    min(P, 128) bytes fit its 32 KiB buffer, the vector design past that,
    the byte design for other packetsizes or unaligned data."""
    rng = np.random.default_rng(w * k + packetsize + offset)
    bm = torch.from_numpy(rng.integers(0, 2, (2 * w, k * w),
                                       dtype=np.uint8)).to(cuda)
    n = 2 * w * packetsize
    buf = torch.from_numpy(rng.integers(0, 256, 2 * k * n + offset,
                                        dtype=np.uint8)).to(cuda)
    packet_held_against_plain(bm, buf[offset:].view(2, k, n), w, packetsize,
                              design)


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,supers,batch,fill,design", [
    (7, 7, 12, 16, "liberation", "vector"),  # 104 set bits <= 3 * 49
    (8, 8, 8, 16, "liber8tion", "staged"),   # 214 > 3 * 64
    (8, 10, 4, 2, "cauchy", "staged"),
    (7, 2, 2, 1, "liberation", "vector"),    # the default profile's k=2
    (6, 6, 4, 4, "blaum_roth", "vector"),    # 97 <= 3 * 36
    (8, 3, 2, 16, "random", "staged"),       # about 8 selects an input
    (16, 3, 2, 1, "random", "staged")])
def test_packet_kernel_design_by_set_bits_on_card(cuda, w, k, supers, batch,
                                                  fill, design):
    """With the count of set entries a codec gives, the vector design is
    kept where it was faster than the staged one: at most 3 selects per
    input packet on average."""
    rng = np.random.default_rng(w * k + supers)
    if fill == "random":
        mat = rng.integers(0, 2, (2 * w, k * w), dtype=np.uint8)
    else:
        technique = {"cauchy": "cauchy_good"}.get(fill, fill)
        mat = registry.factory("torch_cuda", {
            "technique": technique, "k": str(k), "m": "2", "w": str(w),
            "packetsize": "2048"}, device="cpu")._bitmat
    bm = torch.from_numpy(np.ascontiguousarray(mat)).to(cuda)
    data = torch.from_numpy(rng.integers(
        0, 256, (batch, k, supers * w * 2048), dtype=np.uint8)).to(cuda)
    packet_held_against_plain(bm, data, w, 2048, design, int(mat.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,packetsize,offset,takes", [
    (8, 10, 2048, 0, ("staged", "vector", "byte")),
    (32, 9, 2048, 0, ("vector", "byte")),
    (8, 10, 24, 0, ("byte",)),
    (8, 10, 2048, 1, ("byte",))])
def test_packet_kernel_named_design_on_card(cuda, w, k, packetsize, offset,
                                            takes):
    """A named design runs where it takes the geometry and alignment,
    byte-equal to the plain version and counted as its own launch, and
    raises with no launch where it does not."""
    rng = np.random.default_rng(w * k + packetsize + offset + 1)
    bm = torch.from_numpy(rng.integers(0, 2, (2 * w, k * w),
                                       dtype=np.uint8)).to(cuda)
    n = 2 * w * packetsize
    buf = torch.from_numpy(rng.integers(0, 256, 2 * k * n + offset,
                                        dtype=np.uint8)).to(cuda)
    data = buf[offset:].view(2, k, n)
    want = xor_mm.bitmatrix_encode_plain(bm, data, w, packetsize)
    for design in packet_kernel.DESIGNS:
        before = packet_kernel.launches_by_design()
        if design in takes:
            out = packet_kernel.bitmatrix_encode(bm, data, w, packetsize,
                                                 design=design)
            torch.cuda.synchronize()
            assert torch.equal(out, want), design
        else:
            with pytest.raises(RuntimeError, match="design %s" % design):
                packet_kernel.bitmatrix_encode(bm, data, w, packetsize,
                                               design=design)
        after = packet_kernel.launches_by_design()
        assert {d: after[d] - before[d] for d in after} == {
            d: int(d == design and design in takes)
            for d in packet_kernel.DESIGNS}


@pytest.mark.gpu
def test_packet_kernel_cauchy_encode_and_decode_bitmatrices_on_card(cuda):
    coding = gf.cauchy_good_generator(10, 4, 8)
    data = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 10, 4 * 8 * 2048), dtype=np.uint8)).to(cuda)
    for mat in (gf.generator_to_bitmatrix(coding, 8),
                decode_bitmat(coding, 10, tuple(range(4, 14)), 8)):
        packet_held_against_plain(torch.from_numpy(mat).to(cuda), data, 8,
                                  2048)


@pytest.mark.gpu
def test_packet_kernel_past_shared_memory_raises_on_card(cuda):
    bm = torch.zeros((1792, 1024), dtype=torch.uint8, device=cuda)
    data = torch.zeros((1, 32, 64), dtype=torch.uint8, device=cuda)
    count = packet_kernel.LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        packet_kernel.bitmatrix_encode(bm, data, 32, 2)
    assert packet_kernel.LAUNCHES == count


@pytest.mark.gpu
def test_cauchy_shec_lrc_codecs_on_card(cuda):
    rng = np.random.default_rng(9)
    cauchy = registry.factory("torch_cuda", {
        "technique": "cauchy_good", "k": "10", "m": "4",
        "packetsize": "2048"})
    shec = registry.factory("shec_cuda", {"k": "8", "m": "4", "c": "3"})
    lrc = registry.factory("lrc_cuda", {"k": "4", "m": "2", "l": "3"})
    for codec, erased in ((cauchy, (0, 1, 2, 3)), (shec, (2, 9)),
                          (lrc, (0, 5))):
        assert codec.device.type == "cuda"
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        size = codec.get_chunk_size(k * 65536)
        data = torch.from_numpy(rng.integers(0, 256, (2, k, size),
                                             dtype=np.uint8)).to(cuda)
        full = torch.cat([data, codec.encode_batch(data)], 1)
        avail = tuple(i for i in range(n) if i not in erased)
        if not codec.DECODE_BATCH_ANY:
            avail = avail[:k]
        out = codec.decode_batch(avail, full[:, list(avail)].contiguous())
        assert torch.equal(out, full), codec
    host = full.cpu().numpy()
    assert np.array_equal(
        host[:1, 4:], lrc._encode_batch_layers(host[:1, :4]))


# -- the write transform's kernels (csrc/write_transform.cu) -----------------

def u32(t):
    """uint32 results as numpy, for comparison."""
    return t.cpu().numpy()


def rand_card(cuda, shape, seed, offset=0, high=256):
    """Random bytes on the card; offset 1 gives a view one byte into a
    larger buffer (the byte paths)."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, n + offset, dtype=np.uint8)).to(cuda)
    return buf[offset:].view(*shape)


def launched(fn):
    """fn's result and the wrapper launches it made."""
    before = dict(write_kernels.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in write_kernels.LAUNCHES.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length,offset", [
    (3, 0, 0), (3, 1, 0), (5, 15, 0), (4, 16, 0), (7, 96, 0), (3, 4097, 0),
    (1024, 4096, 0), (2, 65536, 0), (3, 4096, 1), (1, (8 << 20) + 3, 0)])
@pytest.mark.parametrize("poly", [ft.POLY_ZLIB, ft.POLY_C])
def test_crc32_rows_match_plain_on_card(cuda, rows, length, offset, poly):
    data = rand_card(cuda, (rows, 1, length), rows + length, offset)
    consts = ft.dev_consts(cuda)[poly]
    got, n = launched(lambda: write_kernels.crc32_rows(data, consts))
    assert n["crc32_rows"] == 1
    assert np.array_equal(u32(got), u32(write_kernels.crc32_rows_plain(
        data, consts)))
    if rows * length < 1 << 16:
        host = data.cpu().numpy().reshape(rows, length)
        oracle = zlib.crc32 if poly == ft.POLY_ZLIB else ft.crc32c_host
        assert [int(c) for c in u32(got)] == [oracle(r.tobytes())
                                              for r in host]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length,offset", [
    (1, 2049, 0), (3, 6244, 0), (5, 65539, 0), (2, 4 * 2048 * 32 + 16, 0),
    (700, 4112, 0), (4, 6160, 1)])
def test_crc32_rows_span_combine_on_card(cuda, rows, length, offset):
    """Rows of several 2048-byte spans, the first span mostly leading
    zeros: the last warp of a row to arrive combines its spans in the one
    launch and leaves the scratch zeroed, so the next call on the stream
    gets the same values."""
    data = rand_card(cuda, (rows, 1, length), rows * length, offset)
    consts = ft.dev_consts(cuda)[ft.POLY_C]
    want = u32(write_kernels.crc32_rows_plain(data, consts))
    for _ in range(2):
        before = write_kernels.launches_by_kernel()["crc_rows"]
        got, n = launched(lambda: write_kernels.crc32_rows(data, consts))
        assert n["crc32_rows"] == 1
        assert write_kernels.launches_by_kernel()["crc_rows"] == before + 1
        assert np.array_equal(u32(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,pad_stripes", [
    ((128, 11, 4096), 0), ((128, 11, 4096), 1), ((128, 11, 4096), 127),
    ((7, 3, 96), 2), ((5, 3, 40), 4), ((40, 3, 64), 5)])
def test_shard_crcs_with_pad_match_plain_on_card(cuda, shape, pad_stripes):
    """Shard streams read in place from [S, n, chunk] (segments at a
    stride), un-shifted by a pad read from device memory."""
    data = rand_card(cuda, shape, shape[2] + pad_stripes)
    data[shape[0] - pad_stripes:] = 0
    view = data.permute(1, 0, 2)
    consts = ft.dev_consts(cuda)[ft.POLY_ZLIB]
    pad = torch.tensor([pad_stripes * shape[2]], device=cuda)
    got, n = launched(lambda: write_kernels.crc32_rows(view, consts, pad))
    assert n["crc32_rows"] == 1
    assert np.array_equal(u32(got), u32(write_kernels.crc32_rows_plain(
        view, consts, pad)))
    host = data.cpu().numpy()[:shape[0] - pad_stripes]
    assert [int(c) for c in u32(got)] == [
        zlib.crc32(np.ascontiguousarray(host[:, i]).tobytes())
        for i in range(shape[1])]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length,offset", [
    (3, 0, 0), (3, 1, 0), (5, 15, 0), (4, 16, 0), (33, 96, 0), (3, 4097, 0),
    (1024, 4096, 0), (128, 65536, 0), (40, 4096, 1), (2, 300, 0)])
def test_xxh32_rows_match_plain_on_card(cuda, rows, length, offset):
    data = rand_card(cuda, (rows, length), rows * 7 + length, offset)
    got, n = launched(lambda: write_kernels.xxh32_rows(data))
    assert n["xxh32_rows"] == 1
    assert np.array_equal(u32(got), u32(write_kernels.xxh32_rows_plain(data)))
    if rows * length < 1 << 14:
        host = data.cpu().numpy()
        assert [int(h) for h in u32(got)] == [ft.xxh32_host(r.tobytes())
                                              for r in host]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,offset", [
    ("low", 8 * 4 * 4096, 0), ("random", 8 * 4 * 4096, 0),
    ("zeros", 8 * 4 * 4096, 0), ("low", 3 * 4097, 0),
    ("low", 8 * 4 * 4096, 1), ("ones", 64 * 1000, 0),
    ("low", 128 * 8 * 4096, 0)])
def test_bitplane_stage_matches_plain_on_card(cuda, kind, n, offset):
    high = {"low": 4, "random": 256, "zeros": 1, "ones": 1}[kind]
    flat = rand_card(cuda, (n,), n + high, offset, high)
    if kind == "ones":
        flat = (flat + 255).contiguous()
    sw = 8 * 4096 if n % (8 * 4096) == 0 else 3 * 4097
    chunk = sw // (8 if sw == 8 * 4096 else 3)
    cap2 = ft.plan_capacity(n, sw)
    (stored, dec), count = launched(lambda: write_kernels.bitplane_stage(
        flat, cap2, sw, chunk, 875, 7000))
    assert count["bitplane_stage"] == 1
    ref_stored, ref_dec = write_kernels.bitplane_stage_plain(
        flat, cap2, sw, chunk, 875, 7000)
    got, ref = dict(zip(write_kernels.DEC_FIELDS, dec.tolist())), dict(
        zip(write_kernels.DEC_FIELDS, ref_dec.tolist()))
    assert abs(got.pop("entropy_milli") - ref.pop("entropy_milli")) <= 1
    assert got == ref
    assert torch.equal(stored, ref_stored)
    if got["do_compress"]:
        twin, _ = ft.bitplane_compress_host(flat.cpu().numpy().tobytes())
        assert stored[:len(twin)].cpu().numpy().tobytes() == twin


@pytest.mark.gpu
@pytest.mark.parametrize("mode,kind", [("store", 256), ("compress", 4),
                                       ("compress", 256)])
def test_encode_fused_on_card_matches_cpu(cuda, mode, kind):
    prof = dict(PROFILE)
    codec = registry.factory("torch_cuda", prof)
    host_codec = registry.factory("torch_cuda", prof, device="cpu")
    sinfo = ec_util.StripeInfo(8, 8 * 4096)
    data = np.random.default_rng(kind).integers(
        0, kind, 16 * sinfo.stripe_width, dtype=np.uint8).tobytes()
    before = dict(write_kernels.LAUNCHES)
    shards, r = ec_util.encode_fused(sinfo, codec, data, mode=mode)
    host_shards, hr = ec_util.encode_fused(sinfo, host_codec, data,
                                           mode=mode)
    assert all(write_kernels.LAUNCHES[k] > before[k]
               for k in ("crc32_rows", "xxh32_rows")) and (
        mode == "store" or write_kernels.LAUNCHES["bitplane_stage"] >
        before["bitplane_stage"])
    assert r.compressed == hr.compressed == (mode == "compress" and
                                             kind == 4)
    assert r.shard_crcs == hr.shard_crcs
    assert np.array_equal(r.chunk_crc32c, hr.chunk_crc32c)
    assert np.array_equal(r.chunk_xxh32, hr.chunk_xxh32)
    for s in host_shards:
        assert np.array_equal(shards[s], host_shards[s]), s
        assert r.shard_crcs[s] == zlib.crc32(shards[s].tobytes())
