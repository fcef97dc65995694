"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``).

They skip where ``torch.cuda.is_available()`` is false, and import neither
JAX nor the ceph_tpu package, so that on a machine with a card they run
without the reference installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

The CUDA kernels have no CPU mode; each test holds one against its plain
PyTorch version on the card (tolerance: none, bit-exact). The GF
bitmatrix kernel on its three designs: bit-sliced for w=8 with k <= 16
when the expanded bitmatrix fits in shared memory, popcount for w=16 with
k <= 8, mma (int8 tensor cores) for every other geometry. The packet
kernel on its three designs: staged through shared memory where k*w
tiles fit, 16-byte columns loaded per set bit past that, byte columns
for other packetsizes or unaligned pointers. The write transform's
kernels (CRC rows, xxh32 rows, the bit-plane stage) on their aligned and
byte paths, and one
``ec_util.encode_fused`` on the card in each mode against the CPU path.
The CRUSH straw2 kernel on both of its designs (tables staged in shared
memory, past 48 KiB too, or read from device memory) on the bench's map,
the 1024-OSD cluster with and without weight sets, a bucket of 20,000
OSDs and a hierarchy of depth 4, each whole sweep equal to the plain
version on the card and sampled seeds to the scalar mapper. And a kernel
at the edge of ``launch_common``'s shared-memory opt-in: 48 KiB of
dynamic shared memory beside static shared memory. The device chunk
tier's kernels: the chunk digest (the 65535 wrap, ragged n, rows not on
16 bytes, a 17 MB row, no rows and rows of 0 bytes, one launch a call)
and the per-lane GF product (both designs, 1, 3, 64 and 70,000 lanes,
one launch a call), dense and with each lane's rows read where they lie
through a table of addresses (rows of several upload batches, w = 8,
16, 32, an unaligned row refused); and the tier on the card: its
consumers, adoption from the pipelined dispatcher with no upload,
eviction. The CRUSH kernel also at every group size (1 to 32 lanes a
seed), on buckets of 1, 3, 17 and 33 items, with forced ties and a
bucket of zero weights, and its profiled launch (the clock split). The
MSR code's geometries: the GF kernel's mma design in row groups (an MSR
decode's [840, 448] in two, a bitmatrix of 3,640 rows, the widest k*w
the opt-in limit holds, one K-tile past it refused with no launch),
k = 10's products past 512 columns in one launch each, dense, per lane
and through a row table, and ``msr_cuda`` k=8, m=7 against the numpy
``msr``. And the observability layer on the card: the dispatcher's stage
fractions and span nesting, the profiler's call counts against each
kernel module's launch counters for one call of every wrapped entry
point, and the chunk tier's ledger category against its resident bytes.
And the multi-device paths on one card repeated (``["cuda:0"] * 4``): the
mesh's sharded encode, decode, recovery and repair (one GF launch a
block), its checksum on the digest kernel (blocks of 74 and 1001 bytes a
row, not multiples of 16, and aligned ones) against ``torch.sum`` and
tripping on a corrupted byte, the rateless dispatcher (stealing, LT
decode, every worker killed), ``mesh_do_rule`` over a flat mesh and
through the queue, and ``dryrun_multichip``. And the placement control
plane on a 64-OSD cluster of two pools: ``OSDMapMapping.update`` (one
straw2 launch a pool, no table upload on a second call, each pool's raw
result equal to the plain version, the mapping to the scalar path's,
four launches a pool over a mesh of four), ``apply_incremental`` (no
launch for an overlay-only inc, a full remap on a weight change), the
balancer's sweeps and ``osdmaptool --test-map-pgs --batched``. And the
native seam on the card: the bridge's dispatcher (coalesced batches, one
GF launch each, parity equal to the native runtime's ``NativeCodec``) and
``update(native=True)`` against ``update()``. And the OSD's erasure-coded
backend (``osd/ec_backend.py``) in a loopback PG with its dispatchers and
chunk tier on the card, against the same seeded sequence on the CPU.
"""

import itertools
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch import registry
from ceph_tpu_torch.common.profiler import PROFILER
from ceph_tpu_torch.common.tracer import SpanCollector
from ceph_tpu_torch.crush import batched, mapper_ref
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, CrushMap, Rule
from ceph_tpu_torch.crush import map as cmap_mod
from ceph_tpu_torch.ops import (crush_kernel, digest_kernel, gf, gf_kernel,
                                gf_ref, launch_check, packet_kernel,
                                write_kernels, xor_mm)
from ceph_tpu_torch.tools import crushtool
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd import fused_transform as ft
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier, host_digest
from ceph_tpu_torch.parallel import mesh as pmesh, rateless
from ceph_tpu_torch.parallel.dryrun import dryrun_multichip

from . import torch_mma_plan as plan

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
    if k * w <= 128:
        return "bitsliced" if w == 8 else "popcount"
    return "mma"


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
    (16, 8, 3, 2050), (16, 9, 3, 2050), (32, 8, 3, 4100), (32, 16, 2, 2052),
    (32, 4, 2, 4100), (32, 1, 1, 260),
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
    (512, 16, "mma"),         # 256 KiB does not, at KMAX = 16, 8 and 4
    (1024, 8, "mma"),
    (2048, 4, "mma"),
])
def test_shared_memory_limit_picks_the_design_on_card(cuda, rows, k, design):
    """A w=8 bitmatrix whose expansion does not fit in shared memory takes
    the mma kernel."""
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
    (1024, 4096, 0), (128, 65536, 0), (40, 4096, 1), (2, 300, 0),
    (3, 4096, 0), (33, 4096, 0), (3, 65536, 0), (33, 65536, 0),
    (33, 4097, 0), (3, 4112, 1), (9, 1040, 0)])
def test_xxh32_rows_match_plain_on_card(cuda, rows, length, offset):
    """Rows on the TMA ring (aligned, a multiple of 16 bytes: whole 1 KiB
    tiles and a partial last one) and on direct loads, at row counts that
    fill a warp's 8 rows and that do not."""
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
    ("low", 128 * 8 * 4096, 0), ("ones", 128 * 8 * 4096, 0),
    ("random", 128 * 8 * 4096, 0), ("low", 16 << 20, 0),
    ("random", 16 << 20, 0), ("low", 8 * 4096 + 64 * 3, 0)])
def test_bitplane_stage_matches_plain_on_card(cuda, kind, n, offset):
    """One cooperative launch: low-entropy, random, all-zero and all-one
    bytes; an unaligned pointer; 16 MiB, past the grid the card holds at
    once (tiles loaded twice); a container whose planes start off 8
    bytes (N not a multiple of 256)."""
    high = {"low": 4, "random": 256, "zeros": 1, "ones": 1}[kind]
    flat = rand_card(cuda, (n,), n + high, offset, high)
    if kind == "ones":
        flat = (flat + 255).contiguous()
    sw, chunk = (8 * 4096, 4096) if n % (8 * 4096) == 0 else (3 * 4097, 4097)
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
def test_bitplane_stage_is_one_launch_without_memset_on_card(cuda,
                                                             monkeypatch):
    """A K3 call is one CUDA launch and clears no buffer: the scratch the
    kernel leaves zeroed is reused by the next call on the stream, which
    then gets the same result."""
    n = 128 * 8 * 4096
    flat = rand_card(cuda, (n,), 11, high=4)
    cap2 = ft.plan_capacity(n, 8 * 4096)
    args = (cap2, 8 * 4096, 4096, 875, 7000)
    first = write_kernels.bitplane_stage(flat, *args)
    torch.cuda.synchronize()
    clears = []
    for name in ("zeros", "zeros_like", "full"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, real=real, name=name,
                            **k: clears.append(name) or real(*a, **k))
    real_zero = torch.Tensor.zero_
    monkeypatch.setattr(torch.Tensor, "zero_",
                        lambda t: clears.append("zero_") or real_zero(t))
    before = write_kernels.launches_by_kernel()
    again = write_kernels.bitplane_stage(flat, *args)
    torch.cuda.synchronize()
    after = write_kernels.launches_by_kernel()
    monkeypatch.undo()
    assert clears == []
    assert {k: after[k] - before[k] for k in after} == {
        "crc_rows": 0, "xxh32": 0, "bitplane": 1}
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


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


@pytest.mark.gpu
def test_smem_edge_launches_on_card(cuda):
    """48 KiB of dynamic shared memory beside 1 KiB of static: the launch
    needs the opt-in that resident_blocks now makes from both sizes."""
    static, sums = launch_check.smem_edge()
    torch.cuda.synchronize()
    assert static == 1024
    assert sums.tolist() == [launch_check.smem_edge_expected()] * 4
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    with pytest.raises(RuntimeError, match="1024 bytes of static and %d"
                       % optin):
        launch_check.smem_edge(optin)


def crush_bench_map():
    rng = np.random.default_rng(7070)
    weights = rng.integers(0x8000, 3 * 0x10000, size=32, dtype=np.uint32)
    m = CrushMap()
    m.type_names = {"osd": 0, "host": 1, "root": 2}
    hids, hw = [], []
    for h in range(8):
        items = [h * 4 + i for i in range(4)]
        w = [int(weights[i]) for i in items]
        hids.append(m.add_bucket("straw2", 1, items, w, id=-2 - h))
        hw.append(sum(w))
    m.add_bucket("straw2", 2, hids, hw, id=-1, name="default")
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSELEAF_INDEP, 5, 1),
                           (cmap_mod.RULE_EMIT,)]))
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                           (cmap_mod.RULE_CHOOSELEAF_FIRSTN, 3, 1),
                           (cmap_mod.RULE_EMIT,)]))
    rw = np.full(32, 0x10000, dtype=np.int64)
    rw[3] = 0
    rw[9] = 0x8000
    return m, rw, None


def crush_layers(n, layers, weight_sets=0):
    m = crushtool.build_map(n, layers)
    m.add_simple_rule("ec", "default", layers[0][0], mode="indep")
    m.add_simple_rule("rep", "default", layers[0][0])
    m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, m.bucket_names["default"]),
                           (cmap_mod.RULE_CHOOSE_INDEP, 4, 0),
                           (cmap_mod.RULE_EMIT,)]))
    rw = np.full(n, 0x10000, dtype=np.int64)
    rw[::97] = 0
    rw[5::89] = 0x8000
    cargs = None
    if weight_sets:
        m.create_choose_args(0, positions=weight_sets)
        for host in range(0, 60, 7):
            m.choose_args_adjust_item_weight(0, -1 - host, host * 16 + 2,
                                             [0x4000 * (p + 1) for p in
                                              range(weight_sets)])
        cargs = 0
    return m, rw, cargs


def crush_cluster(weight_sets=0):
    return crush_layers(1024, [("host", "straw2", 16), ("rack", "straw2", 8),
                               ("root", "straw2", 0)], weight_sets)


def crush_flat(n):
    m = CrushMap()
    m.type_names = {"osd": 0, "root": 1}
    m.add_bucket("straw2", 1, list(range(n)),
                 [0x8000 + (i * 7919) % 0x20000 for i in range(n)], id=-1,
                 name="default")
    for op, numrep in ((cmap_mod.RULE_CHOOSE_INDEP, 6),
                       (cmap_mod.RULE_CHOOSE_FIRSTN, 3)):
        m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1), (op, numrep, 0),
                               (cmap_mod.RULE_EMIT,)]))
    rw = np.full(n, 0x10000, dtype=np.int64)
    rw[::13] = 0
    rw[1::17] = 0x9000
    return m, rw, None


CRUSH_CASES = {
    # name: (map maker, rule, result_max, seeds, design, scalar samples)
    "bench_indep": (crush_bench_map, 0, 5, 4096, "shared", 72),
    "bench_firstn": (crush_bench_map, 1, 3, 4096, "shared", 72),
    "cluster_ec": (crush_cluster, 0, 12, 8192, "shared", 72),
    "cluster_rep": (crush_cluster, 1, 3, 8192, "shared", 72),
    "cluster_ec_weight_sets": (lambda: crush_cluster(2), 0, 12, 8192,
                               "shared", 72),
    "cluster_rep_weight_sets": (lambda: crush_cluster(3), 1, 3, 8192,
                                "shared", 72),
    # a scalar draw over 2,400 or 20,000 items takes the host 0.1-0.6 s
    # 2,400 items: 61,720 bytes of tables with their reciprocals
    "flat_2400_past_48KiB": (lambda: crush_flat(2400), 0, 6, 2048, "shared",
                             12),
    "flat_20000_global": (lambda: crush_flat(20000), 0, 6, 1024, "global",
                          3),
    "flat_20000_global_firstn": (lambda: crush_flat(20000), 1, 3, 512,
                                 "global", 3),
    "depth_4_ec": (lambda: crush_layers(
        512, [("host", "straw2", 8), ("rack", "straw2", 4),
              ("row", "straw2", 4), ("root", "straw2", 0)]), 0, 6, 4096,
        "shared", 72),
    "depth_4_osds": (lambda: crush_layers(
        512, [("host", "straw2", 8), ("rack", "straw2", 4),
              ("row", "straw2", 4), ("root", "straw2", 0)]), 2, 4, 4096,
        "shared", 72),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CRUSH_CASES))
def test_crush_kernel_matches_plain_on_card(cuda, name):
    make, rule, rmax, n, design, samples = CRUSH_CASES[name]
    m, rw, cargs = make()
    args = m.choose_args_get_with_fallback(cargs) if cargs is not None \
        else None
    xs = np.concatenate([np.arange(n - 8), [-1, -(2**31), 2**31 - 1, 2**31,
                                             2**32 - 1, 2**32, 2**40, -5]])
    plan = batched.plan_rule(m, rule, rmax)
    cm = batched.compile_map(m, args)
    wvec = batched.reweight_vector(rw, cm.max_devices)
    assert crush_kernel.kernel_design(cm, plan, wvec.size) == design
    batched.reset_paths()
    crush_kernel.reset_launches()
    xs_dev = torch.from_numpy(xs).to(cuda)
    out = batched.batched_do_rule(m, rule, xs_dev, rmax, rw,
                                  choose_args=cargs, device_out=True)
    torch.cuda.synchronize()
    assert batched.paths() == {"kernel": 1, "plain": 0, "scalar": 0}
    assert crush_kernel.launches_by_design() == {
        d: int(d == design) for d in crush_kernel.DESIGNS}
    assert crush_kernel.LAUNCHES == 1
    plain = batched.map_plain(cm, plan, xs_dev,
                              torch.from_numpy(wvec).to(cuda))
    assert torch.equal(out, plain)
    host = out.cpu().numpy()
    # the 8 seeds past 2^31 and below 0, or two of them on a large bucket
    tail = list(range(n - 8, n)) if samples >= 16 else [n - 5, n - 3]
    picks = np.random.default_rng(n).choice(n - 8, samples - len(tail),
                                            replace=False)
    for i in list(picks) + tail:
        ref = mapper_ref.crush_do_rule(m, rule, int(xs[i]), rmax, list(rw),
                                       choose_args=args)
        assert list(host[i]) == ref + [CRUSH_ITEM_NONE] * (rmax - len(ref))


@pytest.mark.gpu
def test_crush_kernel_counts_its_work_on_card(cuda):
    m, rw, _ = crush_cluster()
    plan = batched.plan_rule(m, 0, 12)
    cm = batched.compile_map(m)
    wvec = batched.reweight_vector(rw, cm.max_devices)
    xs = torch.arange(4096, device=cuda)
    work = torch.zeros((4096, 2), dtype=torch.int32, device=cuda)
    out = crush_kernel.crush_sweep(cm, plan, xs, wvec, work=work)
    again = crush_kernel.crush_sweep(cm, plan, xs, wvec)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    draws = work[:, 0].cpu().numpy()
    # 12 slots of 8 + 8 + 16 draws at least (root, rack, host's OSDs)
    assert draws.min() >= 12 * 32 and work[:, 1].sum().item() > 0


def crush_sweep_held(cuda, m, rw, cargs, rule, rmax, xs, groups):
    """The kernel at each group size in `groups` (0: the map's) equal to
    the plain version on the card, one launch each."""
    args = m.choose_args_get_with_fallback(cargs) if cargs is not None \
        else None
    plan = batched.plan_rule(m, rule, rmax)
    cm = batched.compile_map(m, args)
    wvec = batched.reweight_vector(rw, cm.max_devices)
    xs_dev = torch.from_numpy(np.asarray(xs, dtype=np.int64)).to(cuda)
    plain = batched.map_plain(cm, plan, xs_dev,
                              torch.from_numpy(wvec).to(cuda))
    for g in groups:
        crush_kernel.reset_launches()
        out = crush_kernel.crush_sweep(cm, plan, xs_dev, wvec, group=g)
        torch.cuda.synchronize()
        assert crush_kernel.LAUNCHES == 1
        assert torch.equal(out, plain), g
    return cm, plan, wvec, plain


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bench_indep", "bench_firstn",
                                  "cluster_ec", "cluster_rep_weight_sets",
                                  "flat_20000_global", "depth_4_osds"])
def test_crush_kernel_at_every_group_size_on_card(cuda, name):
    """G = 1 ... 32 lanes a seed: buckets larger than G loop, smaller
    ones leave lanes idle; a seed count that is no multiple of the seeds
    a block holds (128 / G), and the device-memory design."""
    make, rule, rmax, n, design, _ = CRUSH_CASES[name]
    m, rw, cargs = make()
    cm, plan, wvec, _ = crush_sweep_held(cuda, m, rw, cargs, rule, rmax,
                                         np.arange(n - 3),
                                         [1, 2, 4, 8, 16, 32])
    assert crush_kernel.kernel_design(cm, plan, wvec.size) == design


def crush_flat_of(n, weights=None, ids=None):
    """One straw2 bucket of n OSDs under the root, indep and firstn rules
    of min(n, 4) and min(n, 3); choose_args ids / weights when given."""
    m = CrushMap()
    m.type_names = {"osd": 0, "root": 1}
    w = [0x8000 + (i * 7919) % 0x20000 for i in range(n)]
    m.add_bucket("straw2", 1, list(range(n)), w, id=-1, name="default")
    for op, numrep in ((cmap_mod.RULE_CHOOSE_INDEP, min(n, 4)),
                       (cmap_mod.RULE_CHOOSE_FIRSTN, min(n, 3))):
        m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1), (op, numrep, 0),
                               (cmap_mod.RULE_EMIT,)]))
    rw = np.full(n, 0x10000, dtype=np.int64)
    rw[1::7] = 0x9000
    cargs = None
    if weights is not None or ids is not None:
        m.create_choose_args(0, positions=1)
        m.choose_args[0][-1] = {"weight_set": [weights or w], "ids": ids}
        cargs = 0
    return m, rw, cargs


@pytest.mark.gpu
@pytest.mark.parametrize("size", [1, 3, 17, 33])
def test_crush_kernel_on_bucket_sizes_on_card(cuda, size):
    m, rw, cargs = crush_flat_of(size)
    for rule, rmax in ((0, min(size, 4)), (1, min(size, 3))):
        _, _, _, plain = crush_sweep_held(cuda, m, rw, cargs, rule, rmax,
                                          np.arange(4093), [0, 1, 4, 32])
        host = plain.cpu().numpy()
        for x in range(0, 4093, 97):
            ref = mapper_ref.crush_do_rule(m, rule, x, rmax, list(rw))
            assert list(host[x]) == ref + [CRUSH_ITEM_NONE] * (rmax -
                                                               len(ref))


@pytest.mark.gpu
def test_crush_kernel_on_forced_ties_on_card(cuda):
    """Items of one hash id at equal weights draw the same, so the lowest
    index wins: 24 items in 4 pairs of one id (items i and i + 12), and a
    bucket of zero weights, whose every draw is S64_MIN: item 0."""
    ids = [5000 + (i % 12) for i in range(24)]
    m, rw, cargs = crush_flat_of(24, weights=[0x10000] * 24, ids=ids)
    rw = np.full(24, 0x10000, dtype=np.int64)
    _, _, _, plain = crush_sweep_held(cuda, m, rw, cargs, 1, 3,
                                      np.arange(2048), [0, 1, 2, 8, 16])
    host = plain.cpu().numpy()
    assert (host < 12).all()            # item i + 12 never beats item i
    args = m.choose_args_get_with_fallback(cargs)
    for x in range(0, 2048, 61):
        ref = mapper_ref.crush_do_rule(m, 1, x, 3, list(rw),
                                       choose_args=args)
        assert list(host[x]) == ref
    m, rw, cargs = crush_flat_of(5, weights=[0] * 5)
    _, _, _, plain = crush_sweep_held(cuda, m, rw, cargs, 0, 1,
                                      np.arange(512), [0, 1, 4])
    assert (plain == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["indep", "firstn"])
def test_crush_kernel_slots_past_shared_memory_on_card(cuda, op):
    """A rule of as many replicas as result_max (numrep 0) at result_max
    1,100 on a bucket of 8: two rows of 1,100 slots a seed exceed a
    block's 32 KiB even at 32 lanes a seed, so the slots lie in the
    wrapper's scratch; the same result_max under a rule of 3 keeps them
    in shared memory (slots are sized by the replicas, not result_max)."""
    m, rw, _ = crush_flat_of(8)
    step = cmap_mod.RULE_CHOOSE_INDEP if op == "indep" \
        else cmap_mod.RULE_CHOOSE_FIRSTN
    for numrep, scratch in ((0, True), (3, False)):
        rule = m.add_rule(Rule(steps=[(cmap_mod.RULE_TAKE, -1),
                                      (step, numrep, 0),
                                      (cmap_mod.RULE_EMIT,)]))
        plan = batched.plan_rule(m, rule, 1100)
        cm = batched.compile_map(m)
        wvec = batched.reweight_vector(rw, cm.max_devices)
        words = crush_kernel._kernel().crush_straw2_scratch(
            *crush_kernel._geometry(cm, plan, wvec.size), 0, 33)
        assert words == (33 * 2 * 1100 if scratch else 0)
        batched.reset_paths()
        crush_kernel.reset_launches()
        xs = torch.arange(33, device=cuda)
        out = batched.batched_do_rule(m, rule, xs, 1100, rw,
                                      device_out=True)
        torch.cuda.synchronize()
        assert batched.paths()["kernel"] == 1 and crush_kernel.LAUNCHES == 1
        plain = batched.map_plain(cm, plan, xs,
                                  torch.from_numpy(wvec).to(cuda))
        assert torch.equal(out, plain)
        placed = (out != CRUSH_ITEM_NONE).sum(dim=1)
        assert int(placed.min()) >= 1 and int(placed.max()) <= 8


@pytest.mark.gpu
def test_crush_kernel_clock_split_on_card(cuda):
    """A profiled launch fills one row a warp and maps as a plain one."""
    m, rw, _ = crush_cluster()
    plan = batched.plan_rule(m, 0, 12)
    cm = batched.compile_map(m)
    wvec = batched.reweight_vector(rw, cm.max_devices)
    xs = torch.arange(1000, device=cuda)
    rows = crush_kernel.clock_rows(cm, plan, wvec.size, 1000)
    # up to 16,384 seeds leave the card short of 16 warps an SM at G = 4
    # (the largest bucket's square root): G doubles once, to 8; 1,000
    # seeds at 32 lanes stay within 8 warps an SM: a warp a seed
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 1000) == 32
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 2048) == 16
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 8192) == 8
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 16384) == 8
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 32768) == 4
    assert crush_kernel.kernel_group(cm, plan, wvec.size, 1 << 20) == 4
    assert rows == 1000
    clk = torch.zeros((rows, 4), dtype=torch.int64, device=cuda)
    work = torch.zeros((1000, 2), dtype=torch.int32, device=cuda)
    out = crush_kernel.crush_sweep(cm, plan, xs, wvec, work=work,
                                   clocks=clk)
    assert torch.equal(out, crush_kernel.crush_sweep(cm, plan, xs, wvec))
    c = clk.cpu()
    assert (c[:, 0] > 0).all() and (c[:, 1] > 0).all()
    # the lanes active at draw steps are the draws the kernel counted
    assert int(c[:, 2].sum()) == int(work[:, 0].sum())


@pytest.mark.gpu
def test_crush_fallback_on_card_takes_no_launch(cuda):
    m, rw, _ = crush_bench_map()
    b = m.buckets[-3]
    m.buckets[-3] = cmap_mod.Bucket(id=-3, alg="list", type=1, items=b.items,
                                    weights=b.weights)
    batched.reset_paths()
    crush_kernel.reset_launches()
    got = batched.batched_do_rule(m, 0, np.arange(64), 5, rw)
    assert batched.paths() == {"kernel": 0, "plain": 0, "scalar": 1}
    assert crush_kernel.launches_by_design() == {"shared": 0, "global": 0}
    for x in range(64):
        ref = mapper_ref.crush_do_rule(m, 0, x, 5, list(rw))
        assert list(got[x]) == ref + [CRUSH_ITEM_NONE] * (5 - len(ref))


# -- the HBM chunk tier's kernels (csrc/hbm_digest.cu, the per-lane entry
# point of csrc/gf_bitmatrix.cu) ---------------------------------------------

def as_values(t):
    """uint32 results compare as int32 views: torch lacks uint32 ops."""
    return t.view(torch.int32)


def digest_held_against_plain(x, calls=2):
    """One launch a call (none for no rows), equal to the plain version;
    a second call over the same scratch gives the same digests."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else \
        int(torch.Size(x.shape[:-1]).numel())
    plain = [as_values(t) for t in digest_kernel.chunk_digest_plain(x)]
    for _ in range(calls):
        before = digest_kernel.cuda_launches()
        count = digest_kernel.LAUNCHES
        s, ws = digest_kernel.chunk_digest(x)
        torch.cuda.synchronize()
        assert digest_kernel.cuda_launches() - before == int(rows > 0)
        assert digest_kernel.LAUNCHES - count == int(rows > 0)
        assert s.shape == ws.shape == x.shape[:-1]
        assert torch.equal(as_values(s), plain[0])
        assert torch.equal(as_values(ws), plain[1])
    return s, ws


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,offset", [
    (11, 131072, 0), (3, 65535, 0), (3, 65536, 0), (2, 131075, 0),
    (5, 15, 0), (4, 1, 0), (7, 4096, 1), (3, 70000, 3), (64, 16, 0),
    (0, 4096, 0), (3, 0, 0),
])
def test_chunk_digest_matches_plain_on_card(cuda, rows, n, offset):
    """The 65535 wrap (n past 65535), ragged n, rows not on 16 bytes (n %
    16 != 0, or a pointer `offset` bytes off), no rows and rows of 0
    bytes."""
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + n)
    buf = torch.randint(0, 256, (rows * n + offset,), generator=g,
                        dtype=torch.uint8, device=cuda)
    digest_held_against_plain(buf[offset:].view(rows, n))


@pytest.mark.gpu
def test_chunk_digest_wraps_on_card(cuda):
    """Rows of 0xFF past the ws wrap (about 260 bytes), one 17 MB row past
    the s wrap (about 16.8 MB), and [P, k+m, n] chunk stacks."""
    ones = torch.full((4, 65536 + 300), 0xFF, dtype=torch.uint8,
                      device=cuda)
    s, ws = digest_held_against_plain(ones)
    assert as_values(s)[0].item() == 255 * (65536 + 300)
    big = torch.full((1, 17_000_000), 0xFF, dtype=torch.uint8, device=cuda)
    s, _ = digest_held_against_plain(big, calls=1)
    assert as_values(s)[0].item() & 0xFFFFFFFF == \
        (255 * 17_000_000) % (1 << 32)
    g = torch.Generator(device=cuda).manual_seed(11)
    stack = torch.randint(0, 256, (4, 11, 32768 * 3 + 16), generator=g,
                          dtype=torch.uint8, device=cuda)
    digest_held_against_plain(stack)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(131072, 0), (5000, 0), (4096, 1)])
def test_chunk_digest_many_through_a_row_table_on_card(cuda, n, offset):
    """Rows read where they lie: parts of one n in several tensors, a
    pick of sub-tensors along the first dimension, rows on 16 bytes or
    not; one launch, equal to the plain version of the concatenation."""
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    buf = torch.randint(0, 256, (4 * 11 * n + offset,), generator=g,
                        dtype=torch.uint8, device=cuda)
    a = buf[offset:].view(4, 11, n)
    b = torch.randint(0, 256, (3, n), generator=g, dtype=torch.uint8,
                      device=cuda)
    before = digest_kernel.cuda_launches()
    s, ws = digest_kernel.chunk_digest_many([a, b], [[3, 1], None])
    torch.cuda.synchronize()
    assert digest_kernel.cuda_launches() == before + 1
    ps, pws = digest_kernel.chunk_digest_plain(
        torch.cat([a[[3, 1]].reshape(-1, n), b]))
    assert torch.equal(as_values(s), as_values(ps))
    assert torch.equal(as_values(ws), as_values(pws))


def multi_held_against_plain(bms, data, w, design):
    """One launch of the per-lane entry point on `design` (the single-matrix
    counts unchanged), byte-equal to the plain version."""
    assert gf_kernel.kernel_design(bms.shape[1], data.shape[-2], w,
                                   data.device) == design
    single = gf_kernel.launches_by_design()
    before = gf_kernel.launches_by_design(multi=True)
    count = gf_kernel.MULTI_LAUNCHES
    out = gf_kernel.matrix_encode_multi(bms, data, w)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design(multi=True)
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == design) for d in gf_kernel.DESIGNS}
    assert gf_kernel.MULTI_LAUNCHES == count + 1
    assert gf_kernel.launches_by_design() == single
    assert torch.equal(out, gf_kernel.matrix_encode_multi_plain(bms, data, w))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3, 64])
@pytest.mark.parametrize("w,k,rows,lead,n,design", [
    (8, 8, 88, (2,), 32 * 40 + 7, "bitsliced"),   # decode bitmatrices
    (8, 8, 8, (1,), 4096, "bitsliced"),           # one lost shard's rows
    (8, 4, 16, (2, 3), 1000, "bitsliced"),
    (8, 40, 32, (2,), 1024 + 5, "mma"),
    (16, 8, 48, (2,), 2050, "popcount"),
    (32, 4, 64, (1,), 4100, "popcount"),
    (32, 8, 96, (1,), 4100, "mma"),
])
def test_matrix_encode_multi_matches_plain_on_card(cuda, lanes, w, k, rows,
                                                   lead, n, design):
    rng = np.random.default_rng(lanes * 100 + k)
    if rows == (k + 3) * w and w == 8:
        coding = gf.rs_vandermonde_generator(k, 3, w)
        sigs = list(itertools.combinations(range(k + 3), k))
        mats = [decode_bitmat(coding, k, sigs[(p * 37) % len(sigs)], w)
                for p in range(lanes)]
        bms = np.stack(mats)
    else:
        bms = rng.integers(0, 2, (lanes, rows, k * w), dtype=np.uint8)
    data = rng.integers(0, 256, (lanes, *lead, k, n), dtype=np.uint8)
    multi_held_against_plain(torch.from_numpy(bms).to(cuda),
                             torch.from_numpy(data).to(cuda), w, design)


@pytest.mark.gpu
def test_matrix_encode_multi_past_the_grid_rows_on_card(cuda):
    """70,000 lanes: more than gridDim.y holds, so blocks take a second
    lane and stage its bitmatrix after the first."""
    g = torch.Generator(device=cuda).manual_seed(5)
    bms = torch.randint(0, 2, (70_000, 8, 32), generator=g,
                        dtype=torch.uint8, device=cuda)
    data = torch.randint(0, 256, (70_000, 1, 4, 64), generator=g,
                         dtype=torch.uint8, device=cuda)
    multi_held_against_plain(bms, data, 8, "bitsliced")


def rows_held(cuda, bms, parts, rows, w, design):
    """One launch of the table entry point on `design`, equal to the dense
    entry point and the plain version on the rows stacked."""
    k = bms.shape[2] // w
    before = gf_kernel.launches_by_design(multi=True)
    out = gf_kernel.matrix_encode_multi_rows(bms, parts, rows, w)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design(multi=True)
    assert {d: after[d] - before[d] for d in after} == {
        d: int(d == design) for d in gf_kernel.DESIGNS}
    n = parts[0].shape[-1]
    stacked = torch.cat([t.reshape(-1, n)[torch.from_numpy(
        np.asarray(r, dtype=np.int64)).to(cuda)] for t, r in zip(parts, rows)])
    data = stacked.reshape(bms.shape[0], 1, k, n)
    assert torch.equal(out, gf_kernel.matrix_encode_multi(bms, data, w)[:, 0])
    assert torch.equal(out, gf_kernel.matrix_encode_multi_rows_plain(
        bms, parts, rows, w))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,rows,n,design", [
    (8, 8, 8, 4096, "bitsliced"),        # one lost shard's rows
    (8, 8, 88, 16000, "bitsliced"),      # a ragged 32-column unit
    (8, 4, 16, 1024, "bitsliced"),
    (8, 40, 32, 1024, "mma"),
    (16, 8, 48, 2048, "popcount"),
    (32, 4, 64, 4096, "popcount"),
    (32, 8, 96, 4096, "mma"),
])
def test_matrix_encode_multi_rows_on_card(cuda, w, k, rows, n, design):
    """Survivors from several upload batches [B, k+3, n] in one call,
    each lane's rows out of order within its object."""
    rng = np.random.default_rng(k * w + rows)
    g = torch.Generator(device=cuda).manual_seed(k + w)
    batches = [torch.randint(0, 256, (b, k + 3, n), generator=g,
                             dtype=torch.uint8, device=cuda)
               for b in (3, 1, 2)]
    lanes = 7
    picks = [(i % 3, i % batches[i % 3].shape[0]) for i in range(lanes)]
    parts = [batches[b] for b, _ in picks]
    rows_ = [obj * (k + 3) + rng.permutation(k + 3)[:k] for _, obj in picks]
    bms = torch.from_numpy(rng.integers(0, 2, (lanes, rows, k * w),
                                        dtype=np.uint8)).to(cuda)
    rows_held(cuda, bms, parts, rows_, w, design)


@pytest.mark.gpu
def test_matrix_encode_multi_rows_past_the_grid_rows_on_card(cuda):
    """70,000 lanes of one part: more than gridDim.y holds."""
    g = torch.Generator(device=cuda).manual_seed(6)
    bms = torch.randint(0, 2, (70_000, 8, 32), generator=g,
                        dtype=torch.uint8, device=cuda)
    part = torch.randint(0, 256, (70_000, 6, 64), generator=g,
                         dtype=torch.uint8, device=cuda)
    rows = [(np.arange(70_000)[:, None] * 6 + [5, 0, 3, 1]).reshape(-1)]
    rows_held(cuda, bms, [part], rows, 8, "bitsliced")


@pytest.mark.gpu
def test_matrix_encode_multi_rows_refuses_an_unaligned_row_on_card(cuda):
    buf = torch.zeros(4 * 1024 + 1, dtype=torch.uint8, device=cuda)
    part = buf[1:].view(4, 1024)
    bms = torch.zeros((1, 8, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="row at 0x%x is not on 16 bytes"
                       % part.data_ptr()):
        gf_kernel.matrix_encode_multi_rows(bms, [part], None, 8)


# -- the device chunk tier on the card (osd/hbm_tier.py) ----------------------

@pytest.mark.gpu
def test_tier_consumers_on_card(cuda):
    """put_encode (its one upload), deep_scrub (one digest launch), the
    rebuilds (one per-lane launch for the batch), equal to the host."""
    codec = registry.factory("torch_cuda", dict(PROFILE))
    tier = HbmChunkTier(codec)
    assert tier.device.type == "cuda"
    data = np.random.default_rng(4).integers(0, 256, (4, 8, 8192),
                                             dtype=np.uint8)
    names = ["o%d" % i for i in range(4)]
    parity = tier.put_encode(names, data)
    assert parity.is_cuda and tier.uploads() == (1, data.nbytes)
    assert np.array_equal(parity.cpu().numpy(), codec.encode_batch(data))
    full = {n: tier.get(n).cpu().numpy() for n in names}
    before = digest_kernel.cuda_launches()
    digs = tier.deep_scrub(names)
    assert digest_kernel.cuda_launches() == before + 1
    for n in names:
        assert np.array_equal(digs[n], host_digest(full[n]))
    for lost in ((0,), (9,), (1, 10)):
        got = tier.reconstruct("o1", lost).cpu().numpy()
        assert all(np.array_equal(got[j], full["o1"][s])
                   for j, s in enumerate(lost))
    lost = [3, 8, 10, 0]
    before = gf_kernel.MULTI_LAUNCHES
    got = tier.reconstruct_batch(["o2", "o0", "o3", "o1"], lost).cpu()
    assert gf_kernel.MULTI_LAUNCHES == before + 1
    for i, n in enumerate(["o2", "o0", "o3", "o1"]):
        assert np.array_equal(got[i].numpy(), full[n][lost[i]])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["encode", "store", "compress"])
def test_tier_adopts_from_the_pipelined_dispatcher_on_card(cuda, kind):
    """Four writes of one shape back to back with resident= through the
    pipelined dispatcher: no upload by the tier, the dispatcher stages
    each byte once, every entry holds its own write (a staging buffer
    released before the tier's copy would hold the next write's), and
    the fourth evicts the first at capacity 3."""
    codec = registry.factory("torch_cuda", dict(PROFILE))
    tier = HbmChunkTier(codec, capacity_objects=3)
    rng = np.random.default_rng(8)
    high = 4 if kind == "compress" else 256
    batches = [rng.integers(0, high, (16, 8, 4096), dtype=np.uint8)
               for _ in range(4)]
    disp = GpuDispatcher(max_batch=1)
    try:
        if kind == "encode":
            futs = [disp.encode_async(codec, b, resident=(tier, i))
                    for i, b in enumerate(batches)]
        else:
            futs = [disp.fused_write_async(codec, b, mode=kind,
                                           resident=(tier, i))
                    for i, b in enumerate(batches)]
        outs = [f.result(120) for f in futs]
    finally:
        disp.shutdown()
    assert tier.uploads() == (0, 0)
    assert disp.perf.dump()["l_gpu_h2d_bytes"] == sum(b.nbytes
                                                      for b in batches)
    assert disp.perf.dump()["l_gpu_adopted"] == 4
    assert not tier.resident(0) and tier.stats()["evictions"] == 1
    for i in range(1, 4):
        if kind == "encode":
            rows, par, crcs = batches[i], outs[i], None
        else:
            r = ft.result_from_host(outs[i], 16, 8, 4096, kind)
            rows = r.stored if r.stored is not None else batches[i]
            par, crcs = r.parity, r.shard_crcs
            assert r.compressed == (kind == "compress")
        want = np.concatenate([rows, par], 1).transpose(1, 0, 2).reshape(
            11, -1)
        assert np.array_equal(tier.get(i).cpu().numpy(), want)
        assert np.array_equal(tier.deep_scrub([i])[i], host_digest(want))
        if crcs is not None:
            assert list(tier.shard_digests(i)) == crcs
            assert crcs == [zlib.crc32(want[s].tobytes()) for s in range(11)]
        got = tier.reconstruct(i, (2, 9)).cpu().numpy()
        assert np.array_equal(got, want[[2, 9]])


# -- the MSR code's geometries ----------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols", [(840, 448), (3640, 448), (16, 1792)],
                         ids=["msr_decode", "tall", "widest"])
def test_mma_row_groups_on_card(cuda, rows, cols):
    """The MSR decode's [840, 448] (two row groups), a bitmatrix of 3,640
    rows (past what one block's shared memory holds) and the widest k*w
    the opt-in limit takes: the C entry point's plan is the one
    tests/torch_mma_plan.py restates, and each product is one mma launch,
    byte-equal to the plain version."""
    groups = gf_kernel.row_groups(rows, cols // 8, 8, cuda)
    optin = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    assert groups == plan.row_groups(rows, cols, optin)
    assert gf_kernel.max_k(8, cuda) == plan.max_k(8, optin)
    if optin == plan.H100_OPTIN:
        assert len(groups) == {840: 2, 3640: 9, 16: 1}[rows]
    rng = np.random.default_rng(rows)
    bm = torch.from_numpy(rng.integers(0, 2, (rows, cols),
                                       dtype=np.uint8)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, (2, cols // 8, 4 * 1000 + 4),
                                         dtype=np.uint8)).to(cuda)
    held_against_plain(bm, data, 8, "mma")


@pytest.mark.gpu
def test_mma_past_the_widest_launch_on_card(cuda):
    """k*w = 1800: even the smallest row group does not fit beside the
    warps' data tiles, so the wrapper refuses it before any launch, and
    the codecs' entry point runs it as two launches of 113 and 112 data
    rows, byte-equal to the plain version."""
    rng = np.random.default_rng(1800)
    bm = torch.from_numpy(rng.integers(0, 2, (16, 1800),
                                       dtype=np.uint8)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, (2, 225, 1000),
                                         dtype=np.uint8)).to(cuda)
    before = gf_kernel.launches_by_design()
    with pytest.raises(ValueError, match="does not take"):
        gf_kernel.matrix_encode(bm, data, 8)
    torch.cuda.synchronize()
    assert gf_kernel.launches_by_design() == before
    out = xor_mm.matrix_encode(bm, data, 8)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design()
    assert {d: after[d] - before[d] for d in after} == {
        "bitsliced": 0, "mma": 2, "popcount": 0}
    assert torch.equal(out, gf_kernel.matrix_encode_plain(bm, data, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_msr_k17_two_launches_on_card(cuda, which):
    """msr k=17, m=16: [2048, 2176] and [4224, 2176], 272 sub-symbol rows
    past the 224 of one launch: two mma launches of 136 rows each
    through the codec, byte-equal to the plain version."""
    codec = registry.factory("msr_cuda", {"k": "17", "m": "16"},
                             device=cuda)
    rng = np.random.default_rng(17)
    chunk = codec.get_chunk_size(17 * 16 * 64)
    data = torch.from_numpy(rng.integers(0, 256, (2, 17, chunk),
                                         dtype=np.uint8)).to(cuda)
    before = gf_kernel.launches_by_design()
    parity = codec.encode_batch(data)
    avail = tuple(range(0, 33, 2))
    full = torch.cat([data, parity], dim=1)
    if which == "decode":
        before = gf_kernel.launches_by_design()
        got = codec.decode_batch(avail, full[:, list(avail)].contiguous())
        assert torch.equal(got, full)
        bm = torch.from_numpy(codec._decode_entry(avail)["bitmat"]).to(cuda)
        sub = full[:, list(avail)].reshape(2, 272, -1)
    else:
        got = parity
        bm = torch.from_numpy(codec._bitmat).to(cuda)
        sub = data.reshape(2, 272, -1)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design()
    assert {d: after[d] - before[d] for d in after} == {
        "bitsliced": 0, "mma": 2, "popcount": 0}
    plain = gf_kernel.matrix_encode_plain(bm, sub, 8)
    assert torch.equal(got.reshape(plain.shape) if which == "encode"
                       else got.reshape(2, -1, plain.shape[-1]), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["encode", "decode"])
def test_msr_k10_one_launch_on_card(cuda, which):
    """msr k=10, m=9: [648, 720] and [1368, 720], past 512 columns, one
    mma launch each through xor_mm.matrix_encode, byte-equal to the
    plain version."""
    codec = registry.factory("msr_cuda", {"k": "10", "m": "9"},
                             device=cuda)
    bm_np = codec._bitmat if which == "encode" else \
        codec._decode_entry(tuple(range(0, 19, 2)))["bitmat"]
    bm = torch.from_numpy(bm_np).to(cuda)
    data = torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (3, 90, 160 * 9), dtype=np.uint8)).to(cuda)
    before = gf_kernel.launches_by_design()
    out = xor_mm.matrix_encode(bm, data, 8)
    torch.cuda.synchronize()
    after = gf_kernel.launches_by_design()
    assert {d: after[d] - before[d] for d in after} == {
        "bitsliced": 0, "mma": 1, "popcount": 0}
    assert torch.equal(out, gf_kernel.matrix_encode_plain(bm, data, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("w,k", [(8, 90), (16, 45), (32, 20)])
def test_mma_past_512_columns_per_lane_and_row_table_on_card(cuda, w, k):
    """k*w = 720 and 640 (the chunked kernels, 8 N-tiles a step) through
    the per-lane and row-table entry points: one mma launch each, 5 lanes
    of [400, 720] or [416, 640] bitmatrices (3 and 2 row groups on an
    H100), byte-equal to the plain versions."""
    rng = np.random.default_rng(w + k)
    lanes, rows, n = 5, 400 if w < 32 else 416, 1008 * w // 8
    assert len(gf_kernel.row_groups(rows, k, w, cuda)) == (3 if w < 32
                                                           else 2)
    bms = torch.from_numpy(rng.integers(0, 2, (lanes, rows, k * w),
                                        dtype=np.uint8)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, (lanes, 2, k, n),
                                         dtype=np.uint8)).to(cuda)
    multi_held_against_plain(bms, data, w, "mma")
    part = torch.from_numpy(rng.integers(0, 256, (lanes, k + 3, n),
                                         dtype=np.uint8)).to(cuda)
    picks = [p * (k + 3) + rng.permutation(k + 3)[:k] for p in range(lanes)]
    rows_held(cuda, bms, [part], [np.concatenate(picks)], w, "mma")


@pytest.mark.gpu
def test_msr_codec_on_card_matches_host(cuda):
    """msr_cuda k=8, m=7 on the card against the port's numpy msr:
    encode, two decode signatures, a fraction repair; tensors stay on
    the card."""
    prof = {"k": "8", "m": "7"}
    card = registry.factory("msr_cuda", dict(prof))
    host = registry.factory("msr", dict(prof))
    chunk = card.get_chunk_size(1 << 20)
    data = np.random.default_rng(8).integers(0, 256, (2, 8, chunk),
                                             dtype=np.uint8)
    parity = card.encode_batch(torch.from_numpy(data).to(cuda))
    assert parity.is_cuda
    want = host.encode_batch(data)
    assert np.array_equal(parity.cpu().numpy(), want)
    full = np.concatenate([data, want], 1)
    full_dev = torch.from_numpy(full).to(cuda)
    for avail in [(7, 8, 9, 10, 11, 12, 13, 14), (0, 2, 4, 6, 8, 10, 12, 14)]:
        out = card.decode_batch(avail, full_dev[:, list(avail)].contiguous())
        assert torch.equal(out, full_dev)
    target = 2
    helpers = tuple(sorted(card.minimum_to_repair(target, set(range(15)))))
    fracs = torch.stack([card.repair_fraction_batch(
        target, full_dev[:, h].contiguous()) for h in helpers], 1)
    rebuilt = card.repair_combine_batch(target, helpers, fracs)
    assert torch.equal(rebuilt, full_dev[:, target])
    assert np.array_equal(rebuilt.cpu().numpy()[0], host.repair_oracle(
        target, helpers, {h: full[0, h] for h in helpers}))


@pytest.mark.gpu
def test_stage_fractions_and_spans_on_card(cuda):
    """A traced encode and decode per thread through the pipelined
    dispatcher: every fraction of dispatch_profile() lies in [0, 1], each
    op's span has gpu_queue and gpu_device with the three legs nested in
    the latter, and the staging ring is empty once every op is back."""
    codec = registry.factory("torch_cuda", dict(PROFILE))
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (2, 8, 65536), dtype=np.uint8)
    full = np.concatenate([data, codec.encode_batch(data)], axis=1)
    avail = (0, 1, 2, 4, 5, 6, 8, 10)
    tracer = SpanCollector()
    tracer.enabled = True
    PROFILER.mem_set("staging_ring", 0)
    disp = GpuDispatcher(tracer=tracer)
    try:
        roots, futs = [], []
        for _ in range(6):
            r = tracer.start_trace("op")
            futs.append((disp.encode_async(codec, data, trace=r), r))
            r2 = tracer.start_trace("op")
            futs.append((disp.decode_async(
                codec, avail, np.ascontiguousarray(full[:, list(avail)]),
                trace=r2), r2))
        for f, r in futs:
            f.result(120)
            r.finish()
            roots.append(r.trace_id)
        prof = disp.dispatch_profile()
    finally:
        disp.shutdown()
    for row in prof["stages"].values():
        for state in ("busy", "idle", "blocked"):
            assert 0.0 <= row[state + "_frac"] <= 1.0
    assert prof["stages"]["compute"]["busy_s"] > 0
    assert prof["verdict"].startswith(prof["bound"])
    spans = tracer.dump()
    for tid in roots:
        mine = [s for s in spans if s["trace_id"] == tid]
        names = {s["name"]: s for s in mine}
        assert {"op", "gpu_queue", "gpu_device", "h2d", "compute",
                "d2h"} <= set(names)
        dev = names["gpu_device"]
        for leg in ("h2d", "compute", "d2h"):
            assert names[leg]["parent_id"] == dev["span_id"]
            assert names[leg]["duration"] <= dev["duration"] + 1e-6
    assert PROFILER.mem_dump()["staging_ring"]["bytes"] == 0


@pytest.mark.gpu
def test_profiler_counts_equal_launch_counters_on_card(cuda):
    """One call of every wrapped entry point: each is counted once in the
    profiler's registry, and each kernel module counts its launches."""
    rng = np.random.default_rng(22)
    coding = gf.rs_vandermonde_generator(8, 3, 8)
    bm = torch.from_numpy(gf.generator_to_bitmatrix(coding, 8)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, (4, 8, 8192),
                                         dtype=np.uint8)).to(cuda)
    cauchy = registry.factory("torch_cuda", {
        "technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "64"})
    pdata = torch.from_numpy(rng.integers(
        0, 256, (2, 4, cauchy.get_chunk_size(4 * 4096)),
        dtype=np.uint8)).to(cuda)
    cmap = crushtool.build_map(64, [("host", "straw2", 4),
                                    ("root", "straw2", 0)])
    cmap.add_simple_rule("ec", "default", "host", mode="indep")
    cmap.add_simple_rule("rep", "default", "host")
    codec = registry.factory("torch_cuda", dict(PROFILE))
    PROFILER.reset()
    gf_kernel.reset_launches()
    packet_kernel.reset_launches()
    digest_kernel.reset_launches()
    crush_kernel.reset_launches()
    write_kernels.reset_launches()
    xor_mm.matrix_encode(bm, data, 8)
    xor_mm.matrix_encode_multi(torch.stack([bm, bm]), data[:2, None], 8)
    xor_mm.matrix_encode_multi_rows(torch.stack([bm, bm]), [data],
                                    [np.arange(16)], 8)
    cauchy.encode_batch(pdata)
    tier = HbmChunkTier(codec, capacity_objects=4)
    tier.put_encode(["a", "b"], rng.integers(0, 256, (2, 8, 4096),
                                             dtype=np.uint8))
    tier.deep_scrub(["a", "b"])
    seeds = np.arange(1024)
    batched.batched_do_rule(cmap, 0, seeds, 4)
    batched.batched_do_rule(cmap, 1, seeds, 3)
    ft.run_fused(codec, data[:, :, :4096].contiguous())
    ft.device_crc32(b"x" * 1000)
    torch.cuda.synchronize()
    calls = {name: k["compiles"] + k["cache_hits"]
             for name, k in PROFILER.dump()["kernels"].items()}
    assert calls == {"xor_mm.matrix_encode": 2,       # + put_encode's
                     "xor_mm.matrix_encode_multi": 2,
                     "xor_mm.bitmatrix_encode": 1, "hbm_tier.digest": 1,
                     "crush.indep": 1, "crush.firstn": 1,
                     "fused_transform.program": 1,
                     "fused_transform.scrub_crc": 1}
    gf_single = sum(gf_kernel.launches_by_design().values())
    assert gf_single == calls["xor_mm.matrix_encode"] + \
        calls["fused_transform.program"]            # the write's encode
    assert sum(gf_kernel.launches_by_design(multi=True).values()) == \
        calls["xor_mm.matrix_encode_multi"]
    assert sum(packet_kernel.launches_by_design().values()) == \
        calls["xor_mm.bitmatrix_encode"]
    assert digest_kernel.cuda_launches() == calls["hbm_tier.digest"]
    assert sum(crush_kernel.launches_by_design().values()) == \
        calls["crush.indep"] + calls["crush.firstn"]
    # a store write: K1 for the chunks and the shards (3 wrapper calls),
    # K2 once; the scrub's crc is one more K1 call
    assert write_kernels.LAUNCHES == {"crc32_rows": 4, "xxh32_rows": 1,
                                      "bitplane_stage": 0}


@pytest.mark.gpu
def test_tier_ledger_equals_resident_bytes_on_card(cuda):
    codec = registry.factory("torch_cuda", dict(PROFILE))
    rng = np.random.default_rng(23)
    for device, cat in ((None, "hbm_tier"), ("cuda", "hbm_tier[cuda:0]")):
        tier = HbmChunkTier(codec, capacity_objects=6, device=device)
        for i in range(4):
            tier.put_encode([(cat, 2 * i), (cat, 2 * i + 1)],
                            rng.integers(0, 256, (2, 8, 16384),
                                         dtype=np.uint8))
            assert PROFILER.mem_dump()[cat]["bytes"] == \
                tier.stats()["resident_bytes"]
        assert tier.stats()["resident_objects"] == 6       # two evicted
        assert PROFILER.mem_dump()[cat]["high_watermark"] >= \
            tier.stats()["resident_bytes"]
        assert tier.drop_prefix(cat) == 6
        assert PROFILER.mem_dump()[cat]["bytes"] == 0



# -- the mesh legs and the rateless dispatcher on one card ---------------------

def card_mesh(n=4):
    """A mesh of one card repeated: 2 x 2 for n = 4."""
    return pmesh.make_mesh(devices=["cuda:0"] * n)


def gf_launched(fn):
    """fn()'s result and the GF kernel's launches it made, synchronised."""
    torch.cuda.synchronize()
    before = gf_kernel.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    return out, gf_kernel.LAUNCHES - before


@pytest.mark.gpu
def test_mesh_legs_on_card(cuda):
    """encode_sharded / decode_sharded / recover_sharded of RS k=8, m=3
    over a 2 x 2 mesh of one card: one GF launch a block, every output
    equal to the single-device path and the plain version, the host
    input's result on the host, a CUDA input's on the card."""
    codec = registry.factory("torch_cuda", dict(PROFILE))
    rng = np.random.default_rng(1414)
    data = rng.integers(0, 256, (8, 8, 8192), dtype=np.uint8)
    mesh = card_mesh()
    parity, launched = gf_launched(
        lambda: pmesh.encode_sharded(codec, data, mesh))
    assert launched == 4 and isinstance(parity, np.ndarray)
    x = torch.from_numpy(data).to(cuda)
    plain = gf_kernel.matrix_encode_plain(codec._device_bitmat(x.device), x, 8)
    assert np.array_equal(parity, plain.cpu().numpy())
    assert np.array_equal(parity, codec.encode_batch(data))
    on_card = pmesh.encode_sharded(codec, x, mesh)
    assert on_card.is_cuda and torch.equal(on_card, plain)
    full = np.concatenate([data, parity], axis=1)
    avail = (0, 2, 3, 4, 6, 7, 8, 10)
    dec, launched = gf_launched(lambda: pmesh.decode_sharded(
        codec, avail, full[:, list(avail)], mesh))
    assert launched == 4 and np.array_equal(dec, full)
    before = digest_kernel.LAUNCHES
    row, launched = gf_launched(lambda: pmesh.recover_sharded(
        codec, avail, full[:7, list(avail), :8000], 5, mesh=mesh))
    assert launched == 4 and digest_kernel.LAUNCHES - before == 4
    assert np.array_equal(row, full[:7, 5, :8000])


@pytest.mark.gpu
def test_mesh_checksum_on_card_and_corruption(cuda):
    """The checksum's digest path on blocks whose width is not a multiple
    of 16 bytes (74 and 1001 columns) and on aligned ones, against
    torch.sum on the card; one corrupted byte trips recover_sharded and
    repair_sharded."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for shape, mesh in (((4, 3, 2 * 74), card_mesh(4)),        # 74 a block
                        ((2, 5, 3 * 1001),                     # 1001
                         pmesh.make_mesh(devices=["cuda:0"] * 3)),
                        ((4, 8, 2 * 4096), card_mesh(4))):     # aligned
        x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                          device=cuda)
        blocks = pmesh._place(x, mesh, 1)
        before = digest_kernel.LAUNCHES
        got = pmesh._checksum(blocks)
        assert digest_kernel.LAUNCHES - before == len(blocks)
        plain = sum(int(torch.sum(b.data, dtype=torch.int64)) % (1 << 32)
                    for b in blocks) % (1 << 32)
        assert got == plain == int(torch.sum(x, dtype=torch.int64)) % (1 << 32)
    codec = registry.factory("torch_cuda", dict(PROFILE))
    data = np.random.default_rng(2).integers(0, 256, (4, 8, 1000),
                                             dtype=np.uint8)
    full = np.concatenate([data, codec.encode_batch(data)], axis=1)
    chunks = np.ascontiguousarray(full[:, 1:9])
    expected = int(chunks.astype(np.uint64).sum()) % (1 << 32)
    chunks[2, 3, 999] ^= 1
    with pytest.raises(pmesh.MeshChecksumError):
        pmesh.recover_sharded(codec, tuple(range(1, 9)), chunks, 0,
                              mesh=card_mesh(), expected_sum=expected)
    msr = registry.factory("msr_cuda", {"technique": "msr", "k": "4",
                                        "m": "3", "w": "8"})
    host = registry.factory("msr", {"technique": "msr", "k": "4", "m": "3",
                                    "w": "8"})
    chunk = msr.get_chunk_size(4 * 4096)
    mdata = np.random.default_rng(3).integers(0, 256, (3, 4, chunk),
                                              dtype=np.uint8)
    mfull = np.concatenate([mdata, host.encode_batch(mdata)], axis=1)
    helpers = tuple(sorted(msr.minimum_to_repair(2, set(range(7)))))
    fracs = np.stack([host.repair_fraction_batch(
        2, np.ascontiguousarray(mfull[:, h])) for h in helpers], 1)
    rebuilt, launched = gf_launched(lambda: pmesh.repair_sharded(
        msr, 2, helpers, fracs, mesh=card_mesh()))
    assert launched == 4 and np.array_equal(rebuilt, mfull[:, 2])
    expected = int(fracs.astype(np.uint64).sum()) % (1 << 32)
    fracs[0, 0, 0] ^= 1
    with pytest.raises(pmesh.MeshChecksumError):
        pmesh.repair_sharded(msr, 2, helpers, fracs, mesh=card_mesh(),
                             expected_sum=expected)


@pytest.mark.gpu
def test_rateless_dispatcher_on_card(cuda):
    """Four workers on one card, each on its own stream: encode under
    stalls (stealing), LT-coded decode, and every worker killed (the
    caller's thread finishes on the codec's card), each equal to the
    single-device call; the speculative ledger ends at 0."""
    codec = registry.factory("torch_cuda", dict(PROFILE))
    data = np.random.default_rng(7).integers(0, 256, (16, 8, 16384),
                                             dtype=np.uint8)
    want = codec.encode_batch(data)
    full = np.concatenate([data, want], axis=1)
    avail = (1, 2, 3, 4, 5, 6, 8, 9)
    inj = rateless.DeviceFaultSet(seed=1)
    rl = rateless.RatelessDispatcher(devices=["cuda:0"] * 4, injector=inj,
                                     name="card-rl")
    try:
        assert len({id(t) for t in rl._threads}) == 4
        for idx in (1, 3):
            inj.stall_ms(idx, 5.0)
        assert np.array_equal(rl.encode(codec, data), want)
        assert rl.status()["stolen_total"] > 0
        inj.clear_all()
        for seed in (0, 1):
            assert np.array_equal(rl.decode(codec, avail,
                                            full[:, list(avail)],
                                            lt=True, seed=seed), full)
        for idx in range(4):
            inj.kill(idx)
        assert np.array_equal(rl.encode(codec, data), want)
    finally:
        inj.clear_all()
        rl.shutdown()
    assert rl._spec_bytes == 0


@pytest.mark.gpu
def test_mesh_do_rule_on_card(cuda):
    """The flat-mesh sweep over one card repeated: one kernel launch a
    share, the seeds padded (4,097 over 4) and trimmed, equal to the
    single sweep and the plain version on the card; then through a
    dispatcher's queue."""
    m = crushtool.build_map(64, [("host", "straw2", 4),
                                 ("root", "straw2", 0)])
    m.add_simple_rule("rep", "default", "host")
    xs = np.arange(4_097)
    one = batched.batched_do_rule(m, 0, xs, 3, device=cuda)
    cm, plan = batched.compile_map(m), batched.plan_rule(m, 0, 3)
    wvec = torch.from_numpy(batched.reweight_vector(None, cm.max_devices))
    plain = batched.map_plain(cm, plan, torch.from_numpy(xs).to(cuda),
                              wvec.to(cuda))
    assert np.array_equal(one, plain.cpu().numpy())
    batched.reset_paths()
    got = batched.mesh_do_rule(m, 0, xs, 3, mesh=batched.make_batch_mesh(
        devices=["cuda:0"] * 4))
    assert batched.paths() == {"kernel": 4, "plain": 0, "scalar": 0}
    assert np.array_equal(got, one)
    rl = rateless.RatelessDispatcher(devices=["cuda:0"] * 4, name="crush-rl")
    rateless.set_dispatcher(rl)
    try:
        batched.reset_paths()
        assert np.array_equal(batched.mesh_do_rule(m, 0, xs, 3), one)
        assert batched.paths()["kernel"] >= 16
    finally:
        rateless.reset_dispatcher()


@pytest.mark.gpu
def test_dryrun_multichip_on_card(cuda):
    doc = dryrun_multichip(["cuda:0"] * 4)
    assert doc["mesh"] == {"stripe": 2, "block": 2}


def placement_map():
    """A 64-OSD cluster of 16 hosts (``crushtool --build``) with two pools:
    pool 1 replicated size 3 over hosts (256 PGs), pool 2 EC of 6 slots
    over hosts (64 PGs) with a two-position weight set under
    choose_args[2]; every 13th OSD out, every 7th from OSD 3 at half
    weight."""
    from ceph_tpu_torch.osd.osd_map import Incremental, OSDMap, PGPool
    crush = crushtool.build_map(64, [("host", "straw2", 4),
                                     ("root", "straw2", 0)])
    rep = crush.add_simple_rule("rep", "default", "host")
    ec = crush.add_simple_rule("ec", "default", "host", mode="indep",
                               rule_type=cmap_mod.POOL_TYPE_ERASURE)
    crush.create_choose_args(2, positions=2)
    for host in (2, 5, 11):
        crush.choose_args_adjust_item_weight(2, -1 - host, host * 4 + 1,
                                             [0x4000, 0xC000])
    m = OSDMap()
    inc = Incremental(1)
    inc.new_max_osd = 64
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(pool_id=1, name="rbd", size=3, pg_num=256,
                              crush_rule=rep)
    inc.new_pools[2] = PGPool(pool_id=2, name="ec", size=6, pg_num=64,
                              crush_rule=ec,
                              type=cmap_mod.POOL_TYPE_ERASURE)
    for osd in range(64):
        inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
        inc.new_weight[osd] = 0 if osd % 13 == 0 else \
            0x8000 if osd % 7 == 3 else 0x10000
    m.apply_incremental(inc)
    return m


def remap(m, **kw):
    from ceph_tpu_torch.osd.osd_map import OSDMapMapping
    mapping = OSDMapMapping()
    mapping.update(m, **kw)
    return mapping


@pytest.mark.gpu
def test_full_remap_on_card(cuda):
    """OSDMapMapping.update on the card: one straw2 launch a pool, no
    table upload on a second call, each pool's raw result equal to the
    plain version on the card, the mapping equal to the plain version's
    and the scalar path's (by_osd in order); over a flat mesh of four,
    four launches a pool and the same mapping."""
    m = placement_map()
    crush_kernel.clear_tables()
    crush_kernel.reset_launches()
    batched.reset_paths()
    card = remap(m)
    assert crush_kernel.LAUNCHES == 2 and crush_kernel.UPLOADS == 2
    assert batched.paths() == {"kernel": 2, "plain": 0, "scalar": 0}
    crush_kernel.reset_launches()
    again = remap(m)
    assert crush_kernel.LAUNCHES == 2 and crush_kernel.UPLOADS == 0
    plain = remap(m, device="cpu")
    scalar = remap(m, batched=False)
    for other in (again, plain, scalar):
        assert other.by_pg == card.by_pg and other.by_osd == card.by_osd
    for pool_id, pool in m.pools.items():
        args = m.crush.choose_args_get_with_fallback(pool_id)
        cm = batched.compile_map(m.crush, args)
        plan = batched.plan_rule(m.crush, pool.crush_rule, pool.size)
        wvec = batched.reweight_vector(m._weight_vector(), cm.max_devices)
        seeds = torch.from_numpy(pool.pps_of(np.arange(pool.pg_num)))
        want = batched.map_plain(cm, plan, seeds.to(cuda),
                                 torch.from_numpy(wvec).to(cuda))
        assert np.array_equal(card.raw[pool_id], want.cpu().numpy())
    crush_kernel.reset_launches()
    meshed = remap(m, mesh=batched.make_batch_mesh(devices=["cuda:0"] * 4))
    assert crush_kernel.LAUNCHES == 8
    assert meshed.by_pg == card.by_pg and meshed.by_osd == card.by_osd


@pytest.mark.gpu
def test_churn_on_card(cuda):
    """apply_incremental after a full remap on the card: an overlay-only
    inc recomputes its PGs on the host (no launch) to the full remap's
    mapping; a weight change falls back to a full remap, one launch a
    pool."""
    from ceph_tpu_torch.osd.osd_map import Incremental, PGID
    m = placement_map()
    mapping = remap(m)
    inc = Incremental(m.epoch + 1)
    inc.new_pg_temp = {PGID(1, ps): [1, 6, 10] for ps in range(0, 40, 5)}
    inc.new_primary_temp = {PGID(2, 3): 20, PGID(1, 7): 6}
    inc.new_pg_upmap_items = {PGID(1, 9): [(mapping.by_pg[PGID(1, 9)][0][0],
                                            63)]}
    inc.new_down = [4, 30]
    m.apply_incremental(inc)
    crush_kernel.reset_launches()
    info = mapping.apply_incremental(m, inc)
    assert info["mode"] == "incremental" and 0 < info["recomputed"] < 320
    assert crush_kernel.LAUNCHES == 0
    full = remap(m)
    assert mapping.by_pg == full.by_pg
    assert {o: sorted(p, key=str) for o, p in mapping.by_osd.items() if p} \
        == {o: sorted(p, key=str) for o, p in full.by_osd.items() if p}
    inc2 = Incremental(m.epoch + 1)
    inc2.new_weight = {8: 0x4000}
    m.apply_incremental(inc2)
    crush_kernel.reset_launches()
    assert mapping.apply_incremental(m, inc2) == {"mode": "full",
                                                  "recomputed": 320}
    assert crush_kernel.LAUNCHES == 2
    assert mapping.by_pg == remap(m, batched=False).by_pg


@pytest.mark.gpu
def test_balancer_on_card(cuda):
    """calc_pg_upmaps with its sweeps on the card: the proposal of the
    plain version's sweeps, one launch a pool a sweep, the tables
    uploaded by the first sweep only."""
    from ceph_tpu_torch.osd import balancer
    m = placement_map()
    crush_kernel.clear_tables()
    crush_kernel.reset_launches()
    card = balancer.calc_pg_upmaps(m, max_changes=12, changes_per_sweep=4)
    assert card.num_changed > 0
    assert crush_kernel.LAUNCHES == 2 * card.sweeps
    assert crush_kernel.UPLOADS == 2
    host = balancer.calc_pg_upmaps(m, max_changes=12, changes_per_sweep=4,
                                   device="cpu")
    assert (card.new_pg_upmap_items, card.old_pg_upmap_items,
            card.start_deviation, card.end_deviation, card.sweeps) == \
        (host.new_pg_upmap_items, host.old_pg_upmap_items,
         host.start_deviation, host.end_deviation, host.sweeps)


@pytest.mark.gpu
def test_osdmaptool_batched_on_card(cuda, tmp_path, capsys):
    from ceph_tpu_torch.tools import osdmaptool
    import json as json_
    path = tmp_path / "map.json"
    path.write_text(json_.dumps(osdmaptool.osdmap_to_json(placement_map())))
    reports = []
    for extra in (["--batched"], []):
        capsys.readouterr()
        assert osdmaptool.main([str(path), "--test-map-pgs"] + extra) == 0
        reports.append(capsys.readouterr().out)
    assert reports[0] == reports[1] and "total 320 pgs" in reports[0]


@pytest.mark.gpu
def test_native_bridge_on_card(cuda):
    """The native bridge's dispatcher on the card: 8 threads' encodes of
    RS k=8, m=3 coalesce into fewer batches, each one GF kernel launch,
    every parity equal to the native runtime's NativeCodec; after
    uninstall_dispatcher a bridge encode raises."""
    import concurrent.futures

    from ceph_tpu_torch import native
    k, m, n = 8, 3, 65536
    ref = native.NativeCodec("jerasure", dict(PROFILE))
    data = np.random.default_rng(16).integers(0, 256, (8, k, n),
                                              dtype=np.uint8)
    want = np.empty((8, m, n), dtype=np.uint8)
    for b in range(8):
        ref.encode_chunks(data[b], want[b])
    dispatch = native.install_cuda_dispatcher(max_batch=8,
                                              max_delay_us=20000)
    try:
        gf_kernel.reset_launches()
        b0 = native.lib().ec_tpu_batches_dispatched()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(native.bridge_encode, k, m, 8,
                                "reed_sol_van", list(data[b]))
                    for b in range(8)]
            got = [f.result(timeout=120) for f in futs]
        batches = native.lib().ec_tpu_batches_dispatched() - b0
    finally:
        native.uninstall_dispatcher()
    for b in range(8):
        assert got[b] == [want[b, j].tobytes() for j in range(m)]
    assert 1 <= batches < 8 and gf_kernel.LAUNCHES == batches
    assert dispatch.device.type == "cuda"
    with pytest.raises(OSError):
        native.bridge_encode(k, m, 8, "reed_sol_van", list(data[0]))


@pytest.mark.gpu
def test_update_native_on_card(cuda):
    """update(native=True) maps as update() on the card, each pool on
    the native host mapper and no straw2 launch."""
    m = placement_map()
    card = remap(m)
    crush_kernel.reset_launches()
    host = remap(m, native=True)
    assert crush_kernel.LAUNCHES == 0
    assert {p: s["path"] for p, s in host.split.items()} == \
        {1: "native", 2: "native"}
    assert host.by_pg == card.by_pg and host.by_osd == card.by_osd
    for pool_id in m.pools:
        assert np.array_equal(host.raw[pool_id], card.raw[pool_id])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rs_store", "rs_compress", "msr"])
def test_ec_backend_on_card_equals_cpu(cuda, case):
    """The port's ECBackend in a loopback PG with its dispatchers and
    chunk tier on the card runs tests/torch_ec_sequence.py's seeded
    sequence (writes, tier reads and rebuilds, bitrot, RMW overwrites,
    appends, reads, EIO, degraded reads, rebuilds with the tier off) to
    the same reads, rebuilt shards, messages and shard stores as on the
    CPU, through the card's kernels."""
    from . import test_torch_ec_backend as ecb
    gf_kernel.reset_launches()
    write_kernels.reset_launches()
    card = ecb.port_run(case, device="cuda")
    torch.cuda.synchronize()
    by_design = gf_kernel.launches_by_design()
    writes = dict(write_kernels.LAUNCHES)
    host = ecb.port_run(case, device="cpu")
    for label, got, want in card["reads"] + card["rebuilt"]:
        assert got == want, label
    assert [r[1] for r in card["reads"]] == [r[1] for r in host["reads"]]
    assert [r[1] for r in card["rebuilt"]] == \
        [r[1] for r in host["rebuilt"]]
    assert ecb.stable_routes(card) == ecb.stable_routes(host)
    assert card["stores"] == host["stores"]
    assert card["logs"] == host["logs"]
    # every product here, MSR k=4's sub-symbol ones included (k*w = 96),
    # takes the bit-sliced design
    assert by_design["bitsliced"] > 0
    if case != "msr":
        assert writes["crc32_rows"] > 0 and writes["xxh32_rows"] > 0
