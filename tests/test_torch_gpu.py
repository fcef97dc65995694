"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``).

They skip where ``torch.cuda.is_available()`` is false, and import neither
JAX nor the ceph_tpu package, so that on a machine with a card they run
without the reference installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

The CUDA kernels have no CPU mode; each test holds one against its plain
PyTorch version on the card (tolerance: none, bit-exact). The GF
bitmatrix kernel on both of its designs: bit-sliced for w=8 with k <= 16
when the expanded bitmatrix fits in shared memory, popcount for every
other geometry. The packet kernel on both of its paths: 16-byte columns
when the packetsize is a multiple of 16 and both pointers are aligned,
byte columns otherwise.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch import registry
from ceph_tpu_torch.ops import gf, gf_kernel, gf_ref, packet_kernel, xor_mm
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

def packet_held_against_plain(bm, data, w, packetsize):
    """One launch, on the path the geometry and alignment take, byte-equal
    to the plain version."""
    path = "vector" if packetsize % 16 == 0 and data.data_ptr() % 16 == 0 \
        else "byte"
    before = packet_kernel.launches_by_path()
    count = packet_kernel.LAUNCHES
    out = packet_kernel.bitmatrix_encode(bm, data, w, packetsize)
    torch.cuda.synchronize()
    after = packet_kernel.launches_by_path()
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in packet_kernel.PATHS}
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
