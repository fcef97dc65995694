"""Tests of the PyTorch port that need a CUDA card (marker ``gpu``).

They skip where ``torch.cuda.is_available()`` is false, and import neither
JAX nor the ceph_tpu package, so that on a machine with a card they run
without the reference installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

The CUDA kernel has no CPU mode; each test holds it against its plain
PyTorch version on the card (tolerance: none, bit-exact).
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch import registry
from ceph_tpu_torch.ops import gf, gf_kernel, gf_ref
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bitmats(k, m, w):
    coding = gf.rs_vandermonde_generator(k, m, w)
    avail = tuple(range(m, k + m))
    dec = gf.decode_matrix(coding, k, avail, w)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, w)], axis=0)
    return [gf.generator_to_bitmatrix(coding, w),
            gf.generator_to_bitmatrix(full, w)]


@pytest.mark.gpu
@pytest.mark.parametrize("w,k,m,n", [
    (8, 8, 3, 4096), (8, 12, 4, 1000), (8, 2, 1, 512), (8, 40, 4, 1024),
    (16, 8, 3, 2050), (32, 8, 3, 4100), (32, 16, 2, 2052),
])
def test_kernel_matches_plain_on_card(cuda, w, k, m, n):
    rng = np.random.default_rng(w * 1000 + k)
    before = gf_kernel.LAUNCHES
    for mat in bitmats(k, m, w):
        bm = torch.from_numpy(mat).to(cuda)
        data = torch.from_numpy(rng.integers(0, 256, (3, k, n),
                                             dtype=np.uint8)).to(cuda)
        out = gf_kernel.matrix_encode(bm, data, w)
        torch.cuda.synchronize()
        assert torch.equal(out, gf_kernel.matrix_encode_plain(bm, data, w))
    assert gf_kernel.LAUNCHES == before + 2


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
