"""GF bitmatrix kernel of the PyTorch port against the JAX reference.

The port's wrapper (``ceph_tpu_torch.ops.gf_kernel.matrix_encode``) runs
its plain PyTorch version for CPU tensors; here that version is held
byte-for-byte (tolerance: none) against the Pallas kernel
``ceph_tpu.ops.pallas_gf.matrix_encode8`` in interpret mode and against
``ceph_tpu.ops.xor_mm.matrix_encode``, on every case of
tests/test_pallas.py, plus w=16 and w=32. The CUDA kernel itself is held
against the same plain version on the card by tests/test_torch_gpu.py.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import gf_ref as jgf_ref
from ceph_tpu.ops import pallas_gf
from ceph_tpu.ops import xor_mm as jxor_mm
from ceph_tpu_torch.ops import gf, gf_kernel, xor_mm

from . import torch_mma_plan as plan
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def make_bitmat(k, m, w=8):
    coding = gf.rs_vandermonde_generator(k, m, w)
    return coding, gf.generator_to_bitmatrix(coding, w)


def port_encode(bm, data, w=8):
    return gf_kernel.matrix_encode(torch.from_numpy(bm),
                                   torch.from_numpy(data), w).numpy()


def decode_bitmat(coding, k, avail, w=8):
    dec = gf.decode_matrix(coding, k, avail, w)
    full = np.concatenate([dec, gf.gf_matmul(coding, dec, w)], axis=0)
    return gf.generator_to_bitmatrix(full, w)


def test_port_generator_equals_reference():
    for w in (8, 16, 32):
        coding, bm = make_bitmat(8, 3, w)
        assert np.array_equal(coding, jgf.rs_vandermonde_generator(8, 3, w))
        assert np.array_equal(bm, jgf.generator_to_bitmatrix(coding, w))


@pytest.mark.parametrize("k,m,batch,n", [
    (8, 3, 4, 1024),     # flagship geometry
    (2, 1, 1, 512),      # minimal
    (12, 4, 3, 1536),    # wide
])
def test_plain_matches_pallas_and_xla(k, m, batch, n):
    _, bm = make_bitmat(k, m)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(batch, k, n), dtype=np.uint8)
    pallas = np.asarray(pallas_gf.matrix_encode8(
        jnp.asarray(bm), jnp.asarray(data), interpret=True))
    xla = np.asarray(jxor_mm.matrix_encode(jnp.asarray(bm),
                                           jnp.asarray(data), 8))
    out = port_encode(bm, data)
    assert np.array_equal(out, pallas)
    assert np.array_equal(out, xla)


def test_decode_matrix_shape_matches_pallas():
    """The same kernel serves decode bitmatrices ([(k+m)*8, k*8])."""
    coding, _ = make_bitmat(4, 2)
    bm = decode_bitmat(coding, 4, (0, 2, 3, 5))
    rng = np.random.default_rng(3)
    chunks = rng.integers(0, 256, size=(1, 4, 512), dtype=np.uint8)
    pallas = np.asarray(pallas_gf.matrix_encode8(
        jnp.asarray(bm), jnp.asarray(chunks), interpret=True))
    assert np.array_equal(port_encode(bm, chunks), pallas)


@pytest.mark.parametrize("n", [512 + 128, 1024 + 384, 2048 - 128])
def test_ragged_tail_matches_padded_pallas(n):
    """The port takes any N directly; the Pallas kernel needs the tail
    zero-padded to its 512-byte tile. Both agree with gf_ref."""
    rng = np.random.default_rng(11)
    k = 4
    coding, bm = make_bitmat(k, 2)
    data = rng.integers(0, 256, size=(2, k, n), dtype=np.uint8)
    pad = (-n) % pallas_gf._TILE_N
    padded = jnp.pad(jnp.asarray(data), ((0, 0), (0, 0), (0, pad)))
    pallas = np.asarray(pallas_gf.matrix_encode8(
        jnp.asarray(bm), padded, interpret=True))[..., :n]
    out = port_encode(bm, data)
    assert np.array_equal(out, pallas)
    want = np.stack([jgf_ref.matrix_encode_ref(coding, d, 8) for d in data])
    assert np.array_equal(out, want)


@pytest.mark.parametrize("w", [16, 32])
@pytest.mark.parametrize("decode", [False, True])
def test_wide_words_match_xla(w, decode):
    k, m = 8, 3
    coding, bm = make_bitmat(k, m, w)
    if decode:
        bm = decode_bitmat(coding, k, (1, 2, 4, 5, 6, 8, 9, 10), w)
    rng = np.random.default_rng(w)
    data = rng.integers(0, 256, size=(2, k, 1024), dtype=np.uint8)
    xla = np.asarray(jxor_mm.matrix_encode(jnp.asarray(bm),
                                           jnp.asarray(data), w))
    assert np.array_equal(port_encode(bm, data, w), xla)


@pytest.mark.parametrize("rows,k", [(512, 16), (1024, 8), (2048, 4)])
def test_tall_random_bitmatrix_matches_xla(rows, k):
    """w=8 bitmatrices too tall for the bit-sliced design's shared memory,
    which the card runs on the mma kernel, are taken by the wrapper."""
    rng = np.random.default_rng(rows)
    bm = rng.integers(0, 2, (rows, k * 8), dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, k, 96), dtype=np.uint8)
    xla = np.asarray(jxor_mm.matrix_encode(jnp.asarray(bm),
                                           jnp.asarray(data), 8))
    assert np.array_equal(port_encode(bm, data), xla)


def test_launch_counts_are_zero_before_a_build(monkeypatch):
    monkeypatch.setattr(gf_kernel, "_lib", None)
    monkeypatch.setattr(gf_kernel, "LAUNCHES", 5)
    gf_kernel.reset_launches()
    assert gf_kernel.LAUNCHES == 0
    assert gf_kernel.launches_by_design() == {"bitsliced": 0, "mma": 0,
                                              "popcount": 0}


def test_xor_mm_routes_to_the_wrapper():
    _, bm = make_bitmat(8, 3)
    data = np.random.default_rng(5).integers(0, 256, (2, 8, 256),
                                             dtype=np.uint8)
    out = xor_mm.matrix_encode(torch.from_numpy(bm), torch.from_numpy(data),
                               8)
    assert np.array_equal(out.numpy(), port_encode(bm, data))


def test_cpu_tensor_takes_plain_version_without_launch():
    _, bm = make_bitmat(8, 3)
    data = torch.zeros((1, 8, 64), dtype=torch.uint8)
    before = gf_kernel.LAUNCHES
    out = gf_kernel.matrix_encode(torch.from_numpy(bm), data, 8)
    assert out.shape == (1, 3, 64) and out.dtype == torch.uint8
    assert gf_kernel.LAUNCHES == before


@pytest.mark.parametrize("case", [
    "dtype", "bitmat_dtype", "columns", "too_wide", "rows", "ragged_w",
    "noncontiguous", "w",
])
def test_wrapper_rejects(case, monkeypatch):
    _, bm = make_bitmat(8, 3)
    bm = torch.from_numpy(bm)
    data = torch.zeros((1, 8, 64), dtype=torch.uint8)
    w = 8
    if case == "dtype":
        data = data.to(torch.int16)
    elif case == "bitmat_dtype":
        bm = bm.to(torch.int32)
    elif case == "columns":
        data = torch.zeros((1, 7, 64), dtype=torch.uint8)
    elif case == "too_wide":        # k*w = 57*32 = 1824 > 1792 on an H100
        # the card's entry point as tests/torch_mma_plan.py restates it:
        # -1 (refused) where no row group fits, so the wrapper raises
        # before any launch; 56 rows pass
        class Card:
            @staticmethod
            def gf_bitmatrix_design(rows, k, w):
                return 1 if plan.group_tiles(rows, k * w,
                                             plan.H100_OPTIN) else -1

        monkeypatch.setattr(gf_kernel, "_kernel", Card)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        gf_kernel._check_geometry(32, 56 * 32, 56, 64, 32, "cuda")
        with pytest.raises(ValueError, match="does not take"):
            gf_kernel._check_geometry(32, 57 * 32, 57, 64, 32, "cuda")
        return
    elif case == "rows":
        bm = bm[:20].contiguous()
    elif case == "ragged_w":        # N must be a multiple of w/8
        w = 16
        bm = torch.from_numpy(make_bitmat(8, 3, 16)[1])
        data = torch.zeros((1, 8, 63), dtype=torch.uint8)
    elif case == "noncontiguous":
        data = torch.zeros((1, 8, 128), dtype=torch.uint8)[..., ::2]
    elif case == "w":
        w = 11
    with pytest.raises((TypeError, ValueError)):
        gf_kernel.matrix_encode(bm, data, w)



PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__a9876c8f_15_gf_bitmatrix_cu_87fc942319gf_bitsliced_kernelILi16EEEvPKhiiS2_Phxxb' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__a9876c8f_15_gf_bitmatrix_cu_87fc942319gf_bitsliced_kernelILi16EEEvPKhiiS2_Phxxb
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gf_bitmatrix_kernelILi32ELi16EEEvPKhiiS2_Phxxb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119gf_bitmatrix_kernelILi32ELi16EEEvPKhiiS2_Phxxb
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    from ceph_tpu_torch.ops import _build
    (tmp_path / "k.log").write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    assert _build.ptxas_report("k") == {
        "_ZN48_GLOBAL__N__a9876c8f_15_gf_bitmatrix_cu_87fc942319"
        "gf_bitsliced_kernelILi16EEEvPKhiiS2_Phxxb": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 168, "smem": 0},
        "_ZN12_GLOBAL__N_119gf_bitmatrix_kernelILi32ELi16EEEvPKhiiS2_Phxxb": {
            "stack": 24, "spill_stores": 8, "spill_loads": 12,
            "registers": 255, "smem": 1024},
    }


def test_sweep_bitmatrices_equal_the_reference():
    from ceph_tpu_torch.tools import gf_kernel_sweep
    mats = gf_kernel_sweep.bitmatrices()
    coding = jgf.rs_vandermonde_generator(8, 3, 8)
    assert np.array_equal(mats["encode"],
                          jgf.generator_to_bitmatrix(coding, 8))
    dec = jgf.decode_matrix(coding, 8, (3, 4, 5, 6, 7, 8, 9, 10), 8)
    full = np.concatenate([dec, jgf.gf_matmul(coding, dec, 8)])
    assert np.array_equal(mats["decode345678910"],
                          jgf.generator_to_bitmatrix(full, 8))


def test_packet_sweep_bitmatrices_equal_the_reference():
    from ceph_tpu_torch.tools import gf_kernel_sweep
    mats = gf_kernel_sweep.packet_bitmatrices()
    coding = jgf.cauchy_good_generator(10, 4, 8)
    assert np.array_equal(mats["encode"],
                          jgf.generator_to_bitmatrix(coding, 8))
    dec = jgf.decode_matrix(coding, 10, tuple(range(4, 14)), 8)
    full = np.concatenate([dec, jgf.gf_matmul(coding, dec, 8)])
    assert np.array_equal(mats["decode0123"],
                          jgf.generator_to_bitmatrix(full, 8))
    assert mats["decode0123"].shape == (112, 80)


def test_sweep_fails_without_a_card(monkeypatch, capsys):
    from ceph_tpu_torch.tools import gf_kernel_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gf_kernel_sweep.main(["--batches", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("rows,out_rows,want_ms,want_by", [
    (24, 3, 0.006886629253731343, "bytes"),        # encode [16, 8, 2^17]
    (88, 11, 0.011895976119402985, "bytes"),       # decode
])
def test_gf_bound_of_the_main_path(rows, out_rows, want_ms, want_by):
    from ceph_tpu_torch.utils.cuda_timing import gf_bound
    meta = dict(dtype=torch.uint8, device="meta")
    ms, by = gf_bound(torch.empty(rows, 64, **meta),
                      torch.empty(16, 8, 131072, **meta),
                      torch.empty(16, out_rows, 131072, **meta), 8)
    assert by == want_by and ms == pytest.approx(want_ms, rel=1e-12)
