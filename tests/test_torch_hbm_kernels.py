"""The device chunk tier's two kernels' functions, against the JAX package.

``ops/digest_kernel.py`` ``chunk_digest_plain`` (the function of
``csrc/hbm_digest.cu``) against the reference's jitted ``_device_digest``
(``ceph_tpu/osd/hbm_tier.py:60-78``) and its numpy twin ``host_digest``;
``ops/gf_kernel.py`` ``matrix_encode_multi_plain`` (the function of
``csrc/gf_bitmatrix.cu``'s per-lane entry point) against
``ceph_tpu.ops.xor_mm.matrix_encode_multi``. On the CPU the wrappers run
these plain versions; the GPU tests hold the kernels against them on the
card. Inputs come from a numpy seed; every comparison is byte-exact.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import xor_mm as jxor
from ceph_tpu.osd import hbm_tier as jtier
from ceph_tpu_torch.ops import digest_kernel, gf_kernel
from ceph_tpu_torch.osd.hbm_tier import host_digest

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def reference_digest(x: np.ndarray):
    jtier._init_device_digest()
    s, ws = jtier._device_digest(x)
    return np.asarray(s).astype(np.uint32), np.asarray(ws).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 15, 4096, 65535, 65536, 131075])
def test_chunk_digest_matches_reference(n):
    """The weight's period is 65535: n past it wraps the weights."""
    rows = max(1, 6 * 65536 // max(n, 4096))
    x = np.random.default_rng(n).integers(0, 256, (rows, n), dtype=np.uint8)
    s, ws = digest_kernel.chunk_digest(torch.from_numpy(x))
    rs, rws = reference_digest(x)
    assert np.array_equal(u32(s), rs) and np.array_equal(u32(ws), rws)
    packed = (u32(ws).astype(np.uint64) << np.uint64(32)) | \
        u32(s).astype(np.uint64)
    assert np.array_equal(packed, host_digest(x))


def test_chunk_digest_weighted_sum_wraps():
    """Rows of 0xFF: ws passes 2^32 at about 260 bytes; chunks of several
    leading dims keep their shape."""
    x = np.full((2, 3, 65536 + 300), 0xFF, np.uint8)
    s, ws = digest_kernel.chunk_digest(torch.from_numpy(x))
    assert s.shape == ws.shape == (2, 3)
    rs, rws = reference_digest(x)
    assert np.array_equal(u32(s), rs) and np.array_equal(u32(ws), rws)
    assert int(u32(s)[0, 0]) == 255 * (65536 + 300)


def test_chunk_digest_sum_wraps():
    """One row of 2^24 + 64 bytes of 0xFF: s passes 2^32 (host_digest
    only: the reference's jit of this shape costs more than it shows)."""
    x = np.full((1, (1 << 24) + 64), 0xFF, np.uint8)
    s, ws = digest_kernel.chunk_digest(torch.from_numpy(x))
    packed = (u32(ws).astype(np.uint64) << np.uint64(32)) | \
        u32(s).astype(np.uint64)
    assert np.array_equal(packed, host_digest(x))
    assert int(u32(s)[0]) == (255 * ((1 << 24) + 64)) % (1 << 32)


def test_chunk_digest_many_is_the_concatenation():
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, shape, dtype=np.uint8)
             for shape in ((2, 3, 70000), (5, 70000), (70000,))]
    s, ws = digest_kernel.chunk_digest_many(
        [torch.from_numpy(p) for p in parts])
    flat = np.concatenate([p.reshape(-1, 70000) for p in parts])
    packed = (u32(ws).astype(np.uint64) << np.uint64(32)) | \
        u32(s).astype(np.uint64)
    assert np.array_equal(packed, host_digest(flat))


def test_chunk_digest_many_picks_sub_tensors():
    """picks[i] selects sub-tensors along part i's first dimension (a
    tier's objects in its upload batches), in the order given."""
    rng = np.random.default_rng(4)
    parts = [rng.integers(0, 256, (4, 3, 5000), dtype=np.uint8),
             rng.integers(0, 256, (2, 5000), dtype=np.uint8)]
    picks = [[2, 0, 3], None]
    s, ws = digest_kernel.chunk_digest_many(
        [torch.from_numpy(p) for p in parts], picks)
    flat = np.concatenate([parts[0][[2, 0, 3]].reshape(-1, 5000), parts[1]])
    packed = (u32(ws).astype(np.uint64) << np.uint64(32)) | \
        u32(s).astype(np.uint64)
    assert np.array_equal(packed, host_digest(flat))


def test_chunk_digest_rejects_bad_input():
    with pytest.raises(ValueError):
        digest_kernel.chunk_digest(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        digest_kernel.chunk_digest(torch.zeros((4, 8), dtype=torch.uint8).t())
    with pytest.raises(ValueError):
        digest_kernel.chunk_digest_many(
            [torch.zeros((2, 8), dtype=torch.uint8),
             torch.zeros((2, 9), dtype=torch.uint8)])


def decode_bitmats(k, m, w, lanes):
    coding = jgf.rs_vandermonde_generator(k, m, w)
    sigs = list(itertools.combinations(range(k + m), k))
    mats = []
    for p in range(lanes):
        avail = sigs[(p * 7 + 1) % len(sigs)]
        dec = jgf.decode_matrix(coding, k, avail, w)
        full = np.concatenate([dec, jgf.gf_matmul(coding, dec, w)])
        mats.append(jgf.generator_to_bitmatrix(full, w))
    return np.stack(mats)


@pytest.mark.parametrize("k,m,w,n", [(8, 3, 8, 4096), (4, 2, 16, 2048)])
def test_matrix_encode_multi_matches_reference(k, m, w, n):
    """P = 3 lanes, each its own RS decode bitmatrix, [P, 2, k, N]."""
    bms = decode_bitmats(k, m, w, 3)
    data = np.random.default_rng(k * w).integers(0, 256, (3, 2, k, n),
                                                 dtype=np.uint8)
    ref = np.asarray(jax.device_get(jxor.matrix_encode_multi(bms, data, w)))
    got = gf_kernel.matrix_encode_multi(torch.from_numpy(bms),
                                        torch.from_numpy(data), w)
    assert got.shape == ref.shape == (3, 2, k + m, n)
    assert np.array_equal(got.numpy(), ref)
    # one lane's rows alone (what reconstruct_batch passes): the same rows
    part = gf_kernel.matrix_encode_multi(
        torch.from_numpy(np.ascontiguousarray(bms[:, w:2 * w])),
        torch.from_numpy(data), w)
    assert np.array_equal(part.numpy()[:, :, 0], ref[:, :, 1])


def test_matrix_encode_multi_is_per_lane_matrix_encode():
    rng = np.random.default_rng(9)
    bms = rng.integers(0, 2, (4, 16, 32), dtype=np.uint8)
    data = rng.integers(0, 256, (4, 3, 4, 96), dtype=np.uint8)
    got = gf_kernel.matrix_encode_multi(torch.from_numpy(bms),
                                        torch.from_numpy(data), 8)
    for p in range(4):
        one = gf_kernel.matrix_encode(torch.from_numpy(bms[p]),
                                      torch.from_numpy(data[p]), 8)
        assert torch.equal(got[p], one)


@pytest.mark.parametrize("bms_shape,data_shape", [
    ((3, 16, 32), (2, 1, 4, 64)),     # lanes differ
    ((16, 32), (3, 1, 4, 64)),        # no lane dimension
    ((3, 16, 40), (3, 1, 4, 64)),     # k*w differs
])
def test_matrix_encode_multi_rejects_bad_shapes(bms_shape, data_shape):
    with pytest.raises(ValueError):
        gf_kernel.matrix_encode_multi(
            torch.zeros(bms_shape, dtype=torch.uint8),
            torch.zeros(data_shape, dtype=torch.uint8), 8)


@pytest.mark.parametrize("k,m,w,n", [(8, 3, 8, 4096), (4, 2, 16, 2048),
                                     (4, 2, 32, 1024)])
def test_matrix_encode_multi_rows_matches_reference(k, m, w, n):
    """The survivors read where they lie: lane p's k rows picked from
    three "upload batches" [B, k+m, n] out of order, against the JAX
    package's matrix_encode_multi on the same rows stacked."""
    lanes = 5
    bms = decode_bitmats(k, m, w, lanes)
    rng = np.random.default_rng(k * w + n)
    batches = [rng.integers(0, 256, (b, k + m, n), dtype=np.uint8)
               for b in (3, 2, 1)]
    picks = [(1, 0), (0, 2), (2, 0), (1, 1), (0, 1)]   # (batch, object)
    shards = [rng.permutation(k + m)[:k] for _ in range(lanes)]
    parts, rows, stacked = [], [], []
    for (b, obj), sh in zip(picks, shards):
        parts.append(torch.from_numpy(batches[b]))
        rows.append(obj * (k + m) + sh)
        stacked.append(batches[b][obj][sh])
    ref = np.asarray(jax.device_get(jxor.matrix_encode_multi(
        bms, np.stack(stacked)[:, None], w)))[:, 0]
    got = gf_kernel.matrix_encode_multi_rows(torch.from_numpy(bms), parts,
                                             rows, w)
    assert got.shape == ref.shape == (lanes, k + m, n)
    assert np.array_equal(got.numpy(), ref)
    dense = gf_kernel.matrix_encode_multi(
        torch.from_numpy(bms), torch.from_numpy(np.stack(stacked)[:, None]),
        w)[:, 0]
    assert torch.equal(got, dense)


@pytest.mark.parametrize("rows", [[np.arange(7)], [np.arange(9)],
                                  [np.array([0, 1, 2, 99])]])
def test_matrix_encode_multi_rows_rejects_bad_rows(rows):
    """Two lanes of k=4 need 8 rows, each inside its part."""
    bms = torch.zeros((2, 8, 32), dtype=torch.uint8)
    part = torch.zeros((2, 11, 64), dtype=torch.uint8)
    if rows[0].size == 4:
        rows = [rows[0], np.arange(4)]
        parts = [part, part]
    else:
        parts = [part]
    with pytest.raises((ValueError, IndexError)):
        gf_kernel.matrix_encode_multi_rows(bms, parts, rows, 8)
