"""The port's MSR regenerating code against the JAX package's.

``ceph_tpu_torch``'s ``msr`` (numpy) and ``msr_cuda`` (``device="cpu"``,
the GF kernel's plain version) against ``ceph_tpu``'s ``msr`` (numpy),
its ``msr_tpu`` once for parity, and its ``repair_oracle``, at K=4, M=3
(the decode bank) and k=8, m=7 (the bench's geometry, decode tables on
the host), on inputs made from numpy seeds. Every comparison is
byte-exact (tolerance: none): GF arithmetic is exact. The reference's
outputs are computed once per shape, in module-scoped fixtures.
"""

import errno
import itertools
import threading

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.models.matrix_base import load_msr_state
from ceph_tpu_torch.ops import gf, gf_kernel, gf_ref, xor_mm
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H100_OPTIN = 232448       # shared_memory_per_block_optin of an H100
GEOMETRIES = [(4, 3), (8, 7)]


def profile(k, m, **extra):
    return {"technique": "msr", "k": str(k), "m": str(m), "w": "8", **extra}


def port(k, m, plugin="msr_cuda"):
    kw = {"device": "cpu"} if plugin == "msr_cuda" else {}
    return registry.factory(plugin, profile(k, m), **kw)


@pytest.fixture(scope="module", params=GEOMETRIES,
                ids=["K4M3", "k8m7"])
def case(request):
    """The reference numpy codec, the port's two codecs, and one batch
    encoded by the reference: its data, every chunk and 4 stripes."""
    k, m = request.param
    ref = jregistry.factory("msr", profile(k, m))
    chunk = ref.get_chunk_size(4096 * k)
    data = np.random.default_rng(k * 10 + m).integers(
        0, 256, (3, k, chunk), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_batch(data)], axis=1)
    return {"k": k, "m": m, "ref": ref, "data": data, "full": full,
            "numpy": port(k, m, "msr"), "cuda": port(k, m)}


@pytest.fixture(scope="module")
def tpu_outputs():
    """msr_tpu's encode, fraction and combine at K=4, M=3 (one compile
    each)."""
    codec = jregistry.factory("msr_tpu", profile(4, 3))
    rng = np.random.default_rng(43)
    data = rng.integers(0, 256, (2, 4, codec.get_chunk_size(4096)),
                        dtype=np.uint8)
    full = np.concatenate([data, np.asarray(codec.encode_batch(data))], 1)
    target = 2
    helpers = tuple(sorted(codec.minimum_to_repair(target,
                                                   set(range(7)))))
    fracs = np.stack([np.asarray(codec.repair_fraction_batch(
        target, np.ascontiguousarray(full[:, h]))) for h in helpers], 1)
    comb = np.asarray(codec.repair_combine_batch(target, helpers, fracs))
    return {"data": data, "full": full, "target": target,
            "helpers": helpers, "fracs": fracs, "comb": comb}


# -- construction ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_generator_equals_reference(case, backend):
    ref, codec = case["ref"], case[backend]
    assert codec._x == ref._x and codec._lam == ref._lam
    assert np.array_equal(codec._psi, ref._psi)
    assert np.array_equal(codec._g_sys, ref._g_sys)
    assert np.array_equal(codec.coding, ref.coding)
    assert np.array_equal(codec._bitmat, ref._bitmat)
    k, m, alpha = case["k"], case["m"], case["k"] - 1
    assert codec._bitmat.shape == (m * alpha * 8, k * alpha * 8)
    assert codec._xor_rows == [] and codec.get_alignment() == \
        ref.get_alignment()
    load_msr_state(codec, ref._x, ref._lam, ref._psi, ref._g_sys,
                   ref.coding, ref._bitmat)
    assert np.array_equal(codec._bitmat, ref._bitmat)
    assert codec._xor_rows == []


@pytest.mark.parametrize("field", ["x", "lam", "psi", "g_sys", "coding",
                                   "bitmat"])
def test_load_msr_state_refuses_a_different_generator(field):
    ref = jregistry.factory("msr", profile(4, 3))
    codec = port(4, 3)
    state = {"x": list(ref._x), "lam": list(ref._lam),
             "psi": ref._psi.copy(), "g_sys": ref._g_sys.copy(),
             "coding": ref.coding.copy(), "bitmat": ref._bitmat.copy()}
    if field in ("x", "lam"):
        state[field][1] ^= 1
    else:
        state[field][0, 0] ^= 1
    with pytest.raises(ValueError, match="differs"):
        load_msr_state(codec, **state)


@pytest.mark.parametrize("prof,code", [
    (profile(4, 3, w="16"), errno.EINVAL),
    (profile(2, 3), errno.EINVAL),
    (profile(5, 3), errno.EINVAL),
    (profile(4, 0), errno.EINVAL),
    ({"technique": "msr", "k": "4", "m": "3", "mapping": "DD_"},
     errno.EINVAL),
], ids=["w16", "k2", "m_below_k-1", "m0", "mapping"])
def test_profile_errors_match_reference(prof, code):
    with pytest.raises(ErasureCodeError) as mine:
        registry.factory("msr", dict(prof))
    with pytest.raises(Exception) as theirs:
        jregistry.factory("msr", dict(prof))
    assert mine.value.errno == code == theirs.value.errno


def test_profile_echo():
    mine, theirs = profile(8, 7), profile(8, 7)
    codec = registry.factory("msr_cuda", mine, device="cpu")
    jregistry.factory("msr", theirs)
    assert mine == theirs
    assert (mine["d"], mine["beta"], mine["alpha"]) == ("14", "1", "7")
    assert codec.supports_repair() and codec.repair_helper_count() == 14
    assert codec.repair_fraction() == pytest.approx(1 / 7)


def test_bench_geometry():
    """bench.py run_recovery's sizes: a 1 MiB object at k=8, m=7."""
    codec = port(8, 7, "msr")
    chunk = codec.get_chunk_size(1 << 20)
    assert (chunk, codec.repair_sub_size(chunk)) == (131152, 18736)
    # 14 fractions against Reed-Solomon k=8's 8 chunks of 131,072 bytes
    assert 14 * 18736 / (1 << 20) == pytest.approx(0.2502, abs=1e-4)


# -- encode and decode ---------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_encode_equals_reference(case, backend):
    codec, k = case[backend], case["k"]
    out = codec.encode_batch(case["data"])
    assert isinstance(out, np.ndarray)
    assert np.array_equal(out, case["full"][:, k:])
    t = codec.encode_batch(torch.from_numpy(case["data"]))
    if backend == "cuda":      # a tensor stays a tensor on its device
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        t = t.numpy()
    assert np.array_equal(t, case["full"][:, k:])


def test_encode_equals_msr_tpu(tpu_outputs):
    for plugin in ("msr", "msr_cuda"):
        codec = port(4, 3, plugin)
        assert np.array_equal(codec.encode_batch(tpu_outputs["data"]),
                              tpu_outputs["full"][:, 4:])


def _signatures(k, m):
    sigs = list(itertools.combinations(range(k + m), k))
    if len(sigs) <= 64:
        return sigs
    pick = np.random.default_rng(k + m).choice(len(sigs), 20, replace=False)
    return [sigs[i] for i in sorted(pick)]


def test_decode_signatures_equal_reference(case):
    """Every signature at K=4 (through the decode bank), 20 at k=8
    (tables built on the host), on both port codecs."""
    k, m, full, ref = case["k"], case["m"], case["full"], case["ref"]
    sigs = _signatures(k, m)
    for avail in sigs:
        chunks = np.ascontiguousarray(full[:, list(avail)])
        want = ref.decode_batch(avail, chunks)
        assert np.array_equal(want, full)
        for backend in ("numpy", "cuda"):
            assert np.array_equal(case[backend].decode_batch(avail, chunks),
                                  want), (backend, avail)
    cuda = case["cuda"]
    if k == 4:
        assert len(sigs) == 35
        assert tuple(cuda._bank_dev.shape) == (35, 168, 96)
    else:
        assert len(sigs) == 20 and cuda._bank_state == "infeasible"


def test_decode_needs_k_chunks(case):
    codec, k = case["cuda"], case["k"]
    with pytest.raises(ErasureCodeError) as e:
        codec.decode_batch(tuple(range(k - 1)),
                           np.zeros((1, k - 1, 56 * k), np.uint8))
    assert e.value.errno == errno.EIO
    with pytest.raises(ErasureCodeError) as e:
        codec.encode_batch(np.zeros((1, k, k * (k - 1) + 1), np.uint8))
    assert e.value.errno == errno.EINVAL


# -- repair --------------------------------------------------------------------

def _repair(codec, full, target):
    n = full.shape[1]
    helpers = tuple(sorted(codec.minimum_to_repair(target, set(range(n)))))
    fracs = np.stack([codec.repair_fraction_batch(
        target, np.ascontiguousarray(full[:, h])) for h in helpers], 1)
    return helpers, fracs, codec.repair_combine_batch(target, helpers, fracs)


def test_repair_equals_reference_and_oracle(case):
    k, m, full, ref = case["k"], case["m"], case["full"], case["ref"]
    for target in (0, k - 1, k, k + m - 1):
        helpers, fracs, comb = _repair(ref, full, target)
        assert np.array_equal(comb, full[:, target])
        assert fracs.shape[1:] == (2 * (k - 1), full.shape[2] // (k - 1))
        oracle = [ref.repair_oracle(target, helpers,
                                    {h: full[b, h] for h in helpers})
                  for b in range(full.shape[0])]
        for backend in ("numpy", "cuda"):
            codec = case[backend]
            h2, f2, c2 = _repair(codec, full, target)
            assert h2 == helpers
            assert np.array_equal(f2, fracs), (backend, target)
            assert np.array_equal(c2, comb), (backend, target)
            for b in range(full.shape[0]):
                assert np.array_equal(codec.repair_oracle(
                    target, helpers, {h: full[b, h] for h in helpers}),
                    oracle[b])


def test_repair_equals_msr_tpu(tpu_outputs):
    t = tpu_outputs
    assert np.array_equal(t["comb"], t["full"][:, t["target"]])
    for plugin in ("msr", "msr_cuda"):
        helpers, fracs, comb = _repair(port(4, 3, plugin), t["full"],
                                       t["target"])
        assert helpers == t["helpers"]
        assert np.array_equal(fracs, t["fracs"])
        assert np.array_equal(comb, t["comb"])


def test_repair_tensor_in_tensor_out(case):
    codec, full, k = case["cuda"], case["full"], case["k"]
    helpers, fracs, comb = _repair(codec, full, 1)
    tf = codec.repair_fraction_batch(1, torch.from_numpy(
        np.ascontiguousarray(full[:, helpers[0]])))
    assert isinstance(tf, torch.Tensor) and np.array_equal(tf.numpy(),
                                                           fracs[:, 0])
    tc = codec.repair_combine_batch(1, helpers, torch.from_numpy(fracs))
    assert isinstance(tc, torch.Tensor) and np.array_equal(tc.numpy(), comb)
    assert codec.table_cache_stats()["entries"] >= 2


def test_repair_entries_cached_like_the_reference(case):
    codec, ref, k = case["cuda"], case["ref"], case["k"]
    helpers = tuple(range(1, 2 * k - 1))
    for a, b in ((codec._fraction_entry(0), ref._fraction_entry(0)),
                 (codec._combine_entry(0, helpers),
                  ref._combine_entry(0, helpers))):
        assert np.array_equal(a["gf"], b["gf"])
        assert np.array_equal(a["bitmat"], b["bitmat"])
    assert codec._decode_cache.get(("frac", 0)) is not None
    assert codec._decode_cache.get(("comb", 0, helpers)) is not None


@pytest.mark.parametrize("what", ["below_d", "combine_count",
                                  "target_in_helpers", "unknown_chunk"])
def test_repair_errors(what):
    codec = port(4, 3)
    if what == "below_d":
        with pytest.raises(ErasureCodeError) as e:
            codec.minimum_to_repair(0, {1, 2, 3, 4, 5})
        assert e.value.errno == errno.EIO
        assert codec.minimum_to_repair(0, {1, 2, 3, 4, 5, 6}) == \
            {1, 2, 3, 4, 5, 6}
    elif what == "combine_count":
        with pytest.raises(ErasureCodeError) as e:
            codec.repair_combine_batch(0, (1, 2, 3, 4, 5),
                                       np.zeros((1, 5, 48), np.uint8))
        assert e.value.errno == errno.EIO
    elif what == "target_in_helpers":
        with pytest.raises(ErasureCodeError) as e:
            codec.repair_combine_batch(0, (0, 1, 2, 3, 4, 5),
                                       np.zeros((1, 6, 48), np.uint8))
        assert e.value.errno == errno.EINVAL
    else:
        with pytest.raises(ErasureCodeError) as e:
            codec.repair_fraction_batch(9, np.zeros((1, 144), np.uint8))
        assert e.value.errno == errno.EINVAL


def test_chunk_mapping_repair_equals_reference():
    prof = profile(4, 3, mapping="D_DD_D_")
    mine = registry.factory("msr_cuda", dict(prof), device="cpu")
    theirs = jregistry.factory("msr", dict(prof))
    data = np.random.default_rng(9).integers(
        0, 256, (2, 4, theirs.get_chunk_size(8192)), dtype=np.uint8)
    assert np.array_equal(mine.encode_batch(data), theirs.encode_batch(data))
    logical = np.concatenate([data, theirs.encode_batch(data)], axis=1)
    phys = {theirs.chunk_index(i): logical[:, i] for i in range(7)}
    target = theirs.chunk_index(1)
    helpers = tuple(sorted(theirs.minimum_to_repair(target, set(phys))))
    fr = np.stack([theirs.repair_fraction_batch(target, phys[h])
                   for h in helpers], 1)
    assert np.array_equal(
        np.stack([mine.repair_fraction_batch(target, phys[h])
                  for h in helpers], 1), fr)
    assert np.array_equal(mine.repair_combine_batch(target, helpers, fr),
                          phys[target])


# -- the GF kernel's geometries: the column and row splits ---------------------

@pytest.mark.parametrize("rows,cols,limit,want_rows,want_cols", [
    (392, 448, H100_OPTIN, [(0, 392)], [(0, 448)]),
    (840, 448, H100_OPTIN, [(0, 840)], [(0, 448)]),
    (3632, 448, H100_OPTIN, [(0, 3632)], [(0, 448)]),
    (3640, 448, H100_OPTIN, [(0, 3632), (3632, 3640)], [(0, 448)]),
    (648, 720, H100_OPTIN, [(0, 648)], [(0, 512), (512, 720)]),
    (1368, 720, H100_OPTIN, [(0, 1368)], [(0, 512), (512, 720)]),
    (1368, 720, None, [(0, 1368)], [(0, 512), (512, 720)]),
    (840, 448, 48 * 1024, [(0, 768), (768, 840)], [(0, 448)]),
], ids=["msr_encode", "msr_decode", "optin_edge", "optin_edge+1",
        "k10_encode", "k10_decode", "cpu", "default_48KiB"])
def test_split_blocks(rows, cols, limit, want_rows, want_cols):
    assert xor_mm.split_blocks(rows, cols, 8, limit) == (want_rows,
                                                         want_cols)
    if limit is not None:
        assert all(gf_kernel.mask_bytes(r1 - r0, min(cols, 512)) <= limit
                   for r0, r1 in want_rows)


def test_cpu_has_no_shared_memory_limit():
    assert gf_kernel.smem_limit("cpu") is None
    bm = torch.zeros((3640, 448), dtype=torch.uint8)
    out = gf_kernel.matrix_encode(bm, torch.zeros((1, 56, 16),
                                                  dtype=torch.uint8), 8)
    assert out.shape == (1, 455, 16)


@pytest.fixture
def counted(monkeypatch):
    """Kernel wrapper calls (one launch each on a card) by the split."""
    calls = []
    real = gf_kernel.matrix_encode

    def spy(bm, data, w):
        calls.append((tuple(bm.shape), tuple(data.shape)))
        return real(bm, data, w)

    monkeypatch.setattr(gf_kernel, "matrix_encode", spy)
    return calls


def test_k10_encode_and_decode_split_in_two(counted):
    """msr k=10, m=9: encode [648, 720] and decode [1368, 720] go past
    the kernel's 512 columns, so each is two launches, byte-equal to
    gf_ref."""
    codec = port(10, 9)
    assert codec._bitmat.shape == (648, 720)
    chunk = codec.get_chunk_size(10 * 1440)
    data = np.random.default_rng(10).integers(0, 256, (2, 10, chunk),
                                              dtype=np.uint8)
    parity = codec.encode_batch(data)
    assert counted == [((648, 512), (2, 64, chunk // 9)),
                       ((648, 208), (2, 26, chunk // 9))]
    for b in range(2):
        sub = data[b].reshape(90, chunk // 9)
        assert np.array_equal(
            parity[b].reshape(81, -1),
            gf_ref.matrix_encode_ref(codec.coding, sub, 8))
    full = np.concatenate([data, parity], axis=1)
    avail = (0, 2, 4, 6, 8, 10, 12, 14, 16, 18)
    del counted[:]
    out = codec.decode_batch(avail, np.ascontiguousarray(full[:, avail]))
    assert [c[0] for c in counted] == [(1368, 512), (1368, 208)]
    assert np.array_equal(out, full)
    entry = codec._decode_entry(avail)
    for b in range(2):
        sub = full[b, list(avail)].reshape(90, -1)
        assert np.array_equal(out[b].reshape(171, -1),
                              gf_ref.matrix_encode_ref(entry["gf"], sub, 8))


def test_split_encode_rows_and_columns_against_gf_ref():
    """A row split forced by a small limit, beside the column split, on
    the plain version: the same bytes as one product."""
    rng = np.random.default_rng(11)
    gen = rng.integers(0, 256, (40, 70), dtype=np.uint8)
    bm = torch.from_numpy(gf.generator_to_bitmatrix(gen, 8))
    data = rng.integers(0, 256, (2, 70, 96), dtype=np.uint8)
    for limit in (None, 64 * 8 * 16, 64 * 8 * 3):
        rows, cols = xor_mm.split_blocks(320, 560, 8, limit)
        assert len(cols) == 2 and len(rows) == {None: 1, 8192: 3,
                                                1536: 14}[limit]
        out = xor_mm.split_encode(bm, torch.from_numpy(data), 8, limit)
        for b in range(2):
            assert np.array_equal(out[b].numpy(),
                                  gf_ref.matrix_encode_ref(gen, data[b], 8))


# -- the dispatcher's and ec_util's repair legs ----------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_dispatcher_repair_from_4_threads(depth):
    ref = jregistry.factory("msr", profile(4, 3))
    codec = port(4, 3)
    chunk = codec.get_chunk_size(4096)
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (8, 4, chunk), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_batch(data)], axis=1)
    disp = GpuDispatcher(device="cpu", pipeline_depth=depth, max_delay=0.01)
    errors = []

    def worker(tid):
        try:
            for it in range(3):
                target = (tid + it) % 7
                helpers = tuple(sorted(codec.minimum_to_repair(
                    target, set(range(7)))))
                sl = slice(2 * tid, 2 * tid + 2)
                futs = [disp.repair_fraction_async(
                    codec, target, np.ascontiguousarray(full[sl, h]))
                    for h in helpers]
                fracs = np.stack([f.result(60) for f in futs], 1)
                want = np.stack([ref.repair_fraction_batch(
                    target, np.ascontiguousarray(full[sl, h]))
                    for h in helpers], 1)
                if not np.array_equal(fracs, want):
                    errors.append("fraction %d/%d" % (tid, target))
                out = disp.repair_combine(codec, target, helpers, fracs)
                if not np.array_equal(out, full[sl, target]):
                    errors.append("combine %d/%d" % (tid, target))
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(120)
    disp.shutdown()
    assert not errors and not any(t.is_alive() for t in pool)
    assert disp.stats["ops"] == 4 * 3 * 7
    assert disp.perf.dump()["l_gpu_dec_bytes"] == 4 * 3 * (
        6 * 2 * chunk + 2 * 6 * chunk // 3)


@pytest.mark.parametrize("via", ["host", "dispatcher"])
def test_ec_util_repair_round_trip(via):
    codec = port(4, 3)
    chunk = codec.get_chunk_size(8192)
    sinfo = ec_util.StripeInfo(4, 4 * chunk)
    payload = np.random.default_rng(13).integers(0, 256, 3 * 4 * chunk,
                                                 dtype=np.uint8)
    shards = ec_util.encode(sinfo, codec, payload)
    disp = GpuDispatcher(device="cpu") if via == "dispatcher" else None
    try:
        for target in (1, 5):
            helpers = codec.minimum_to_repair(target, set(shards))
            fr = {h: ec_util.repair_fraction(sinfo, codec, target,
                                             shards[h], dispatcher=disp)
                  for h in helpers}
            assert all(len(v) == 3 * chunk // 3 for v in fr.values())
            out = ec_util.repair_combine(sinfo, codec, target, fr,
                                         dispatcher=disp)
            assert out == shards[target].tobytes()
    finally:
        if disp is not None:
            disp.shutdown()


@pytest.mark.parametrize("what,code", [
    ("unaligned_stream", errno.EINVAL), ("empty_stream", errno.EINVAL),
    ("fraction_count", errno.EIO), ("unequal", errno.EINVAL),
    ("unaligned_fraction", errno.EINVAL)])
def test_ec_util_repair_errors(what, code):
    codec = port(4, 3)
    chunk = codec.get_chunk_size(8192)
    sinfo = ec_util.StripeInfo(4, 4 * chunk)
    sub = chunk // 3
    fr = {h: bytes(2 * sub) for h in range(1, 7)}
    with pytest.raises(ErasureCodeError) as e:
        if what == "unaligned_stream":
            ec_util.repair_fraction(sinfo, codec, 0, bytes(chunk + 1))
        elif what == "empty_stream":
            ec_util.repair_fraction(sinfo, codec, 0, b"")
        else:
            if what == "fraction_count":
                del fr[6]
            elif what == "unequal":
                fr[6] = bytes(sub)
            else:
                fr = {h: bytes(sub + 1) for h in fr}
            ec_util.repair_combine(sinfo, codec, 0, fr)
    assert e.value.errno == code
