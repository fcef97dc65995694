"""GpuDispatcher of the PyTorch port, on the CPU device.

8 concurrent submitter threads push host batches through the coalescing
dispatcher; every encode and decode result must equal the JAX reference
codec's output byte for byte, same-key ops must share dispatches, and a
failing batch must fail only its own submitters.
"""

import random
import threading

import numpy as np
import pytest

from ceph_tpu import registry as jregistry
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}
THREADS, ITERS, PER_OP, N = 8, 6, 2, 2048


@pytest.fixture(scope="module")
def setup():
    jax_codec = jregistry.factory("jax_tpu", dict(PROFILE))
    codec = registry.factory("torch_cuda", dict(PROFILE), device="cpu")
    data = np.random.default_rng(0).integers(0, 256, size=(16, 8, N),
                                             dtype=np.uint8)
    parity = np.asarray(jax_codec.encode_batch(data))
    full = np.concatenate([data, parity], axis=1)
    sigs = [(0, 1, 2, 3, 4, 5, 6, 7), (3, 4, 5, 6, 7, 8, 9, 10),
            (0, 2, 3, 5, 6, 8, 9, 10)]
    decoded = {s: np.asarray(jax_codec.decode_batch(
        s, np.ascontiguousarray(full[:, list(s)]))) for s in sigs}
    return codec, data, full, sigs, decoded


def run_threads(fn, n=THREADS, timeout=120):
    pool = [threading.Thread(target=fn, args=(t,)) for t in range(n)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout)
    assert not any(t.is_alive() for t in pool)


@pytest.mark.parametrize("depth", [1, 2])
def test_concurrent_results_equal_jax(setup, depth):
    codec, data, full, sigs, decoded = setup
    disp = GpuDispatcher(device="cpu", pipeline_depth=depth,
                         max_delay=0.005)
    errors = []

    def submitter(tid):
        r = random.Random(tid)
        try:
            for _ in range(ITERS):
                i = r.randrange(16 - PER_OP + 1)
                sl = slice(i, i + PER_OP)
                s = sigs[r.randrange(len(sigs))]
                f_enc = disp.encode_async(codec, data[sl])
                f_dec = disp.decode_async(codec, s, full[sl][:, list(s)])
                if not np.array_equal(f_enc.result(60), full[sl, 8:]):
                    errors.append("encode")
                if not np.array_equal(f_dec.result(60), decoded[s][sl]):
                    errors.append("decode %s" % (s,))
        except Exception as e:
            errors.append(repr(e))

    try:
        run_threads(submitter)
    finally:
        disp.shutdown()
    assert errors == []
    assert disp.stats["ops"] == 2 * THREADS * ITERS
    assert disp.stats["dispatches"] < disp.stats["ops"]
    perf = disp.perf.dump()
    assert perf["l_gpu_ops"] == disp.stats["ops"]
    assert perf["l_gpu_dispatches"] == disp.stats["dispatches"]
    assert perf["l_gpu_compute"]["avgcount"] == disp.stats["dispatches"]
    assert perf["l_gpu_enc_bytes"] == THREADS * ITERS * PER_OP * 8 * N


class _Boom:
    """A codec whose every encode fails (its own dispatch key)."""

    _bitmat = np.ones((8, 16), dtype=np.uint8)
    w = 8

    def encode_batch(self, data):
        raise RuntimeError("boom")


def test_failing_batch_fails_only_its_submitters(setup):
    codec, data, full, sigs, decoded = setup
    disp = GpuDispatcher(device="cpu", max_delay=0.01)
    good, bad, errors = [], [], []

    def submitter(tid):
        try:
            sl = slice(tid, tid + 1)
            if tid % 2:
                try:
                    disp.encode_async(_Boom(), data[sl]).result(60)
                    errors.append("no error")
                except RuntimeError as e:
                    bad.append(str(e))
                try:   # wrong row count: EIO for this op alone
                    disp.decode_async(codec, (0, 1, 2),
                                      full[sl][:, :3]).result(60)
                    errors.append("no EIO")
                except ErasureCodeError as e:
                    bad.append(e.errno)
            else:
                out = disp.encode_async(codec, data[sl]).result(60)
                good.append(np.array_equal(out, full[sl, 8:]))
        except Exception as e:
            errors.append(repr(e))

    try:
        run_threads(submitter)
        # the pipeline keeps flowing after the failures
        assert np.array_equal(disp.encode(codec, data[:3]), full[:3, 8:])
    finally:
        disp.shutdown()
    assert errors == []
    assert good == [True] * (THREADS // 2)
    assert bad.count("boom") == THREADS // 2 and bad.count(5) == THREADS // 2


class _Span:
    """Records the intervals the dispatcher back-fills under an op."""

    def __init__(self, log, name="op"):
        self.log, self.name = log, name

    def valid(self):
        return True

    def child_interval(self, name, start, end, **kv):
        assert end >= start
        self.log.append((self.name, name, kv))
        return _Span(self.log, name)


def test_trace_gets_queue_and_device_segments(setup):
    codec, data, full, _, _ = setup
    log = []
    disp = GpuDispatcher(device="cpu")
    try:
        out = disp.encode(codec, data[:2], trace=_Span(log))
    finally:
        disp.shutdown()
    assert np.array_equal(out, full[:2, 8:])
    names = [(parent, name) for parent, name, _ in log]
    assert names == [("op", "gpu_queue"), ("op", "gpu_device"),
                     ("gpu_device", "h2d"), ("gpu_device", "compute"),
                     ("gpu_device", "d2h")]
    assert log[1][2] == {"batch": 2, "coalesced": 1}
