"""The port's rateless dispatcher against the JAX package's.

``ceph_tpu_torch.parallel.rateless.RatelessDispatcher`` over
``["cpu"] * n`` workers, with the reference's own cases
(``tests/test_mesh.py:276-562``): work stealing under random stalls,
LT-coded decode, first result wins with the speculative-buffer ledger
back to 0, strike-out to the blacklist and probation's re-admission,
the doubled backoff after a failed canary, a kill mid-batch, and every
worker killed (the caller's thread finishes on the codec's device).
Every output is held byte for byte (tolerance: none) against the JAX
package's codec on the same seeded numpy payload, computed once per
module; ``status()`` against the reference dispatcher's keys, and the
fault injector's flaky picks against the reference's.

Every verdict is bounded: deadlines and backoffs read a fake clock,
every poll goes through ``_spin`` (a 30 s wall bound), every thread is
joined with a timeout and every dispatcher shut down in a ``finally``.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.parallel import rateless as jrateless
from ceph_tpu_torch import registry
from ceph_tpu_torch.common.profiler import PROFILER
from ceph_tpu_torch.parallel import rateless
from ceph_tpu_torch.parallel.rateless import (DeviceFaultSet, DeviceKilled,
                                              RatelessDispatcher)

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, M, W = 4, 2, 8
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M),
           "w": str(W)}
AVAIL = (0, 2, 3, 5)


@functools.lru_cache(maxsize=None)
def case():
    """The seeded payload, the reference's encode of it and its decode
    from AVAIL's rows."""
    ref = jregistry.factory("jax_tpu", PROFILE)
    data = np.random.default_rng(42).integers(0, 256, (8, K, 1024),
                                              dtype=np.uint8)
    parity = np.asarray(ref.encode_batch(data))
    chunks = np.concatenate([data, parity], axis=1)[:, list(AVAIL), :]
    return data, parity, chunks, np.asarray(ref.decode_batch(AVAIL, chunks))


@functools.lru_cache(maxsize=None)
def codec():
    return registry.factory("torch_cuda", PROFILE, device="cpu")


class _FakeClock:
    """Injectable monotonic clock: every deadline and blacklist decision
    reads it, so the tests advance logical time instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _spin(check, timeout=30.0):
    """Poll a timing-independent predicate within a wall bound."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if check():
            return True
        time.sleep(0.005)
    return check()


def _encode(rl):
    return rl.encode(codec(), case()[0])


@pytest.fixture
def rateless_pair():
    """(dispatcher, injector, fake clock) over 2 workers, torn down."""
    clk = _FakeClock()
    inj = DeviceFaultSet(seed=3)
    rl = RatelessDispatcher(devices=["cpu"] * 2, clock=clk, injector=inj,
                            name="test-rl")
    try:
        yield rl, inj, clk
    finally:
        inj.clear_all()
        rl.shutdown()


def test_stealing_under_stalls_matches_jax():
    """Random stalls reshuffle which worker runs each micro-batch; the
    result stays the reference's and idle workers steal."""
    rng = np.random.default_rng(17)
    inj = DeviceFaultSet(seed=17)
    rl = RatelessDispatcher(devices=["cpu"] * 4, injector=inj,
                            name="steal-rl")
    try:
        for trial in range(3):
            inj.clear_all()
            for idx in range(4):
                if rng.random() < 0.5:
                    inj.stall_ms(idx, float(rng.integers(1, 15)))
            assert np.array_equal(_encode(rl), case()[1]), trial
        st = rl.status()
        assert st["stolen_total"] > 0
        assert sum(d["completed"] for d in st["devices"]) >= 3 * 8
    finally:
        inj.clear_all()
        rl.shutdown()


def test_lt_coded_decode_matches_jax():
    rl = RatelessDispatcher(devices=["cpu"] * 4, name="lt-rl")
    try:
        for seed in (0, 1, 2):
            got = rl.decode(codec(), AVAIL, case()[2], lt=True, seed=seed)
            assert np.array_equal(got, case()[3]), seed
        assert np.array_equal(rl.decode(codec(), AVAIL, case()[2]),
                              case()[3])
    finally:
        rl.shutdown()


def test_first_result_wins_and_the_ledger_returns_to_zero(rateless_pair):
    """Wedge one worker past its (fake-clock) deadline mid-encode: the
    overdue micro-batch is re-dispatched, the healthy worker's copy
    seals the job, the straggler's late answer is discarded, and the
    duplicated buffers leave the memory ledger."""
    rl, inj, clk = rateless_pair
    # prime worker 0's latency EWMA (no sample, no deadline): worker 1
    # is slowed until worker 0 has completed a micro-batch
    inj.stall_ms(1, 20.0)
    for _ in range(10):
        assert np.array_equal(_encode(rl), case()[1])
        if rl.health[0].ewma_s is not None:
            break
    assert rl.health[0].ewma_s is not None
    inj.clear_all()
    prev, PROFILER.enabled = PROFILER.enabled, True
    PROFILER.mem_set("speculative_buffers", 0)      # earlier tests: rebase
    PROFILER.reset()
    inj.stall_ms(0, 400.0)
    stop = threading.Event()

    def tick():
        while not stop.is_set():
            clk.advance(0.05)
            time.sleep(0.002)

    t = threading.Thread(target=tick, daemon=True)
    t.start()
    try:
        # an encode whose every micro-batch worker 1 took has nothing to
        # speculate on: run it again
        for _ in range(5):
            assert np.array_equal(_encode(rl), case()[1])
            if rl.status()["redispatch_total"]:
                break
        assert rl.status()["redispatch_total"] >= 1
        assert _spin(lambda: rl.status()["duplicate_total"] >= 1), \
            rl.status()
        mem = PROFILER.mem_dump()["speculative_buffers"]
        assert mem["high_watermark"] > 0
        assert _spin(lambda: PROFILER.mem_dump()
                     ["speculative_buffers"]["bytes"] == 0)
        assert rl._spec_bytes == 0
    finally:
        stop.set()
        t.join(timeout=10)
        PROFILER.enabled = prev
    assert not t.is_alive()


def _encode_until(rl, inj, pred, tries=10):
    """Encodes, each held against the reference, until `pred` holds.
    Worker 1 is slowed meanwhile, so that worker 0 (polling its
    blacklist every 10 ms) gets a pull before worker 1 drains a job."""
    inj.stall_ms(1, 20.0)
    try:
        for _ in range(tries):
            assert np.array_equal(_encode(rl), case()[1])
            if _spin(pred, timeout=0.5):
                return True
        return pred()
    finally:
        inj.stall_ms(1, 0)


def test_strikeout_blacklists_then_probation_readmits(rateless_pair):
    rl, inj, clk = rateless_pair
    inj.fail_next(0, 3)
    assert _encode_until(rl, inj,
                         lambda: rl.health[0].state == "blacklisted")
    assert rl.degraded() == 1
    assert rl.health[0].errors == 3
    # backoff not yet expired: the worker must NOT take work
    assert np.array_equal(_encode(rl), case()[1])
    assert rl.health[0].state == "blacklisted"
    # expire the backoff: a job hands it ONE canary, which lands clean
    # and re-admits it
    clk.advance(60.0)
    assert _encode_until(rl, inj, lambda: rl.health[0].state == "healthy")
    assert rl.degraded() == 0
    assert rl.health[0].strikes == 0


def test_failed_canary_doubles_backoff(rateless_pair):
    rl, inj, clk = rateless_pair
    inj.fail_next(0, 4)          # 3 strikes + 1 failed canary
    assert _encode_until(rl, inj,
                         lambda: rl.health[0].state == "blacklisted")
    first_until = rl.health[0].blacklist_until
    clk.advance(60.0)
    assert _encode_until(rl, inj, lambda: rl.health[0].blacklist_total == 2)
    assert rl.health[0].state == "blacklisted"
    assert rl.health[0].backoffs == 2
    assert (rl.health[0].blacklist_until - clk()) > first_until * 1.5
    clk.advance(60.0)
    assert _encode_until(rl, inj, lambda: rl.health[0].state == "healthy")


def test_mid_batch_kill_drains_and_completes_on_survivor(rateless_pair):
    rl, inj, clk = rateless_pair
    # worker 0 must hold work when the kill lands: it stalls inside its
    # micro-batch, and worker 1 is slowed so that it cannot drain the
    # queue alone before worker 0 pulls; an encode that ends with worker
    # 0 never having pulled is run again
    inj.stall_ms(0, 250.0)
    inj.stall_ms(1, 20.0)
    for _attempt in range(5):
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(out=_encode(rl)),
                             daemon=True)
        t.start()
        try:
            assert _spin(lambda: rl.health[0].inflight >= 1
                         or not t.is_alive())
            if rl.health[0].inflight >= 1:
                inj.kill(0)
        finally:
            t.join(timeout=60)
        assert not t.is_alive(), "encode hung after mid-batch kill"
        assert np.array_equal(box["out"], case()[1])
        if inj.is_killed(0):
            break
    assert inj.is_killed(0), "worker 0 never pulled a micro-batch"
    assert _spin(lambda: rl.degraded() == 1)
    assert rl.health[0].state == "blacklisted"
    inj.clear_all()
    clk.advance(60.0)
    assert _encode_until(rl, inj, lambda: rl.health[0].state == "healthy")
    assert rl.degraded() == 0


def test_all_killed_finishes_on_the_callers_thread(rateless_pair,
                                                   monkeypatch):
    """With every worker killed the caller's thread runs the rest, on
    the codec's own device."""
    rl, inj, _clk = rateless_pair
    seen = []
    real = rateless._call
    monkeypatch.setattr(rateless, "_call", lambda fn, data, device,
                        stream=None: seen.append(
                            (threading.current_thread(), device))
                        or real(fn, data, device, stream))
    inj.kill(0)
    inj.kill(1)
    assert np.array_equal(_encode(rl), case()[1])
    assert seen and all(t is threading.current_thread()
                        and d == codec().device for t, d in seen)


def test_status_keys_match_jax():
    import jax
    ref = jrateless.RatelessDispatcher(devices=jax.devices()[:2],
                                       name="keys-ref")
    mine = RatelessDispatcher(devices=["cpu"] * 2, name="keys-port")
    try:
        want, got = ref.status(), mine.status()
        assert set(got) == set(want)
        assert set(got["devices"][0]) == set(want["devices"][0])
        assert got["devices"][0]["device"] == "cpu:0"
        assert {k: got[k] for k in got if k != "devices"} == \
            {k: want[k] for k in want if k != "devices"}
        assert [set(r) for r in mine.device_status()] == \
            [set(r) for r in ref.device_status()]
    finally:
        ref.shutdown()
        mine.shutdown()


def test_fault_injector_matches_jax():
    mine, ref = DeviceFaultSet(seed=9), jrateless.DeviceFaultSet(seed=9)

    def picks(inj):
        out = []
        for seq in range(64):
            try:
                inj.check(1, seq)
            except RuntimeError:
                out.append(seq)
        return out

    for inj in (mine, ref):
        inj.flaky(1, 5)
    assert picks(mine) == picks(ref) and picks(mine)
    mine.kill(2)
    with pytest.raises(DeviceKilled):
        mine.check(2, 0)
    mine.fail_next(0, 2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="injected device failure"):
            mine.check(0, 0)
    mine.check(0, 0)
    assert not mine.empty()
    mine.clear_all()
    assert mine.empty()


def test_small_and_tensor_batches():
    """A batch too small to split runs on the caller's thread; a tensor
    batch comes back as a host array, as the reference's does."""
    rl = RatelessDispatcher(devices=["cpu"] * 2, name="small-rl")
    try:
        data = case()[0]
        assert np.array_equal(rl.encode(codec(), data[:1]), case()[1][:1])
        assert rl.encode(codec(), data[:0]).shape == (0, M, 1024)
        got = rl.encode(codec(), torch.from_numpy(data.copy()))
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, case()[1])
        assert np.array_equal(rl.map_batch(lambda x: x * 2, np.arange(9),
                                           micro=3), np.arange(9) * 2)
    finally:
        rl.shutdown()


class _Conf:
    def __init__(self, **vals):
        self.vals = {"osd_mesh_rateless": True,
                     "osd_mesh_microbatch_factor": 2,
                     "osd_mesh_microbatch_timeout_ms": 0.0,
                     "osd_mesh_blacklist_strikes": 3,
                     "osd_mesh_probation_base_ms": 50.0, **vals}

    def get_val(self, key):
        return self.vals[key]


def test_process_global_dispatcher(monkeypatch):
    """get_dispatcher returns None below two cards and when the conf
    turns the queue off; a dispatcher set explicitly is served until
    reset; with two cards it is made from the conf's options."""
    rateless.reset_dispatcher()
    try:
        assert rateless.get_dispatcher() is None          # no CUDA here
        explicit = RatelessDispatcher(devices=["cpu"] * 2, name="set-rl")
        rateless.set_dispatcher(explicit)
        assert rateless.get_dispatcher(create=False) is explicit
        rateless.set_enabled(False)
        assert rateless.get_dispatcher() is None
        rateless.set_enabled(True)
        rateless.reset_dispatcher()
        assert rateless.get_dispatcher(create=False) is None
        assert not any(t.is_alive() for t in explicit._threads)
        monkeypatch.setattr(rateless, "local_device_count", lambda: 2)
        monkeypatch.setattr(rateless, "_local_devices",
                            lambda: [torch.device("cpu")] * 2)
        assert rateless.get_dispatcher(
            _Conf(osd_mesh_rateless=False)) is None
        made = rateless.get_dispatcher(_Conf())
        assert made.factor == 2 and len(made.devices) == 2
        assert rateless.get_dispatcher() is made
    finally:
        rateless.set_enabled(True)
        rateless.reset_dispatcher()


def test_no_devices_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(rateless, "_local_devices", lambda: [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RatelessDispatcher()
