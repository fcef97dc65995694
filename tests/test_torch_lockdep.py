"""The reference's lockdep cases over both packages.

``tests/test_lockdep.py``'s seeded cycles and false-positive checks, on
the reference's ``ceph_tpu.common.lockdep`` and on the port's
``ceph_tpu_torch.common.lockdep`` (each module's graph snapshotted and
restored around a test, as the reference's fixture does); then the port's
ECBackend, its locks made under the port's lockdep, runs a loopback PG's
writes, reads, faults and rebuilds without an order cycle.
"""

from __future__ import annotations

import importlib
import threading

import pytest

from . import torch_ec_loopback as loopback
from . import torch_ec_sequence as sequence
from .torch_util import one_torch_thread  # noqa: F401

lockdep = None


def _fresh(name):
    global lockdep
    lockdep = importlib.import_module(name + ".common.lockdep")
    # snapshot the session-wide state so these tests' seeded cycles
    # neither pollute nor ERASE what the rest of the suite collected
    saved = list(lockdep.violations)
    saved_edges = {k: set(v) for k, v in lockdep._edges.items()}
    saved_reported = set(lockdep._reported)
    lockdep.reset()
    was = lockdep.enabled()
    lockdep.enable()
    yield
    lockdep.reset()
    lockdep.violations.extend(saved)
    lockdep._edges.update(saved_edges)
    lockdep._reported.update(saved_reported)
    if not was:
        lockdep.disable()


@pytest.fixture(autouse=True, params=["ceph_tpu", "ceph_tpu_torch"])
def fresh_graph(request):
    yield from _fresh(request.param)


class TestSeededCycle:
    def test_inverse_order_fires(self):
        a = lockdep.DebugRLock("A")
        b = lockdep.DebugRLock("B")
        with a:
            with b:
                pass                 # establishes A -> B
        with b:
            with a:                  # B -> A closes the cycle
                pass
        assert lockdep.violations
        assert "cycle" in lockdep.violations[0]
        assert "'A'" in lockdep.violations[0]

    def test_strict_mode_raises(self):
        lockdep.enable(strict=True)
        a = lockdep.DebugRLock("SA")
        b = lockdep.DebugRLock("SB")
        with a:
            with b:
                pass
        with pytest.raises(lockdep.LockOrderError):
            with b:
                with a:
                    pass

    def test_three_way_cycle(self):
        a, b, c = (lockdep.DebugRLock(n) for n in ("X", "Y", "Z"))
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:                  # X->Y->Z->X
                pass
        assert lockdep.violations


class TestNoFalsePositives:
    def test_consistent_order_clean(self):
        a = lockdep.DebugRLock("P")
        b = lockdep.DebugRLock("Q")
        for _ in range(10):
            with a:
                with b:
                    pass
        assert not lockdep.violations

    def test_reentrant_same_name_clean(self):
        a = lockdep.DebugRLock("R")
        with a:
            with a:
                pass
        # two instances of the same lock CLASS (e.g. two PGs) nest
        # without being a self-cycle, like the reference's per-name
        # registration
        a2 = lockdep.DebugRLock("R")
        with a:
            with a2:
                pass
        assert not lockdep.violations

    def test_condition_compat(self):
        lk = lockdep.DebugRLock("cond")
        cond = threading.Condition(lk)
        hit = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                hit.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        import time
        time.sleep(0.1)
        with cond:
            cond.notify()
        t.join(timeout=5)
        assert hit == [1]
        assert not lockdep.violations




class TestPortBackend:
    @pytest.fixture(autouse=True)
    def fresh_graph(self):
        yield from _fresh("ceph_tpu_torch")

    def test_port_backend_has_no_lock_cycles(self, one_torch_thread):
        """The port's ECBackend and its loopback PG, locks made with the
        port's lockdep on: a short sequence leaves no violation."""
        from ceph_tpu_torch import registry
        from ceph_tpu_torch.common.tracer import SpanCollector
        from ceph_tpu_torch.common.workqueue import SafeTimer
        from ceph_tpu_torch.osd.ec_backend import ECBackend
        from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
        from ceph_tpu_torch.osd.pg_log import PGLog, entry_from_tuple
        from ceph_tpu_torch.osd.pg_transaction import PGTransaction
        from ceph_tpu_torch.store import MemStore, Transaction
        codec = registry.factory("torch_cuda", {
            "technique": "reed_sol_van", "k": "4", "m": "2"},
            device="cpu")
        lb = loopback.Loopback(
            ECBackend=ECBackend, MemStore=MemStore,
            Transaction=Transaction, PGLog=PGLog,
            entry_from_tuple=entry_from_tuple, SafeTimer=SafeTimer,
            tracer=SpanCollector(), codec=codec, stripe_width=1024,
            tier=HbmChunkTier(device="cpu"))
        try:
            assert isinstance(lb.primary.backend.lock, lockdep.DebugRLock)
            sequence.run(lb, PGTransaction, sequence.Config(
                objects=3, overwrites=6, appends=1, ranges=3))
        finally:
            lb.shutdown()
        assert not lockdep.violations, lockdep.violations[:2]
