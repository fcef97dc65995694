"""The reference's work queue and bounded-dict cases over both packages.

``tests/test_common.py``'s ``TestWorkQueues`` (thread pool, sharded
per-key ordering, finisher, SafeTimer with a cancelled event), on the
reference's ``ceph_tpu.common.workqueue`` and on the port's
``ceph_tpu_torch.common.workqueue``; and ``BoundedDict``'s eviction
(``common/bounded.py``, the sub-write dedup set of ECBackend) on both.
"""

import importlib
import time

import pytest

PKGS = ["ceph_tpu", "ceph_tpu_torch"]


@pytest.fixture(params=PKGS)
def wq(request):
    return importlib.import_module(request.param + ".common.workqueue")


@pytest.fixture(params=PKGS)
def bounded(request):
    return importlib.import_module(request.param + ".common.bounded")


def test_threadpool_runs_work(wq):
    tp = wq.ThreadPool("tp", 2)
    tp.start()
    done = []
    for i in range(10):
        tp.queue(done.append, i)
    tp.drain()
    time.sleep(0.05)
    tp.stop()
    assert sorted(done) == list(range(10))


def test_sharded_ordering(wq):
    stp = wq.ShardedThreadPool("s", 4)
    stp.start()
    order = {k: [] for k in range(8)}
    for i in range(50):
        for k in range(8):
            stp.queue(k, order[k].append, i)
    stp.drain()
    time.sleep(0.1)
    stp.stop()
    for k in range(8):  # per-key FIFO preserved
        assert order[k] == list(range(50))


def test_finisher(wq):
    f = wq.Finisher()
    f.start()
    hits = []
    f.queue(hits.append, 1)
    f.wait_for_empty()
    time.sleep(0.02)
    f.stop()
    assert hits == [1]


def test_safe_timer(wq):
    timer = wq.SafeTimer()
    timer.init()
    hits = []
    timer.add_event_after(0.02, hits.append, "a")
    tok = timer.add_event_after(0.04, hits.append, "b")
    timer.cancel_event(tok)
    time.sleep(0.1)
    timer.shutdown()
    assert hits == ["a"]


def test_safe_timer_cancel_all_and_order(wq):
    """Events run in due order; cancel_all_events drops the pending."""
    timer = wq.SafeTimer()
    timer.init()
    hits = []
    timer.add_event_after(0.04, hits.append, "late")
    timer.add_event_after(0.01, hits.append, "early")
    time.sleep(0.08)
    timer.add_event_after(0.05, hits.append, "dropped")
    timer.cancel_all_events()
    time.sleep(0.1)
    timer.shutdown()
    assert hits == ["early", "late"]


def test_bounded_dict_evicts_least_recently_updated(bounded):
    d = bounded.BoundedDict(cap=3)
    for k in "abc":
        d[k] = 0
    d["a"] = 1            # a refreshed: b is now the oldest
    d["d"] = 0
    assert list(d) == ["c", "a", "d"] and d["a"] == 1
    d["e"] = 0
    assert list(d) == ["a", "d", "e"]
