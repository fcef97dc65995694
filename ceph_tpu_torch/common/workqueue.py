"""Execution substrate: thread pools, sharded queues, finisher, timer.

Port of ``ceph_tpu/common/workqueue.py``, host code the port keeps its
own copy of.

Role of the reference's src/common/WorkQueue.h (ThreadPool,
ShardedThreadPool), Finisher, and SafeTimer:

  ThreadPool         N workers draining one queue
  ShardedThreadPool  work hashed to a fixed shard -> per-shard ordering
                     with cross-shard parallelism — the OSD's op
                     scheduling shape (ShardedOpWQ, src/osd/OSD.h:1623)
  Finisher           a dedicated completion-callback thread so IO paths
                     never run arbitrary callbacks inline
  SafeTimer          cancellable scheduled callbacks sharing one thread

All integrate with HeartbeatMap so a wedged worker is detectable.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time

__all__ = ["ThreadPool", "ShardedThreadPool", "Finisher", "SafeTimer"]

_SHUTDOWN = object()


class ThreadPool:
    def __init__(self, name: str, num_threads: int, hbmap=None,
                 grace: float = 30.0):
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self._threads = []
        self._hbmap = hbmap
        self._grace = grace
        self._started = False
        self._num = num_threads

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self._num):
            t = threading.Thread(target=self._worker,
                                 name="%s-%d" % (self.name, i), daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        handle = self._hbmap.add(threading.current_thread().name,
                                 self._grace) if self._hbmap else None
        while True:
            if handle:
                handle.renew()
            try:
                item = self._q.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is _SHUTDOWN:
                break
            fn, args = item
            try:
                fn(*args)
            except Exception:
                import traceback
                traceback.print_exc()
        if handle:
            handle.remove()

    def queue(self, fn, *args) -> None:
        self._q.put((fn, args))

    def drain(self) -> None:
        while not self._q.empty():
            time.sleep(0.001)

    def stop(self) -> None:
        for _ in self._threads:
            self._q.put(_SHUTDOWN)
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        self._started = False


class ShardedThreadPool:
    """Work keyed by hashable -> stable shard; one worker per shard keeps
    per-key ordering (a PG's ops execute in order) while different keys
    run concurrently — the ShardedOpWQ contract."""

    def __init__(self, name: str, num_shards: int, hbmap=None):
        self.name = name
        self.num_shards = num_shards
        self._shards = [ThreadPool("%s-s%d" % (name, i), 1, hbmap)
                        for i in range(num_shards)]

    def start(self) -> None:
        for s in self._shards:
            s.start()

    def queue(self, key, fn, *args, **qos) -> None:
        # qos kwargs (klass/priority/cost) are accepted for signature
        # parity with QosShardedOpWQ; FIFO ignores them
        self._shards[hash(key) % self.num_shards].queue(fn, *args)

    def drain(self) -> None:
        for s in self._shards:
            s.drain()

    def stop(self) -> None:
        for s in self._shards:
            s.stop()


class Finisher:
    """Completion-callback thread (src/common/Finisher.h)."""

    def __init__(self, name: str = "finisher"):
        self._pool = ThreadPool(name, 1)

    def start(self) -> None:
        self._pool.start()

    def queue(self, fn, *args) -> None:
        self._pool.queue(fn, *args)

    def wait_for_empty(self) -> None:
        self._pool.drain()

    def stop(self) -> None:
        self._pool.stop()


class SafeTimer:
    """Cancellable timer events on one thread (src/common/Timer.h)."""

    def __init__(self, name: str = "safe-timer"):
        self.name = name
        self._heap: list = []
        self._counter = itertools.count()
        self._cond = threading.Condition()
        self._cancelled: set[int] = set()
        self._thread = None
        self._stopping = False

    def init(self) -> None:
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def add_event_after(self, seconds: float, fn, *args) -> int:
        with self._cond:
            token = next(self._counter)
            heapq.heappush(self._heap,
                           (time.monotonic() + seconds, token, fn, args))
            self._cond.notify()
            return token

    def cancel_event(self, token: int) -> None:
        with self._cond:
            self._cancelled.add(token)
            self._cond.notify()

    def cancel_all_events(self) -> None:
        with self._cond:
            self._cancelled.update(t for _, t, _, _ in self._heap)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    delay = None if not self._heap else \
                        max(0.0, self._heap[0][0] - time.monotonic())
                    self._cond.wait(delay)
                if self._stopping:
                    return
                when, token, fn, args = heapq.heappop(self._heap)
                if token in self._cancelled:
                    self._cancelled.discard(token)
                    continue
            try:
                fn(*args)
            except Exception:
                import traceback
                traceback.print_exc()

    def shutdown(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify()
        if self._thread:
            self._thread.join(timeout=5)
