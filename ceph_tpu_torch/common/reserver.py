"""Slot reservations with priority preemption.

Port of ``ceph_tpu/common/reserver.py``, host code the port keeps its
own copy of.

Role of the reference's AsyncReserver<T> (src/common/AsyncReserver.h):
a bounded set of concurrently-granted slots (osd_max_backfills /
osd_recovery_max_active), a priority-bucketed wait queue for everything
beyond the budget, and preemption — a request of strictly higher
priority evicts the lowest-priority current holder (its on_preempt
fires, it re-requests later) so degraded-object recovery is never
parked behind routine backfill.

Each OSD runs four of these (local/remote x recovery/backfill,
the OSD daemon); PGs are the items.  Grant/preempt callbacks run
OUTSIDE the reserver lock: a grant handler immediately requesting a
remote reservation (the PG reservation round-trip) must not deadlock.
"""

from __future__ import annotations

import threading

__all__ = ["AsyncReserver"]


class _Request:
    __slots__ = ("item", "prio", "on_grant", "on_preempt")

    def __init__(self, item, prio, on_grant, on_preempt):
        self.item = item
        self.prio = prio
        self.on_grant = on_grant
        self.on_preempt = on_preempt


class AsyncReserver:
    def __init__(self, name: str, max_allowed: int = 1):
        self.name = name
        self._max = max(0, int(max_allowed))
        self._lock = threading.Lock()
        self._queues: dict[int, list[_Request]] = {}  # prio -> FIFO
        self._granted: dict = {}                      # item -> _Request
        # lifetime counters for the observability riders
        # (l_osd_reservation_* perf lanes / dump_reservations asok)
        self.granted_total = 0
        self.preempted_total = 0

    # -- core ----------------------------------------------------------

    def request_reservation(self, item, on_grant, prio: int = 0,
                            on_preempt=None) -> None:
        """Queue a reservation; on_grant() fires (possibly immediately,
        on this thread) once a slot is held.  A duplicate request for a
        queued/granted item is ignored — the PG state machine re-enters
        its request path freely."""
        with self._lock:
            if item in self._granted:
                return
            for q in self._queues.values():
                if any(r.item == item for r in q):
                    return
            self._queues.setdefault(prio, []).append(
                _Request(item, prio, on_grant, on_preempt))
        self._do_queues()

    def cancel_reservation(self, item) -> bool:
        """Release a held slot or withdraw a queued request (both the
        completion and the interval-change path).  Returns True if the
        item was known."""
        found = False
        with self._lock:
            if self._granted.pop(item, None) is not None:
                found = True
            else:
                for prio, q in list(self._queues.items()):
                    keep = [r for r in q if r.item != item]
                    if len(keep) != len(q):
                        found = True
                        if keep:
                            self._queues[prio] = keep
                        else:
                            del self._queues[prio]
        if found:
            self._do_queues()
        return found

    def set_max(self, max_allowed: int) -> None:
        with self._lock:
            self._max = max(0, int(max_allowed))
        self._do_queues()

    def has_reservation(self, item) -> bool:
        with self._lock:
            return item in self._granted

    def _do_queues(self) -> None:
        """Grant free slots highest-priority-first; when none are free,
        preempt a strictly lower-priority holder (AsyncReserver
        do_queues + preempt_by_prio)."""
        grants: list[_Request] = []
        preempts: list[_Request] = []
        with self._lock:
            while True:
                prio = max(self._queues) if self._queues else None
                if prio is None:
                    break
                if len(self._granted) < self._max:
                    req = self._queues[prio].pop(0)
                    if not self._queues[prio]:
                        del self._queues[prio]
                    self._granted[req.item] = req
                    self.granted_total += 1
                    grants.append(req)
                    continue
                victim = min(self._granted.values(),
                             key=lambda r: r.prio) \
                    if self._granted else None
                if victim is None or victim.prio >= prio:
                    break          # nothing evictable: head waits
                del self._granted[victim.item]
                self.preempted_total += 1
                preempts.append(victim)
                # loop: the freed slot goes to the queue head
        for req in preempts:
            if req.on_preempt is not None:
                req.on_preempt()
        for req in grants:
            req.on_grant()

    # -- introspection -------------------------------------------------

    def num_granted(self) -> int:
        with self._lock:
            return len(self._granted)

    def num_waiting(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def dump(self) -> dict:
        """The `dump_reservations` asok payload for one reserver."""
        with self._lock:
            return {
                "max_allowed": self._max,
                "granted": [{"item": str(r.item), "prio": r.prio}
                            for r in self._granted.values()],
                "waiting": [{"item": str(r.item), "prio": r.prio}
                            for prio in sorted(self._queues,
                                               reverse=True)
                            for r in self._queues[prio]],
                "granted_total": self.granted_total,
                "preempted_total": self.preempted_total,
            }
