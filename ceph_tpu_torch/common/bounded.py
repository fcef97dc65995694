"""BoundedDict — insertion-ordered dict with size-capped eviction.

Port of ``ceph_tpu/common/bounded.py``, host code the port keeps its own
copy of.

The dedup/replay caches (client-op replies, sub-op seen sets) all need
"record, bounded, oldest-out" semantics; one helper instead of three
inlined eviction loops."""

from __future__ import annotations

__all__ = ["BoundedDict"]


class BoundedDict(dict):
    def __init__(self, cap: int = 8192):
        super().__init__()
        self.cap = cap

    def __setitem__(self, key, value):
        # move-to-end on reassignment: eviction is then LRU-by-update,
        # not FIFO-by-first-insertion — a constantly-refreshed entry
        # (e.g. a hot object's atime) must never be the one evicted
        if key in self:
            super().__delitem__(key)
        super().__setitem__(key, value)
        while len(self) > self.cap:
            super().__delitem__(next(iter(self)))
