"""Pinned-extent cache for pipelined RMW overwrites.

Port of ``ceph_tpu/osd/extent_cache.py``, host code the port keeps its
own copy of.

Role of the reference's ExtentCache (src/osd/ExtentCache.{h,cc}): when
write A must read-modify-write a stripe and write B to the same stripe
is right behind it, B must see A's post-image without waiting for A to
commit to disk.  Each in-flight write pins the extents it reads/writes;
reads check the cache first and only fetch the holes remotely; on
write-apply the new bytes land in the cache; a pin releases on commit
and extents nobody later pinned are dropped.

Ownership model (ExtentCache.h's core design, realised with an
interval owner-map instead of intrusive lists): every cached byte
range is owned by exactly ONE pin — the LATEST write that pinned it.
Reserving moves overlapping ranges to the (younger) reserving pin;
releasing a pin drops only the ranges it still owns.  This is what
makes out-of-order commit completion safe: if write B (tid 8) re-
pinned part of write A's (tid 5) extents, A's release leaves those
bytes cached for B, and whichever order A and B commit in, bytes are
freed exactly when their last pinned writer completes.

Invariant inherited from the reference (its header's "Writes on a
particular object must be ordered"): reserve_extents_for_rmw calls
for one object must happen in tid order — the EC backend's
waiting_state FIFO guarantees it, and the cache asserts it.

API shape follows the reference: open_write_pin /
reserve_extents_for_rmw -> must_read holes;
get_remaining_extents_for_rmw after the readback; present_rmw_update
with the written bytes; release_write_pin on commit.
"""

from __future__ import annotations

from ..common.interval_set import ExtentMap, IntervalSet

__all__ = ["ExtentCache", "WritePin"]


class WritePin:
    def __init__(self, tid):
        self.tid = tid
        self.objects: set = set()    # oids this pin ever touched


class _OwnerMap:
    """Interval -> owner tid, with assign-splits and per-tid release
    (the pin_state/extent ownership bookkeeping of ExtentCache.h as a
    flat sorted interval list: [start, end, tid])."""

    def __init__(self):
        self._ivals: list = []       # sorted, non-overlapping

    def assign(self, off: int, length: int, tid: int) -> None:
        """Make `tid` the owner of [off, off+length) — later writes
        steal ownership of overlapping ranges (extent::move)."""
        if length <= 0:
            return
        end = off + length
        out = []
        for s, e, t in self._ivals:
            if e <= off or s >= end:
                out.append([s, e, t])
                continue
            if s < off:
                out.append([s, off, t])
            if e > end:
                out.append([end, e, t])
        out.append([off, end, tid])
        out.sort()
        # merge adjacent same-owner ranges (fixed per-extent overhead)
        merged: list = []
        for s, e, t in out:
            if merged and merged[-1][2] == t and merged[-1][1] == s:
                merged[-1][1] = e
            else:
                merged.append([s, e, t])
        self._ivals = merged

    def release(self, tid: int) -> IntervalSet:
        """Drop every range still owned by tid; returns them."""
        freed = IntervalSet()
        keep = []
        for s, e, t in self._ivals:
            if t == tid:
                freed.union_insert(s, e - s)
            else:
                keep.append([s, e, t])
        self._ivals = keep
        return freed

    def max_tid(self) -> int:
        return max((t for _s, _e, t in self._ivals), default=-1)

    def empty(self) -> bool:
        return not self._ivals

    def owned_by(self, tid: int) -> IntervalSet:
        out = IntervalSet()
        for s, e, t in self._ivals:
            if t == tid:
                out.union_insert(s, e - s)
        return out

    def all_ranges(self) -> IntervalSet:
        out = IntervalSet()
        for s, e, _t in self._ivals:
            out.union_insert(s, e - s)
        return out


class _ObjectState:
    def __init__(self):
        self.cache = ExtentMap()     # bytes (post-images + readbacks)
        self.owners = _OwnerMap()    # byte range -> owning pin tid

    def empty(self) -> bool:
        return self.owners.empty()


class ExtentCache:
    def __init__(self):
        self._objects: dict = {}

    def open_write_pin(self, tid) -> WritePin:
        return WritePin(tid)

    # -- reserve -------------------------------------------------------

    def reserve_extents_for_rmw(self, oid, pin: WritePin,
                                to_read: IntervalSet,
                                will_write: IntervalSet) -> IntervalSet:
        """Pin to_read+will_write under this (youngest) pin; return
        the subset of to_read NOT in the cache (must be fetched from
        shards)."""
        state = self._objects.setdefault(oid, _ObjectState())
        # the pipeline invariant the reference's design leans on:
        # writes on one object reserve in order
        assert pin.tid >= state.owners.max_tid(), \
            "out-of-order reserve: tid %s after %s" % (
                pin.tid, state.owners.max_tid())
        pin.objects.add(oid)
        # ranges an EARLIER in-flight write already pinned are the
        # reference's "Write Pending" extents: their bytes will be in
        # the cache (readback or post-image) before this op's apply
        # runs, so they must NOT be fetched from the shards — a shard
        # read could return the pre-write image and clobber the
        # pipelined post-image (ExtentCache.h state 1)
        pending = state.owners.all_ranges()
        for off, length in to_read:
            state.owners.assign(off, length, pin.tid)
        for off, length in will_write:
            state.owners.assign(off, length, pin.tid)

        must_read = IntervalSet()
        cached = state.cache.intervals()
        for off, length in to_read:
            seg = IntervalSet([(off, length)])
            for cover in (cached, pending):
                hit = seg.intersect(cover)
                for s, e_len in hit:
                    seg.erase(s, e_len)
            must_read.union_of(seg)
        return must_read

    # -- fill ----------------------------------------------------------

    def present_read(self, oid, offset: int, data) -> None:
        """Insert readback bytes fetched for an RMW."""
        state = self._objects.setdefault(oid, _ObjectState())
        state.cache.insert(offset, data)

    def get_remaining_extents_for_rmw(self, oid,
                                      to_read: IntervalSet) -> ExtentMap:
        """Return the cached bytes covering to_read (post-readback)."""
        state = self._objects.get(oid)
        out = ExtentMap()
        if state is None:
            return out
        for off, length in to_read:
            got = state.cache.get(off, length)
            if got is not None:
                out.insert(off, got)
            else:
                for s, d in state.cache:
                    lo, hi = max(s, off), min(s + d.size, off + length)
                    if lo < hi:
                        out.insert(lo, d[lo - s:hi - s])
        return out

    def present_rmw_update(self, oid, written: ExtentMap) -> None:
        """Write-apply: the op's post-image becomes visible to later
        pipelined ops immediately (before commit)."""
        state = self._objects.setdefault(oid, _ObjectState())
        for off, data in written:
            state.cache.insert(off, data)

    # -- release -------------------------------------------------------

    def release_write_pin(self, pin: WritePin) -> None:
        """Commit: drop every byte range this pin still OWNS.  Ranges
        a younger write re-pinned were moved to that pin at its
        reserve and survive — out-of-order commit completion cannot
        evict bytes a later in-flight write will read."""
        for oid in pin.objects:
            state = self._objects.get(oid)
            if state is None:
                continue
            for off, length in state.owners.release(pin.tid):
                state.cache.erase(off, length)
            if state.empty():
                self._objects.pop(oid, None)
        pin.objects = set()

    # -- introspection -------------------------------------------------

    def contains_object(self, oid) -> bool:
        return oid in self._objects

    def pinned_by(self, oid, tid) -> IntervalSet:
        state = self._objects.get(oid)
        return state.owners.owned_by(tid) if state else IntervalSet()

    def dump(self) -> dict:
        return {str(oid): [(s, d.size) for s, d in state.cache]
                for oid, state in self._objects.items()}
