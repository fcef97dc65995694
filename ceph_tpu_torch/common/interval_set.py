"""Interval sets and interval maps.

Port of ``ceph_tpu/common/interval_set.py``, host code the port keeps
its own copy of.

Role of the reference's interval_set (src/include/interval_set.h) and
extent_map's backing interval_map (src/include/interval_map.h): sorted,
coalesced [offset, offset+len) ranges — the currency of the EC write
planner (extent_set of stripes to read/write) and the ExtentCache
(extent_map of offset -> bytes).
"""

from __future__ import annotations

import bisect

import numpy as np

__all__ = ["IntervalSet", "ExtentMap"]


class IntervalSet:
    """Coalesced set of half-open integer intervals (extent_set)."""

    def __init__(self, intervals=None):
        self._ivs: list[tuple[int, int]] = []  # sorted (start, end)
        if intervals:
            for start, length in intervals:
                self.union_insert(start, length)

    # -- mutation ------------------------------------------------------

    def union_insert(self, start: int, length: int) -> None:
        if length <= 0:
            return
        end = start + length
        out = []
        for s, e in self._ivs:
            if e < start or s > end:
                out.append((s, e))
            else:  # touching or overlapping: absorb
                start, end = min(s, start), max(e, end)
        bisect.insort(out, (start, end))
        self._ivs = out

    def erase(self, start: int, length: int) -> None:
        end = start + length
        out = []
        for s, e in self._ivs:
            if e <= start or s >= end:
                out.append((s, e))
            else:
                if s < start:
                    out.append((s, start))
                if e > end:
                    out.append((end, e))
        self._ivs = out

    def union_of(self, other: "IntervalSet") -> None:
        for s, e in other._ivs:
            self.union_insert(s, e - s)

    def intersect(self, other: "IntervalSet") -> "IntervalSet":
        out = IntervalSet()
        for s1, e1 in self._ivs:
            for s2, e2 in other._ivs:
                s, e = max(s1, s2), min(e1, e2)
                if s < e:
                    out.union_insert(s, e - s)
        return out

    # -- queries -------------------------------------------------------

    def __iter__(self):
        for s, e in self._ivs:
            yield s, e - s

    def __bool__(self) -> bool:
        return bool(self._ivs)

    def __len__(self) -> int:
        return len(self._ivs)

    def __eq__(self, other) -> bool:
        return isinstance(other, IntervalSet) and self._ivs == other._ivs

    def __repr__(self) -> str:
        return "IntervalSet(%s)" % [(s, e - s) for s, e in self._ivs]

    def empty(self) -> bool:
        return not self._ivs

    def size(self) -> int:
        return sum(e - s for s, e in self._ivs)

    def contains(self, start: int, length: int = 1) -> bool:
        end = start + length
        return any(s <= start and end <= e for s, e in self._ivs)

    def intersects(self, start: int, length: int) -> bool:
        end = start + length
        return any(s < end and start < e for s, e in self._ivs)

    def range_start(self) -> int:
        return self._ivs[0][0]

    def range_end(self) -> int:
        return self._ivs[-1][1]


class ExtentMap:
    """offset -> bytes map with interval semantics (extent_map over
    bufferlists in the reference). Later inserts overwrite overlaps."""

    def __init__(self):
        self._ivs: list[tuple[int, np.ndarray]] = []  # sorted (start, data)

    def insert(self, offset: int, data) -> None:
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else \
            np.asarray(data, dtype=np.uint8).reshape(-1)
        if arr.size == 0:
            return
        end = offset + arr.size
        out = []
        for s, d in self._ivs:
            e = s + d.size
            if e <= offset or s >= end:
                out.append((s, d))
            else:
                if s < offset:
                    out.append((s, d[:offset - s]))
                if e > end:
                    out.append((end, d[end - s:]))
        bisect.insort(out, (offset, arr), key=lambda x: x[0])
        self._ivs = out
        self._coalesce()

    def _coalesce(self) -> None:
        out = []
        for s, d in self._ivs:
            if out:
                ps, pd = out[-1]
                if ps + pd.size == s:
                    out[-1] = (ps, np.concatenate([pd, d]))
                    continue
            out.append((s, d))
        self._ivs = out

    def erase(self, offset: int, length: int) -> None:
        end = offset + length
        out = []
        for s, d in self._ivs:
            e = s + d.size
            if e <= offset or s >= end:
                out.append((s, d))
            else:
                if s < offset:
                    out.append((s, d[:offset - s]))
                if e > end:
                    out.append((end, d[end - s:]))
        self._ivs = out

    def get(self, offset: int, length: int) -> np.ndarray | None:
        """Contiguous bytes [offset, offset+length) or None if any hole."""
        end = offset + length
        parts = []
        pos = offset
        for s, d in self._ivs:
            e = s + d.size
            if e <= pos or s >= end:
                continue
            if s > pos:
                return None
            parts.append(d[pos - s:min(e, end) - s])
            pos = min(e, end)
            if pos >= end:
                break
        if pos < end:
            return None
        return np.concatenate(parts) if len(parts) != 1 else parts[0]

    def intervals(self) -> IntervalSet:
        out = IntervalSet()
        for s, d in self._ivs:
            out.union_insert(s, d.size)
        return out

    def __iter__(self):
        return iter(self._ivs)

    def empty(self) -> bool:
        return not self._ivs
