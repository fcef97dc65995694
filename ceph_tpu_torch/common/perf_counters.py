"""Performance counters.

Port of ``ceph_tpu/common/perf_counters.py``: PerfCounters and its
builder, as far as the dispatcher uses them (the histogram kind, the
schema dump and the per-context collection wait for the daemon's slice).
Role of the reference's PerfCounters (src/common/perf_counters.h:70):
each subsystem builds a named counter set (u64 counters, time sums,
averages with count+sum), registered in a per-context
collection and dumped as nested dicts by the admin socket's "perf dump".
A PerfCountersBuilder mirrors the add_u64_counter/add_time_avg/... API.
"""

from __future__ import annotations

import threading

__all__ = ["PerfCounters", "PerfCountersBuilder"]

U64 = "u64"
U64_COUNTER = "u64_counter"
TIME_AVG = "time_avg"
U64_AVG = "u64_avg"


class _Counter:
    __slots__ = ("kind", "value", "count")

    def __init__(self, kind):
        self.kind = kind
        self.value = 0
        self.count = 0


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, _Counter] = {}

    def _add(self, name, kind):
        self._counters[name] = _Counter(kind)

    # -- update --------------------------------------------------------

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name].value += amount

    def set(self, name: str, value) -> None:
        with self._lock:
            self._counters[name].value = value

    def tinc(self, name: str, seconds: float) -> None:
        """Add a duration or, to a u64 average, a sample; averages also
        bump their sample count."""
        with self._lock:
            c = self._counters[name]
            c.value += seconds
            c.count += 1

    # -- read ----------------------------------------------------------

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for name, c in self._counters.items():
                if c.kind in (TIME_AVG, U64_AVG):
                    out[name] = {"avgcount": c.count, "sum": c.value}
                else:
                    out[name] = c.value
            return out

    def reset(self) -> None:
        """Zero every counter (the 'perf reset' before/after-
        measurement surface)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
                c.count = 0


class PerfCountersBuilder:
    """add_* then create_perf_counters (perf_counters.h builder idiom)."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64(self, name, desc=""):
        self._pc._add(name, U64)
        return self

    def add_u64_counter(self, name, desc=""):
        self._pc._add(name, U64_COUNTER)
        return self

    def add_time_avg(self, name, desc=""):
        self._pc._add(name, TIME_AVG)
        return self

    def add_u64_avg(self, name, desc=""):
        self._pc._add(name, U64_AVG)
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc

