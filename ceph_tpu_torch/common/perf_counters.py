"""Performance counters.

Port of ``ceph_tpu/common/perf_counters.py``. Role of the reference's
PerfCounters (src/common/perf_counters.h:70):
each subsystem builds a named counter set (u64 counters, time sums,
averages with count+sum, histograms), registered in a per-context
collection and dumped as nested dicts by the admin socket's "perf dump".
A PerfCountersBuilder mirrors the add_u64_counter/add_time_avg/... API.
"""

from __future__ import annotations

import threading
import time

__all__ = ["PerfCounters", "PerfCountersBuilder", "PerfCountersCollection"]

U64 = "u64"
U64_COUNTER = "u64_counter"
TIME = "time"
TIME_AVG = "time_avg"
U64_AVG = "u64_avg"
HISTOGRAM = "histogram"

_HIST_BUCKETS = tuple(1 << i for i in range(1, 31))  # power-of-two buckets


class _Counter:
    __slots__ = ("kind", "value", "count", "buckets")

    def __init__(self, kind):
        self.kind = kind
        self.value = 0
        self.count = 0
        self.buckets = [0] * (len(_HIST_BUCKETS) + 1) \
            if kind == HISTOGRAM else None


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

    def dec(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name].value -= amount

    def set(self, name: str, value) -> None:
        with self._lock:
            self._counters[name].value = value

    def tinc(self, name: str, seconds: float) -> None:
        """Add a duration; averages also bump their sample count."""
        with self._lock:
            c = self._counters[name]
            c.value += seconds
            c.count += 1

    def hinc(self, name: str, sample: int) -> None:
        with self._lock:
            c = self._counters[name]
            c.count += 1
            c.value += sample
            for i, edge in enumerate(_HIST_BUCKETS):
                if sample <= edge:
                    c.buckets[i] += 1
                    break
            else:
                c.buckets[-1] += 1

    class _Timer:
        __slots__ = ("pc", "name", "t0")

        def __init__(self, pc, name):
            self.pc, self.name = pc, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.pc.tinc(self.name, time.perf_counter() - self.t0)

    def time(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    # -- read ----------------------------------------------------------

    def get(self, name: str):
        with self._lock:
            return self._counters[name].value

    def avg(self, name: str) -> float:
        with self._lock:
            c = self._counters[name]
            return c.value / c.count if c.count else 0.0

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for name, c in self._counters.items():
                if c.kind in (TIME_AVG, U64_AVG):
                    out[name] = {"avgcount": c.count, "sum": c.value}
                elif c.kind == HISTOGRAM:
                    out[name] = {"count": c.count, "sum": c.value,
                                 "buckets": list(c.buckets)}
                else:
                    out[name] = c.value
            return out

    def schema(self) -> dict:
        """Counter kinds + histogram bucket bounds (the 'perf schema'
        admin command payload; perf_counters.h's schema dump role —
        'perf dump' alone can't tell a gauge from a counter or name
        the bucket edges)."""
        with self._lock:
            out = {}
            for name, c in self._counters.items():
                entry: dict = {"type": c.kind}
                if c.kind == HISTOGRAM:
                    entry["buckets"] = list(_HIST_BUCKETS)
                out[name] = entry
            return out

    def reset(self) -> None:
        """Zero every counter (the 'perf reset' before/after-
        measurement surface)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
                c.count = 0
                if c.buckets is not None:
                    c.buckets = [0] * len(c.buckets)


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

    def add_u64_avg(self, name, desc=""):
        self._pc._add(name, U64_AVG)
        return self

    def add_time(self, name, desc=""):
        self._pc._add(name, TIME)
        return self

    def add_time_avg(self, name, desc=""):
        self._pc._add(name, TIME_AVG)
        return self

    def add_histogram(self, name, desc=""):
        self._pc._add(name, HISTOGRAM)
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    def __init__(self):
        self._lock = threading.Lock()
        self._loggers: dict[str, PerfCounters] = {}

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers[pc.name] = pc

    def remove(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers.pop(pc.name, None)

    def perf_dump(self) -> dict:
        with self._lock:
            return {name: pc.dump() for name, pc in self._loggers.items()}

    def perf_schema(self) -> dict:
        with self._lock:
            return {name: pc.schema()
                    for name, pc in self._loggers.items()}

    def perf_reset(self, logger: str | None = None) -> list[str]:
        """Reset one named logger, or every logger; returns the names
        that were reset."""
        with self._lock:
            targets = [pc for name, pc in self._loggers.items()
                       if logger is None or name == logger]
        for pc in targets:
            pc.reset()
        return sorted(pc.name for pc in targets)
