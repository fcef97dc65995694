"""Device-runtime profiler: per-kernel launch accounting and the
device-memory ledger.

Port of ``ceph_tpu/common/profiler.py``. Every hand-written kernel's entry
point on the port's paths registers with ONE process-wide registry
(``PROFILER``), so "why did streaming stall" decomposes into
per-(kernel, shape-signature) call counts, first-call wall time and
repeat calls instead of guesswork.

The reference wraps jitted programs (``wrap_jit``): a call whose shape
signature is new is a trace and compile, the rest hit the trace cache.
Nothing in the port is jitted, so ``profiled_jit`` has no counterpart;
``wrap_kernel(name, fn)`` keeps the same accounting around a kernel's
Python entry point. A call with a fresh signature counts as a "compile"
and its host wall time as ``compile_wall_s``: the first call in a process
therefore carries the kernel library's ``nvcc`` build and load, which
``ops/_build.py`` does lazily; every later call with a seen signature is
a cache hit. The wrapper never synchronises the device: it times the
host call only, as the reference times its asynchronous jit call (a
synchronise there would serialise the dispatcher's pipeline).

Two failure classes this makes visible:

* **Recompile storms**: a kernel called with a fresh signature on every
  call because its input shapes churn (a new batch size or a new erasure
  signature per op). The detector keeps a bounded ring of those events
  and flags any kernel whose events within the window cross the
  threshold.

* **Device-memory creep**: categories (the chunk tier's residency, the
  dispatcher's staging ring, the staging buffers it keeps for reuse
  under the reference's ``donated_buffers``, cached decode tables)
  account live bytes plus a high watermark each.

The registry is process-global (module-level kernel entry points have no
daemon context) and config-gated: with ``enabled`` off every wrapped
call costs one attribute check.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque

import torch

__all__ = ["DeviceProfiler", "PROFILER", "MEM_CATEGORIES"]

# device-memory ledger categories (mem_* accept any string; these are
# the ones the OSD path populates)
MEM_CATEGORIES = ("hbm_tier", "staging_ring", "donated_buffers",
                  "decode_tables")


def _shape_sig(args, kwargs):
    """Cheap shape signature: (shape, dtype, device) per tensor argument,
    (shape, dtype) per other array-like, the value of a scalar, the type
    name of anything else. The device stands where the reference puts its
    jax placement token: the same shape on the CPU and on ``cuda:0`` is
    two signatures. Built from attributes only (no numpy, no ``.item()``),
    so it never reads device memory."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), str(a.dtype), str(a.device))
        shape = getattr(a, "shape", None)
        if shape is not None:
            return (tuple(shape), str(getattr(a, "dtype", "")))
        if isinstance(a, (int, float, bool, str, bytes, type(None))):
            return a
        return type(a).__name__
    sig = tuple(one(a) for a in args)
    if kwargs:
        sig += tuple((k, one(v)) for k, v in sorted(kwargs.items()))
    return sig


class _Kernel:
    __slots__ = ("sigs", "compiles", "compile_wall", "cache_hits")

    def __init__(self):
        self.sigs: dict = {}          # sig -> [compiles, wall, hits]
        self.compiles = 0
        self.compile_wall = 0.0
        self.cache_hits = 0


class DeviceProfiler:
    """Process-wide kernel registry + device-memory ledger (one instance,
    `PROFILER`, shared by everything in the process — module-level
    kernels have no per-daemon home)."""

    def __init__(self, recompile_window: float = 60.0,
                 recompile_threshold: int = 24):
        self.enabled = True
        self.recompile_window = recompile_window
        self.recompile_threshold = recompile_threshold
        self._lock = threading.Lock()
        self._kernels: dict[str, _Kernel] = {}
        # bounded compile-event ring: (monotonic stamp, kernel name)
        self._compile_events: deque = deque(maxlen=4096)
        # category -> [live_bytes, high_watermark]
        self._mem: dict[str, list] = {}

    def configure(self, conf) -> None:
        """Adopt a daemon's osd_profiler* knobs (idempotent: every OSD in
        a shared process applies the same conf). `conf` is duck-typed:
        ``get_val(key)``."""
        try:
            self.enabled = bool(conf.get_val("osd_profiler"))
            self.recompile_window = float(
                conf.get_val("osd_profiler_recompile_window"))
            self.recompile_threshold = int(
                conf.get_val("osd_profiler_recompile_threshold"))
        except Exception:
            pass

    # -- kernel accounting ------------------------------------------------

    def record_compile(self, kernel: str, sig, wall: float) -> None:
        with self._lock:
            k = self._kernels.setdefault(kernel, _Kernel())
            row = k.sigs.setdefault(sig, [0, 0.0, 0])
            row[0] += 1
            row[1] += wall
            k.compiles += 1
            k.compile_wall += wall
            self._compile_events.append((time.monotonic(), kernel))

    def wrap_kernel(self, kernel: str, fn):
        """Wrap a kernel's entry point: per-(kernel, shape-sig) call
        accounting, with a single attribute check when the profiler is
        off. The first call with a fresh signature is counted as the
        compile and its host wall time as the compile wall; later calls
        with that signature are cache hits. The device is never
        synchronised here."""
        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            sig = _shape_sig(args, kwargs)
            with self._lock:
                k = self._kernels.setdefault(kernel, _Kernel())
                fresh = sig not in k.sigs
                if not fresh:
                    k.sigs[sig][2] += 1
                    k.cache_hits += 1
            if not fresh:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.record_compile(kernel, sig, time.perf_counter() - t0)
            return out
        functools.update_wrapper(wrapped, fn)   # and __wrapped__ = fn
        return wrapped

    # -- recompile-storm detection ----------------------------------------

    def storm_report(self, now: float | None = None) -> dict:
        """Worst kernel by fresh signatures within the window. {kernel,
        count, window_s, threshold, storming}."""
        now = time.monotonic() if now is None else now
        cutoff = now - self.recompile_window
        with self._lock:
            counts: dict[str, int] = {}
            for t, kernel in self._compile_events:
                if t >= cutoff:
                    counts[kernel] = counts.get(kernel, 0) + 1
        worst, count = None, 0
        for kernel, n in counts.items():
            if n > count:
                worst, count = kernel, n
        return {"kernel": worst, "count": count,
                "window_s": self.recompile_window,
                "threshold": self.recompile_threshold,
                "storming": count >= self.recompile_threshold}

    def storm_count(self) -> int:
        """The worst kernel's in-window count when it crosses the
        threshold, else 0 (the health feed)."""
        rep = self.storm_report()
        return rep["count"] if rep["storming"] else 0

    # -- device-memory ledger ---------------------------------------------

    def mem_add(self, category: str, nbytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            row = self._mem.setdefault(category, [0, 0])
            row[0] += int(nbytes)
            if row[0] > row[1]:
                row[1] = row[0]

    def mem_sub(self, category: str, nbytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            row = self._mem.setdefault(category, [0, 0])
            row[0] = max(0, row[0] - int(nbytes))

    def mem_set(self, category: str, nbytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            row = self._mem.setdefault(category, [0, 0])
            row[0] = int(nbytes)
            if row[0] > row[1]:
                row[1] = row[0]

    def mem_dump(self) -> dict:
        with self._lock:
            out = {cat: {"bytes": row[0], "high_watermark": row[1]}
                   for cat, row in sorted(self._mem.items())}
        out["total_bytes"] = sum(r["bytes"] for r in out.values())
        return out

    # -- introspection (the `profile dump` payload) -----------------------

    def dump(self) -> dict:
        with self._lock:
            kernels = {}
            for name, k in sorted(self._kernels.items()):
                sigs = sorted(k.sigs.items(),
                              key=lambda kv: kv[1][0], reverse=True)
                kernels[name] = {
                    "compiles": k.compiles,
                    "compile_wall_s": round(k.compile_wall, 6),
                    "cache_hits": k.cache_hits,
                    "signatures": [
                        {"sig": repr(sig), "compiles": row[0],
                         "compile_wall_s": round(row[1], 6),
                         "cache_hits": row[2]}
                        for sig, row in sigs[:16]],
                    "num_signatures": len(k.sigs)}
        return {"enabled": self.enabled,
                "kernels": kernels,
                "recompile_storm": self.storm_report(),
                "memory": self.mem_dump()}

    def reset(self) -> None:
        """Zero the kernel registry, the compile-event ring, and the
        memory high watermarks (live bytes stay — they are gauges of real
        residency, not statistics)."""
        with self._lock:
            self._kernels.clear()
            self._compile_events.clear()
            for row in self._mem.values():
                row[1] = row[0]


PROFILER = DeviceProfiler()
